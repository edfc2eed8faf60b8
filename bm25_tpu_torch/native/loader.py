"""Loader for the native (C++) text-processing library.

``get()`` returns the process's ``NativeTextPipeline`` over the library
that ``native/_build.py`` builds at first use from ``native/src``.  Where
the library cannot be built or loaded it raises: the port has no silent
Python fallback (the JAX package's loader warns and falls back).
"""

from __future__ import annotations

import threading

from bm25_tpu_torch.native.text_native import NativeTextPipeline

_pipeline: NativeTextPipeline | None = None
_lock = threading.Lock()


def get() -> NativeTextPipeline:
    """The loaded pipeline (built on the first call); threads that ask
    first at the same time wait for one build and one load."""
    global _pipeline
    if _pipeline is not None:
        return _pipeline
    from bm25_tpu_torch.native import _build as native_build
    from bm25_tpu_torch.ops import _build

    with _lock:
        if _pipeline is None:
            path = native_build.build()
            with _build._charged("library_load_s"):
                _pipeline = NativeTextPipeline(path)
        return _pipeline


def snowball_stem(word: str) -> str:
    """NLTK's ``SnowballStemmer("english").stem``, natively: the stemmer
    behind ``Tokenizer(stemmer="snowball-en")`` (``use_native=True``).  A
    module-level function, so a tokenizer holding it pickles."""
    return get().stem(word)
