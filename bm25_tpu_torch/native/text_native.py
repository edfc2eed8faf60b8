"""ctypes wrapper over the native text library (tokenizer, Snowball
stemmer, counting-sort CSC build): the port's copy of
``bm25_tpu/native/text_native.py``, with the same checks and errors.

What differs: the port builds the library from its own sources
(``native/_build.py``), so every entry point is always there; and
``stem`` takes a word of any script, as NLTK's ``SnowballStemmer.stem``
does: it lowercases with Python's ``str.lower()``, then an ASCII word goes
to ``bm25_stem`` as bytes and any other to ``bm25_stem_u32`` as UTF-32 code
points.
"""

from __future__ import annotations

import ctypes

import numpy as np


class NativeTextPipeline:
    def __init__(self, so_path: str):
        self.path = so_path
        lib = ctypes.CDLL(so_path)
        lib.bm25_tokenize_corpus.restype = ctypes.c_void_p
        lib.bm25_tokenize_corpus.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64,
            ctypes.c_int,
        ]
        for name, restype in [
            ("tok_total_tokens", ctypes.c_int64),
            ("tok_vocab_size", ctypes.c_int64),
            ("tok_vocab_bytes", ctypes.c_int64),
        ]:
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = [ctypes.c_void_p]
        lib.tok_copy_ids.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.tok_copy_offsets.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.tok_copy_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tok_free.argtypes = [ctypes.c_void_p]
        lib.bm25_stem.restype = ctypes.c_int64
        lib.bm25_stem.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.bm25_stem_u32.restype = ctypes.c_int64
        lib.bm25_stem_u32.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.bm25_build_csc.restype = ctypes.c_void_p
        lib.bm25_build_csc.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.csc_nnz.restype = ctypes.c_int64
        lib.csc_nnz.argtypes = [ctypes.c_void_p]
        lib.csc_copy_indptr.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.csc_copy_indices.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.csc_copy_tf.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.csc_free.argtypes = [ctypes.c_void_p]
        lib.bm25_csc_last_error.restype = ctypes.c_int
        lib.bm25_csc_last_error.argtypes = []
        self._lib = lib

    def build_tf_csc(self, flat_tokens: "np.ndarray", doc_lengths: "np.ndarray",
                     vocab_size: int):
        """Counting-sort CSC build: (indptr int64, doc ids int32, tf f32).

        Same output contract as the numpy pipeline in
        ``scoring.build_scored_index_flat`` (ascending doc ids per column,
        exact tf); single histogram + scatter + RLE passes, threaded when
        cores are available.
        """
        if int(vocab_size) < 0:
            raise ValueError(f"vocab_size must be >= 0; got {vocab_size}")
        flat_in = np.asarray(flat_tokens)
        if flat_in.dtype != np.int32 and len(flat_in):
            # validate BEFORE the int32 cast: a wider id would silently
            # wrap through ascontiguousarray and bypass every later check
            lo, hi = int(flat_in.min()), int(flat_in.max())
            if lo < 0 or hi >= vocab_size:
                raise ValueError(
                    f"token ids must be in [0, {vocab_size}); got [{lo}, {hi}]"
                )
        flat = np.ascontiguousarray(flat_in, dtype=np.int32)
        lens = np.ascontiguousarray(doc_lengths, dtype=np.int32)
        # int32 inputs skip the host min/max sweeps: the native histogram
        # pass bounds-checks every id itself (it reads them anyway) and
        # reports via bm25_csc_last_error
        if len(lens) and int(lens.min()) < 0:
            # a negative length would make doc_end non-monotonic and send
            # the native scatter out of bounds
            raise ValueError("doc_lengths must be non-negative")
        if int(lens.sum()) != len(flat):
            raise ValueError("doc_lengths must sum to len(flat_tokens)")
        h = self._lib.bm25_build_csc(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(flat),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(lens),
            int(vocab_size),
        )
        if not h:
            if self._lib.bm25_csc_last_error() == 1:
                lo = int(flat.min()) if len(flat) else 0
                hi = int(flat.max()) if len(flat) else 0
                raise ValueError(
                    f"token ids must be in [0, {vocab_size}); got [{lo}, {hi}]"
                )
            raise MemoryError("bm25_build_csc failed (allocation)")
        try:
            nnz = self._lib.csc_nnz(h)
            indptr = np.empty(vocab_size + 1, dtype=np.int64)
            indices = np.empty(nnz, dtype=np.int32)
            tf = np.empty(nnz, dtype=np.float32)
            self._lib.csc_copy_indptr(
                h, indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if nnz:
                self._lib.csc_copy_indices(
                    h, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                self._lib.csc_copy_tf(
                    h, tf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        finally:
            self._lib.csc_free(h)
        return indptr, indices, tf

    def stem(self, word: str) -> str:
        """NLTK's ``SnowballStemmer("english").stem(word)``."""
        word = word.lower()
        if word.isascii():
            w, enc, width = word.encode("ascii"), "ascii", 1
            buf = ctypes.create_string_buffer(len(w) + 16)
            n = self._lib.bm25_stem(w, len(w), buf, len(buf))
        else:
            w, enc, width = word.encode("utf-32-le", "surrogatepass"), \
                "utf-32-le", 4
            buf = (ctypes.c_uint32 * (len(word) + 16))()
            n = self._lib.bm25_stem_u32(w, len(word), buf, len(buf))
        if n == -1:
            raise ValueError("stem buffer overflow")
        if n < 0:
            raise MemoryError("bm25_stem failed")
        return ctypes.string_at(buf, width * n).decode(enc, "surrogatepass")

    def tokenize_corpus(self, texts, stopwords=frozenset(), use_stemmer=True):
        from bm25_tpu_torch.text.tokenizer import TokenizedCorpus

        enc = [t.encode("utf-8") for t in texts]
        n = len(enc)
        docs = (ctypes.c_char_p * n)(*enc)
        lens = (ctypes.c_int64 * n)(*[len(e) for e in enc])
        stop_enc = [s.encode("utf-8") for s in sorted(stopwords)]
        stops = (ctypes.c_char_p * max(len(stop_enc), 1))(*(stop_enc or [b""]))

        handle = self._lib.bm25_tokenize_corpus(
            docs, lens, n, stops, len(stop_enc), 1 if use_stemmer else 0
        )
        if not handle:
            raise MemoryError("bm25_tokenize_corpus failed (allocation)")
        try:
            total = self._lib.tok_total_tokens(handle)
            ids = np.empty(total, dtype=np.int32)
            if total:
                self._lib.tok_copy_ids(
                    handle, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
                )
            offsets = np.empty(n + 1, dtype=np.int64)
            self._lib.tok_copy_offsets(
                handle, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            )
            vb = self._lib.tok_vocab_bytes(handle)
            vbuf = ctypes.create_string_buffer(int(vb))
            if vb:
                self._lib.tok_copy_vocab(handle, vbuf)
            terms = vbuf.raw[:vb].decode("utf-8").split("\n")[:-1] if vb else []
        finally:
            self._lib.tok_free(handle)

        vocab = {t: i for i, t in enumerate(terms)}
        doc_ids = [ids[offsets[i] : offsets[i + 1]] for i in range(n)]
        return TokenizedCorpus(ids=doc_ids, vocab=vocab)
