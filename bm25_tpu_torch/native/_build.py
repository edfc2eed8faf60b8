"""Build the native text library at first use (a C++ compiler + ctypes).

The three sources of ``native/src`` compile into one shared library,
``libbm25text-<hash>.so``, in the kernels' build directory
(``ops/_build.py::build_dir``: ``$BM25_TPU_TORCH_BUILD_DIR``, else
``bm25_tpu_torch/_build/``), where ``runtime/cache.py`` exports and
imports it with the CUDA libraries.  The hash covers the sources and the
flags.  The compiler is ``$CXX``, else ``c++`` or ``g++`` on ``PATH``;
one missing, or a failed build, raises: there is no Python fallback.

The build itself is the kernels' protocol (``ops/_build.py::_compile``):
under the library's lock, to a temporary name, renamed into place; the
compile is charged to the open phase collectors as ``native_build_s``.
"""

from __future__ import annotations

import hashlib
import os
import shutil

from bm25_tpu_torch.ops import _build

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCES = ("snowball_en.cpp", "tokenize.cpp", "csc_build.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def find_cxx() -> str:
    """The C++ compiler: ``$CXX`` where it is set, else ``c++`` or ``g++``
    on ``PATH``."""
    env = os.environ.get("CXX")
    cands = [env] if env else ["c++", "g++"]
    for cand in cands:
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError(
        f"no C++ compiler ({'$CXX=' + env if env else 'c++ or g++ on PATH'}"
        "): the native text library of bm25_tpu_torch builds from source "
        "at first use"
    )


def library_path() -> str:
    """Where the native library lies in the build directory: its name
    carries a hash of the sources and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_build.build_dir(),
                        f"libbm25text-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the native library unless the one for the hash of its
    sources exists; returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    return _build._compile(out, [find_cxx(), *CXX_FLAGS],
                           [os.path.join(SRC_DIR, s) for s in SOURCES],
                           "native_build_s", "the native text library")
