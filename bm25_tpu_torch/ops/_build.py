"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface, keyed by a hash of its source, the headers of ``csrc/``
(``*.cuh``) and the flags, in the build directory (``build_dir()``:
``$BM25_TPU_TORCH_BUILD_DIR``, else ``bm25_tpu_torch/_build/``; the build
cache that ``runtime/cache.py`` exports and imports).  A library found
there is loaded as it is: the name does not hash the nvcc or the driver
that built it, which is what the cache's fingerprint checks on import.
A missing ``nvcc`` or a failed build raises:
nothing falls back to a plain version.  The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library.

First-use work is charged to every open phase collector
(``collect_phases``, read by ``runtime/profiling.py::
compile_phase_collector``): seconds in nvcc under ``nvcc_build_s``, in
``ctypes.CDLL`` under ``library_load_s``.  With no collector open nothing
is timed.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")  # the default build directory
BUILD_DIR_ENV = "BM25_TPU_TORCH_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


PHASES = ("nvcc_build_s", "library_load_s")
_sinks: list[dict] = []  # the open collectors' dicts
_sinks_lock = threading.Lock()


@contextlib.contextmanager
def collect_phases():
    """Yield a dict of the seconds of first-use work (``PHASES``) done in
    any thread while the block runs."""
    sink = dict.fromkeys(PHASES, 0.0)
    with _sinks_lock:
        _sinks.append(sink)
    try:
        yield sink
    finally:
        with _sinks_lock:
            _sinks.remove(sink)


@contextlib.contextmanager
def _charged(phase: str):
    """Time the block into every open collector (free when none is)."""
    if not _sinks:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _sinks_lock:
            for sink in _sinks:
                sink[phase] += dt


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "bm25_tpu_torch build from source at first use"
    )


def build_dir() -> str:
    """The directory the kernel libraries are built into and loaded from:
    ``$BM25_TPU_TORCH_BUILD_DIR`` where it is set, else ``BUILD_DIR``.
    Read at each build, so a process started with the variable set reads
    and fills that directory."""
    return os.environ.get(BUILD_DIR_ENV) or BUILD_DIR


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lies in the build directory:
    its name carries a hash of the source, the headers and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the library for the hash of its
    source and the headers exists; returns the library's path."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = library_path(name)
    if os.path.exists(out):
        return out
    where = os.path.dirname(out)
    os.makedirs(where, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=where)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    try:
        with _charged("nvcc_build_s"):
            res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {name}.cu:\n"
                f"{res.stdout}{res.stderr}"
            )
        with open(out[:-3] + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names) -> dict[str, str]:
    """``build`` for several sources at once, one nvcc process each, all
    started together; returns {name: library path}."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


_libs: dict[str, ctypes.CDLL] = {}
_lib_locks: dict[str, threading.Lock] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu`` (built if needed).
    Threads that ask for one library first at the same time wait for one
    build and one load."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _sinks_lock:
        lock = _lib_locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            path = build(name)
            with _charged("library_load_s"):
                _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher; every
    library exports ``bm25_cuda_error_string`` to name it."""
    if err:
        fn = lib.bm25_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()})")
