"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface, keyed by a hash of its source, the headers of ``csrc/``
(``*.cuh``) and the flags, in the build directory (``build_dir()``:
``runtime.session.enable_persistent_compile_cache``'s directory, else
``$BM25_TPU_TORCH_BUILD_DIR``, else ``bm25_tpu_torch/_build/``; the build
cache that ``runtime/cache.py`` exports and imports).  A library found
there is loaded as it is: the name does not hash the nvcc or the driver
that built it, which is what the cache's fingerprint checks on import.
A missing ``nvcc`` or a failed build raises:
nothing falls back to a plain version.  The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library.

``_compile`` is the one build protocol of the kernels and of the native
text library (``native/_build.py``): an exclusive lock on ``<library>.lock``
(so of several processes or threads building one library, one compiles and
the others load its result), the compiler writing to a temporary name, and
``os.replace`` into place, so nothing ever loads a half-written file.

First-use work is charged to every open phase collector
(``collect_phases``, read by ``runtime/profiling.py::
compile_phase_collector``): seconds in nvcc under ``nvcc_build_s``, in the
C++ compiler building the native text library (``native/_build.py``) under
``native_build_s``, in ``ctypes.CDLL`` under ``library_load_s``.  With no
collector open nothing is timed.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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


PHASES = ("nvcc_build_s", "native_build_s", "library_load_s")
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


# the directory runtime/session.py::enable_persistent_compile_cache set;
# it wins over the environment
_dir: str | None = None


def build_dir() -> str:
    """The directory the kernel libraries are built into and loaded from:
    the one ``enable_persistent_compile_cache`` set, else
    ``$BM25_TPU_TORCH_BUILD_DIR`` where it is set, else ``BUILD_DIR``.
    Read at each build, so a process started with the variable set reads
    and fills that directory."""
    return _dir or os.environ.get(BUILD_DIR_ENV) or BUILD_DIR


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lies in the build directory:
    its name carries a hash of the source, the headers and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _file_lock(path: str):
    """Hold an exclusive ``flock`` on ``path`` (created if missing) for the
    block; each caller opens its own descriptor, so threads wait on each
    other as processes do."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # closing the descriptor drops the lock


def _compile(out: str, argv: list[str], sources: list[str], phase: str,
             what: str, keep_log: bool = False) -> str:
    """Run ``argv -o <tmp> sources`` and rename the result to ``out``,
    under ``out``'s lock, unless ``out`` exists once the lock is held;
    the seconds in the compiler go to ``phase``.  A nonzero exit raises
    with the compiler's output; ``keep_log`` keeps that output beside the
    library as ``<name>.log``."""
    where = os.path.dirname(out)
    os.makedirs(where, exist_ok=True)
    with _file_lock(out + ".lock"):
        if os.path.exists(out):  # another builder finished meanwhile
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=where)
        os.close(fd)
        cmd = [*argv, "-o", tmp, *sources]
        try:
            with _charged(phase):
                res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(cmd[0])} failed ({res.returncode}) "
                    f"building {what}:\n{res.stdout}{res.stderr}"
                )
            if keep_log:
                with open(out[:-3] + ".log", "w") as f:
                    f.write(res.stdout + res.stderr)
            os.replace(tmp, out)  # atomic: no reader ever sees half
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the library for the hash of its
    source and the headers exists; returns the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    return _compile(out, [find_nvcc(), *NVCC_FLAGS],
                    [os.path.join(CSRC, f"{name}.cu")], "nvcc_build_s",
                    f"{name}.cu", keep_log=True)


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
