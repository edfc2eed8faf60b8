"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface, keyed by a hash of its source and flags, under
``bm25_tpu_torch/_build/``.  A missing ``nvcc`` or a failed build raises:
nothing falls back to a plain version.  The compiler's ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the library for its source hash
    exists; returns the library's path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    try:
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


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu`` (built if needed)."""
    return ctypes.CDLL(build(name))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher; every
    library exports ``bm25_cuda_error_string`` to name it."""
    if err:
        fn = lib.bm25_cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()})")
