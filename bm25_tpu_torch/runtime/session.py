"""Device session — PyTorch counterpart of ``bm25_tpu/runtime/session.py``.

A ``Session`` pins one explicit ``torch.device`` and owns the host<->device
boundary (``put``/``get``, and ``put_async``/``fetch_async``/
``record_event`` for transfers that do not wait on the device).  Unlike the
JAX session it never picks a device by itself: the default is ``"cuda"``
and it raises when CUDA is absent, so a run that was meant for the GPU
cannot quietly measure the CPU; ``get_device`` and ``Session.create`` keep
that rule.  CPU tests pass ``Session("cpu")`` (or ``prefer="cpu"``)
explicitly.  ``Session.compile`` is JAX's keyed, thread-safe memo of built
step functions (PyTorch runs eagerly, so nothing is traced: ``build`` runs
once a key).  The persistent compile cache of this port is the kernels'
build directory (``ops/_build.py``), which
``enable_persistent_compile_cache`` points at a directory.

``full_f32_matmul`` is the one place that sets the precision of cuBLAS
float32 products: the dense engine's matmul scoring and the op library's
``matmul(algorithm="xla")`` run under it.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import shutil
import tempfile
import threading
from typing import Callable, Hashable

import numpy as np
import torch

from bm25_tpu_torch.ops import _build

_cache_configured = False


def enable_persistent_compile_cache(path: str | None = None) -> None:
    """Point the kernels' build directory (``ops/_build.py::build_dir``),
    where each CUDA kernel is compiled once and loaded from after, at
    ``path``.

    JAX's rules: with no path the directory is ``$BM25_TPU_TORCH_BUILD_DIR``
    (else the package's ``_build/``) and only the first such call acts; an
    explicit path wins over any earlier call; an empty string (as the
    path, or as the variable when no path is given) disables the cache:
    the kernels then build into a temporary directory of this process,
    removed at its exit.
    """
    global _cache_configured
    if _cache_configured and path is None:
        return
    if path is None:
        path = os.environ.get(_build.BUILD_DIR_ENV)
        if path is None:  # build_dir() already reads the default
            _cache_configured = True
            return
    if not path:
        path = tempfile.mkdtemp(prefix="bm25_tpu_torch_build_")
        atexit.register(shutil.rmtree, path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    _build._dir = path
    _cache_configured = True


def accelerator_count() -> int:
    """The CUDA cards this process sees (0 where CUDA is absent)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_device(device_id: int = 0, prefer: str | None = None) -> torch.device:
    """The execution device: ``prefer="cpu"`` gives the CPU; otherwise
    (``None``, ``"gpu"`` or ``"cuda"``) CUDA card ``device_id``.

    Where there is no such card this raises: JAX's ``get_device`` falls
    back to the CPU when no accelerator is present, and the port leaves
    that out, as ``Session`` does, so a run meant for the card cannot
    quietly measure the CPU.
    """
    if prefer == "cpu":
        if device_id != 0:
            raise ValueError(f"device_id {device_id} out of range: 1 cpu "
                             "device available")
        return torch.device("cpu")
    if prefer not in (None, "gpu", "cuda"):
        raise ValueError(f"no {prefer!r} device available; have "
                         "['cpu', 'gpu']")
    n = accelerator_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass prefer='cpu' "
                           "to run on the CPU")
    if not 0 <= device_id < n:
        raise ValueError(f"device_id {device_id} out of range: {n} gpu "
                         "device(s) available")
    return torch.device("cuda", device_id)


class Session:
    """Execution session: one explicit device, transfer helpers and a
    keyed cache of built step functions."""

    def __init__(self, device: str | torch.device = "cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Session(device='cuda') needs a CUDA device and none is "
                "available; pass Session('cpu') explicitly to run on the CPU"
            )
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self._cache: dict[Hashable, Callable] = {}
        self._lock = threading.Lock()

    @classmethod
    def create(cls, device_id: int = 0, prefer: str | None = None
               ) -> "Session":
        """A session on ``get_device(device_id, prefer)``."""
        return cls(get_device(device_id, prefer))

    def __repr__(self) -> str:
        return f"Session(device={str(self.device)!r})"

    @property
    def platform(self) -> str:
        """JAX's platform name of the device: ``"gpu"`` or ``"cpu"``."""
        return "cpu" if self.device.type == "cpu" else "gpu"

    def compile(self, key: Hashable, build: Callable[[], Callable]
                ) -> Callable:
        """The function cached under ``key``, made by ``build()`` on the
        first call (thread-safe: the server calls engines from a threading
        HTTP server, and racing threads build a key once)."""
        fn = self._cache.get(key)
        if fn is None:
            with self._lock:
                fn = self._cache.get(key)
                if fn is None:
                    fn = build()
                    self._cache[key] = fn
        return fn

    def put(self, x) -> torch.Tensor:
        """Host -> device transfer of a numpy array (or tensor).

        ``ml_dtypes`` bfloat16 arrays (what a JAX engine hands back) travel
        as their uint16 bit patterns: ``torch.from_numpy`` refuses them.
        """
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # a CPU tensor would alias it
            x = x.copy()
        if x.dtype.name == "bfloat16":
            x = x.view(np.int16)
            return torch.from_numpy(x).view(torch.bfloat16).to(self.device)
        return torch.from_numpy(x).to(self.device)

    def put_async(self, x: np.ndarray) -> torch.Tensor:
        """Host -> device transfer of a small numpy array that does not
        wait for the device: on CUDA the array is copied into pinned
        memory and uploaded with ``non_blocking=True`` (the caller may
        reuse ``x`` at once)."""
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # a CPU tensor would alias it
            x = x.copy()
        t = torch.from_numpy(x)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def fetch_async(x: torch.Tensor) -> torch.Tensor:
        """Start a device -> host copy of ``x`` into a pinned buffer and
        return the buffer without waiting.  It holds ``x`` once an event
        recorded after this call (``record_event``) has completed.  A CPU
        tensor comes back as it is."""
        if x.device.type != "cuda":
            return x
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        return out

    def record_event(self):
        """A CUDA event recorded on the device's current stream (None on
        the CPU, where every operation has finished when it returns)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    @staticmethod
    def get(x: torch.Tensor) -> np.ndarray:
        """Device -> host transfer; bfloat16 comes back as exact float32."""
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()


@contextlib.contextmanager
def full_f32_matmul():
    """cuBLAS float32 products in full f32 inside the block, whatever the
    process allowed (``allow_tf32``, ``set_float32_matmul_precision`` or
    ``fp32_precision``); the caller's setting is restored on exit.  The
    setting is process-wide while the block runs."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = saved


_default_session: Session | None = None
_session_lock = threading.Lock()


def get_session() -> Session:
    """Process-default session on ``cuda``; raises where CUDA is absent."""
    global _default_session
    if _default_session is None:
        with _session_lock:
            if _default_session is None:
                _default_session = Session()
    return _default_session
