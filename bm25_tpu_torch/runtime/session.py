"""Device session — PyTorch counterpart of ``bm25_tpu/runtime/session.py``.

A ``Session`` pins one explicit ``torch.device`` and owns the host<->device
boundary (``put``/``get``, and ``put_async``/``fetch_async``/
``record_event`` for transfers that do not wait on the device).  Unlike the JAX session it never picks a device
by itself: the default is ``"cuda"`` and it raises when CUDA is absent, so a
run that was meant for the GPU cannot quietly measure the CPU.  CPU tests
pass ``Session("cpu")`` explicitly.  PyTorch runs eagerly, so there is no
compile cache to own.

``full_f32_matmul`` is the one place that sets the precision of cuBLAS
float32 products: the dense engine's matmul scoring and the op library's
``matmul(algorithm="xla")`` run under it.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


class Session:
    """Execution session: one explicit device plus transfer helpers."""

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

    def __repr__(self) -> str:
        return f"Session(device={str(self.device)!r})"

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
