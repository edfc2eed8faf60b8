"""Tracing & profiling hooks — the port's copy of
``bm25_tpu/runtime/profiling.py``.

JAX's ``named_scope`` / ``TraceAnnotation`` spans become
``torch.profiler.record_function`` ranges (and an NVTX range where CUDA
is present, for tools that read NVTX); its XPlane capture becomes a
``torch.profiler`` trace of the host and the card written as a Chrome
trace.  The compile-phase collector reports the port's own first-use
work: nvcc builds and library loads of the CUDA kernels (``ops/_build.py``),
not XLA's tracing, lowering and compiling, which the port does not do.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from bm25_tpu_torch.ops import _build


@contextlib.contextmanager
def _span(name: str):
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def op_span(name: str):
    """Named trace span around device work (a profiler range, and an
    NVTX range on CUDA)."""
    return _span(name)


def host_span(name: str):
    """Named trace span for host-side phases (shows up in profiler
    traces)."""
    return _span(name)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a host + CUDA profile of the block into ``log_dir`` as a
    Chrome trace (``trace.json``; open it in Perfetto or
    ``chrome://tracing``).

    Usage:
        with capture_trace("/tmp/bm25_trace"):
            engine.search(queries, top_k=1000)
    """
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def compile_phase_collector():
    """Collect the seconds of first-use work done inside the with-block.

    Yields a dict that accumulates ``nvcc_build_s`` (compiling a kernel
    library with nvcc, where no library for its source hash exists) and
    ``library_load_s`` (``ctypes.CDLL`` of a library not loaded before).
    The caller's wall time minus these is execution, host overhead and
    transfers.  Built for the serve warmup breakdown.  Work done by any
    thread while the block runs counts.
    """
    with _build.collect_phases() as phases:
        yield phases


@dataclass
class StepTimer:
    """Wall-clock step timer collecting simple latency stats (p50/p99)."""

    samples_s: list = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples_s.append(time.perf_counter() - t0)

    def percentile(self, p: float) -> float:
        if not self.samples_s:
            return float("nan")
        xs = sorted(self.samples_s)
        idx = min(int(round(p / 100 * (len(xs) - 1))), len(xs) - 1)
        return xs[idx]

    def summary(self) -> dict:
        return {
            "count": len(self.samples_s),
            "p50_ms": self.percentile(50) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "mean_ms": (sum(self.samples_s) / len(self.samples_s) * 1e3)
            if self.samples_s
            else float("nan"),
        }
