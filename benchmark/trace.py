"""Device timings of the traced run: ``torch.profiler`` over some calls of
the window, the device's busy intervals and idle gaps, the time in which
some kernel ran, and kernel time by name.

The profiler is prepared one call early: the first call runs in its warm-up
step and a short primer kernel opens the recorded step, since the profiler
can miss the first launches of a window it has only just switched on.
"""

from __future__ import annotations

import math
import time

import torch

PRIMER_US = 1000  # the primer's length (cycles of torch.cuda._sleep / 1e3)
WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"


def kernel_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces in brackets, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    for stop in ("<", "("):
        name = name.split(stop)[0]
    return name.strip()


def profiled_window(fn, calls: int, device: torch.device,
                    host_ops: bool):
    """Run ``fn(i)`` for i in range(calls) under ``torch.profiler``, after
    one unrecorded call ``fn(-1)`` in the profiler's warm-up step.

    ``host_ops=False`` records the device alone, which costs the host
    almost nothing, and times the window by the host's clock: the busy
    share and the kernels' times come from such a window.  ``host_ops=True``
    also records the host's operations, each call inside ``CALL_SPAN`` and
    all inside ``WINDOW_SPAN``: that names the idle gaps, but the recording
    slows the host, so those gaps are longer than in a plain window.
    Returns ``(profiler, window seconds by the host's clock)``."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host_ops or not cuda:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn(-1)
        _sync(device)
        prof.step()
        if cuda:
            torch.cuda._sleep(PRIMER_US * 1000)
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            for i in range(calls):
                with record_function(CALL_SPAN):
                    fn(i)
            _sync(device)
        window_s = time.perf_counter() - t0
        prof.step()
    return prof, window_s


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def is_copy(name: str) -> bool:
    """A device event that moves or sets memory rather than runs a
    kernel."""
    return name.startswith(("Memcpy", "Memset"))


def union_s(intervals: list) -> float:
    """Seconds covered by sorted ``(start, end, ...)`` intervals in
    microseconds."""
    total, end = 0.0, -math.inf
    for lo, hi, *_ in intervals:
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e6


def read_profile(prof, window_s: float) -> dict:
    """What the readers need of a profiled window: its length, the seconds
    in which some kernel or copy ran inside it (``busy_s``) and in which
    some kernel ran (``kernel_busy_s``), each kernel's device seconds and
    launches by name, and the longest idle gaps, each named by the
    innermost host operation running at its middle (where the window
    recorded the host's operations)."""
    events = list(prof.events())
    spans = (WINDOW_SPAN, CALL_SPAN)
    windows = [e for e in events if e.name == WINDOW_SPAN
               and e.device_type != torch.autograd.DeviceType.CUDA]
    w0 = min((e.time_range.start for e in windows), default=-math.inf)
    w1 = max((e.time_range.end for e in windows), default=math.inf)
    dev, host = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the primer, and the device copies of the benchmark's spans
            if "sleep" in e.name or e.name in spans \
                    or getattr(e, "is_user_annotation", False):
                continue
            lo, hi = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if hi > lo:
                dev.append((lo, hi, e.name))
        elif e.name != WINDOW_SPAN and not e.name.startswith("ProfilerStep"):
            host.append(e)
    dev.sort()
    kernels: dict[str, list] = {}
    for lo, hi, name in dev:
        k = kernels.setdefault(kernel_name(name), [0.0, 0])
        k[0] += (hi - lo) / 1e6
        k[1] += 1
    gaps = []
    end = w0 if windows else (dev[0][0] if dev else 0.0)
    for lo, hi, _ in dev:
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    if windows and w1 > end:
        gaps.append((end, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = ([[_host_at(host, (lo + hi) / 2), (hi - lo) / 1e6]
              for lo, hi in gaps[:10]] if host else [])
    return {"window_s": window_s, "busy_s": union_s(dev),
            "kernel_busy_s": union_s([d for d in dev if not is_copy(d[2])]),
            "kernels": sorted(([n, s, c] for n, (s, c) in kernels.items()),
                              key=lambda r: -r[1]),
            "gaps": named}


def _host_at(host: list, t: float) -> str:
    """The innermost host span or operation running at ``t`` (the one that
    started last), under the benchmark's span that holds it."""
    live = [e for e in host if e.time_range.start <= t <= e.time_range.end]
    if not live:
        return "host outside the calls"
    inner = max(live, key=lambda e: e.time_range.start)
    if inner.name == CALL_SPAN:
        return f"{CALL_SPAN}: host work outside torch (numpy, Python)"
    return f"{CALL_SPAN}: {inner.name}"
