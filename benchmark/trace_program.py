"""The layers inside the program over one cell, read from the program's own
spans and counters (``bm25_tpu_torch.runtime.profiling``) on the card.

    python3 benchmark/trace_program.py --workload <cell> --seed <n>

from the root of a checkout on a machine with an NVIDIA GPU.  It makes the
cell's inputs from the seed, builds the program with its tracer on, warms
one cycle of calls, then profiles three windows of the traffic's
``trace_calls`` calls, as a ``--trace 1`` run of ``run.py`` profiles its
own (``trace.profiled_window``):

1. the device alone, tracing off: the reference for tracing's cost;
2. the device alone, tracing on: the spans, counters and each kernel's
   launching span (``spans.attribute``), and the card's idle time split
   by the span the host was in (``spans.idle_split``);
3. host operations too, tracing on, a quarter as many calls: the longest
   idle gaps, named as ``trace.read_profile`` names them or, inside the
   benchmark's call span, by the innermost program span.

It prints one JSON line: ``spans.metrics``, the host's ms a batch in each
span, the idle split, the set-up's spans, the calls' ms with tracing off
and on, the benchmark's own ``plan_ms`` (timed from outside, as ``run.py``
does) and two sums that must hold: selection and the scan within the
window's kernel time, and idle inside and outside the calls equal to the
window's idle time.  The benchmark's runs do not run it: a ``benchmark``
change that moves this reading into ``harness.traced_window`` deletes it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import gen, harness  # noqa: E402
from benchmark import spans as bspans  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from benchmark.metrics._common import kernel_group_ms  # noqa: E402
from bm25_tpu_torch.runtime.profiling import tracing  # noqa: E402

OUTSIDE_TORCH = f"{btrace.CALL_SPAN}: host work outside torch"


def _window(calls, keep, n: int, device, host_ops: bool, traced: bool):
    """One profiled window of ``n`` calls: ``(profile, window_s, w0_ns,
    spans, tally)``, ``w0_ns`` the first call's start on the epoch clock
    and ``spans`` those of the window's calls (none untraced)."""
    tally = harness.new_tally()
    marks = {}

    def fn(i):
        if i < 0:
            calls(0)
            return
        if i == 0:
            marks["w0"] = time.time_ns()
        harness.one_call(calls, keep, i, tally)

    with tracing() if traced else contextlib.nullcontext() as trace:
        prof, window_s = btrace.profiled_window(fn, n, device, host_ops)
    w0 = marks["w0"]
    spans = [s for s in trace.records() if s["start_ns"] >= w0] \
        if traced else []
    return prof, window_s, w0, spans, tally


def _name_gaps(prof, spans, w0, w1, top: int = 10) -> list:
    """The ``top`` longest idle gaps, ``[name, seconds]``, named by
    ``trace._host_at`` or, where that finds no torch operation inside the
    benchmark's call span, by the innermost program span's path."""
    dev, _ = bspans.profile_events(prof)
    base = prof.profiler.kineto_results.trace_start_ns()
    host = [e for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA
            and e.name != btrace.WINDOW_SPAN
            and not e.name.startswith("ProfilerStep")]
    idle = sorted(bspans.gaps(dev, w0, w1), key=lambda g: g[0] - g[1])
    named = bspans.paths(spans)
    out = []
    for lo, hi in idle[:top]:
        t = (lo + hi) / 2
        name = btrace._host_at(host, (t - base) / 1e3)
        if name.startswith(OUTSIDE_TORCH):
            (sid,) = bspans.innermost(spans, [t])
            if sid is not None:
                name = f"{btrace.CALL_SPAN}: {named[sid]}"
        out.append([name, (hi - lo) / 1e9])
    return out


def trace_cell(cell: dict, seed: int, device: torch.device,
               session=None) -> dict:
    """The JSON object that ``main`` prints for ``cell`` at ``seed``
    (``session`` puts the program on the CPU in tests)."""
    config, traffic = cell["config"], cell["traffic"]
    doc_lengths, flat, queries = gen.make_inputs(config, seed, device)
    longest = int(np.argmax(gen.query_lengths(queries)))
    with tracing() as trace:
        engine, setup_s = harness.build_program(doc_lengths, flat, config,
                                                session)
    build = trace.records()
    calls = harness.Calls(engine, queries, traffic)
    for i in range(len(calls)):
        calls(i)
    btrace._sync(device)
    keep = harness.Keeper(calls, traffic, seed, longest)
    n = int(traffic["trace_calls"])
    batches = sum(len(calls.batches(i)) for i in range(n))

    prof, off_s, _, _, t_off = _window(calls, keep, n, device, False, False)
    off = btrace.read_profile(prof, off_s)
    prof, on_s, w0, spans, t_on = _window(calls, keep, n, device, False,
                                          True)
    on = btrace.read_profile(prof, on_s)
    dev, launches = bspans.profile_events(prof)
    kernels = bspans.attribute(dev, launches, spans)
    idle = bspans.idle_split(bspans.gaps(dev, w0, w0 + int(on_s * 1e9)),
                             spans) if dev else None
    prof, host_s, w0h, hspans, t_host = _window(
        calls, keep, max(n // 4, 1), device, True, True)
    gaps = _name_gaps(prof, hspans, w0h, w0h + int(host_s * 1e9))
    del prof
    plan = harness.plan_times(engine, calls)

    out = {"workload": cell["name"], "seed": seed,
           "device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "power": harness.power_limit() if device.type == "cuda" else None,
           "traced_calls": n, "traced_batches": batches,
           "failed": t_off["failed"] + t_on["failed"] + t_host["failed"],
           "metrics": bspans.metrics(spans, kernels, idle, build),
           "plan_ms": sum(plan) / len(plan) if plan else None,
           "call_ms": {"tracing_off": off_s / n * 1e3,
                       "tracing_on": on_s / n * 1e3},
           "host_self_ms_a_batch": bspans.per_batch_ms(spans),
           "counts": bspans.counts(spans),
           "idle": idle, "idle_gaps": gaps,
           "setup_s": setup_s,
           "build_self_s": bspans.seconds_by_name(build),
           "kernels_by_span": kernels[:40]}
    busy = on.get("kernel_busy_s")
    sel = out["metrics"].get("select_ms")
    scan = kernel_group_ms({"kernels": on["kernels"], "traced_calls": n},
                           "scan_ms")
    if busy and sel is not None and scan is not None:
        out["select_and_scan_within_kernel_time"] = {
            "select_ms_x_batches": sel * batches,
            "scan_ms_x_calls": scan * n, "kernel_busy_ms": busy * 1e3}
    if idle is not None:
        window_idle = on_s - on["busy_s"]
        out["idle_balance"] = {
            "inside_plus_outside_s": idle["inside_s"] + idle["outside_s"],
            "window_s_less_busy_s": window_idle}
    out["device_idle_pct"] = {
        "tracing_off": 100 * (1 - off["busy_s"] / off_s) if off["busy_s"]
        else None,
        "tracing_on": 100 * (1 - on["busy_s"] / on_s) if on["busy_s"]
        else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the program's trace is read on a CUDA device; found none",
              file=sys.stderr)
        return 2
    from benchmark import run

    run.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    print(json.dumps(trace_cell(cell, args.seed, torch.device("cuda", 0))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
