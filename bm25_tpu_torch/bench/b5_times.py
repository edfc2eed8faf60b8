"""Time B5 (the Gumbel-max choice) of one checkout of the port, on the card.

Bare ``gumbel_choice(logits, seed)`` at (512, 100), (512, 1,000), (64,
32,768) and (8, 131,072), logits from ``default_rng(0)``: the kernel's
device time per launch (``torch.profiler``), CUDA-event time per call
over back-to-back calls, the host's wall time per call (calls queued
back to back, no sync inside), and the bound (``bound_ms``).  Also the host time of the parts a launch wrapper may spend
on: ``torch.empty`` of the output, a ``torch.cuda.Stream`` object or the
raw stream handle, and a ``torch.cuda.device`` context.  Where the
checkout has B5's layouts (``ChoicePlan``), the
kernel's device time is also taken at each shape in each layout: a warp
a row, a block of 256, 512 or 1,024 threads a row, and clusters of 2-8
such blocks.

Then, on the dense step's (512, 131,072) scores at k = 100 and k =
1,000: where the checkout has it, the fused step alone,
``gumbel_sample`` on the f32 top k at temperature 0.7 (CUDA-event ms and
host µs a call, and the rows whose sampled id differs from its twin's);
and ``top_k_fused_sampling(implementation="pallas")`` (the exact tree
top k, its default as JAX's, then the fused step) with a CUDA generator:
wall time per call, each ending in ``torch.cuda.synchronize()`` (median
of 40).  The scores are those of
``chip_smoke.py`` phase 6's corpus and queries
(``BenchConfig(num_docs=131072)``, the first 512 queries), summed by
``ReferenceEngine`` on the host (every doc eligible, as there).

``--repo`` names the checkout whose ``bm25_tpu_torch`` is imported, so
that two checkouts can be timed in turns on one card (parent, change,
change, parent), each in its own process; ``--scores FILE`` reads the
scores from a ``.npy`` file and writes them there first if it is
missing.  Prints one JSON line, with the card's name and power limit.

Run: ``python bm25_tpu_torch/bench/b5_times.py [--repo DIR] [--scores
FILE]``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SHAPES = ((512, 100), (512, 1000), (64, 32768), (8, 131072))
SEED = 12345
# operations a column (csrc/topk.cu gumbel_z), counted low: the hash's 9
# integer operations (the xor with the row's hash, mix32's three
# xor-shifts and two multiplies), u's 4 (shift, convert, multiply, add),
# two logf and two negations, z's add and the compare, each logf as one
# operation (compiled, it is a polynomial of many) and the integer ones at
# the f32 rate
OPS_PER_COLUMN = 19
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host wall microseconds a call, the calls queued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_us(fn, calls: int = 20) -> float:
    """Device microseconds a launch of B5's kernel (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if "gumbel_choice" in e.key and e.device_time_total > 0:
            us += e.device_time_total
            n += e.count
    return us / n if n else float("nan")


def bound_ms(b: int, k: int, ids: bool = False) -> tuple[float, str]:
    """B5's bound on (b, k) logits in ms, and what sets it: the larger of
    the bytes (the logits read once, the (b,) int64 result written once
    and, with ``ids``, one int64 id a row read) over 3.35 TB/s and
    OPS_PER_COLUMN operations a column over the f32 peak of 67 TFLOP/s.
    The operations part is a lower bound (see OPS_PER_COLUMN), so
    "bytes" names the larger of two lower bounds, not the limiter."""
    mem = (b * k * 4 + b * 8 * (2 if ids else 1)) / HBM_BYTES_PER_S * 1e3
    ops = b * k * OPS_PER_COLUMN / F32_OPS_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def dense_scores(path: str | None) -> np.ndarray:
    """chip_smoke.py phase 6's (512, 131,072) scores, from the host."""
    if path and os.path.exists(path):
        return np.load(path)
    from bm25_tpu_torch import ReferenceEngine
    from bm25_tpu_torch.bench import (BenchConfig, make_queries,
                                      make_synthetic_index)

    cfg = BenchConfig(num_docs=131072)
    index = make_synthetic_index(cfg)
    ref = ReferenceEngine.from_scored_index(index)
    queries = make_queries(cfg)[: cfg.batch]
    scores = np.stack([ref.get_scores(q) for q in queries])
    if path:
        np.save(path, scores)
    return scores


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--scores", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("b5_times: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    tk = importlib.import_module("bm25_tpu_torch.ops.topk")
    if not tk.__file__.startswith(repo):
        raise RuntimeError(f"imported {tk.__file__}, not from {repo}")
    dev = torch.device("cuda")
    out = {"repo": repo, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    # the host work a launch wrapper may do, each alone

    def device_context():
        with torch.cuda.device(dev):
            pass

    out["host_parts_us"] = {
        "torch_empty": host_us(lambda: torch.empty(
            (512,), dtype=torch.int64, device=dev), 2000),
        "current_stream_object": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream, 2000),
        "raw_stream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev.index or 0),
            2000),
        "device_context": host_us(device_context, 2000)}
    plans = {}
    if hasattr(tk, "ChoicePlan"):
        plans = {"warp": tk.WARP_PLAN,
                 **{f"block{t}": tk.ChoicePlan("block", t, 1)
                    for t in (256, 512, 1024)},
                 **{f"cluster{c}x{t}": tk.ChoicePlan("cluster", t, c)
                    for c in (2, 4, 8) for t in (256, 512, 1024)}}
    rng = np.random.default_rng(0)
    for b, k in SHAPES:
        logits = torch.from_numpy(rng.standard_normal((b, k)).astype(
            np.float32)).to(dev)

        def call():
            return tk.gumbel_choice(logits, SEED)

        rec = {"device_us": device_us(call),
               "cuda_ms": cuda_ms(call, 200),
               "host_us": host_us(call, 200),
               "bound_ms": bound_ms(b, k)}
        if plans:
            rec["plan"] = tk._device_plan(b, k, dev.index or 0).layout
            rec["layouts_device_us"] = {
                name: device_us(lambda: tk._gumbel_launch(
                    logits, SEED, plan=plan), 10)
                for name, plan in plans.items()}
        out[f"b5_{b}x{k}"] = rec
    masked = torch.from_numpy(dense_scores(args.scores)).to(dev)
    if hasattr(tk, "gumbel_sample"):
        seed = torch.tensor([SEED], dtype=torch.int64, device=dev)
        for k in (100, 1000):
            vals, idxs = tk.top_k(masked, k)

            def fused():
                return tk.gumbel_sample(vals, idxs, seed, 0.7)

            twin = tk.gumbel_sample_plain(vals.cpu(), idxs.cpu(), SEED, 0.7)
            out[f"fused_k{k}"] = {
                "cuda_ms": cuda_ms(fused, 200), "host_us": host_us(fused, 200),
                "rows_off_twin": int((fused().cpu() != twin).sum())}
    gen = torch.Generator(device=dev).manual_seed(0)
    for k in (100, 1000):
        times = []
        for _ in range(41):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tk.top_k_fused_sampling(masked, k, implementation="pallas",
                                    generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"sampling_k{k}_ms"] = statistics.median(times[1:])
        out[f"sampling_k{k}_ms_runs"] = [round(t, 4) for t in times[1:]]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
