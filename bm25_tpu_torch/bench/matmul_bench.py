"""Matmul benchmark: GFLOPS and output elements per second per algorithm.

PyTorch counterpart of ``bm25_tpu/bench/matmul_bench.py``: the same
default problem (M = K = N = 1028, f32 inputs from
``np.random.default_rng(0)``), the same FLOP count ``M * N * (2K - 1)``
and the same result keys, over ``matmul``'s algorithms (``"xla"``:
``torch.matmul`` in full f32; ``"naive"`` and ``"optimized"``: kernel B6's
two CUDA kernels).

Timing on the card is device time: CUDA events around ``iters``
back-to-back launches on the current stream, after one warm-up call, and
the mean per launch.  The JAX harness chains its launches through a
``fori_loop`` and consumes every output with ``max()`` so that XLA cannot
drop or slice away the work, and it differences two chain lengths to
remove a host round trip of some 30 ms.  Eager PyTorch elides nothing and
events are recorded on the device's own stream, so neither is needed
here.  On the CPU (plain twins) the host clock times the calls instead.

Run: ``python -m bm25_tpu_torch.bench.matmul_bench [--m 1028 --k 1028
--n 1028 --iters N --device cuda]``; it prints the JSON list.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from bm25_tpu_torch.ops.matmul import matmul


def _seconds(fn, iters: int, device: torch.device) -> float:
    """Mean seconds per call of ``fn`` over ``iters`` calls, after one."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def bench_matmul(m: int = 1028, k: int = 1028, n: int = 1028,
                 iters: int | None = None,
                 algorithms=("xla", "naive", "optimized"), log=print,
                 device: torch.device | str = "cuda") -> list[dict]:
    """Benchmark the matmul algorithms at the reference's problem size
    on ``device``; ``iters`` defaults to 50 launches on the card and 2
    calls elsewhere (the plain twin is a loop over K)."""
    device = torch.device(device)
    if iters is None:
        iters = 50 if device.type == "cuda" else 2
    if iters < 1:
        raise ValueError(f"iters={iters} must be at least 1")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.random((m, k), dtype=np.float32)).to(device)
    b = torch.from_numpy(rng.random((k, n), dtype=np.float32)).to(device)
    flops = m * n * (2 * k - 1)
    elements = m * n

    results = []
    for algo in algorithms:
        dt = _seconds(lambda: matmul(a, b, algorithm=algo), iters, device)
        res = {
            "algorithm": algo,
            "seconds": dt,
            "gflops": flops / dt / 1e9,
            "melements_per_sec": elements / dt / 1e6,
        }
        results.append(res)
        log(f"[matmul {m}x{k}x{n}] {algo}: {dt * 1e3:.4f} ms  "
            f"{res['gflops']:.1f} GFLOPS")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--m", type=int, default=1028)
    p.add_argument("--k", type=int, default=1028)
    p.add_argument("--n", type=int, default=1028)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    results = bench_matmul(args.m, args.k, args.n, iters=args.iters,
                           device=args.device,
                           log=lambda *a: print(*a, file=sys.stderr))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
