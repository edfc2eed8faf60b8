"""Time B6's optimized matmul of one checkout of the port, on the card.

Back-to-back wrapper calls between CUDA events, after one warm-up call:
``matmul(a, b)`` ("optimized") in f32 at 1028^3, 2048^3 and 4096^3 and in
bf16 at 1028^3 (operand staging included), ``torch.matmul`` in full f32
beside each, and E1's ``matmul_sweep`` at 128 x 128 x 16 at 1028^3 and
4096^3 (the same ring header).
``--repo`` names the checkout whose ``bm25_tpu_torch`` is imported, so that
two checkouts can be timed in turns on one card (parent, change, change,
parent), each in its own process.  Prints one JSON line, with the card's
name and power limit.

Run: ``python bm25_tpu_torch/bench/b6_times.py [--repo DIR]``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

SIZES = (1028, 2048, 4096)
REPS = {1028: 50, 2048: 20, 4096: 10}


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("b6_times: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    pm = importlib.import_module("bm25_tpu_torch.ops.matmul")
    ms = importlib.import_module("bm25_tpu_torch.ops.matmul_schedules")
    if not pm.__file__.startswith(repo):
        raise RuntimeError(f"imported {pm.__file__}, not from {repo}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"repo": repo, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    for s in SIZES:
        a, b = (torch.from_numpy(rng.standard_normal((s, s), dtype=np.float32))
                .to(dev) for _ in range(2))
        out[f"b6_f32_{s}"] = cuda_ms(lambda: pm.matmul(a, b), REPS[s])
        out[f"torch_matmul_{s}"] = cuda_ms(lambda: torch.matmul(a, b),
                                           REPS[s])
        if s != 2048:
            out[f"e1_128x128x16_{s}"] = cuda_ms(
                lambda: ms.matmul_sweep(a, b, (128, 128, 16)), REPS[s])
        if s == 1028:
            a16, b16 = a.bfloat16(), b.bfloat16()
            out["b6_bf16_1028"] = cuda_ms(lambda: pm.matmul(a16, b16),
                                          REPS[s])
        del a, b
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
