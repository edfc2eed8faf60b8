"""Time E6 (the window gather) and B1 (the sparse path's bucket scoring)
of one checkout of the port, on the card.

E6 at ``gather_bench``'s ``window_gather`` shape (Q = 512 queries, R =
2,048 super-rows, KP = 1,024 sorted ids, inputs from ``default_rng(0)``)
at W = 32 and 48, beside ``torch.gather``.  B1 on a bucket of the sparse
headline's shape, made here from ``default_rng(0)``: 262,144 doc rows of
L = 16 and of L = 40 slots (the two buckets ``chip_smoke.py`` logs), the
H = 1,024 hot rows as a bf16 pair, and the first Q = 512 and Q = 8
queries of ``make_queries(BenchConfig())``, whose ids below H count as
hot tokens (the synthetic vocabulary is ranked by frequency).  B1 is
timed with and without its hot tier: the difference is the hot
epilogue.  Where the wrapper takes a hot plan it is made once, outside
the timed calls, as the engine makes it once per chunk; its own time is
``plan``.  Back-to-back calls between CUDA events after one warm-up call.

``--repo`` names the checkout whose ``bm25_tpu_torch`` is imported, so
that two checkouts can be timed in turns on one card (parent, change,
change, parent), each in its own process.  Prints one JSON line, with the
card's name and power limit.

Run: ``python bm25_tpu_torch/bench/e6_b1_times.py [--repo DIR]``.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROWS = 262144
SLOTS = (16, 40)
HOT = 1024
QUERIES = (512, 8)


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


def b1_times(es, dev, rng, out: dict) -> None:
    from bm25_tpu_torch.bench import BenchConfig, make_queries
    from bm25_tpu_torch.utils.counts import split_bf16

    hot = torch.from_numpy(rng.standard_normal((HOT, ROWS), np.float32))
    hotT, hotLo = (x.to(dev) for x in split_bf16(hot))
    del hot
    did = torch.arange(ROWS, dtype=torch.int32, device=dev)
    queries = make_queries(BenchConfig())
    takes_plan = "plan" in inspect.signature(es.ell_score_fused).parameters
    for slots in SLOTS:
        tokT = rng.integers(HOT, 32768, (slots, ROWS)).astype(np.int32)
        tokT[rng.random((slots, ROWS)) < 0.3] = -1
        tokT = torch.from_numpy(tokT).to(dev)
        valT = torch.from_numpy(rng.random((slots, ROWS), np.float32)).to(dev)
        for q in QUERIES:
            ids = queries[:q]
            hc = np.zeros((q, HOT), np.float32)
            for i, row in enumerate(ids):
                np.add.at(hc[i], row[row < HOT], 1)
            ids = torch.from_numpy(ids).to(dev)
            hc = torch.from_numpy(hc).to(dev).bfloat16()
            kw = {}
            if takes_plan:
                kw["plan"] = es.hot_plan(hc)
                out[f"plan_q{q}"] = cuda_ms(lambda: es.hot_plan(hc), 20)
                out[f"used_q{q}"] = int(kw["plan"].n_used.item())
            args = (ids, tokT, valT, did)
            reps = 10 if q > 8 else 50
            full = cuda_ms(lambda: es.ell_score_fused(*args, hc, hotT, hotLo,
                                                      **kw), reps)
            scan = cuda_ms(lambda: es.ell_score_fused(*args), reps)
            key = f"L{slots}_q{q}"
            out[f"b1_{key}"] = full
            out[f"scan_{key}"] = scan
            out[f"hot_{key}"] = full - scan
        del tokT, valT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("e6_b1_times: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    es = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    srg = importlib.import_module("bm25_tpu_torch.ops.super_row_gather")
    gb = importlib.import_module("bm25_tpu_torch.bench.gather_bench")
    if not es.__file__.startswith(repo):
        raise RuntimeError(f"imported {es.__file__}, not from {repo}")
    dev = torch.device("cuda")
    out = {"repo": repo, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    x3, rowof, _ = gb.make_inputs("window_gather")
    x3, rowof = torch.from_numpy(x3).to(dev), torch.from_numpy(rowof).to(dev)
    for w in gb.WINDOWS:
        out[f"e6_w{w}"] = cuda_ms(
            lambda: srg.super_row_gather_window(x3, rowof, w), 50)
    index = rowof.long()[:, :, None].expand(*rowof.shape, srg.ROW)
    out["torch_gather"] = cuda_ms(lambda: torch.gather(x3, 1, index), 50)
    del x3, rowof, index
    b1_times(es, dev, np.random.default_rng(0), out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
