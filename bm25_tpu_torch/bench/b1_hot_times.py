"""Time B1's hot epilogue on the sparse headline's engine, for one
checkout of the port, on the card.

The engine is ``chip_smoke.py`` phase 4's: ``make_synthetic_index`` at
the default ``BenchConfig`` (524,288 docs, a 32,768-token Zipf
vocabulary), ``hot_tokens=1024`` and 2 buckets.  The queries are the
batch's unrouted chunk (``make_queries``' first 512 x 8, planned with
``route_cold=False``), and chunks of 16 and of 8 of its rows (starting at
rows 0, 128, 256 and 384).  For each chunk the hot plan and the scan's
tables are made once, as the query step makes them, and B1 runs on every
bucket: its hot kernel (``ell_hot_kernel``) is timed by ``torch.profiler``
as phase 4 times it (the mean device ms a launch over the launches
recorded in 10 calls, summed over the buckets), B1 as a whole by CUDA
events (back-to-back calls after one warm-up call).  ``listed`` is the
plan's ``n_used`` (the hot ranks the kernel's K runs over), ``used`` the
hot tokens some query of the chunk counts.

``--repo`` names the checkout whose ``bm25_tpu_torch`` is imported, so
that two checkouts can be timed in turns on one card (parent, change,
change, parent), each in its own process.  Prints one JSON line, with the
card's name and power limit.

Run: ``python bm25_tpu_torch/bench/b1_hot_times.py [--repo DIR]``.
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

HOT_TOKENS = 1024
MAX_BUCKETS = 2
CHUNKS = ((512, (0,)), (16, (0, 128, 256, 384)), (8, (0, 128, 256, 384)))
CALLS = 10


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


def hot_kernel_ms(fn, tries: int = 4) -> float:
    """Device ms a launch of ``ell_hot_kernel`` over ``CALLS`` calls of
    ``fn()`` (``torch.profiler``; the tracer is switched on a call early
    and its first recorded launch is a short sleep, since it can miss the
    first launches of a window; a window that records none is taken
    again)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            prof.step()
        us = n = 0
        for e in prof.key_averages():
            name = e.key.replace("(anonymous namespace)::", "")
            if "ell_hot_kernel" in name and e.device_time_total > 0:
                us += e.device_time_total
                n += e.count
        if n:
            return us / n / 1e3
    raise RuntimeError("torch.profiler recorded no ell_hot_kernel")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("b1_hot_times: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    es = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    if not es.__file__.startswith(repo):
        raise RuntimeError(f"imported {es.__file__}, not from {repo}")
    from bm25_tpu_torch import Session, SparseEngine
    from bm25_tpu_torch.bench import (BenchConfig, make_queries,
                                      make_synthetic_index)
    from bm25_tpu_torch.models.sparse import hot_counts_for

    out = {"repo": repo, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    cfg = BenchConfig()
    index = make_synthetic_index(cfg)
    session = Session("cuda")
    engine = SparseEngine.from_scored_index(
        index, session=session, hot_tokens=HOT_TOKENS,
        hot_budget_bytes=HOT_TOKENS * index.num_docs * 4,
        max_buckets=MAX_BUCKETS)
    del index
    engine.route_cold = False
    queries = make_queries(cfg)[: cfg.batch]
    chunk = session.put(engine.plan_chunks(queries)[1][0].padded)
    for q, starts in CHUNKS:
        hot, b1, listed, used = [], [], [], []
        for s in starts:
            ids = chunk[s : s + q].contiguous()
            hc, _ = hot_counts_for(ids, engine.hot_table, engine.hot_h)
            plan, table = es.hot_plan(hc), es.scan_table(ids)
            listed.append(int(plan.n_used.item()))
            used.append(int((hc != 0).any(dim=0).sum()))
            h_ms = b_ms = 0.0
            for b in engine.buckets:
                def call(b=b):
                    return es.ell_score_fused(
                        ids, b["tokT"], b["valT"], b["doc_ids"], hc,
                        b["hotT"], b["hotLo"], plan=plan, table=table)

                h_ms += hot_kernel_ms(call)
                b_ms += cuda_ms(call, 10 if q > 16 else 50)
            hot.append(h_ms)
            b1.append(b_ms)
        out[f"q{q}"] = {"hot_ms": hot, "hot_ms_mean": float(np.mean(hot)),
                        "b1_ms": b1, "listed": listed, "used": used}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
