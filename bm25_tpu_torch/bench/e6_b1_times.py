"""Time E6 (the window gather), B1 (the sparse path's bucket scoring)
and B2 (the engine build's hot tier) of one checkout of the port, on the
card.

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
``plan``.  The same for the scan's lookup tables (``scan_table``, once a
chunk; its time is ``table``) where the checkout has them.  ``fan_`` is
the scan at Q = 512 with every query's cold ids replaced by one shared
run of cold tokens (each match then adds to every query).  B2 at the
engine build's shape: the H = 1,024 hot ids as one-token queries over a
hot ELL of 262,144 rows and L = 48 slots of distinct hot ids (a random
fill of 24-48 a row).  ``--ablate`` also times the scan at Q = 512
with parts of its work taken away (``ablations``).  Back-to-back calls
between CUDA events after one warm-up call.

``--repo`` names the checkout whose ``bm25_tpu_torch`` is imported, so
that two checkouts can be timed in turns on one card (parent, change,
change, parent), each in its own process.  Prints one JSON line, with the
card's name and power limit.

Run: ``python bm25_tpu_torch/bench/e6_b1_times.py [--repo DIR] [--ablate]
[--no-e6]``.
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
HOT_SLOTS = 48


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


def b2_times(es, dev, rng, out: dict) -> None:
    fill = rng.integers(HOT_SLOTS // 2, HOT_SLOTS + 1, ROWS)
    start = rng.integers(0, HOT, ROWS)
    stride = 2 * rng.integers(0, HOT // 2, ROWS) + 1  # odd: distinct ids
    slot = np.arange(HOT_SLOTS)[:, None]
    tokT = ((start + slot * stride) % HOT).astype(np.int32)
    tokT[slot >= fill] = -1
    valT = rng.random((HOT_SLOTS, ROWS), np.float32)
    valT[tokT < 0] = 0.0
    args = (torch.arange(HOT, dtype=torch.int32, device=dev).reshape(-1, 1),
            torch.from_numpy(tokT).to(dev), torch.from_numpy(valT).to(dev))
    out["b2_slots_filled"] = int(fill.sum())
    kw = {"table": es.scan_table(args[0])} if hasattr(
        es, "scan_table") else {}
    out["b2_h1024"] = cuda_ms(lambda: es.ell_score(*args, **kw), 10)


def ablations(es, ids, tokT, valT, did, out: dict, key: str) -> None:
    """The scan at Q = 512 with parts of its work taken away: no slots
    (the write-out, pad mask and maxima alone), every slot a pad (the
    token loads, no lookups), ids that match nothing (every lookup a
    miss), B2's entry (no mask or maxima), and ``zero_()`` of a (Q, rows)
    tensor, the card's rate for the same bytes written."""
    table = es.scan_table(ids)
    pads = torch.full_like(tokT, -1)
    none = torch.full_like(ids, 40000)
    t_none = es.scan_table(none)
    out[f"abl_{key}_no_slots"] = cuda_ms(
        lambda: es.ell_score_fused(ids, None, None, did, table=table), 10)
    out[f"abl_{key}_all_pads"] = cuda_ms(
        lambda: es.ell_score_fused(ids, pads, valT, did, table=table), 10)
    out[f"abl_{key}_no_match"] = cuda_ms(
        lambda: es.ell_score_fused(none, tokT, valT, did, table=t_none), 10)
    out[f"abl_{key}_b2_entry"] = cuda_ms(
        lambda: es.ell_score(ids, tokT, valT, table=table), 10)
    out[f"abl_{key}_b2_entry_no_slots"] = cuda_ms(
        lambda: es.ell_score(ids, tokT[:0], valT[:0], table=table), 10)
    out[f"abl_{key}_b2_entry_all_pads"] = cuda_ms(
        lambda: es.ell_score(ids, pads, valT, table=table), 10)
    # the same tables' load (ids moved past the bucket's tokens), no hits
    moved = torch.where(ids >= 0, ids + 40000, ids)
    t_moved = es.scan_table(moved)
    out[f"abl_{key}_no_hit_same_load"] = cuda_ms(
        lambda: es.ell_score_fused(moved, tokT, valT, did, table=t_moved), 10)
    buf = torch.empty((ids.shape[0], tokT.shape[1]), device=tokT.device)
    out[f"abl_{key}_zero_fill"] = cuda_ms(lambda: buf.zero_(), 10)


def b1_times(es, dev, rng, out: dict, ablate: bool) -> None:
    from bm25_tpu_torch.bench import BenchConfig, make_queries
    from bm25_tpu_torch.utils.counts import split_bf16

    hot = torch.from_numpy(rng.standard_normal((HOT, ROWS), np.float32))
    hotT, hotLo = (x.to(dev) for x in split_bf16(hot))
    del hot
    did = torch.arange(ROWS, dtype=torch.int32, device=dev)
    queries = make_queries(BenchConfig())
    takes_plan = "plan" in inspect.signature(es.ell_score_fused).parameters
    takes_table = hasattr(es, "scan_table")
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
            kw, skw = {}, {}
            if takes_plan:
                kw["plan"] = es.hot_plan(hc)
                out[f"plan_q{q}"] = cuda_ms(lambda: es.hot_plan(hc), 20)
                out[f"listed_q{q}"] = int(kw["plan"].n_used.item())
            if takes_table:
                skw["table"] = es.scan_table(ids)
                out[f"table_q{q}"] = cuda_ms(lambda: es.scan_table(ids), 20)
            args = (ids, tokT, valT, did)
            reps = 10 if q > 8 else 50
            full = cuda_ms(lambda: es.ell_score_fused(*args, hc, hotT, hotLo,
                                                      **kw, **skw), reps)
            key = f"L{slots}_q{q}"
            out[f"scan_{key}"] = cuda_ms(
                lambda: es.ell_score_fused(*args, **skw), reps)
            out[f"b1_{key}"] = full
            out[f"hot_{key}"] = full - out[f"scan_{key}"]
            # the scan as B1 launches it before its hot kernel (no mask, no
            # maxima): B2's entry runs that kernel
            out[f"unmasked_{key}"] = cuda_ms(
                lambda: es.ell_score(ids, tokT, valT, **skw), reps)
            # the hot kernel alone (no slots: no scan, the sums start at 0)
            out[f"hot_only_{key}"] = cuda_ms(
                lambda: es.ell_score_fused(ids, None, None, did, hc, hotT,
                                           hotLo, **kw), reps)
        # fan-out: every query's cold ids become one shared run of cold
        # tokens
        ids = queries[:QUERIES[0]].copy()
        shared = HOT + 7 + 97 * np.arange(ids.shape[1])
        cold = ids >= HOT
        ids[cold] = np.broadcast_to(shared, ids.shape)[cold]
        # matching (query, posting) pairs: each query's distinct cold ids
        # times their postings in the bucket
        postings = {int(s): int((tokT == int(s)).sum()) for s in shared}
        out[f"fan_L{slots}_pairs"] = sum(
            postings[s] for row in ids for s in set(row[row >= HOT].tolist()))
        ids = torch.from_numpy(ids).to(dev)
        skw = {"table": es.scan_table(ids)} if takes_table else {}
        out[f"fan_L{slots}"] = cuda_ms(
            lambda: es.ell_score_fused(ids, tokT, valT, did, **skw), 10)
        if ablate and takes_table:
            ablations(es, torch.from_numpy(queries[:QUERIES[0]]).to(dev),
                      tokT, valT, did, out, f"L{slots}")
        del tokT, valT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--ablate", action="store_true",
                   help="also time the scan with parts of its work removed")
    p.add_argument("--no-e6", action="store_true", help="skip E6")
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
    if not args.no_e6:
        x3, rowof, _ = gb.make_inputs("window_gather")
        x3 = torch.from_numpy(x3).to(dev)
        rowof = torch.from_numpy(rowof).to(dev)
        for w in gb.WINDOWS:
            out[f"e6_w{w}"] = cuda_ms(
                lambda: srg.super_row_gather_window(x3, rowof, w), 50)
        index = rowof.long()[:, :, None].expand(*rowof.shape, srg.ROW)
        out["torch_gather"] = cuda_ms(lambda: torch.gather(x3, 1, index), 50)
        del x3, rowof, index
    b1_times(es, dev, np.random.default_rng(0), out, args.ablate)
    b2_times(es, dev, np.random.default_rng(1), out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
