"""Winning-group gather benchmark: the three TPU gather experiments as one
script for the port (kernels E5-E7 of ``ops/super_row_gather.py``).

Each experiment makes its inputs as its JAX script does, from
``np.random.default_rng(0)``, at the script's shape by default (Q = 512
queries over N = 262,144 docs cut into R = 2,048 super-rows of 128, K =
1,000 winning groups of 8 padded to KP = 1,024 rows):

* ``pallas_gather`` (``scripts/exp_r4_pallas_gather.py``): sorted groups
  drawn with replacement; the direct kernel at each rows-per-warp setting
  (the script's unroll sweep), then the script's consumer: the gather,
  the lane select of each winner's group of 8, and the two-key sort (score
  descending, doc ascending) as two stable sorts;
* ``window_gather`` (``exp_r4_window_gather.py``): distinct sorted groups;
  the window kernel at W = 32 and 48, with its fallback tiles counted;
* ``dyngather`` (``exp_r4_dyngather.py``): tables of H = 8, 32, 256 and
  2,048 rows per query; the direct kernel at every H and the resident
  kernel where the table fits the card's shared memory, so the sweep shows
  where they cross.

Every variant is checked bit for bit against the plain twin, and timed
beside the twin and the one-call library gather ``torch.gather``; each
result carries the bytes the gather must move for its ids (``bytes``).
Timing on the card is device time: CUDA events around ``iters``
back-to-back launches after one warm-up call, the mean per launch.  On the
CPU (plain twins only) the host clock times the calls, and each result
says which clock it used.

Run: ``python -m bm25_tpu_torch.bench.gather_bench --experiment
pallas_gather|window_gather|dyngather [--device cuda] [--q 512 --n 262144
--k 1000 --kp 1024 --iters N]``; it prints the JSON list of results.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from bm25_tpu_torch.bench.matmul_bench import _seconds
from bm25_tpu_torch.ops import super_row_gather as srg

GROUP = 8  # docs per group (BR in the scripts)
EXPERIMENTS = ("pallas_gather", "window_gather", "dyngather")
WINDOWS = (32, 48)
HEIGHTS = (8, 32, 256, 2048)


def make_inputs(experiment: str, q: int = 512, n: int = 262144,
                k: int = 1000, kp: int = 1024):
    """``(x3, rowof, tg)`` as numpy arrays, drawn as the experiment's
    script draws them: x3 (Q, N / 128, 128) f32, rowof (Q, KP) int32 and
    the sorted winning groups tg (Q, K) int32."""
    if n % srg.ROW or not 0 < k <= kp:
        raise ValueError(f"need N % {srg.ROW} == 0 and 0 < K <= KP, got "
                         f"N={n} K={k} KP={kp}")
    rng = np.random.default_rng(0)
    groups, r, per = n // GROUP, n // srg.ROW, srg.ROW // GROUP
    x3 = rng.random((q, n), dtype=np.float32).reshape(q, r, srg.ROW)
    rowof = np.zeros((q, kp), np.int32)
    if experiment == "pallas_gather":
        tg = np.sort(rng.integers(0, groups, (q, k), dtype=np.int32), axis=1)
        rowof[:, :k] = tg // per
    elif experiment == "window_gather":
        tg = np.sort(np.stack([rng.choice(groups, size=k, replace=False)
                               for _ in range(q)]), axis=1).astype(np.int32)
        rowof[:, :k] = tg // per
        rowof[:, k:] = rowof[:, k - 1 : k]
    else:
        raise ValueError(f"unknown experiment {experiment!r}")
    return x3, rowof, tg


def make_table_inputs(h: int, q: int = 512, kp: int = 1024, rng=None):
    """dyngather's (x3 (Q, H, 128) f32, rowof (Q, KP) int32) for one H,
    drawn from ``rng`` in the script's order."""
    rng = np.random.default_rng(0) if rng is None else rng
    x3 = rng.random((q, h, srg.ROW), dtype=np.float32)
    rowof = rng.integers(0, h, (q, 1, kp)).astype(np.int32)[:, 0]
    return x3, rowof


def gather_bytes(rowof: torch.Tensor) -> int:
    """Bytes the gather must move for these ids: the ids, each distinct
    (query, row) read once and the output written once."""
    q, kp = rowof.shape
    if rowof.numel() == 0:
        return 0
    key = rowof.long() + torch.arange(q, device=rowof.device)[:, None] * (
        int(rowof.max()) + 1)
    return rowof.numel() * 4 + (torch.unique(key).numel() + q * kp) * (
        srg.ROW * 4)


def select_and_sort(rows: torch.Tensor, tg: torch.Tensor):
    """The consumer of ``exp_r4_pallas_gather.py:130-143``: from each
    winner's gathered super-row (Q, >= K, 128) take its group of 8 (lane
    select), then order the (Q, K * 8) candidates by score descending, doc
    ascending, as two stable sorts.  Returns (scores, doc ids)."""
    q, k = tg.shape
    per = srg.ROW // GROUP
    tg = tg.long()
    rows4 = rows[:, :k].reshape(q, k, per, GROUP)
    sel = (tg % per)[:, :, None, None].expand(q, k, 1, GROUP)
    cand = rows4.gather(2, sel).reshape(q, k * GROUP)
    cand_idx = (tg[:, :, None] * GROUP
                + torch.arange(GROUP, device=tg.device)).reshape(q, k * GROUP)
    order = torch.argsort(cand_idx, dim=1, stable=True)
    cand, cand_idx = cand.gather(1, order), cand_idx.gather(1, order)
    order = torch.argsort(-cand, dim=1, stable=True)
    return cand.gather(1, order), cand_idx.gather(1, order)


def _variant(name: str, fn, x3: torch.Tensor, rowof: torch.Tensor,
             iters: int, clock: str, **extra) -> dict:
    """Check ``fn()`` against the twin bit for bit and time it."""
    want = srg.super_row_gather_plain(x3, rowof)
    if not torch.equal(fn(), want):
        raise AssertionError(f"{name}: gather differs from the plain twin")
    return {"variant": name, "ms": _seconds(fn, iters, x3.device) * 1e3,
            "clock": clock, **extra}


def _yardsticks(x3: torch.Tensor, rowof: torch.Tensor, iters: int,
                clock: str) -> list[dict]:
    q, kp = rowof.shape
    index = rowof.long()[:, :, None].expand(q, kp, srg.ROW)
    res = _variant("torch.gather", lambda: torch.gather(x3, 1, index), x3,
                   rowof, iters, clock)
    twin = {"variant": "plain", "ms": _seconds(
        lambda: srg.super_row_gather_plain(x3, rowof), max(iters // 5, 1),
        x3.device) * 1e3, "clock": clock}
    return [res, twin]


def bench_gather(experiment: str, device: torch.device | str = "cuda",
                 q: int = 512, n: int = 262144, k: int = 1000,
                 kp: int = 1024, iters: int | None = None,
                 log=print) -> list[dict]:
    """Run one experiment on ``device``; returns one dict per variant with
    its time in ms (``iters`` defaults to 20 launches on the card, 2 calls
    elsewhere) and the shape it ran at."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gather_bench: no CUDA device")
    if iters is None:
        iters = 20 if device.type == "cuda" else 2
    if iters < 1:
        raise ValueError(f"iters={iters} must be at least 1")
    clock = "cuda_events" if device.type == "cuda" else "host"
    results = []

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if experiment == "dyngather":
        rng = np.random.default_rng(0)
        for h in HEIGHTS:
            x3, rowof = map(put, make_table_inputs(h, q, kp, rng))
            shape = {"experiment": experiment, "q": q, "h": h, "kp": kp,
                     "bytes": gather_bytes(rowof)}
            rows = [_variant("direct", lambda: srg.super_row_gather(x3, rowof),
                             x3, rowof, iters, clock)]
            fits = device.type == "cpu" or h * srg.ROW * 4 <= \
                srg.smem_optin_bytes(device.index or 0)
            if fits:
                rows.append(_variant(
                    "resident", lambda: srg.super_row_gather_resident(x3,
                                                                      rowof),
                    x3, rowof, iters, clock))
            rows += _yardsticks(x3, rowof, iters, clock)
            for row in rows:
                results.append({**shape, **row})
                log(f"[gather {experiment} H={h}] {row['variant']}: "
                    f"{row['ms']:.4f} ms")
            if not fits:
                log(f"[gather {experiment} H={h}] resident: the table does "
                    "not fit the card's shared memory (ValueError)")
            del x3, rowof
        return results

    x3_np, rowof_np, tg_np = make_inputs(experiment, q, n, k, kp)
    x3, rowof, tg = put(x3_np), put(rowof_np), put(tg_np)
    del x3_np
    shape = {"experiment": experiment, "q": q, "r": x3.shape[1], "kp": kp,
             "k": k, "bytes": gather_bytes(rowof)}
    rows = []
    if experiment == "pallas_gather":
        for rpw in srg.ROWS_PER_WARP:
            rows.append(_variant(
                "direct", lambda rpw=rpw: srg.super_row_gather(x3, rowof, rpw),
                x3, rowof, iters, clock, rows_per_warp=rpw))
        want = select_and_sort(srg.super_row_gather_plain(x3, rowof), tg)
        full = lambda: select_and_sort(srg.super_row_gather(x3, rowof), tg)
        got = full()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("gather + select + sort differs from the "
                                 "plain twin's")
        rows.append({"variant": "gather + select + 2-key sort",
                     "ms": _seconds(full, iters, device) * 1e3,
                     "clock": clock})
    else:
        for w in WINDOWS:
            fb = torch.zeros(1, dtype=torch.int32, device=device)
            srg.super_row_gather_window(x3, rowof, w, fallbacks=fb)
            tiles = int(fb.item())
            if tiles != int(srg.window_fallback_tiles(rowof, x3.shape[1], w)):
                raise AssertionError(f"W={w}: fallback tiles miscounted")
            rows.append(_variant(
                "window",
                lambda w=w: srg.super_row_gather_window(x3, rowof, w),
                x3, rowof, iters, clock, window=w, fallback_tiles=tiles,
                tiles=q * kp // srg.WINDOW_TILE))
        rows.append(_variant("direct", lambda: srg.super_row_gather(x3, rowof),
                             x3, rowof, iters, clock, rows_per_warp=1))
    rows += _yardsticks(x3, rowof, iters, clock)
    for row in rows:
        results.append({**shape, **row})
        log(f"[gather {experiment}] {row['variant']}"
            + "".join(f" {key}={row[key]}" for key in
                      ("rows_per_warp", "window", "fallback_tiles")
                      if key in row)
            + f": {row['ms']:.4f} ms")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--experiment", choices=EXPERIMENTS, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--q", type=int, default=512)
    p.add_argument("--n", type=int, default=262144)
    p.add_argument("--k", type=int, default=1000)
    p.add_argument("--kp", type=int, default=1024)
    p.add_argument("--iters", type=int, default=None)
    args = p.parse_args(argv)
    results = bench_gather(args.experiment, args.device, args.q, args.n,
                           args.k, args.kp, args.iters,
                           log=lambda *a: print(*a, file=sys.stderr))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
