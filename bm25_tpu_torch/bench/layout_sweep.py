"""Sweep the sparse engine's layouts on the card, and fit the layout cost
model (``models.sparse.H100Costs``) to the times.

``--sweep`` builds ``SparseEngine`` on the query benchmark's corpus
(``BenchConfig()``: 524,288 docs, vocabulary 32,768, 21,165,472
postings; ``--corpus longdoc``: the harness's 65,536-doc long-document
corpus) at every hot-tier width h of ``--heights`` and bucket count of
``--buckets``, and for each layout writes one JSON line to ``--out``: the
modelled and the built ELL slot count, the padded rows, then at k=1000
and k=100 on the first 512 x 8 queries of ``make_queries``: B1's scan,
hot kernel and scan tables, device ms a batch (``torch.profiler``
kernel sums over 5 steps, a primer launch first, the window profiled
again where launches are missing), the rest of the step's kernels
(selection and merge: ``other_ms``), the whole device step
(``query_bench.measure_device_step_ms`` over ``--iters`` steps, CUDA
events) and the model's
own terms at the current constants.  ``--sel-grid`` adds the tree
selection alone (``top_k_tree_with_maxes`` on its group maxima, as the
step runs it) on random (512, rows) bases at rows from 65,536 to
2,228,224 and k of 100 and 1000, CUDA events: the model's selection
grid.  Each line carries the card's name and power limit.

``--check FILE [FILE ...]`` prints the same report at the constants
``H100Costs`` holds, with no refit: a sweep the constants were not fitted
on checks them.  ``--fit FILE [FILE ...]`` (host only) reads such lines
and prints the
least-squares constants of ``H100Costs`` (the scan a slot and table and a
row and block; the hot kernel a row and block and a hot token, row and
block), the grid (the mean of its runs), and a table of every layout's
measured against modelled ms with the fit's error (B1 against the scan
and hot terms; the rest of the device step against the selection term),
and, per corpus and k, the layout the model picks beside the fastest
measured one.

Run on the card: ``python -m bm25_tpu_torch.bench.layout_sweep --sweep
--sel-grid --out sweep.jsonl``; then on any host: ``python -m
bm25_tpu_torch.bench.layout_sweep --fit sweep.jsonl``.  The sweep's
engines do not route (``route_cold=False``): the layout model prices
unrouted batches.

``--route-sweep`` times routed steps for the cold-width routing's chunk
DP (``models.sparse._chunk_bounds_dp``): ``SparseEngine`` on the corpus
at ``--route-h`` hot tokens and 2 buckets, one chunk at each height of
``ROUTE_HEIGHTS`` (32-512) and cold width of ``ROUTE_COLD`` (2-64), at
k=1000 and 100 (the device step over ``--iters`` steps, CUDA events, as
the harness times it).  Each row's ids are drawn from the benchmark's
Zipf query distribution until it holds that many cold ids, so the full
ids carry the hot ids such a query has.  ``--fit-route FILE [FILE
...]`` (host only) fits ``ms = u * (rows * (c0_k + 2 T + 2) + fixed)``
by least squares (one u and one fixed, a c0 a k) and prints
``CHUNK_C0_UNITS`` and ``CHUNK_FIXED_UNITS`` in the DP's scan units, each
file's own fit beside the joint one (run the sweep twice, into two
files, to see the constants hold from pass to pass), and the measured
against modelled grid.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

HEIGHTS = (0, 64, 128, 256, 512, 1024, 2048)
BUCKETS = (2, 3, 4, 6, 8)
KS = (1000, 100)
SEL_ROWS = (8192, 16384, 32768, 65536, 131072, 262144, 524288, 1048576,
            2228224)
SEL_Q = 512
PRIMER = "spin_kernel"  # the kernel of torch.cuda._sleep
B1_KERNELS = {"scan": "ell_scan_kernel", "hot": "ell_hot_kernel",
              "table": "ell_table_kernel"}
ROUTE_HEIGHTS = (32, 64, 128, 256, 512)
ROUTE_COLD = (2, 4, 8, 16, 32, 64)


def card(session) -> str:
    if session.device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _window(fn, calls: int) -> dict:
    """{kernel name: (device us, launches)} over ``calls`` calls of
    ``fn()``: the tracer is prepared a call early and its first recorded
    launch is a primer no reading counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

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
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    out = {}
    for e in prof.events():
        # the kernels alone: an operator's event also carries the device
        # time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0]
        if not name.startswith(PRIMER):
            us, n = out.get(name, (0.0, 0))
            out[name] = (us + e.time_range.elapsed_us(), n + 1)
    return out


def kernel_ms(fn, calls: int, expect: dict, tries: int = 4) -> dict:
    """Device ms a call of ``fn()``, per kernel name, from the fullest of
    up to ``tries`` profiler windows; a window is full when every kernel
    of ``expect`` (name prefix -> launches a call) has all its launches."""
    if not torch.cuda.is_available():
        fn()
        return {}
    best, best_n = {}, -1
    for _ in range(tries):
        got = _window(fn, calls)
        n = sum(c for _, c in got.values())
        if n > best_n:
            best, best_n = got, n
        if all(sum(c for name, (_, c) in got.items() if name.startswith(p))
               >= calls * want for p, want in expect.items()):
            break
    return {name: us / calls / 1e3 for name, (us, _) in best.items()}


def _corpus(name: str):
    from bm25_tpu_torch.bench.query_bench import (BenchConfig,
                                                  make_longdoc_index,
                                                  make_queries,
                                                  make_synthetic_index)

    cfg = BenchConfig.from_env()  # BM25_BENCH_<FIELD> shrinks it
    index = (make_longdoc_index(cfg) if name == "longdoc"
             else make_synthetic_index(cfg))
    return cfg, index, make_queries(cfg)[: cfg.batch]


def _cold_nnz(index, h: int) -> np.ndarray:
    """Each doc's postings outside the top-h tokens by DF."""
    df = index.df()
    hot = np.argsort(-df, kind="stable")[:h]
    is_hot = np.zeros(index.vocab_size, bool)
    is_hot[hot] = True
    doc_nnz = np.bincount(index.indices, minlength=index.num_docs)
    tok_of = np.repeat(np.arange(index.vocab_size), np.diff(index.indptr))
    hot_nnz = np.bincount(index.indices[is_hot[tok_of]],
                          minlength=index.num_docs)
    return (doc_nnz - hot_nnz).astype(np.int64)


def sweep(args, session, out) -> None:
    from bm25_tpu_torch.bench.query_bench import measure_device_step_ms
    from bm25_tpu_torch.models import sparse as ms

    smi = card(session)
    cfg, index, queries = _corpus(args.corpus)
    d = index.num_docs
    for h in args.heights:
        cold = _cold_nnz(index, h)
        for mb in args.buckets:
            t0 = time.perf_counter()
            engine = ms.SparseEngine.from_scored_index(
                index, session=session, hot_tokens=h,
                hot_budget_bytes=max(h, 1) * d * 4, max_buckets=mb)
            if session.device.type == "cuda":
                torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            slots = sum(b["tokT"].numel() for b in engine.buckets
                        if "tokT" in b)
            rows_pad = sum(b["doc_ids"].shape[0] for b in engine.buckets)
            row = {"corpus": args.corpus, "num_docs": d, "h": engine.hot_h,
                   "max_buckets": mb, "buckets": len(engine.buckets),
                   "slots": slots,
                   "slots_model": ms._ell_slot_estimate(
                       cold, mb, ms.BLOCK_ROWS),
                   "rows_pad": rows_pad,
                   "rows_pad_model": (ms.next_multiple(d, ms.BLOCK_ROWS)
                                      + mb * ms.BLOCK_ROWS),
                   "widths": [b["tokT"].shape[0] for b in engine.buckets
                              if "tokT" in b],
                   "build_s": round(build_s, 2), "q": len(queries),
                   "t": queries.shape[1], "card": smi}
            engine.route_cold = False  # the model prices unrouted batches
            plan = engine.plan_chunks(queries)[1]
            for k in args.ks:
                step = ms.make_sparse_query_step(k, engine.hot_h)
                chunks = [session.put(c.padded) for c in plan]

                def call():
                    for ids in chunks:
                        step(ids, engine.buckets, engine.offsets,
                             engine.hot_table, tail=engine._tail)

                expect = {B1_KERNELS["scan"]: len(chunks) * len(
                    [b for b in engine.buckets if "tokT" in b])}
                if engine.hot_h:
                    expect[B1_KERNELS["hot"]] = len(chunks) * len(
                        engine.buckets)
                per = kernel_ms(call, 5, expect)
                b1 = {part: sum(v for n, v in per.items()
                                if n.startswith(prefix))
                      for part, prefix in B1_KERNELS.items()}
                busy = sum(per.values())
                step_ms = measure_device_step_ms(engine, queries, k,
                                                 iters=args.iters,
                                                 batch=len(queries))
                row[f"k{k}"] = {
                    "scan_ms": b1["scan"], "hot_ms": b1["hot"],
                    "table_ms": b1["table"],
                    "other_ms": busy - sum(b1.values()),
                    "busy_ms": busy, "step_ms": step_ms,
                    "model_scan_hot_ms": 1e3 * ms.LAYOUT_COSTS.
                    scan_hot_seconds(row["slots_model"], engine.hot_h,
                                     row["rows_pad_model"], len(queries),
                                     max(queries.shape[1], 8)),
                    "model_sel_ms": 1e3 * mb * ms.LAYOUT_COSTS.
                    selection_us_per_query(
                        k, ms.next_multiple(max(d // mb, 1),
                                            ms.BLOCK_ROWS))
                    * len(queries) * 1e-6,
                }
            print(json.dumps(row), file=out, flush=True)
            print(f"[sweep] {args.corpus} h={engine.hot_h} B={mb}: "
                  + json.dumps({k: row[f"k{k}"]["step_ms"]
                                for k in args.ks}), file=sys.stderr,
                  flush=True)
            del engine, chunks
            gc.collect()
            if session.device.type == "cuda":
                torch.cuda.empty_cache()


def sel_grid(args, session, out) -> None:
    """The tree selection alone on random (512, rows) bases."""
    from bm25_tpu_torch.ops.ell_score import GROUP
    from bm25_tpu_torch.ops.topk import top_k_tree_with_maxes

    smi = card(session)
    gen = torch.Generator(device=session.device).manual_seed(0)
    for rows in SEL_ROWS:
        base = torch.rand((SEL_Q, rows), generator=gen,
                          device=session.device)
        gmax = base.view(SEL_Q, rows // GROUP, GROUP).amax(dim=-1)
        for k in KS:
            def call():
                top_k_tree_with_maxes(base, gmax, k, branch=GROUP)

            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            end.synchronize()
            ms_ = start.elapsed_time(end) / 10
            print(json.dumps({"sel_grid": True, "rows": rows, "k": k,
                              "q": SEL_Q, "ms": ms_,
                              "us_per_query": ms_ * 1e3 / SEL_Q,
                              "card": smi}), file=out, flush=True)
        del base, gmax
        torch.cuda.empty_cache()


def routed_rows(index, hot_table: np.ndarray, q: int, t_cold: int,
                seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(q, T) full ids and (q, t_cold) cold ids: each row drawn from the
    benchmark's Zipf query distribution until it holds ``t_cold`` cold
    ids (or 512 ids), the full row every id drawn."""
    from bm25_tpu_torch.bench.query_bench import _zipf_probs

    rng = np.random.default_rng(seed)
    cum = np.cumsum(_zipf_probs(index.vocab_size))
    rows, colds = [], []
    for _ in range(q):
        drawn = np.clip(np.searchsorted(cum, rng.random(512)), 0,
                        index.vocab_size - 1).astype(np.int32)
        cold = np.flatnonzero(hot_table[drawn] < 0)
        end = cold[t_cold - 1] + 1 if len(cold) >= t_cold else len(drawn)
        rows.append(drawn[:end])
        colds.append(drawn[cold[cold < end]])
    t = max(len(r) for r in rows)
    full = np.full((q, t), -1, np.int32)
    cold_ids = np.full((q, t_cold), -1, np.int32)
    for i, (r, c) in enumerate(zip(rows, colds)):
        full[i, : len(r)] = r
        cold_ids[i, : len(c)] = c
    return full, cold_ids


def route_sweep(args, session, out) -> None:
    """Routed steps at every chunk height and cold width (module
    docstring)."""
    from bm25_tpu_torch.bench.query_bench import _time_step_chunk
    from bm25_tpu_torch.models import sparse as ms
    from bm25_tpu_torch.utils.padding import next_pow2_at_least

    smi = card(session)
    _cfg, index, _queries = _corpus(args.corpus)
    h = args.route_h
    engine = ms.SparseEngine.from_scored_index(
        index, session=session, hot_tokens=h,
        hot_budget_bytes=max(h, 1) * index.num_docs * 4, max_buckets=2)
    hot = engine.hot_table_host
    for t_cold in ROUTE_COLD:
        full, cold = routed_rows(index, hot, max(ROUTE_HEIGHTS), t_cold,
                                 seed=t_cold)
        width = next_pow2_at_least(max(full.shape[1], 8))
        full = np.pad(full, ((0, 0), (0, width - full.shape[1])),
                      constant_values=-1)
        for q in ROUTE_HEIGHTS:
            ids, cold_ids = session.put(full[:q]), session.put(cold[:q])
            for k in args.ks:
                step = engine.query_step(k)
                step_ms = _time_step_chunk(engine, step, ids, args.iters,
                                           cold_ids)
                rec = {"route": True, "corpus": args.corpus,
                       "num_docs": index.num_docs, "h": engine.hot_h,
                       "buckets": len(engine.buckets), "height": q,
                       "cold_width": t_cold, "full_width": width, "k": k,
                       "ms": step_ms, "card": smi}
                print(json.dumps(rec), file=out, flush=True)
                print(f"[route] q={q} T_c={t_cold} k={k}: {step_ms:.4f} ms",
                      file=sys.stderr, flush=True)


def _route_lines(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f
                if line.startswith("{") and '"route": true' in line]


def fit_route(files: list[str]) -> dict:
    """The DP's costs from ``--route-sweep`` lines (module docstring):
    ``{"CHUNK_C0_UNITS": {k: c0}, "CHUNK_FIXED_UNITS": f, "unit_ms": u,
    "rows": [...], "cards": [...]}``, every file's readings fitted at
    once."""
    recs = [r for path in files for r in _route_lines(path)]
    ks = sorted({r["k"] for r in recs})
    # ms = a * rows (2 T + 2) + sum_k b_k rows [k] + c
    cols = [np.array([r["height"] * (2 * r["cold_width"] + 2)
                      for r in recs], float)]
    cols += [np.array([r["height"] * (r["k"] == k) for r in recs], float)
             for k in ks]
    cols.append(np.ones(len(recs)))
    x, *_ = np.linalg.lstsq(np.stack(cols, axis=1),
                            np.array([r["ms"] for r in recs]), rcond=None)
    unit = float(x[0])
    return {"CHUNK_C0_UNITS": {k: float(x[1 + i] / unit)
                               for i, k in enumerate(ks)},
            "CHUNK_FIXED_UNITS": float(x[-1] / unit), "unit_ms": unit,
            "rows": recs, "cards": sorted({r["card"] for r in recs})}


def _route_constants(fitted: dict) -> str:
    return json.dumps({k: fitted[k] for k in (
        "CHUNK_C0_UNITS", "CHUNK_FIXED_UNITS", "unit_ms")})


def report_route(files: list[str]) -> None:
    """Each file's fit alone (how stable the constants are from pass to
    pass), the fit of all of them, and a grid a k: each chunk height and
    cold width's readings, one a file, over the joint fit's model ms."""
    fitted = fit_route(files)
    print(f"cards: {fitted['cards']}")
    if len(files) > 1:
        for path in files:
            print(f"{path} alone: {_route_constants(fit_route([path]))}")
    print(f"all: {_route_constants(fitted)}")
    u, c0, fixed = (fitted["unit_ms"], fitted["CHUNK_C0_UNITS"],
                    fitted["CHUNK_FIXED_UNITS"])
    cell: dict = {}
    for r in fitted["rows"]:
        cell.setdefault((r["k"], r["height"], r["cold_width"]),
                        []).append(r["ms"])
    errs = [abs(u * (r["height"] * (c0[r["k"]] + 2 * r["cold_width"] + 2)
                     + fixed) - r["ms"]) / r["ms"] for r in fitted["rows"]]
    widths = sorted({w for _, _, w in cell})
    for k in sorted({k for k, _, _ in cell}, reverse=True):
        print(f"\nk={k}: measured ms (a reading a file) / model ms")
        print("| height | " + " | ".join(f"T_c={w}" for w in widths) + " |")
        print("|---" * (len(widths) + 1) + "|")
        for q in sorted({q for kk, q, _ in cell if kk == k}):
            row = []
            for w in widths:
                got = cell.get((k, q, w))
                model = u * (q * (c0[k] + 2 * w + 2) + fixed)
                row.append("-" if got is None else
                           ", ".join(f"{x:.3f}" for x in got)
                           + f" / {model:.3f}")
            print(f"| {q} | " + " | ".join(row) + " |")
    print(f"\nerror over {len(errs)} readings: median "
          f"{np.median(errs):.3f}, max {max(errs):.3f}")


def _lstsq(cols: list[np.ndarray], y: np.ndarray) -> np.ndarray:
    """Non-negative least squares for two or fewer columns: the plain
    solution, or the best one-column fit where it goes negative."""
    a = np.stack(cols, axis=1)
    x, *_ = np.linalg.lstsq(a, y, rcond=None)
    if (x >= 0).all():
        return x
    best = None
    for i in range(len(cols)):
        xi = max(float(a[:, i] @ y / (a[:, i] @ a[:, i])), 0.0)
        r = np.linalg.norm(a[:, i] * xi - y)
        if best is None or r < best[0]:
            best = (r, i, xi)
    x = np.zeros(len(cols))
    x[best[1]] = best[2]
    return x


def fit(files: list[str]) -> dict:
    rows, grid = [], []
    for path in files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                if not rec.get("route"):
                    (grid if rec.get("sel_grid") else rows).append(rec)
    from bm25_tpu_torch.ops.ell_score import table_geometry
    from bm25_tpu_torch.utils.padding import cdiv

    def tables(r):
        return cdiv(r["q"], table_geometry(r["q"], max(r["t"], 8))[0])

    def blocks(r):
        return cdiv(r["q"], 128)

    # the scan: a slot per table and a row per block (every layout, both k)
    pts = [(r, r[f"k{k}"]) for r in rows for k in KS if f"k{k}" in r]
    scan = _lstsq([np.array([r["slots_model"] * tables(r) for r, _ in pts],
                            float),
                   np.array([r["rows_pad_model"] * blocks(r)
                             for r, _ in pts], float)],
                  np.array([m["scan_ms"] / 1e3 for _, m in pts]))
    hot_pts = [(r, m) for r, m in pts if r["h"] > 0]
    hot = _lstsq([np.array([r["rows_pad_model"] * blocks(r)
                            for r, _ in hot_pts], float),
                  np.array([r["h"] * r["rows_pad_model"] * blocks(r)
                            for r, _ in hot_pts], float)],
                 np.array([m["hot_ms"] / 1e3 for _, m in hot_pts])) \
        if hot_pts else np.zeros(2)
    sel = {}
    for k in KS:
        runs: dict = {}
        for g in grid:
            if g["k"] == k:
                runs.setdefault(g["rows"], []).append(g["us_per_query"])
        sel[k] = [(n, round(float(np.mean(v)), 3))
                  for n, v in sorted(runs.items())]
    consts = {"SCAN_S_PER_SLOT_TABLE": float(scan[0]),
              "SCAN_S_PER_ROW_BLOCK": float(scan[1]),
              "HOT_S_PER_ROW_BLOCK": float(hot[0]),
              "HOT_S_PER_TOKEN_ROW_BLOCK": float(hot[1]),
              "SEL_GRID": sel}
    return {"constants": consts, "rows": rows, "cards": sorted(
        {r["card"] for r in rows + grid})}


def report(fitted: dict) -> None:
    """The measured-against-modelled table under the fitted constants,
    and each corpus and k's chosen and fastest layouts."""
    from bm25_tpu_torch.models import sparse as ms

    costs = ms.H100Costs()
    for name, value in fitted["constants"].items():
        setattr(costs, name, value)
    print(f"cards: {fitted['cards']}")
    print("constants: " + json.dumps(fitted["constants"]))
    print("| corpus | h | B | k | B1 ms (model) | rest of step ms (model "
          "selection) | device step ms | model total ms |")
    print("|---|---|---|---|---|---|---|---|")
    errs_b1, errs_sel = [], []
    by_case: dict = {}
    for r in fitted["rows"]:
        d = r["num_docs"]
        for k in KS:
            m = r.get(f"k{k}")
            if m is None:
                continue
            b1 = 1e3 * costs.scan_hot_seconds(
                r["slots_model"], r["h"], r["rows_pad_model"], r["q"],
                max(r["t"], 8))
            rows_b = ms.next_multiple(max(d // r["max_buckets"], 1),
                                      ms.BLOCK_ROWS)
            sel = (r["max_buckets"] * costs.selection_us_per_query(k, rows_b)
                   * r["q"] * 1e-3)
            got_b1 = m["scan_ms"] + m["hot_ms"]
            # the rest of the device step: selection and merge, the hot
            # counts and plan, the offsets, the scan tables
            got_sel = m["step_ms"] - got_b1
            errs_b1.append(abs(b1 - got_b1) / got_b1)
            errs_sel.append(abs(sel - got_sel) / got_sel)
            print(f"| {r['corpus']} | {r['h']} | {r['max_buckets']} | {k} | "
                  f"{got_b1:.3f} ({b1:.3f}) | {got_sel:.3f} "
                  f"({sel:.3f}) | {m['step_ms']:.3f} | {b1 + sel:.3f} |")
            by_case.setdefault((r["corpus"], k), []).append(
                (b1 + sel, m["step_ms"], r["h"], r["max_buckets"]))
    print(f"B1 error: median {np.median(errs_b1):.3f}, max "
          f"{max(errs_b1):.3f}; the rest of the step against the "
          f"selection term: median "
          f"{np.median(errs_sel):.3f}, max {max(errs_sel):.3f}")
    for (corpus, k), cases in sorted(by_case.items()):
        model = min(cases)
        fast = min(cases, key=lambda c: c[1])
        print(f"{corpus} k={k}: model picks h={model[2]} B={model[3]} "
              f"(measured {model[1]:.3f} ms); fastest measured h={fast[2]} "
              f"B={fast[3]} ({fast[1]:.3f} ms); "
              f"ratio {model[1] / fast[1]:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sel-grid", action="store_true")
    ap.add_argument("--corpus", choices=("headline", "longdoc"),
                    default="headline")
    ap.add_argument("--heights", type=lambda s: [int(x) for x in
                                                 s.split(",")],
                    default=list(HEIGHTS))
    ap.add_argument("--buckets", type=lambda s: [int(x) for x in
                                                 s.split(",")],
                    default=list(BUCKETS))
    ap.add_argument("--ks", type=lambda s: [int(x) for x in s.split(",")],
                    default=list(KS))
    ap.add_argument("--iters", type=int, default=20,
                    help="steps a timing of the device step")
    ap.add_argument("--out", default="-")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu for a dry run "
                         "of --sweep without kernel times)")
    ap.add_argument("--route-sweep", action="store_true")
    ap.add_argument("--route-h", type=int, default=1024,
                    help="hot tokens of the --route-sweep engine")
    ap.add_argument("--fit-route", nargs="+", metavar="FILE")
    ap.add_argument("--fit", nargs="+", metavar="FILE")
    ap.add_argument("--check", nargs="+", metavar="FILE",
                    help="the --fit report at H100Costs' constants as they "
                         "stand, no refit")
    args = ap.parse_args(argv)
    if args.fit:
        report(fit(args.fit))
        return 0
    if args.fit_route:
        report_route(args.fit_route)
        return 0
    if args.check:
        from bm25_tpu_torch.models.sparse import H100Costs

        fitted = fit(args.check)
        fitted["constants"] = {name: getattr(H100Costs, name)
                               for name in fitted["constants"]}
        report(fitted)
        return 0
    from bm25_tpu_torch.runtime.session import Session

    session = Session(args.device)
    out = sys.stdout if args.out == "-" else open(args.out, "a")
    try:
        if args.sel_grid:
            sel_grid(args, session, out)
        if args.sweep:
            sweep(args, session, out)
        if args.route_sweep:
            route_sweep(args, session, out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
