"""Query benchmark harness: the port's copy of
``bm25_tpu/bench/query_bench.py``, function for function, with the same
record keys: batched top-k throughput (sustained qps, pipelined), p50/p99
batch latency, the device step, recall against ``ReferenceEngine``, the
memory trade, the long-document row and the synthetic-BEIR eval.

Run: ``python -m bm25_tpu_torch.bench.query_bench [--device cpu]`` (the
card by default; ``BM25_BENCH_<FIELD>`` environment variables override
``BenchConfig``).  It prints the full record, then the compact headline
as the last line.

What differs from the JAX harness:

* the device step is timed by CUDA events around steps enqueued back to
  back (``measure_device_step_ms``), and its bytes are the ones kernel B1
  moves (``models.sparse.b1_bytes``, the count ``chip_smoke.py`` bounds
  B1 with), against the H100 SXM's 3.35 TB/s;
* the record keeps the layout the cost model chose (``extra["layout"]``
  and the long-document row's ``"layout"``: the choice and each bucket
  count's modelled ms, ``models.sparse.layout_candidates``);
* ``extra["omitted"]`` names the row keys that have no counterpart (the
  VPU op model: the port's scan is a table lookup, not T compares a slot)
  and ``extra["not_ported"]`` the rows switched off (none now);
* the ``sharded`` row's step is timed by CUDA events through the engine's
  ``bench_step_fn``, and the ``shard_scaling`` curve runs in process over
  1, 2, 4 and 8 shards of the mesh's first device (JAX's runs a script on
  a CPU mesh in a subprocess);
* the ``cold_start`` row times the headline step's first call in fresh
  processes against an empty, a warm and an imported build directory
  (``measure_cold_start``): the nvcc bill a fresh host pays, and what a
  shipped build cache saves.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class BenchConfig:
    num_docs: int = 524288
    vocab: int = 32768
    avg_len: int = 48
    num_queries: int = 2048
    batch: int = 512
    query_len: int = 8
    # headline config is the BASELINE.md target row (k=1000); k=100 is
    # measured alongside as the secondary row
    top_k: int = 1000
    top_k2: int = 100
    baseline_queries: int = 32
    seed: int = 0
    engine: str = "auto"
    # ELL bucket count trades padding (more buckets = tighter widths =
    # less VPU scan work) against per-bucket selection cost (one top-k
    # tree per bucket).  0 = choose by the measured cost model
    # (models.sparse.choose_layout, keyed on the headline k) — the model
    # reproduces the round-2 sweep (2 buckets at k=1000, 4 at k=100)
    max_buckets: int = 0
    # also measure a hot-tier-free engine at CSC-parity device memory
    # (the BASELINE.md "index memory equal to reference CSC footprint"
    # row) so the memory/speed trade is a reported pair, not a default
    memory_parity: int = 1
    # adversarial synthetic-BEIR eval shape (shrunk only by tests)
    eval_docs: int = 5000
    eval_queries: int = 50
    # long-document row (the BASELINE Wikipedia config class): a second
    # corpus whose article-length docs push ELL buckets past SLOT_TILE so
    # the slot-tiled kernel path is measured on real hardware every round
    # (0 = off).  Kept smaller than the headline corpus — it exists to
    # characterize the wide-bucket path, not to re-run the headline
    longdoc_docs: int = 65536
    longdoc_long_len: int = 4000
    longdoc_short_len: int = 150
    longdoc_long_pct: int = 20
    # sharded-engine row (0 = off): ShardedSparseEngine over the local
    # mesh: a (1, 1) mesh on one card (the sharded step and its merge run
    # and stay exact on the card each run), real scaling over several
    sharded_docs: int = 131072
    # headline score-payload dtype.  bfloat16 halves the d2h result bytes
    # with EXACT rankings (selection runs in f32 on-device; only the
    # returned score values round) — through the relay's transfer-bound
    # link that is the difference between ~0.56x and ~0.82x of the
    # device-step-implied qps at k=1000 (scripts/exp_r4_pipeline.py).
    # _measure_k always measures BOTH dtypes, so the f32 figure stays a
    # reported row either way.
    score_dtype: str = "bfloat16"
    # measure the cold-build / cache-import deployment costs for one
    # headline chunk (0 = off).  Adds three fresh processes to the run and,
    # on the card, one nvcc build of the step's kernel libraries
    cold_start: int = 1
    # shard-scaling curve row (0 = off; 2 forces it below the headline
    # shape): the sharded step at S in {1, 2, 4, 8} doc shards of one
    # device, in process, with each S's merge share (full step less the
    # local_only step)
    shard_scaling: int = 1
    shard_scaling_docs: int = 32768

    @classmethod
    def from_env(cls) -> "BenchConfig":
        kw = {}
        for f, spec in cls.__dataclass_fields__.items():
            v = os.environ.get(f"BM25_BENCH_{f.upper()}")
            if v is not None:
                kw[f] = v if f in ("engine", "score_dtype") else int(v)
        return cls(**kw)

    def engine_kwargs(self) -> dict:
        # max_buckets/score_dtype only exist on the sparse engines;
        # explicit non-sparse modes use strict kwargs (auto filters them
        # itself)
        if self.engine in ("dense", "sharded"):
            return {}
        return {"max_buckets": self.max_buckets,
                "score_dtype": self.score_dtype}


# upload+init budget (seconds) at the headline shape: a run above it gets
# a "warning" field in the record and the headline line.  About 1.5x the
# card's own create_engine time at 524,288 docs with the explicit layout,
# 4.4-5.3 s over three runs (NVIDIA H100 80GB HBM3, 700.00 W; host numpy
# layout, uploads and B2's hot-tier build; no compile cache is involved)
UPLOAD_INIT_WARM_BUDGET_S = 8.0

# the H100 SXM's peak memory rate (bytes/s), the utilization denominator
# (the peak chip_smoke.py's bounds use)
H100_HBM_BYTES_PER_S = 3.35e12
# row keys of the JAX harness that have no counterpart here, and why
OMITTED = {
    "achieved_vpu_tops": "no counterpart: the scan is a table lookup, not "
                         "T compares a slot (the VPU op model)",
    "vpu_utilization": "no counterpart: the TPU VPU ceiling",
}
# measured only on the card: a rate against the H100's peak
CARD_ONLY = {
    "achieved_hbm_gbps": "not measured: the run is on the CPU",
    "hbm_utilization": "not measured: the run is on the CPU",
}


def compact_headline(result: dict) -> dict:
    """Compact (<~500 byte) headline view of a full bench result, printed
    as the last line so a tail capture of the output ends with one whole,
    parseable record."""
    extra = result.get("extra") or {}
    head = extra.get("headline") or {}
    compact = {
        "metric": result.get("metric"),
        "value": result.get("value"),
        "unit": result.get("unit"),
        "vs_baseline": result.get("vs_baseline"),
        "top_k": head.get("top_k"),
        "device_step_ms": head.get("device_step_ms"),
        "recall": head.get("recall_vs_reference"),
        "upload_init_s": extra.get("upload_init_s"),
        "index_build_docs_per_sec": extra.get("index_build_docs_per_sec"),
    }
    sec = extra.get("secondary") or []
    if sec:
        compact["secondary"] = [
            {"top_k": r.get("top_k"), "qps": r.get("qps"),
             "device_step_ms": r.get("device_step_ms")}
            for r in sec
        ]
    if extra.get("warning"):
        compact["warning"] = extra["warning"]
    return compact


def _zipf_probs(vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    return p / p.sum()


def make_synthetic_index(cfg: BenchConfig, timings: dict | None = None):
    """Synthetic Zipf corpus -> ScoredIndex.

    ``timings`` (if given) receives ``synthesis_s`` (token sampling — a
    HARNESS cost, not product work) and ``index_build_s`` (the
    ``build_scored_index_flat`` call — the product indexing pipeline)
    separately: round 3 billed both to "index build", understating the
    real build rate ~2x.
    """
    from bm25_tpu_torch.scoring import build_scored_index_flat

    t0 = time.perf_counter()
    rng = np.random.default_rng(cfg.seed)
    probs = _zipf_probs(cfg.vocab)
    cum = np.cumsum(probs)
    lengths = np.maximum(4, rng.poisson(cfg.avg_len, cfg.num_docs)).astype(np.int32)
    # inverse-CDF sampling (much faster than rng.choice with p at 10M+ draws)
    flat = np.searchsorted(cum, rng.random(int(lengths.sum()))).astype(np.int32)
    np.clip(flat, 0, cfg.vocab - 1, out=flat)
    t1 = time.perf_counter()
    index = build_scored_index_flat(flat, lengths, vocab_size=cfg.vocab)
    if timings is not None:
        timings["synthesis_s"] = round(t1 - t0, 2)
        timings["index_build_s"] = round(time.perf_counter() - t1, 2)
    return index


def make_queries(cfg: BenchConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed + 1)
    cum = np.cumsum(_zipf_probs(cfg.vocab))
    q = np.searchsorted(cum, rng.random((cfg.num_queries, cfg.query_len)))
    return np.clip(q, 0, cfg.vocab - 1).astype(np.int32)


def make_longdoc_index(cfg: BenchConfig):
    """Mixed-length corpus: ``longdoc_long_pct`` article-length docs.

    Same Zipf vocabulary as the headline corpus; the long mode's unique
    term count per doc is what widens ELL buckets past SLOT_TILE and
    engages the slot-tiled path (ops/ell_score.py::_slot_tiling)."""
    from bm25_tpu_torch.scoring import build_scored_index_flat

    rng = np.random.default_rng(cfg.seed + 7)
    cum = np.cumsum(_zipf_probs(cfg.vocab))
    n = cfg.longdoc_docs
    is_long = rng.random(n) < cfg.longdoc_long_pct / 100.0
    lengths = np.where(
        is_long,
        np.maximum(cfg.longdoc_long_len // 2,
                   rng.poisson(cfg.longdoc_long_len, n)),
        np.maximum(8, rng.poisson(cfg.longdoc_short_len, n)),
    ).astype(np.int32)
    flat = np.searchsorted(
        cum, rng.random(int(lengths.sum()))
    ).astype(np.int32)
    np.clip(flat, 0, cfg.vocab - 1, out=flat)
    return build_scored_index_flat(flat, lengths, vocab_size=cfg.vocab)


def model_layout(index, k: int, cfg: BenchConfig, session) -> dict:
    """The cost model's layout for ``index`` at ``k`` and the benchmark's
    batch (``choose_layout``, JAX's harness's call), with each bucket
    count's modelled ms: ``{"top_k", "max_buckets", "hot_tokens",
    "candidates"}``.  The engine built at this ``max_buckets`` sizes the
    same hot tier itself (``hot_tokens="auto"``)."""
    from bm25_tpu_torch.models.sparse import best_layout, layout_candidates

    cands = layout_candidates(index, k=k, q=cfg.batch,
                              t=max(cfg.query_len, 8),
                              device=session.device)
    return {"top_k": k, **best_layout(cands), "candidates": [
        {key: (round(v, 4) if isinstance(v, float) else v)
         for key, v in c.items()} for c in cands]}


def _free(session) -> None:
    """Return a dropped engine's device memory before the next is built."""
    gc.collect()
    if session.device.type == "cuda":
        torch.cuda.empty_cache()


def _sync(session) -> None:
    if session.device.type == "cuda":
        torch.cuda.synchronize(session.device)


def _measure_longdoc(cfg: BenchConfig, queries: np.ndarray, log,
                     session=None) -> dict:
    from bm25_tpu_torch.eval import index_memory_stats
    from bm25_tpu_torch.models.sparse import SparseEngine
    from bm25_tpu_torch.ops.ell_score import SLOT_TILE
    from bm25_tpu_torch.reference import ReferenceEngine
    from bm25_tpu_torch.runtime.session import get_session

    session = session or get_session()
    t0 = time.perf_counter()
    index = make_longdoc_index(cfg)
    build_s = time.perf_counter() - t0
    k = min(cfg.top_k, cfg.longdoc_docs)
    layout = model_layout(index, k, cfg, session)
    t0 = time.perf_counter()
    engine = SparseEngine.from_scored_index(
        index, session=session, max_buckets=layout["max_buckets"])
    _sync(session)
    upload_s = time.perf_counter() - t0
    widths = [b["tokT"].shape[0] for b in engine.buckets if "tokT" in b]
    log(f"[bench] longdoc: {cfg.longdoc_docs} docs nnz={index.nnz} "
        f"widths={widths} hot_h={engine.hot_h} "
        f"(build {build_s:.1f}s, up {upload_s:.1f}s)")

    plan = engine.plan_chunks(queries.astype(np.int32), k=k)
    step_ms = measure_device_step_ms(engine, queries, k, plan=plan,
                                     batch=cfg.batch)
    nb = min(cfg.baseline_queries, len(queries))
    docs, _ = engine.search(queries[:nb], top_k=k)
    ref_docs, _ = ReferenceEngine.from_scored_index(index).search(
        queries[:nb], top_k=k
    )
    recall = recall_at_k(np.asarray(docs), ref_docs)
    mem = index_memory_stats(index, engine)
    row = {
        "top_k": k,
        "num_docs": cfg.longdoc_docs,
        "nnz": int(index.nnz),
        "bucket_widths": widths,
        "slot_tiled": bool(widths and max(widths) > SLOT_TILE),
        "device_step_ms": None if step_ms is None else round(step_ms, 2),
        "recall_vs_reference": round(recall, 4),
        "overhead_ratio": mem.as_dict().get("overhead_ratio"),
        "upload_init_s": round(upload_s, 1),
        "layout": layout,
        # one batch's planned chunks: the routed ones carry a cold width
        "chunks": routed_chunks(plan),
    }
    log(f"[bench] longdoc: k={k} device_step={row['device_step_ms']}ms "
        f"recall@{k}={recall:.4f} slot_tiled={row['slot_tiled']}")
    del engine
    _free(session)
    return row


def recall_at_k(got_docs: np.ndarray, want_docs: np.ndarray) -> float:
    # one canonical implementation (eval.py): compared-rows denominator,
    # -1 pad slots excluded
    from bm25_tpu_torch.eval import recall_at_k as _recall

    return _recall(got_docs, want_docs)


def _time_enqueued(enqueue, device: torch.device, iters: int) -> float:
    """Device ms of one step: ``enqueue(n)`` enqueues n steps back to back
    on the same device inputs, each step's output consumed on the device
    (a max folded into one accumulator on ``device``, which it returns);
    t(n) is timed by CUDA events with one sync at the end (the host clock
    on the CPU), best of three; the step is (t(iters) - t(1)) / (iters -
    1)."""
    cuda = device.type == "cuda"

    def timed(n):
        best = float("inf")
        for _ in range(3):
            if cuda:
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                enqueue(n)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                float(enqueue(n))
                dt = time.perf_counter() - t0
            best = min(best, dt)
        return best

    float(enqueue(1))  # warm: the scan tables' first launch, allocations
    float(enqueue(iters))
    t1, tn = timed(1), timed(iters)
    return max((tn - t1) / (iters - 1), 0.0) * 1e3


def _time_step_chunk(engine, step, ids, iters: int, cold=None) -> float:
    """Device ms of one SparseEngine step on one chunk of ids (and its
    cold ids where the chunk is routed) (``_time_enqueued``)."""

    def enqueue(n):
        acc = torch.zeros((), dtype=torch.float32, device=ids.device)
        for _ in range(n):
            out = step(ids, engine.buckets, engine.offsets, engine.hot_table,
                       tail=engine._tail, cold_ids=cold)
            leaf = out[0] if isinstance(out, tuple) else out
            acc = acc + leaf.float().amax()
        return acc

    return _time_enqueued(enqueue, ids.device, iters)


def measure_device_step_ms(engine, queries: np.ndarray, k: int,
                           iters: int = 5, plan=None,
                           batch: int = 512) -> float | None:
    """On-device step time of the production step over the batch's chunk
    plan: each distinct chunk shape is timed once (``_time_step_chunk``),
    and the plan's total is normalized per ``batch`` queries (routed
    plans cut chunks of several heights and cold widths).  SparseEngine
    only (the bench engine)."""
    from bm25_tpu_torch.models.sparse import SparseEngine

    if not isinstance(engine, SparseEngine):
        return None
    if plan is None:
        plan = engine.plan_chunks(queries.astype(np.int32), k=k)
    _, chunks = plan
    # the production step's configuration: score dtype, union selection
    step = engine.query_step(min(k, engine.num_docs))
    put = engine.session.put
    per_config: dict[tuple, float] = {}
    times = []
    for c in chunks:
        key = (c.padded.shape,
               None if c.cold_padded is None else c.cold_padded.shape)
        if key not in per_config:
            per_config[key] = _time_step_chunk(
                engine, step, put(c.padded), iters,
                None if c.cold_padded is None else put(c.cold_padded))
        times.append(per_config[key])
    if not times:
        return None
    total_q = sum(c.cq for c in chunks)
    return float(sum(times) * batch / max(total_q, 1))


def routed_chunks(plan) -> list[dict]:
    """Each planned chunk's rows, padded height and cold width (None
    where the chunk is not routed), for the record."""
    return [{"rows": c.cq, "height": c.padded.shape[0],
             "cold_width": (None if c.cold_padded is None
                            else c.cold_padded.shape[1])}
            for c in plan[1]]


def estimate_step_hbm_bytes(engine, q: int, plan) -> int | None:
    """The least bytes one SparseEngine step moves for a batch of ``q``
    queries: kernel B1's on every bucket and chunk of ``plan`` (the
    ``plan_chunks`` result that ``measure_device_step_ms`` times), counted
    from its ids (``models.sparse.b1_bytes``, the count chip_smoke.py
    bounds B1 with): the slots' tokens, a value a matching slot, the used
    hot rows, each (Q, rows) base written once, the group maxima; scaled
    to ``q`` queries as ``measure_device_step_ms`` scales its time."""
    from bm25_tpu_torch.models.sparse import SparseEngine, b1_bytes

    if not isinstance(engine, SparseEngine):
        return None
    put = lambda x: None if x is None else engine.session.put(x)  # noqa
    total = 0
    for c in plan[1]:
        total += sum(b.scan + b.epilogue for b in b1_bytes(
            engine, put(c.padded), cold_ids=put(c.cold_padded)))
    return total * q // max(sum(c.cq for c in plan[1]), 1)


def measure_sharded_step_ms(engine, queries: np.ndarray, k: int,
                            iters: int = 5,
                            local_only: bool = False) -> float | None:
    """Device ms of the ShardedSparseEngine step on the batch's first
    chunk, through the engine's own production step (``bench_step_fn``):
    the shards' B1, selection and bucket merge, the copies to the merge
    device and the cross-shard merge (``_time_enqueued``; the JAX harness
    chains the steps in a ``fori_loop``).  ``local_only`` stops after the
    shards' local top k, so that the merge costs the difference."""
    from bm25_tpu_torch.parallel.sharded_engine import ShardedSparseEngine

    if not isinstance(engine, ShardedSparseEngine):
        return None
    fn, args, _ = engine.bench_step_fn(queries.astype(np.int32), k,
                                       local_only=local_only)
    dev = engine.mesh.devices[0, 0]

    def enqueue(n):
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(n):
            for out in fn(*args):
                # a merged row's (scores, docs), or with local_only a
                # row's list of them a shard
                for s, _ in (out if isinstance(out, list) else [out]):
                    acc = acc + s.float().amax().to(dev)
        return acc

    return _time_enqueued(enqueue, dev, iters)


def _measure_sharded(cfg: BenchConfig, log, session) -> dict:
    """Sharded-engine row: ShardedSparseEngine over the local mesh at
    ``sharded_docs``.  On one card this is a (1, 1) mesh: it proves the
    sharded step and its merge run and stay exact on the card, and its
    device step beside the single-device engine's bounds what the
    sharding machinery costs at one shard."""
    import dataclasses

    from bm25_tpu_torch.parallel.mesh import default_mesh
    from bm25_tpu_torch.parallel.sharded_engine import ShardedSparseEngine
    from bm25_tpu_torch.reference import ReferenceEngine

    scfg = dataclasses.replace(cfg, num_docs=cfg.sharded_docs)
    t0 = time.perf_counter()
    index = make_synthetic_index(scfg)
    build_s = time.perf_counter() - t0
    queries = make_queries(scfg)
    k = min(cfg.top_k, cfg.sharded_docs)

    mesh = default_mesh(session)
    t0 = time.perf_counter()
    engine = ShardedSparseEngine.from_scored_index(index, mesh=mesh)
    _sync(session)
    upload_s = time.perf_counter() - t0
    log(f"[bench] sharded: mesh={dict(mesh.shape)} {cfg.sharded_docs} docs "
        f"nnz={index.nnz} hot_h={engine.hot_h} "
        f"(build {build_s:.1f}s, up {upload_s:.1f}s)")

    step_ms = measure_sharded_step_ms(engine, queries, k)
    nb = min(cfg.baseline_queries, len(queries))
    docs, _ = engine.search(queries[:nb], top_k=k)
    ref_docs, _ = ReferenceEngine.from_scored_index(index).search(
        queries[:nb], top_k=k
    )
    recall = recall_at_k(np.asarray(docs), ref_docs)
    row = {
        "top_k": k,
        "num_docs": cfg.sharded_docs,
        "mesh": {str(ax): int(n) for ax, n in mesh.shape.items()},
        "device_step_ms": None if step_ms is None else round(step_ms, 2),
        "recall_vs_reference": round(recall, 4),
        "upload_init_s": round(upload_s, 1),
    }
    log(f"[bench] sharded: k={k} device_step={row['device_step_ms']}ms "
        f"recall@{k}={recall:.4f}")
    del engine
    _free(session)
    return row


def _measure_shard_scaling(cfg: BenchConfig, log, session,
                           shards=(1, 2, 4, 8)) -> dict:
    """Strong-scaling curve of the sharded step, in process: the corpus
    at ``shard_scaling_docs`` over 1, 2, 4 and 8 doc shards of the
    harness mesh's first device, 64 queries, each point's full and
    ``local_only`` step (``measure_sharded_step_ms``), the merge's share
    of the step and recall against the oracle on 16 queries.  (JAX's row
    runs ``scripts/exp_shard_scaling.py`` in a subprocess, whose platform
    has 8 CPU devices; a port mesh names one device several times.)"""
    import dataclasses

    from bm25_tpu_torch.parallel.mesh import default_mesh, make_mesh
    from bm25_tpu_torch.parallel.sharded_engine import ShardedSparseEngine
    from bm25_tpu_torch.reference import ReferenceEngine

    scfg = dataclasses.replace(cfg, num_docs=cfg.shard_scaling_docs)
    index = make_synthetic_index(scfg)
    queries = make_queries(scfg)[:64]
    k = min(cfg.top_k, cfg.shard_scaling_docs)
    dev = default_mesh(session).devices[0, 0]
    nb = min(16, len(queries))
    ref_docs, _ = ReferenceEngine.from_scored_index(index).search(
        queries[:nb], top_k=k)
    log(f"[bench] shard-scaling curve ({cfg.shard_scaling_docs} docs, "
        f"shards {list(shards)} of {dev})")
    rows = []
    for n in shards:
        engine = ShardedSparseEngine.from_scored_index(
            index, mesh=make_mesh(n, devices=[dev] * n))
        docs, _ = engine.search(queries[:nb], top_k=k)
        full = measure_sharded_step_ms(engine, queries, k)
        local = measure_sharded_step_ms(engine, queries, k, local_only=True)
        merge = max(0.0, full - local)
        row = {
            "shards": n,
            "num_docs": cfg.shard_scaling_docs,
            "k": k,
            "recall": round(recall_at_k(np.asarray(docs), ref_docs), 4),
            "step_full_ms": round(full, 2),
            "step_local_ms": round(local, 2),
            "merge_ms": round(merge, 2),
            "merge_share": round(merge / max(full, 1e-9), 4),
        }
        rows.append(row)
        log(f"[bench] shard-scaling S={n}: step={row['step_full_ms']}ms "
            f"merge_share={row['merge_share']} recall={row['recall']}")
        del engine
        _free(session)
    return {"k": k, "strong": rows}


def first_step_seconds(work: str, k: int, device: str) -> dict:
    """One fresh process's first headline step: restore the engine saved
    in ``work`` (its hot pairs dense, so the restore launches nothing),
    then time the step's first call on the first chunk of
    ``work/queries.npy``, with the first-use work it did (nvcc builds
    and library loads in the build directory of this process).  The
    child side of ``measure_cold_start``."""
    from bm25_tpu_torch.index.device_checkpoint import load_device_checkpoint
    from bm25_tpu_torch.runtime.profiling import compile_phase_collector
    from bm25_tpu_torch.runtime.session import Session

    session = Session(device)
    engine = load_device_checkpoint(os.path.join(work, "engine"),
                                    session=session)
    queries = np.load(os.path.join(work, "queries.npy"))
    chunk = engine.plan_chunks(queries, k=k)[1][0]
    ids = session.put(chunk.padded)
    cold = None if chunk.cold_padded is None else session.put(
        chunk.cold_padded)
    _sync(session)
    t0 = time.perf_counter()
    with compile_phase_collector() as phases:
        step = engine.query_step(min(k, engine.num_docs))
        step(ids, engine.buckets, engine.offsets, engine.hot_table,
             tail=engine._tail, cold_ids=cold)
        _sync(session)
    return {"seconds": time.perf_counter() - t0, **phases}


def _first_step_in_subprocess(work: str, k: int, device: str,
                              build_dir: str) -> dict:
    """``first_step_seconds`` in a fresh Python process whose build
    directory is ``build_dir``."""
    from bm25_tpu_torch.ops import _build

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, _build.BUILD_DIR_ENV: build_dir,
           "PYTHONPATH": root if not path else root + os.pathsep + path}
    code = ("import json; from bm25_tpu_torch.bench.query_bench import "
            "first_step_seconds as f; "
            f"print(json.dumps(f({work!r}, {k}, {device!r})))")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=1800)
    if res.returncode != 0:
        raise RuntimeError(f"cold-start child failed ({res.returncode}):\n"
                           f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def measure_cold_start(engine, queries: np.ndarray, k: int, batch: int,
                       log=print) -> dict | None:
    """Deployment-cost row: the JAX harness's ``cold_start``, with the
    same keys, on the port's build cache.

    The headline ``upload_init_s`` is a warm figure: every kernel library
    the step loads was built before.  This measures, for ONE headline
    chunk, the first call of the step in a fresh process (a restored copy
    of ``engine``: in-process timings would read libraries this process
    already loaded, ``ops/_build.py``'s ``_libs``):

    - ``headline_step_cold_compile_s``: pointed at an empty build
      directory, so nvcc builds what the step loads;
    - ``headline_step_warm_cache_s``: pointed at this process's build
      directory, the libraries present;
    - ``headline_step_cache_import_s``: pointed at a fresh directory
      filled by ``cache export`` of this process's build directory and
      ``cache import`` (the documented deploy flow), whose nvcc seconds
      must read 0.

    ``first_use`` holds each run's ``nvcc_build_s``, ``native_build_s``
    and ``library_load_s``.  SparseEngine only; returns None otherwise.
    """
    import tarfile
    import tempfile

    from bm25_tpu_torch.index.device_checkpoint import _write_checkpoint
    from bm25_tpu_torch.models.sparse import SparseEngine
    from bm25_tpu_torch.ops import _build
    from bm25_tpu_torch.runtime import cache as cc

    if not isinstance(engine, SparseEngine):
        return None
    device = str(engine.session.device)
    cache_dir = _build.build_dir()
    out = {"persistent_cache_dir": cache_dir, "first_use": {}}

    def first_step(name, key, build_dir):
        got = _first_step_in_subprocess(work, k, device, build_dir)
        out[key] = round(got.pop("seconds"), 4)
        out["first_use"][name] = {n: round(v, 4) for n, v in got.items()}

    with tempfile.TemporaryDirectory(prefix="bm25_cold_start_") as work:
        # dense hot pairs: the children restore without launching B2
        _write_checkpoint(os.path.join(work, "engine"), engine,
                          compact=False)
        np.save(os.path.join(work, "queries.npy"),
                queries[:batch].astype(np.int32))
        first_step("cold", "headline_step_cold_compile_s",
                   os.path.join(work, "empty_build_dir"))
        first_step("warm", "headline_step_warm_cache_s", cache_dir)
        try:
            archive = os.path.join(work, "cache.tgz")
            cc.export_cache(archive, path=cache_dir)
            fresh_dir = os.path.join(work, "imported")
            cc.import_cache(archive, path=fresh_dir)
        except (OSError, ValueError, tarfile.TarError) as e:
            out["cache_import_error"] = str(e)
        else:
            first_step("cache_import", "headline_step_cache_import_s",
                       fresh_dir)
    log(f"[bench] cold start: cold_compile="
        f"{out.get('headline_step_cold_compile_s')}s warm_cache="
        f"{out.get('headline_step_warm_cache_s')}s cache_import="
        f"{out.get('headline_step_cache_import_s')}s first use "
        f"{json.dumps(out['first_use'])}")
    return out


def _measure_k(cfg, index, engine, queries, k: int, log, ref=None) -> dict:
    """One k-point: baseline, latency percentiles, sustained qps, recall."""
    if ref is None:
        from bm25_tpu_torch.reference import ReferenceEngine

        ref = ReferenceEngine.from_scored_index(index)
    nb = min(cfg.baseline_queries, len(queries))
    t0 = time.perf_counter()
    ref_docs, ref_scores = ref.search(queries[:nb], top_k=k)
    baseline_qps = nb / (time.perf_counter() - t0)

    batches = [
        queries[i : i + cfg.batch] for i in range(0, len(queries), cfg.batch)
    ]
    # warm-up: one full pass, collecting enough rows to cover every
    # baseline query (with batch < baseline_queries the first batch alone
    # would truncate the recall comparison)
    docs0_parts, docs0_rows = [], 0
    for b in batches:
        d, _ = engine.search(b, top_k=k)
        if docs0_rows < nb:
            docs0_parts.append(d)
            docs0_rows += len(d)
    docs0 = np.concatenate(docs0_parts)[:nb]
    lat = []
    for b in batches:
        t0 = time.perf_counter()
        engine.search(b, top_k=k)
        lat.append(time.perf_counter() - t0)
    p50 = float(np.percentile(lat, 50))
    p99 = float(np.percentile(lat, 99))
    # sustained throughput: the pipelined search (batch i+1 dispatched
    # before batch i is collected); best of two passes
    search_all = getattr(engine, "search_pipelined", None)

    def sustained():
        best = 0.0
        for _ in range(2):
            t_all = time.perf_counter()
            if search_all is not None:
                search_all(queries, top_k=k, batch=cfg.batch)
            else:
                engine.search(queries, top_k=k)
            best = max(best, len(queries) / (time.perf_counter() - t_all))
        return best

    qps = sustained()
    # the score payload dtype halves/doubles result bytes; measure BOTH
    # so the trade is a recorded pair (doc ids stay exact int32 either way)
    qps_other = None
    other_dtype = None
    if hasattr(engine, "score_dtype"):
        configured = engine.score_dtype
        other_dtype = ("bfloat16" if configured == "float32" else "float32")
        engine.score_dtype = other_dtype
        try:
            engine.search(queries[: cfg.batch], top_k=k)  # warm
            qps_other = sustained()
        finally:
            engine.score_dtype = configured
    # rankings-only mode (no score transfer)
    qps_ids = None
    search_ids = getattr(engine, "search_ids", None)
    if search_ids is not None:
        if search_all is not None:
            ids_fn = lambda: search_all(queries, top_k=k, batch=cfg.batch,  # noqa: E731
                                        ids_only=True)
        else:
            ids_fn = lambda: search_ids(queries, top_k=k)  # noqa: E731
        ids_fn()  # warm
        qps_ids = 0.0
        for _ in range(2):
            t_all = time.perf_counter()
            ids_fn()
            qps_ids = max(qps_ids, len(queries) / (time.perf_counter() - t_all))
    recall = recall_at_k(docs0, ref_docs)

    row = {
        "top_k": k,
        "qps": round(qps, 1),
        "vs_baseline": round(qps / baseline_qps, 2),
        "baseline_qps": round(baseline_qps, 1),
        "p50_batch_ms": round(p50 * 1e3, 2),
        "p99_batch_ms": round(p99 * 1e3, 2),
        "recall_vs_reference": round(recall, 4),
    }
    if hasattr(engine, "score_dtype"):
        row["score_dtype"] = engine.score_dtype
    if qps_other is not None:
        row[f"qps_{other_dtype}_scores"] = round(qps_other, 1)
    if qps_ids is not None:
        row["qps_rankings_only"] = round(qps_ids, 1)
    plan = None
    if hasattr(engine, "plan_chunks"):
        plan = engine.plan_chunks(queries.astype(np.int32), k=k)
    step_ms = measure_device_step_ms(engine, queries, k, plan=plan,
                                     batch=cfg.batch)
    if plan is not None:
        row["chunks"] = routed_chunks(plan)
    if step_ms is not None:
        row["device_step_ms"] = round(step_ms, 2)
        # step_ms is normalized to cfg.batch queries: the byte count is
        # for a batch of as many
        model_bytes = estimate_step_hbm_bytes(engine, cfg.batch, plan)
        if model_bytes and step_ms > 0 and \
                engine.session.device.type == "cuda":
            rate = model_bytes / (step_ms / 1e3)
            row["achieved_hbm_gbps"] = round(rate / 1e9, 1)
            row["hbm_utilization"] = round(rate / H100_HBM_BYTES_PER_S, 3)
    log(
        f"[bench] k={k}: qps={qps:.0f} p50={p50*1e3:.1f}ms "
        f"recall@{k}={recall:.4f} vs_baseline={qps/baseline_qps:.1f}x "
        f"device_step={row.get('device_step_ms', '?')}ms"
    )
    return row


def run(cfg: BenchConfig | None = None, log=print, session=None,
        index=None, timings: dict | None = None) -> dict:
    """The benchmark record on ``session``'s device (the default CUDA
    session when None).  ``index`` (with its ``make_synthetic_index``
    ``timings``) reuses a headline corpus the caller already built for
    this ``cfg``."""
    from bm25_tpu_torch.datasets import evaluate_dataset, synthetic_beir_hard
    from bm25_tpu_torch.eval import index_memory_stats
    from bm25_tpu_torch.models.auto import create_engine
    from bm25_tpu_torch.models.sparse import SparseEngine
    from bm25_tpu_torch.reference import ReferenceEngine
    from bm25_tpu_torch.runtime.session import get_session

    cfg = cfg or BenchConfig.from_env()
    session = session or get_session()
    if index is None:
        log(f"[bench] building synthetic index: {cfg.num_docs} docs, "
            f"vocab {cfg.vocab}")
        timings = {}
        index = make_synthetic_index(cfg, timings=timings)
    build_s = max(timings["index_build_s"], 1e-9)
    log(f"[bench] built in {build_s:.1f}s (nnz={index.nnz}; corpus "
        f"synthesis {timings['synthesis_s']:.1f}s, not billed to build)")
    queries = make_queries(cfg)

    kwargs = cfg.engine_kwargs()
    layout = None
    if kwargs.get("max_buckets") == 0:
        layout = model_layout(index, cfg.top_k, cfg, session)
        kwargs["max_buckets"] = layout["max_buckets"]
        log(f"[bench] layout model: max_buckets={layout['max_buckets']} "
            f"hot_tokens={layout['hot_tokens']} (k={cfg.top_k}); "
            f"candidates {json.dumps(layout['candidates'])}")
    t0 = time.perf_counter()
    engine = create_engine(index, mode=cfg.engine, session=session, **kwargs)
    _sync(session)
    upload_s = time.perf_counter() - t0
    log(f"[bench] engine={type(engine).__name__} upload+init {upload_s:.1f}s")
    budget = float(os.environ.get("BM25_BENCH_UPLOAD_BUDGET_S",
                                  UPLOAD_INIT_WARM_BUDGET_S))
    warning = None
    # only meaningful at the headline shape: tiny configs finish in
    # milliseconds and real regressions only show at scale
    if upload_s > budget and cfg.num_docs >= 100_000:
        warning = (f"upload_init_s {upload_s:.1f} exceeds warm budget "
                   f"{budget:.0f}s")
        log(f"[bench] WARNING: {warning}")

    # headline = cfg.top_k; cfg.top_k2 secondary
    ref = ReferenceEngine.from_scored_index(index)
    ks = []
    for k in (cfg.top_k, cfg.top_k2):
        k = min(k, cfg.num_docs)
        if k not in ks:
            ks.append(k)
    rows = {
        k: _measure_k(cfg, index, engine, queries, k, log, ref=ref) for k in ks
    }
    head = rows[ks[0]]
    mem = index_memory_stats(index, engine)

    # retrieval quality on the adversarial self-labelled dataset, one row
    # per engine family
    hard_ds = synthetic_beir_hard(num_docs=cfg.eval_docs,
                                  num_queries=cfg.eval_queries,
                                  seed=cfg.seed)
    beir = {
        mode: evaluate_dataset(hard_ds, top_k=10, engine_mode=mode, log=log,
                               session=session)
        for mode in ("dense", "sparse")
    }

    # deployment cold-path costs for one headline chunk (the warm
    # upload_init_s alone hides the first start's nvcc bill)
    cold = None
    if cfg.cold_start:
        cold = measure_cold_start(engine, queries, ks[0], cfg.batch, log=log)
        if cold is not None:
            cold["upload_init_warm_s"] = round(upload_s, 1)

    # rows of the JAX harness that need modules not ported yet: none
    not_ported: dict[str, str] = {}

    # the memory rows: the same corpus at three points of the memory/speed
    # dial, "parity" (hot_tokens=0, the ELL-only floor), "mid"
    # (overhead_target=3.0, the user-facing budget knob) and "speed" (the
    # headline engine)
    parity = None
    trade = None
    engine_name = type(engine).__name__
    engine_hot_h = getattr(engine, "hot_h", 0)
    if cfg.memory_parity and isinstance(engine, SparseEngine):
        head_step = rows[ks[0]].get("device_step_ms")
        head_recall = rows[ks[0]]["recall_vs_reference"]
        del engine  # free the hot tier before the second resident index
        _free(session)
        k0 = ks[0]
        nb = min(cfg.baseline_queries, len(queries))
        pref_docs, _ = ref.search(queries[:nb], top_k=k0)
        trade = []
        for point, build_kw in (("parity", {"hot_tokens": 0}),
                                ("mid", {"overhead_target": 3.0})):
            peng = SparseEngine.from_scored_index(
                index, session=session,
                max_buckets=kwargs.get("max_buckets", 4), **build_kw)
            pstep = measure_device_step_ms(peng, queries, k0,
                                           batch=cfg.batch)
            pdocs, _ = peng.search(queries[:nb], top_k=k0)
            pmem = index_memory_stats(index, peng)
            row = {
                "point": point,
                **build_kw,
                "hot_h": peng.hot_h,
                "top_k": k0,
                "device_step_ms": None if pstep is None else round(pstep, 2),
                "recall_vs_reference": round(
                    recall_at_k(np.asarray(pdocs), pref_docs), 4),
                "index_memory": pmem.as_dict(),
            }
            trade.append(row)
            log(f"[bench] memory-trade {point}: "
                f"overhead_ratio={pmem.as_dict().get('overhead_ratio')} "
                f"hot_h={peng.hot_h} device_step={row['device_step_ms']}ms "
                f"recall@{k0}={row['recall_vs_reference']}")
            if point == "parity":
                parity = {key: row[key] for key in (
                    "top_k", "device_step_ms", "recall_vs_reference",
                    "index_memory")}
            del peng
            _free(session)
        trade.append({
            "point": "speed",
            "hot_h": engine_hot_h,
            "top_k": k0,
            "device_step_ms": head_step,
            "recall_vs_reference": head_recall,
            "index_memory": mem.as_dict(),
        })
    else:
        # free the headline engine before any later row uploads a second
        # resident index
        del engine
        _free(session)

    longdoc = None
    if cfg.longdoc_docs:
        longdoc = _measure_longdoc(cfg, queries, log, session)

    sharded = None
    if cfg.sharded_docs:
        sharded = _measure_sharded(cfg, log, session)

    scaling = None
    # headline-scale runs only, as in JAX (2 = force)
    if cfg.shard_scaling and (cfg.num_docs >= 100_000
                              or cfg.shard_scaling >= 2):
        scaling = _measure_shard_scaling(cfg, log, session)
    omitted = dict(OMITTED)
    if session.device.type != "cuda":
        omitted.update(CARD_ONLY)
    device = {"type": session.device.type}
    if session.device.type == "cuda":
        device["name"] = torch.cuda.get_device_name(session.device)

    return {
        "metric": "bm25_query_throughput",
        "value": head["qps"],
        "unit": "queries/sec",
        "vs_baseline": head["vs_baseline"],
        "extra": {
            "num_docs": cfg.num_docs,
            "vocab": cfg.vocab,
            "batch": cfg.batch,
            "device": device,
            "headline": head,
            "secondary": [rows[k] for k in ks[1:]],
            # the indexing pipeline only (build_scored_index_flat); corpus
            # synthesis is reported separately
            "index_build_docs_per_sec": round(cfg.num_docs / build_s, 1),
            "index_build_s": timings["index_build_s"],
            "corpus_synthesis_s": timings["synthesis_s"],
            "upload_init_s": round(upload_s, 1),
            "engine": engine_name,
            "hot_tokens": engine_hot_h,
            **({"layout": layout} if layout is not None else {}),
            "index_memory": mem.as_dict(),
            "beir_synthetic_eval": beir,
            **({"cold_start": cold} if cold is not None else {}),
            **({"memory_parity": parity} if parity is not None else {}),
            **({"memory_trade": trade} if trade is not None else {}),
            **({"longdoc": longdoc} if longdoc is not None else {}),
            **({"sharded": sharded} if sharded is not None else {}),
            **({"shard_scaling": scaling} if scaling is not None else {}),
            "omitted": omitted,
            "not_ported": not_ported,
            **({"warning": warning} if warning is not None else {}),
        },
    }


def main(argv=None) -> int:
    from bm25_tpu_torch.runtime.session import Session

    ap = argparse.ArgumentParser(
        description="the query benchmark: the full record, then the "
                    "compact headline as the last line (BM25_BENCH_<FIELD> "
                    "overrides BenchConfig)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    result = run(BenchConfig.from_env(),
                 log=lambda *a: print(*a, file=sys.stderr),
                 session=Session(args.device))
    print(json.dumps(result))
    print(json.dumps(compact_headline(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
