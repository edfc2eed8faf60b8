#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device, ``nvcc`` and the repository's sources; it imports no JAX.

Phases (any failure raises and exits nonzero; nothing is caught):

1. environment: the card's name and power limit;
2. build: every CUDA kernel compiles from ``bm25_tpu_torch/csrc``, one
   nvcc per source, all started together;
3. kernels vs their plain PyTorch twins on the card, at small edge-case
   shapes: B1/B2 (pad rows, pad/OOV ids, ragged Q, a bucket wider than 512
   slots, with and without the hot tier and per-token weights: the
   ELL-only base bit-equal, hot results within 2e-5 * max(1, |row max|));
   B3 (empty grids, ragged D, bf16, weights, duplicate ids: bit-equal);
   B4 (ties inside and across chunks, -inf rows, k = N, a ragged last
   chunk, a merge in two passes, k wider than a stage-1 chunk (the tree,
   counted), largest=False: values and indices equal to the twin and the
   tree); B5 (membership, determinism per seed, greedy
   at temperature -> 0, the twin's choices up to float noise in z);
4. sparse main path: ``SparseEngine`` at the benchmark shape (524,288
   docs, 32,768-token Zipf vocabulary, hot_tokens=1024, 2 buckets) built
   and searched with 512 queries of 8 tokens at k=1000 and k=100, checked
   against ``ReferenceEngine`` under the fuzz campaign's comparator, with
   B1/B2's launch counts taken over this phase alone; then each kernel
   against its twin at the main path's own shapes, both timed;
5. dense main path: ``create_engine(mode="auto")`` over the 131,072-doc
   corpus must pick ``DenseEngine`` (a 17.2 GB f32 table); 512 x 8 queries
   at k=1000 and k=100, plus a weighted batch and a half-masked batch,
   against ``ReferenceEngine``, with B3's launch count over this phase;
   then 64 queries with ``scoring="matmul"`` while TF32 is allowed
   process-wide, which must still match at the f32 tolerance;
6. op-library main path: ``top_k(..., implementation="pallas")`` (B4) on
   the dense step's (512, 131,072) masked scores at k=1000 and k=100, and
   ``top_k_fused_sampling(..., implementation="pallas")`` (B5 on (512,
   100) logits), with B4/B5's launch counts over this phase; then B3, B4
   and B5 against their twins at these shapes, and B4 on (512, 524,288)
   random scores at k=1000, all timed;
7. library entry: ``Retriever`` over a small corpus with the engine
   ``create_engine`` picks (dense), then ``Retriever.fit`` building the
   port's engine itself, both against ``ReferenceEngine``;
8. op library, matmul and the named ops: ``custom("matrix_multiplication",
   ...)`` (B6) with ``algorithm="naive"``, ``"optimized"`` and ``"xla"`` at
   the reference's 1028^3 in f32 and bf16, and ``bench_matmul()`` there
   (its JSON on one line), with B6's launch counts over these calls; then
   both kernels against their twin (bit-equal) and against ``"xla"``
   (within ``2 K 2^-24 (|A| @ |B|)``, plus one bf16 ulp for bf16), all
   timed; ``"optimized"`` at 4096^3 f32 against ``"xla"``; B6 edge cases
   (ragged M, N and K, 1 x 1 x 1, empty M or N, K = 0, bf16, every tile
   override, the analytic corner case, which is exact); and each
   gather/scatter/shape/union op through ``custom`` on CUDA tensors, equal
   to the same call on CPU tensors;
9. selection gather (E5-E7): the three ``super_row_gather`` kernels
   against their twin (bit-equal) at edge cases (rows 0 and R - 1, the
   window clamped to R - W, duplicates, a span wider than the window so
   the fallback tile runs and is counted, KP off a multiple of 32, H = 8
   resident, and R < W and an H above the shared-memory limit, which must
   raise); then ``gather_bench``'s three experiments at the scripts' shapes
   (inputs from ``default_rng(0)``), with the kernels' launch counts over
   these runs, each kernel timed beside its twin and ``torch.gather``;
10. matmul schedules (E1-E4): the four ``ops/matmul_schedules.py`` kernels
   against their twins at edge cases (ragged M, N and K, K off every K step,
   1 x 1 x 1, the analytic corner case: E1-E3 bit-equal at every tile,
   strip height and stage count; E4's TF32 and bf16 modes within
   ``K 2^-22 (|A^| @ |B^|)``; the E2 strip that does not fit shared memory
   and E3 on K % 4 != 0, which must raise); then ``bench_schedules``'s sweep
   at the scripts' sizes 1028, 2048 and 4096 (each variant checked against
   ``torch.matmul`` or the float64 product before it is timed), with the
   kernels' launches counted over the sweep; then every variant against its
   twin at 1028^3 and 2048^3 (bit-equal, or within E4's bound);
11. entry points, on the card: the port's CLI (``index``, ``info``,
   ``query`` with term boosts under ``--engine dense`` and ``sparse``,
   ``demo``, ``eval`` on ``tests/data/mini_beir``, ``bench --suite matmul``)
   against the same commands with ``--device cpu`` (no stemmer: the card's
   machine has no nltk); ``compat.BM25`` on the 13-doc corpus against the
   oracle; ``compat.BM25v`` over phase 4's 524,288-doc CSC, which must route
   to ``SparseEngine``: 512 x 8 queries at k=1000, a weighted batch (also
   on phase 4's hot-tier layout) and ``get_scores`` against
   ``ReferenceEngine``.

After the last phase no module of the JAX package may have been imported.
The last lines are the kernels' JSON record (each kernel's launches on its
main path, max error against its twin, kernel / twin / one-call library ms
and its bound: the larger of the bytes it must move over 3.35 TB/s and
its operations over the peak rate of their type), and the card line from
nvidia-smi; the very last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "ell_score_fused": "bm25_tpu_torch/csrc/ell_score.cu",
    "ell_score": "bm25_tpu_torch/csrc/ell_score.cu",
    "gather_add_rows": "bm25_tpu_torch/csrc/gather_rows.cu",
    "top_k_two_stage": "bm25_tpu_torch/csrc/topk.cu",
    "gumbel_choice": "bm25_tpu_torch/csrc/topk.cu",
    "matmul_naive": "bm25_tpu_torch/csrc/matmul.cu",
    "matmul_tiled": "bm25_tpu_torch/csrc/matmul.cu",
    "super_row_gather": "bm25_tpu_torch/csrc/super_row_gather.cu",
    "super_row_gather_window": "bm25_tpu_torch/csrc/super_row_gather.cu",
    "super_row_gather_resident": "bm25_tpu_torch/csrc/super_row_gather.cu",
    "matmul_sweep": "bm25_tpu_torch/csrc/matmul_schedules.cu",
    "matmul_row_strip": "bm25_tpu_torch/csrc/matmul_schedules.cu",
    "matmul_pipelined": "bm25_tpu_torch/csrc/matmul_schedules.cu",
    "matmul_mma": "bm25_tpu_torch/csrc/matmul_schedules.cu",
}
REPLACES = {
    "ell_score_fused": "bm25_tpu/ops/ell_score.py:314",
    "ell_score": "bm25_tpu/ops/ell_score.py:161",
    "gather_add_rows": "bm25_tpu/ops/gather_rows.py:56",
    "top_k_two_stage": "bm25_tpu/ops/topk.py:241",
    "gumbel_choice": "bm25_tpu/ops/topk.py:620",
    "matmul_naive": "bm25_tpu/ops/matmul.py:127",
    "matmul_tiled": "bm25_tpu/ops/matmul.py:127",
    "super_row_gather": "scripts/exp_r4_pallas_gather.py:64",
    "super_row_gather_window": "scripts/exp_r4_window_gather.py:87",
    "super_row_gather_resident": "scripts/exp_r4_dyngather.py:100",
    "matmul_sweep": "scripts/exp_r4_matmul_tiles3.py:57",
    "matmul_row_strip": "scripts/exp_r4_matmul_tiles4.py:48",
    "matmul_pipelined": "scripts/exp_r4_matmul_dma.py:76",
    "matmul_mma": "scripts/exp_r4_matmul_precision.py:85",
}
HOT_TOKENS = 1024
MAX_BUCKETS = 2
CHECKED_QUERIES = 64
DENSE_DOCS = 131072  # the JAX bench's sharded_docs corpus
SPARSE_DOCS = 524288  # BenchConfig's default corpus
MATMUL_N = 1028  # the reference's matmul benchmark: M = K = N
MATMUL_BIG = 4096
RESIDENT_H = 256  # the tallest of the dyngather tables that fits
SCHEDULE_SIZES = (1028, 2048, 4096)  # the matmul scripts' sizes
SCHEDULE_TWIN_SIZES = (1028, 2048)  # the twin is a loop over K
# H100 SXM data-sheet peaks: memory rate, f32 on the CUDA cores, bf16 on
# the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Logs a phase's wall seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f} s")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops=()) -> tuple[float, str]:
    """The least time (ms) the card could take for work that must move
    ``nbytes`` and do ``ops``, (count, peak rate per s) pairs, and which of
    the two bounds it."""
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = sum(n / rate for n, rate in ops) * 1e3
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_record(launches, err, ms, plain_ms, bnd, library_ms=None) -> dict:
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": library_ms}


def reset(*counters) -> None:
    for c in counters:
        for name in c:
            c[name] = 0


def compare(torch, got, want, exact: bool, what: str) -> float:
    """Kernel output vs plain twin: bit-equal, or within 2e-5 x the row's
    largest |value| (at least 1); -inf positions must agree.  Returns the
    largest absolute difference over finite entries."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    if exact:
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"{what}: {bad} entries differ (exact)")
        return 0.0
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin], want[~fin]):
        raise AssertionError(f"{what}: non-finite entries differ")
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(got))
    scale = torch.where(fin, want.abs(), torch.zeros_like(want))
    scale = scale.amax(dim=-1, keepdim=True).clamp_min(1.0)
    if not bool((diff <= 2e-5 * scale).all()):
        raise AssertionError(f"{what}: max |diff| {diff.max().item():.3e} "
                             "beyond 2e-5 x row scale")
    return float(diff.max().item())


def random_case(rng, q, t, rows, l_pad, vocab, h, pad_rows, weighted):
    """Random ELL bucket + queries (pad, OOV and duplicate ids) + hot tier;
    with weights, float hot counts become a bf16 high + residual pair."""
    fill = rng.integers(0, l_pad + 1, rows)
    tokT = np.full((l_pad, rows), -1, np.int32)
    valT = np.zeros((l_pad, rows), np.float32)
    for r in range(rows):
        tokT[: fill[r], r] = rng.choice(vocab, fill[r], replace=False)
        valT[: fill[r], r] = rng.standard_normal(fill[r]).astype(np.float32)
    ids = rng.integers(-1, vocab + 50, (q, t)).astype(np.int32)  # OOV too
    ids[0] = -1  # a fully padded query
    ids[1, :3] = ids[1, 0]  # duplicates
    w = rng.uniform(0.0, 3.0, (q, t)).astype(np.float32)
    hc = None
    if h:
        hc = np.zeros((q, h), np.float32)
        for qq in range(q):
            np.add.at(hc[qq], rng.integers(0, h, t), w[qq] if weighted else 1)
    dense = rng.standard_normal((h, rows)).astype(np.float32)
    did = np.arange(rows, dtype=np.int32)
    did[rows - pad_rows:] = -1
    return ids, tokT, valT, did, hc, dense, w if weighted else None


def phase_kernel_cases(torch, ops, split_bf16, dev) -> None:
    rng = np.random.default_rng(0)
    cases = [
        # q, t, rows, l_pad, vocab, h, pad_rows, weighted
        (37, 5, 1024, 24, 300, 0, 7, False),
        (37, 5, 1024, 24, 300, 40, 7, False),
        (16, 8, 512, 1208, 4000, 0, 0, False),  # slot-tiled: 3 tiles of 408
        (9, 3, 512, 1536, 4000, 8, 5, False),  # slot-tiled: 3 exact tiles
        (3, 8, 4096, 0, 10, 16, 100, False),  # no cold slots, hot only
        (37, 8, 1024, 24, 300, 0, 7, True),
        (37, 8, 1024, 24, 300, 40, 7, True),  # split hot counts
        (9, 3, 512, 1208, 4000, 8, 5, True),
    ]
    for q, t, rows, l_pad, vocab, h, pad_rows, weighted in cases:
        ids, tokT, valT, did, hc, dense, w = random_case(
            rng, q, t, rows, l_pad, vocab, h, pad_rows, weighted)
        ids_d = torch.from_numpy(ids).to(dev)
        tok_d = torch.from_numpy(tokT).to(dev) if l_pad else None
        val_d = torch.from_numpy(valT).to(dev) if l_pad else None
        did_d = torch.from_numpy(did).to(dev)
        args = [ids_d, tok_d, val_d, did_d]
        kw = {}
        if w is not None:
            kw["weights"] = torch.from_numpy(w).to(dev)
        if h:
            hc_hi, hc_lo = split_bf16(torch.from_numpy(hc).to(dev))
            args += [hc_hi, *split_bf16(torch.from_numpy(dense).to(dev))]
            if weighted:
                kw["hot_counts_lo"] = hc_lo
        name = (f"q={q} t={t} rows={rows} l_pad={l_pad} h={h}"
                f"{' weighted' if weighted else ''}")
        kb, kg = ops.ell_score_fused(*args, **kw)
        pb, pg = ops.ell_score_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        exact = not h
        err = max(compare(torch, kb, pb, exact, f"B1 base {name}"),
                  compare(torch, kg, pg, exact, f"B1 gmax {name}"))
        if l_pad:
            compare(torch, ops.ell_score(*args[:3]),
                    ops.ell_score_plain(*args[:3]), True, f"B2 {name}")
        log(f"[kernels] {name}: B1 {'bit-equal' if exact else 'max_abs_err'}"
            f"{'' if exact else f' {err:.3e}'}"
            + (", B2 bit-equal" if l_pad else ""))


def phase_gather_cases(torch, gr, dev) -> None:
    """B3 vs its twin: empty grids, ragged D, bf16, weights, duplicates."""
    rng = np.random.default_rng(1)
    cases = [
        # v, d, q, t, dtype, weighted
        (50, 1024, 13, 8, torch.float32, False),
        (50, 1024, 13, 8, torch.float32, True),
        (50, 1001, 7, 5, torch.float32, False),  # ragged D: scalar path
        (50, 1001, 7, 5, torch.float32, True),
        (50, 2048, 9, 8, torch.bfloat16, False),
        (50, 2048, 9, 8, torch.bfloat16, True),
        (30, 333, 4, 3, torch.bfloat16, True),
        (10, 512, 5, 0, torch.float32, False),  # T = 0: zeros
        (10, 512, 0, 4, torch.float32, False),  # Q = 0: empty
    ]
    for v, d, q, t, dtype, weighted in cases:
        table = torch.from_numpy(rng.standard_normal((v, d)).astype(
            np.float32)).to(dtype).to(dev)
        ids = rng.integers(0, v, (q, t)).astype(np.int32)
        if q > 1 and t > 2:
            ids[1, :3] = ids[1, 0]  # duplicate ids
        ids = torch.from_numpy(ids).to(dev)
        w = (torch.from_numpy(rng.uniform(-2.0, 3.0, (q, t)).astype(
            np.float32)).to(dev) if weighted else None)
        got = gr.gather_add_rows(table, ids, w)
        compare(torch, got, gr.gather_add_rows_plain(table, ids, w), True,
                f"B3 v={v} d={d} q={q} t={t}")
        if t == 0 and got.any():
            raise AssertionError("B3 with T=0 is not all zeros")
        log(f"[kernels] B3 table ({v}, {d}) {str(dtype)[6:]} ids ({q}, {t})"
            f"{' weighted' if weighted else ''}: bit-equal to twin")


def phase_topk_cases(torch, tk, dev) -> None:
    """B4 vs its twin and the tree: ties, -inf rows, tail chunks, k = N,
    a merge in two passes, k wider than a stage-1 chunk (counted tree
    calls), largest=False."""
    rng = np.random.default_rng(2)
    cases = [(5, 100, 7), (4, 16384, 100), (4, 16385, 64), (3, 40000, 16),
             (6, 131072, 1000), (3, 300, 300), (2, 50000, 1),
             (3, 131072, 7300)]
    for b, n, k in cases:
        x = rng.integers(0, 6, (b, n)).astype(np.float32)  # heavy ties
        x[0] = -np.inf  # exhausted row
        x[1, ::3] = -np.inf
        if b > 2:
            x[2, : n // 2] = -np.inf
        x = torch.from_numpy(x).to(dev)
        v, i = tk.top_k_two_stage(x, k)
        for name, (wv, wi) in (("twin", tk.topk_two_stage_plain(x, k)),
                               ("tree", tk.top_k_tree(x, k))):
            compare(torch, v, wv, True, f"B4 ({b}, {n}) k={k} vs {name}")
            compare(torch, i, wi, True, f"B4 idx ({b}, {n}) k={k} vs {name}")
        if any(len(set(r)) != k for r in i.cpu().numpy().tolist()):
            raise AssertionError(f"B4 ({b}, {n}) k={k}: repeated indices")
        log(f"[kernels] B4 ({b}, {n}) k={k} (plan {tk.two_stage_plan(n, k)})"
            ": equal to twin and tree, distinct indices")
    x = torch.from_numpy(rng.standard_normal((4, 40000)).astype(
        np.float32).round(1)).to(dev)
    for k in (50, 6000, 14000):
        tree_before = tk.tree_calls["top_k_two_stage"]
        v, i = tk.top_k(x, k, largest=False, implementation="pallas")
        tv, ti = tk.top_k(x, k, largest=False, implementation="tree")
        compare(torch, v, tv, True, f"B4 largest=False k={k}")
        compare(torch, i, ti, True, f"B4 idx largest=False k={k}")
        beyond = tk.two_stage_plan(40000, k) is None
        if tk.tree_calls["top_k_two_stage"] != tree_before + beyond:
            raise AssertionError("B4's tree calls are not counted")
        log(f"[kernels] B4 largest=False (4, 40000) k={k}: equal to the tree"
            + (" (k wider than a stage-1 chunk: served by the tree, counted)"
               if beyond else f" (plan {tk.two_stage_plan(40000, k)})"))


def choice_err(torch, tk, logits, seed, got, want) -> float:
    """|z(got) - z(want)| on the twin's z: 0 where the choices agree.
    Choices may differ only where the top two z are within float noise
    (1e-5 x max(1, |z|)): logf on the card vs torch.log."""
    z = logits + tk.gumbel_noise_plain(seed, *logits.shape, logits.device)
    zg = z.gather(1, got[:, None])[:, 0]
    zw = z.gather(1, want[:, None])[:, 0]
    diff = (zg - zw).abs()
    if not bool((diff <= 1e-5 * zw.abs().clamp_min(1.0)).all()):
        raise AssertionError(f"B5: choices differ beyond float noise "
                             f"({int((got != want).sum())} rows)")
    return float(diff.max().item())


def phase_gumbel_cases(torch, tk, dev) -> None:
    """B5: twin agreement, determinism per seed, membership, greedy."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((300, 100)).astype(
        np.float32)).to(dev)
    logits[0, 50:] = float("-inf")
    for seed in (0, 1, 2**32 - 1):
        got = tk.gumbel_choice(logits, seed)
        if not torch.equal(got, tk.gumbel_choice(logits, seed)):
            raise AssertionError("B5: same seed, different choices")
        choice_err(torch, tk, logits, seed, got,
                   tk.gumbel_choice_plain(logits, seed))
        if int(got[0]) >= 50:
            raise AssertionError("B5 chose a -inf column")
    x = torch.from_numpy(rng.random((64, 2000), np.float32)).to(dev)
    _, ti = tk.top_k_tree(x, 10)
    gen = torch.Generator(device=dev)
    _, s1 = tk.top_k_fused_sampling(x, 10, implementation="pallas",
                                    generator=gen.manual_seed(7))
    _, s2 = tk.top_k_fused_sampling(x, 10, implementation="pallas",
                                    generator=gen.manual_seed(7))
    if not torch.equal(s1, s2) or not bool((s1 == ti).any(dim=1).all()):
        raise AssertionError("B5 sampling: not deterministic per seed, or "
                             "a choice outside the top k")
    _, greedy = tk.top_k_fused_sampling(x, 10, temperature=0.0,
                                        implementation="pallas",
                                        generator=gen)
    if not torch.equal(greedy[:, 0], ti[:, 0]):
        raise AssertionError("B5 at temperature 0 is not greedy")
    log("[kernels] B5: twin's choices up to float noise, deterministic per "
        "seed, members of the top k, greedy at temperature 0")


def sparse_main(torch, dev, cfg, ops, session, record):
    """Phase 4: the sparse engine at the benchmark shape; returns its
    index."""
    from bm25_tpu_torch import ReferenceEngine, create_engine
    from bm25_tpu_torch.bench import make_queries, make_synthetic_index
    from bm25_tpu_torch.models.sparse import (hot_counts_for,
                                              hot_ell_for_rows,
                                              split_hot_cold_csr)
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    t0 = time.perf_counter()
    index = make_synthetic_index(cfg)
    queries = make_queries(cfg)[: cfg.batch]
    log(f"[sparse] corpus {index.num_docs} docs, vocab {index.vocab_size}, "
        f"{index.nnz} postings ({time.perf_counter() - t0:.1f} s); "
        f"{len(queries)} queries x {queries.shape[1]} tokens")
    reset(ops.launches, ops.plain_calls)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = create_engine(
        index, mode="sparse", hot_tokens=HOT_TOKENS,
        hot_budget_bytes=HOT_TOKENS * index.num_docs * 4,
        max_buckets=MAX_BUCKETS, session=session)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    if engine.hot_h != HOT_TOKENS:
        raise AssertionError(f"hot_h {engine.hot_h} != {HOT_TOKENS}")
    widths = [tuple(b["tokT"].shape) for b in engine.buckets if "tokT" in b]
    log(f"[sparse] engine built in {engine_s:.2f} s: hot_h={engine.hot_h}, "
        f"buckets (L, rows) {widths}, device bytes {engine.device_bytes()}")
    ref = ReferenceEngine.from_scored_index(index)
    for k in (cfg.top_k, cfg.top_k2):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            docs, scores = engine.search(queries, top_k=k)  # synchronises
            times.append((time.perf_counter() - t0) * 1e3)
        if docs.shape != (len(queries), k) or not np.isfinite(scores).all():
            raise AssertionError(f"k={k}: bad result {docs.shape}")
        od, os_ = ref.search(queries[:CHECKED_QUERIES], top_k=k)
        assert_matches_oracle(docs[:CHECKED_QUERIES],
                              scores[:CHECKED_QUERIES], od, os_)
        log(f"[sparse] k={k}: {len(queries)}-query batch "
            f"{statistics.median(times):.2f} ms median of 5 "
            f"(runs {', '.join(f'{x:.2f}' for x in times)} ms); first "
            f"{CHECKED_QUERIES} queries match ReferenceEngine")
    launches, plain = dict(ops.launches), dict(ops.plain_calls)
    log(f"[sparse] kernel launches {launches}, plain twin runs {plain}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    if not all(launches.values()) or any(plain.values()):
        raise AssertionError("the sparse path did not run every kernel, or "
                             "ran a plain twin")

    # each kernel vs its twin at the main path's shapes: B1 on every
    # bucket (its ms is the batch's total), B2 on bucket 0's hot ELL
    chunk = engine.plan_chunks(queries)[0][1]
    ids = session.put(chunk)
    hc, _ = hot_counts_for(ids, engine.hot_table, engine.hot_h)
    b1_err = b1_ms = b1_plain_ms = 0.0
    # B1's bound per batch: every ELL input, the hot rows some query uses
    # (the kernel skips the others), the outputs; one FMA per matching cold
    # posting (f32) and two bf16 products per used (query, hot token, row)
    hot_used = int((hc != 0).any(dim=0).sum())
    hot_pairs = int((hc != 0).sum())
    cold = chunk[(chunk >= 0)]
    cold = cold[session.get(engine.hot_table)[cold] < 0]
    cold_postings = int(np.diff(index.indptr.astype(np.int64))[cold].sum())
    b1_bytes = b1_ops = 0
    for i, b in enumerate(engine.buckets):
        rows = b["doc_ids"].shape[0]
        b1_bytes += (nbytes(ids, b["tokT"], b["valT"], b["doc_ids"], hc)
                     + 2 * hot_used * rows * 2 + chunk.shape[0] * rows * 4
                     + chunk.shape[0] * (rows // 8) * 4)
        b1_ops += 2 * 2 * hot_pairs * rows
        args = (ids, b["tokT"], b["valT"], b["doc_ids"], hc, b["hotT"],
                b["hotLo"])
        compare(torch, ops.ell_score_fused(*args[:4])[0],
                ops.ell_score_fused_plain(*args[:4])[0], True,
                f"B1 ELL-only base, bucket {i}")
        b1_err = max([b1_err] + [
            compare(torch, x, y, False, f"B1 {n}, bucket {i}")
            for n, x, y in zip(("base", "gmax"), ops.ell_score_fused(*args),
                               ops.ell_score_fused_plain(*args))])
        ms = cuda_ms(torch, lambda: ops.ell_score_fused(*args), 10)
        ell_ms = cuda_ms(torch, lambda: ops.ell_score_fused(*args[:4]), 10)
        plain_ms = cuda_ms(torch, lambda: ops.ell_score_fused_plain(*args), 2)
        log(f"[kernels] B1 at ids {tuple(ids.shape)} x bucket {i} "
            f"{tuple(b['tokT'].shape)} + hot {engine.hot_h}: kernel "
            f"{ms:.3f} ms ({ell_ms:.3f} ms without the hot tier), plain "
            f"{plain_ms:.3f} ms")
        b1_ms += ms
        b1_plain_ms += plain_ms
    b0 = engine.buckets[0]
    hot_ids, _, hot_csr = split_hot_cold_csr(index, engine.hot_h)
    htok, hval = hot_ell_for_rows(hot_csr, session.get(b0["doc_ids"]))
    b2_args = (session.put(hot_ids.reshape(-1, 1)), session.put(htok),
               session.put(hval))
    b2_err = compare(torch, ops.ell_score(*b2_args),
                     ops.ell_score_plain(*b2_args), True, "B2, main shape")
    b2_ms = cuda_ms(torch, lambda: ops.ell_score(*b2_args), 10)
    b2_bound = bound(nbytes(*b2_args) + engine.hot_h * htok.shape[1] * 4,
                     [(2 * int((b2_args[1] >= 0).sum()), F32_OPS_PER_S)])
    b2_plain_ms = cuda_ms(torch, lambda: ops.ell_score_plain(*b2_args), 3)
    log(f"[kernels] B1 per batch (all buckets): kernel {b1_ms:.3f} ms, "
        f"plain {b1_plain_ms:.3f} ms, max_abs_err {b1_err:.3e}")
    log(f"[kernels] B2 at hot ids ({engine.hot_h}, 1) x hot ELL "
        f"{tuple(htok.shape)}: kernel {b2_ms:.3f} ms, plain "
        f"{b2_plain_ms:.3f} ms, bit-equal")
    record["ell_score_fused"] = kernel_record(
        launches["ell_score_fused"], b1_err, b1_ms, b1_plain_ms,
        bound(b1_bytes, [(2 * cold_postings, F32_OPS_PER_S),
                         (b1_ops, BF16_TC_OPS_PER_S)]))
    record["ell_score"] = kernel_record(launches["ell_score"], b2_err,
                                        b2_ms, b2_plain_ms, b2_bound)
    return index


def dense_main(torch, dev, cfg, gr, tk, session, record) -> None:
    """Phases 5 and 6: the dense engine, then the top-k op library on the
    dense step's scores, then B3-B5 against their twins there."""
    from bm25_tpu_torch.eval import engine_device_bytes
    from bm25_tpu_torch import (DenseEngine, ReferenceEngine, create_engine,
                                top_k)
    from bm25_tpu_torch.bench import make_queries, make_synthetic_index
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    with Phase("5. dense main path"):
        t0 = time.perf_counter()
        index = make_synthetic_index(cfg)
        queries = make_queries(cfg)[: cfg.batch]
        rng = np.random.default_rng(4)
        weights = rng.uniform(0.1, 3.0, queries.shape).astype(np.float32)
        doc_mask = rng.random(index.num_docs) < 0.5
        log(f"[dense] corpus {index.num_docs} docs, vocab "
            f"{index.vocab_size}, {index.nnz} postings "
            f"({time.perf_counter() - t0:.1f} s); {len(queries)} queries x "
            f"{queries.shape[1]} tokens")
        reset(gr.launches, gr.plain_calls)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = create_engine(index, session=session)  # mode="auto"
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if not isinstance(engine, DenseEngine):
            raise AssertionError(f"auto picked {type(engine).__name__}, not "
                                 "DenseEngine")
        log(f"[dense] create_engine(mode='auto') picked DenseEngine in "
            f"{build_s:.2f} s: table {tuple(engine.st.shape)} "
            f"{engine.st.dtype}, engine_device_bytes "
            f"{engine_device_bytes(engine)} B")
        ref = ReferenceEngine.from_scored_index(index)
        for k in (cfg.top_k, cfg.top_k2):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                docs, scores = engine.search(queries, top_k=k)
                times.append((time.perf_counter() - t0) * 1e3)
            if docs.shape != (len(queries), k) or \
                    not np.isfinite(scores).all():
                raise AssertionError(f"k={k}: bad result {docs.shape}")
            assert_matches_oracle(
                docs[:CHECKED_QUERIES], scores[:CHECKED_QUERIES],
                *ref.search(queries[:CHECKED_QUERIES], top_k=k))
            log(f"[dense] k={k}: {len(queries)}-query batch "
                f"{statistics.median(times):.2f} ms median of 5 (runs "
                f"{', '.join(f'{x:.2f}' for x in times)} ms); first "
                f"{CHECKED_QUERIES} queries match ReferenceEngine")
        sub = slice(0, CHECKED_QUERIES)
        k = cfg.top_k
        docs, scores = engine.search(queries, top_k=k, weights=weights)
        assert_matches_oracle(docs[sub], scores[sub], *ref.search(
            queries[sub], top_k=k, weights=weights[sub]))
        docs, scores = engine.search(queries, top_k=k, doc_mask=doc_mask)
        assert_matches_oracle(docs[sub], scores[sub], *ref.search(
            queries[sub], top_k=k, doc_mask=doc_mask))
        if not doc_mask[docs[docs >= 0]].all():
            raise AssertionError("a masked doc was returned")
        log(f"[dense] k={k}: a weighted batch and a half-masked batch "
            f"({int(doc_mask.sum())} docs eligible) match ReferenceEngine")
        b3_launches = gr.launches["gather_add_rows"]
        log(f"[dense] B3 launches {b3_launches}, plain twin runs "
            f"{gr.plain_calls['gather_add_rows']}, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B")
        if b3_launches == 0 or gr.plain_calls["gather_add_rows"]:
            raise AssertionError("the dense path did not run B3, or ran its "
                                 "plain twin")

        # matmul scoring while TF32 is allowed process-wide: the step pins
        # its product to full f32 and leaves the setting as it found it
        matmul = torch.backends.cuda.matmul
        engine.scoring = "matmul"
        matmul.allow_tf32 = True
        try:
            t0 = time.perf_counter()
            docs, scores = engine.search(queries[sub], top_k=k)
            mm_ms = (time.perf_counter() - t0) * 1e3
            left_on = matmul.allow_tf32
        finally:
            matmul.allow_tf32 = False
            engine.scoring = "gather"
        assert_matches_oracle(docs, scores,
                              *ref.search(queries[sub], top_k=k))
        if not left_on:
            raise AssertionError("matmul scoring did not restore TF32")
        log(f"[dense] k={k}: scoring='matmul' with TF32 allowed, "
            f"{CHECKED_QUERIES} queries in {mm_ms:.2f} ms (first run), "
            "match ReferenceEngine at the f32 tolerance; TF32 setting "
            "restored")

    # the dense step's masked scores, the op library's input
    ids = session.put(queries)
    st = engine.st
    safe = torch.where(ids >= 0, ids, st.shape[0] - 1).to(torch.int32)
    scores = gr.gather_add_rows(st, safe)
    elig = torch.arange(st.shape[1], device=dev) < index.num_docs
    masked = torch.where(elig, scores, float("-inf"))

    with Phase("6. op-library main path"):
        reset(tk.launches, tk.plain_calls, tk.tree_calls)
        gen = torch.Generator(device=dev).manual_seed(0)
        picked = {}
        for k in (cfg.top_k, cfg.top_k2):
            picked[k] = top_k(masked, k, implementation="pallas")
        vals, sampled = tk.top_k_fused_sampling(
            masked, cfg.top_k2, implementation="pallas", generator=gen)
        torch.cuda.synchronize()
        op_launches = {n: tk.launches[n] for n in tk.launches}
        log(f"[ops] top_k(pallas) at k={cfg.top_k} and k={cfg.top_k2} and "
            f"top_k_fused_sampling(pallas) at k={cfg.top_k2}: launches "
            f"{op_launches}, plain twin runs {tk.plain_calls}, tree calls "
            f"{tk.tree_calls}")
        if not all(op_launches.values()) or any(tk.plain_calls.values()) \
                or tk.tree_calls["top_k_two_stage"]:
            raise AssertionError("the op library did not run B4 and B5 on "
                                 "the card")
        for k, (v, i) in picked.items():
            tv, ti = tk.select_top_k(masked, k)
            compare(torch, v, tv, True, f"B4 k={k} vs select_top_k")
            compare(torch, i, ti, True, f"B4 idx k={k} vs select_top_k")
        if not bool((sampled == picked[cfg.top_k2][1]).any(dim=1).all()):
            raise AssertionError("a sampled doc is outside the top k")
        log(f"[ops] B4 equals select_top_k in values and indices at both "
            "k; every sample is a top-k doc")

    with Phase("6b. kernels vs twins at the main path's shapes"):
        w = session.put(weights)
        compare(torch, gr.gather_add_rows(st, safe),
                gr.gather_add_rows_plain(st, safe), True, "B3, main shape")
        compare(torch, gr.gather_add_rows(st, safe, w),
                gr.gather_add_rows_plain(st, safe, w), True,
                "B3 weighted, main shape")
        b3_ms = cuda_ms(torch, lambda: gr.gather_add_rows(st, safe), 20)
        b3w_ms = cuda_ms(torch, lambda: gr.gather_add_rows(st, safe, w), 20)
        b3_plain_ms = cuda_ms(torch, lambda: gr.gather_add_rows_plain(st,
                                                                     safe), 5)
        # the library's one call: a sum of embedding rows per query
        ids64 = safe.long()
        bag = torch.nn.functional.embedding_bag(ids64, st, mode="sum")
        torch.testing.assert_close(bag, scores, rtol=1e-5, atol=1e-5)
        b3_lib_ms = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(
            ids64, st, mode="sum"), 20)
        del bag, ids64
        # each distinct row read once, the ids, the output written once
        moved = (torch.unique(safe).numel() * st.shape[1] * 4
                 + nbytes(safe, scores))
        b3_bound = bound(moved, [(safe.numel() * st.shape[1],
                                  F32_OPS_PER_S)])
        log(f"[kernels] B3 at ids {tuple(ids.shape)} x table "
            f"{tuple(st.shape)}: kernel {b3_ms:.3f} ms ({moved / b3_ms / 1e6:.0f}"
            f" GB/s of {moved} B needed; bound {b3_bound[0]:.3f} ms), "
            f"weighted {b3w_ms:.3f} ms, plain {b3_plain_ms:.3f} ms, "
            f"embedding_bag {b3_lib_ms:.3f} ms; bit-equal (both)")
        b4 = {}
        for k in (cfg.top_k, cfg.top_k2):
            pv, pi = tk.topk_two_stage_plain(masked, k)
            kv, ki = tk.top_k_two_stage(masked, k)
            err = compare(torch, kv, pv, True, f"B4 k={k} vs twin")
            compare(torch, ki, pi, True, f"B4 idx k={k} vs twin")
            ms = cuda_ms(torch, lambda: tk.top_k_two_stage(masked, k), 5)
            tree_ms = cuda_ms(torch, lambda: tk.select_top_k(masked, k), 5)
            plain_ms = cuda_ms(torch, lambda: tk.topk_two_stage_plain(masked,
                                                                      k), 1)
            lib_ms = cuda_ms(torch, lambda: torch.topk(masked, k), 5)
            b4[k] = (err, ms, plain_ms, bound(nbytes(masked, kv, ki)), lib_ms)
            log(f"[kernels] B4 at ({masked.shape[0]}, {masked.shape[1]}) "
                f"k={k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, tree "
                f"(select_top_k) {tree_ms:.3f} ms, torch.topk {lib_ms:.3f} "
                f"ms, bound {b4[k][3][0]:.4f} ms; equal to the twin")
        # B4 at the sparse corpus's width: 32 stage-1 chunks, and a merge
        # of 32,000 candidates in one block
        k = cfg.top_k
        wide = torch.rand((masked.shape[0], SPARSE_DOCS), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
        kv, ki = tk.top_k_two_stage(wide, k)
        for name, (wv, wi) in (("twin", tk.topk_two_stage_plain(wide, k)),
                               ("tree", tk.select_top_k(wide, k))):
            compare(torch, kv, wv, True, f"B4 wide k={k} vs {name}")
            compare(torch, ki, wi, True, f"B4 wide idx k={k} vs {name}")
        ms = cuda_ms(torch, lambda: tk.top_k_two_stage(wide, k), 3)
        tree_ms = cuda_ms(torch, lambda: tk.select_top_k(wide, k), 3)
        log(f"[kernels] B4 at ({wide.shape[0]}, {wide.shape[1]}) random "
            f"k={k} (plan {tk.two_stage_plan(wide.shape[1], k)}): kernel "
            f"{ms:.3f} ms, tree (select_top_k) {tree_ms:.3f} ms; equal to "
            "the twin and the tree")
        del wide, kv, ki
        logits = (vals - vals[:, :1]).contiguous()
        b5_err = choice_err(torch, tk, logits, 12345,
                            tk.gumbel_choice(logits, 12345),
                            tk.gumbel_choice_plain(logits, 12345))
        b5_ms = cuda_ms(torch, lambda: tk.gumbel_choice(logits, 12345), 20)
        b5_plain_ms = cuda_ms(torch, lambda: tk.gumbel_choice_plain(logits,
                                                                    12345), 5)
        log(f"[kernels] B5 at logits {tuple(logits.shape)}: kernel "
            f"{b5_ms:.4f} ms, plain {b5_plain_ms:.4f} ms, max z gap of "
            f"differing choices {b5_err:.3e}")
    record["gather_add_rows"] = kernel_record(
        b3_launches, 0.0, b3_ms, b3_plain_ms, b3_bound, b3_lib_ms)
    record["top_k_two_stage"] = kernel_record(
        op_launches["top_k_two_stage"], *b4[cfg.top_k])
    record["gumbel_choice"] = kernel_record(
        op_launches["gumbel_choice"], b5_err, b5_ms, b5_plain_ms,
        bound(nbytes(logits) + logits.shape[0] * 4))


def library_entry(session) -> None:
    """Phase 7: Retriever over a small corpus with the engine the library
    picks (``mode="auto"``: DenseEngine; hot_tokens is a sparse-only
    option and is filtered out)."""
    from bm25_tpu_torch import (DenseEngine, ReferenceEngine, Retriever,
                                Tokenizer, build_index, create_engine)
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    corpus = [
        "a cat is a feline and likes to purr",
        "a dog is the human's best friend and loves to play",
        "a bird is a beautiful animal that can fly",
        "a fish is a creature that lives in water and swims",
        "the quick brown fox jumps over the lazy dog",
        "the brown rabbit hops under the tall tree",
    ]
    tokenizer = Tokenizer(stemmer=None)  # the Snowball stemmer needs nltk
    small, _ = build_index(corpus, tokenizer=tokenizer)
    engine = create_engine(small, hot_tokens=4, session=session)
    if not isinstance(engine, DenseEngine):
        raise AssertionError(f"auto picked {type(engine).__name__}")
    retriever = Retriever(index=small, tokenizer=tokenizer, engine=engine)
    texts = ["does the fish purr like a cat?", "lazy brown dog", "zebra"]
    docs, scores = retriever.retrieve(texts, k=3)
    od, os_ = ReferenceEngine.from_scored_index(small).search(
        tokenizer.tokenize_queries(texts, small.vocab), top_k=3)
    assert_matches_oracle(docs, scores, od, os_)
    log(f"[library] Retriever with create_engine's DenseEngine: top docs "
        f"{docs[:, 0].tolist()} scores "
        f"{[round(float(s), 4) for s in scores[:, 0]]} match ReferenceEngine")
    fitted = Retriever.fit(corpus, tokenizer=tokenizer, session=session)
    if not isinstance(fitted.engine, DenseEngine) or \
            fitted.engine.st.device.type != "cuda":
        raise AssertionError(f"Retriever.fit built {type(fitted.engine)}")
    got = fitted.retrieve(texts, k=3)
    assert_matches_oracle(*got, od, os_)
    log(f"[library] Retriever.fit built the port's "
        f"{type(fitted.engine).__name__} on {fitted.engine.st.device}: "
        f"matches ReferenceEngine")


def order_bound(torch, got, want, a, b) -> float:
    """|got - want| within 2 K 2^-24 (|A| @ |B|) elementwise, plus one bf16
    ulp of the result for bf16: two f32 sums of the same products in
    different orders.  Returns the largest |got - want|."""
    k = a.shape[1]
    bound = 2 * k * 2.0**-24 * (a.abs().double() @ b.abs().double())
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(got.abs(), want.abs()).double().clamp_min(
            2.0**-126)
        bound += torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (got.double() - want.double()).abs()
    if not bool((diff <= bound).all()):
        raise AssertionError(f"B6 {tuple(a.shape)} @ {tuple(b.shape)} "
                             f"{got.dtype}: |diff| beyond the order bound "
                             f"(max excess {(diff - bound).max().item():.3e})")
    return float(diff.max().item())


def matmul_operands(torch, dev, m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return (torch.from_numpy(a).to(dev).to(dtype),
            torch.from_numpy(b).to(dev).to(dtype))


def matmul_main(torch, pm, dev, record) -> None:
    """Phase 8, B6: the op library's entry point and the benchmark suite
    at 1028^3 (launches counted over these calls alone), then each kernel
    against its twin and against ``"xla"``, all timed, and 4096^3."""
    from bm25_tpu_torch import custom
    from bm25_tpu_torch.bench.matmul_bench import bench_matmul

    n = MATMUL_N
    flops = n * n * (2 * n - 1)
    inputs = {dt: matmul_operands(torch, dev, n, n, n, dt, 5)
              for dt in pm.DTYPES}
    reset(pm.launches, pm.plain_calls)
    outs = {(dt, algo): custom("matrix_multiplication", a, b,
                               algorithm=algo)
            for dt, (a, b) in inputs.items()
            for algo in ("naive", "optimized", "xla")}
    bench = bench_matmul(n, n, n, log=lambda *_: None, device=dev)
    torch.cuda.synchronize()
    launches, plain = dict(pm.launches), dict(pm.plain_calls)
    log(f"[matmul] custom('matrix_multiplication') at {n}^3 f32 and bf16, "
        f"each algorithm, and bench_matmul(): launches {launches}, plain "
        f"twin runs {plain}")
    if not all(launches.values()) or any(plain.values()):
        raise AssertionError("the matmul path did not run both B6 kernels, "
                             "or ran the plain twin")
    log("[matmul] bench_matmul " + json.dumps(bench))

    times = {}
    for dt, (a, b) in inputs.items():
        twin = pm.matmul_plain(a, b)
        xla = outs[(dt, "xla")]
        name = str(dt)[6:]
        for algo in ("naive", "optimized"):
            got = outs[(dt, algo)]
            compare(torch, got, twin, True, f"B6 {algo} {n}^3 {name} vs twin")
            err = order_bound(torch, got, xla, a, b)
            ms = cuda_ms(torch, lambda: pm.matmul(a, b, algorithm=algo), 20)
            times[(dt, algo)] = ms
            log(f"[kernels] B6 {algo} at {n}^3 {name}: {ms:.4f} ms "
                f"({flops / ms / 1e6:.1f} GFLOP/s); bit-equal to the twin, "
                f"max |diff| vs xla {err:.3e} (within the order bound)")
        xla_ms = cuda_ms(torch, lambda: pm.matmul(a, b, algorithm="xla"), 20)
        plain_ms = cuda_ms(torch, lambda: pm.matmul_plain(a, b), 1)
        times[(dt, "xla")], times[(dt, "plain")] = xla_ms, plain_ms
        log(f"[kernels] B6 at {n}^3 {name}: xla (torch.matmul, full f32) "
            f"{xla_ms:.4f} ms ({flops / xla_ms / 1e6:.1f} GFLOP/s), plain "
            f"twin {plain_ms:.3f} ms")
    del inputs, outs

    big = MATMUL_BIG
    a, b = matmul_operands(torch, dev, big, big, big, torch.float32, 6)
    got = pm.matmul(a, b)
    err = order_bound(torch, got, pm.matmul(a, b, algorithm="xla"), a, b)
    ms = cuda_ms(torch, lambda: pm.matmul(a, b), 5)
    xla_ms = cuda_ms(torch, lambda: pm.matmul(a, b, algorithm="xla"), 5)
    big_flops = big * big * (2 * big - 1)
    log(f"[kernels] B6 optimized at {big}^3 f32 (tile "
        f"{tuple(pm.pick_tile(big, big, torch.float32))}): {ms:.3f} ms "
        f"({big_flops / ms / 1e6:.1f} GFLOP/s), xla {xla_ms:.3f} ms "
        f"({big_flops / xla_ms / 1e6:.1f} GFLOP/s); max |diff| vs xla "
        f"{err:.3e} (within the order bound)")
    del a, b, got
    f32 = torch.float32
    b6_bound = bound(3 * n * n * 4, [(flops, F32_OPS_PER_S)])
    for name, algo in (("matmul_naive", "naive"),
                       ("matmul_tiled", "optimized")):
        record[name] = kernel_record(
            launches[name], 0.0, times[(f32, algo)], times[(f32, "plain")],
            b6_bound, times[(f32, "xla")])


def phase_matmul_cases(torch, pm, dev) -> None:
    """B6 edge cases: both kernels bit-equal to the twin at every tile
    override, f32 and bf16, and the exact analytic corner case."""
    shapes = [(67, 130, 200),  # the JAX test's ragged shape
              (1, 1, 1),
              (33, 13, 70),  # K off every K-step
              (100, 64, 136),  # M, N off the tiles, 16-byte loads
              (130, 24, 129),  # M, N off the tiles, scalar loads
              (0, 5, 7), (5, 7, 0),  # empty M, empty N
              (3, 0, 4)]  # K = 0: zeros
    for m, k, n in shapes:
        for dt in pm.DTYPES:
            a, b = matmul_operands(torch, dev, m, k, n, dt, m + k + n)
            want = pm.matmul_plain(a, b)
            tiles = [("naive", {}), ("optimized", {}),
                     *[("optimized", t._asdict()) for t in pm.TILES[dt]]]
            for algo, kw in tiles:
                kw = {f"tile_{d}": v for d, v in kw.items()}
                compare(torch, pm.matmul(a, b, algorithm=algo, **kw), want,
                        True, f"B6 {algo} {kw} ({m}, {k}, {n}) {dt}")
        log(f"[kernels] B6 ({m}, {k}, {n}): both kernels bit-equal to the "
            f"twin in f32 and bf16, the default and each tile of the dtype")
    r = torch.arange(32, dtype=torch.float32, device=dev)
    a = r[:, None] - r[None, :]
    b = r[:, None] + r[None, :]
    exact = a.double() @ b.double()
    for algo in ("naive", "optimized"):
        got = pm.matmul(a, b, algorithm=algo)
        if not torch.equal(got.double(), exact):
            raise AssertionError(f"B6 {algo}: analytic corner case inexact")
    log("[kernels] B6 analytic corner case (a[r, c] = r - c, b[r, c] = "
        "r + c, n = 32): both kernels equal a @ b exactly")


def named_ops_cases(torch, dev) -> None:
    """Each gather/scatter/shape/union op once through ``custom`` on CUDA
    tensors, bit-equal (NaN fills included) to the call on CPU tensors."""
    from bm25_tpu_torch import custom

    rng = np.random.default_rng(7)

    def t(x):
        return torch.from_numpy(np.asarray(x))

    data = t(rng.standard_normal((6, 5)).astype(np.float32))
    idx = t(rng.integers(-13, 13, (4, 3)))
    col = t(rng.integers(-11, 11, (6, 1)))
    nd = t(rng.integers(-8, 8, (7, 1)))
    upd = t(rng.standard_normal((4, 3)).astype(np.float32))
    ints = t(rng.integers(-9, 9, (6, 5)).astype(np.int32))
    nd_upd = t(rng.standard_normal((7, 5)).astype(np.float32))
    gmax = [t(rng.standard_normal((4, 16)).astype(np.float32))]
    bases = [t(rng.standard_normal((4, 128)).astype(np.float32))]
    dids = [t(np.arange(128, dtype=np.int32))]
    calls = [
        ("gather", (data, idx), {"axis": 1}),
        ("gather_reduce", (data, idx), {"reduce_fn": "mean"}),
        ("gather_reduce", (data, idx), {"reduce_fn": "max"}),
        ("gather_elements", (data, col), {"axis": 1}),
        ("gather_nd", (data, nd), {}),
        ("scatter_elements", (data, idx, upd), {"reduction": "add"}),
        ("scatter_elements", (data, idx, upd), {}),
        ("scatter_elements", (data, idx, upd), {"reduction": "max"}),
        ("scatter_elements", (ints, idx, ints[:4, :3]), {"reduction": "mul"}),
        ("scatter_elements", (ints, idx, ints[:4, :3]), {"reduction": "min"}),
        ("scatter_nd", (data, nd, nd_upd), {"reduction": "mul"}),
        ("scatter_nd", (data, nd, nd_upd), {}),
        ("reshape", (data, (-1, 3)), {}),
        ("union_group_select", (gmax, 3), {}),
        ("gather_group_candidates", (bases, dids, t(np.array(
            [[0, 5], [15, 1], [2, 2], [9, 3]]))), {}),
    ]

    def to(x, d):
        if isinstance(x, (list, tuple)):
            return type(x)(to(y, d) for y in x)
        return x.to(d) if isinstance(x, torch.Tensor) else x

    def same(x, y, what):
        for p, q in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            if p.device.type != dev.type:
                raise AssertionError(f"{what} did not run on {dev}")
            torch.testing.assert_close(p.cpu(), q, rtol=0, atol=0,
                                       equal_nan=True, msg=what)

    for name, args, kw in calls:
        same(custom(name, *to(args, dev), **kw), custom(name, *args, **kw),
             name)
    same(custom("arange", 0.0, 3.0, 0.1, dtype=torch.float32, device=dev),
         custom("arange", 0.0, 3.0, 0.1, dtype=torch.float32, device="cpu"),
         "arange")
    log(f"[ops] {len(calls) + 1} named-op calls through custom() on CUDA "
        "tensors (gather/scatter family, reshape, arange with device=, the "
        "union ops) equal the same calls on CPU tensors")


def gather_case(torch, srg, dev, q, r, kp, seed, sort=False):
    """Random (Q, R, 128) rows and (Q, KP) ids holding rows 0 and R - 1,
    duplicated; sorted within each query for the window kernel."""
    rng = np.random.default_rng(seed)
    x3 = torch.from_numpy(rng.random((q, r, srg.ROW), np.float32)).to(dev)
    rowof = rng.integers(0, r, (q, kp)).astype(np.int32)
    rowof[0, :3] = [0, r - 1, r - 1]
    if sort:
        rowof.sort(axis=1)
    return x3, torch.from_numpy(rowof).to(dev)


def phase_selection_gather_cases(torch, srg, dev) -> None:
    """E5-E7 vs their twin at edge cases; the raises."""
    for q, r, kp in ((3, 64, 40), (5, 300, 1024), (1, 1, 7)):
        x3, rowof = gather_case(torch, srg, dev, q, r, kp, q + r + kp)
        want = srg.super_row_gather_plain(x3, rowof)
        for rpw in srg.ROWS_PER_WARP:
            compare(torch, srg.super_row_gather(x3, rowof, rpw), want, True,
                    f"E5 ({q}, {r}) x ({q}, {kp}) rows_per_warp={rpw}")
        log(f"[kernels] E5 ({q}, {r}, 128) x ({q}, {kp}) ids (rows 0 and "
            f"R-1, duplicates): bit-equal to the twin at every rows_per_warp")
    for q, r, kp in ((3, 64, 40), (4, 2048, 1024), (2, 48, 8)):
        x3, rowof = gather_case(torch, srg, dev, q, r, kp, q + r + kp, True)
        rowof[-1] = r - 1  # a tile of the last row: the window clamps
        rowof[-1, : kp // 2 + 1] = 0  # a tile spanning more than W
        rowof = rowof.sort(dim=1).values.contiguous()
        want = srg.super_row_gather_plain(x3, rowof)
        for w in (32, 48):
            if r < w:
                continue
            fb = torch.zeros(1, dtype=torch.int32, device=dev)
            compare(torch, srg.super_row_gather_window(x3, rowof, w, fb),
                    want, True, f"E6 ({q}, {r}) x ({q}, {kp}) W={w}")
            tiles = int(srg.window_fallback_tiles(rowof, r, w))
            if int(fb.item()) != tiles or (tiles == 0 and r > w):
                raise AssertionError(f"E6 W={w}: {int(fb.item())} fallback "
                                     f"tiles counted, {tiles} expected")
            flipped = rowof.flip(1).contiguous()
            compare(torch, srg.super_row_gather_window(x3, flipped, w),
                    srg.super_row_gather_plain(x3, flipped), True,
                    f"E6 unsorted W={w}")
            log(f"[kernels] E6 ({q}, {r}, 128) x ({q}, {kp}) W={w}: "
                f"bit-equal (clamped window, duplicates, unsorted ids), "
                f"{tiles} fallback tiles counted")
    for h in (8, 100, RESIDENT_H):
        x3, rowof = gather_case(torch, srg, dev, 6, h, 1000, h)
        compare(torch, srg.super_row_gather_resident(x3, rowof),
                srg.super_row_gather_plain(x3, rowof), True, f"E7 H={h}")
    log(f"[kernels] E7 H=8, 100 (shared-memory opt-in), {RESIDENT_H}, "
        "KP=1000: bit-equal to the twin")
    raised = []
    x3, rowof = gather_case(torch, srg, dev, 2, 16, 8, 0, True)
    big, big_rows = gather_case(torch, srg, dev, 1, 2048, 16, 0)
    for what, fn in (
            ("E6 R < W", lambda: srg.super_row_gather_window(x3, rowof, 32)),
            ("E7 H=2048",
             lambda: srg.super_row_gather_resident(big, big_rows))):
        try:
            fn()
        except ValueError as e:
            raised.append(f"{what}: {e}")
        else:
            raise AssertionError(f"{what} did not raise")
    log("[kernels] raised as required: " + "; ".join(raised))


def selection_gather(torch, dev, record) -> None:
    """Phase 9: the E5-E7 edge cases, then ``gather_bench``'s experiments
    at the scripts' shapes with the kernels' launches counted."""
    from bm25_tpu_torch.bench import gather_bench as gb
    from bm25_tpu_torch.ops import super_row_gather as srg

    phase_selection_gather_cases(torch, srg, dev)
    reset(srg.launches, srg.plain_calls)
    results = [row for e in gb.EXPERIMENTS
               for row in gb.bench_gather(e, dev, log=log)]
    torch.cuda.synchronize()
    launches = dict(srg.launches)
    log(f"[gather] gather_bench's three experiments: launches {launches}")
    if not all(launches.values()):
        raise AssertionError("the gather experiments did not run every "
                             "E5-E7 kernel")
    log("[gather] gather_bench " + json.dumps(results))

    def pick(experiment, variant, **key):
        return next(r for r in results if r["experiment"] == experiment
                    and r["variant"] == variant
                    and all(r.get(k) == v for k, v in key.items()))

    for name, exp, variant, key in (
            ("super_row_gather", "pallas_gather", "direct",
             {"rows_per_warp": 1}),
            ("super_row_gather_window", "window_gather", "window",
             {"window": 32}),
            ("super_row_gather_resident", "dyngather", "resident",
             {"h": RESIDENT_H})):
        where = {k: v for k, v in key.items() if k == "h"}
        got = pick(exp, variant, **key)
        record[name] = kernel_record(
            launches[name], 0.0, got["ms"],
            pick(exp, "plain", **where)["ms"], bound(got["bytes"]),
            pick(exp, "torch.gather", **where)["ms"])


def mma_within_bound(bs, ms, got, a, b, mode, what, readings) -> float:
    """E4 against its twin (``bs.mma_readings``: within K 2^-22
    (|A^| @ |B^|), and at most a quarter of the unrounded inputs' reading
    of it); keeps the largest reading and the unrounded one per mode in
    ``readings``; returns the largest |diff|."""
    err, ratio, unrounded = bs.mma_readings(
        got, ms.matmul_mma_plain(a, b, mode), a, b, mode, what)
    if ratio >= readings[mode][0]:
        readings[mode] = (ratio, unrounded)
    return err


def phase_schedule_cases(torch, bs, ms, pm, dev) -> dict:
    """E1-E4 edge cases; returns E4's largest |diff| / bound per mode, with
    the unrounded inputs' reading of the same case."""
    readings = {mode: (0.0, 0.0) for mode in ms.ROUNDING}
    shapes = [(67, 130, 200), (1, 1, 1), (33, 13, 70),  # K off every step
              (100, 64, 136), (130, 24, 129), (37, 36, 44), (257, 1028, 260)]
    for m, k, n in shapes:
        a, b = matmul_operands(torch, dev, m, k, n, torch.float32, m + k + n)
        want = pm.matmul_plain(a, b)
        for t in ms.SWEEP_TILES:
            compare(torch, ms.matmul_sweep(a, b, t), want, True,
                    f"E1 {tuple(t)} ({m}, {k}, {n})")
        for h in ms.STRIP_HEIGHTS:
            for blocks in (None, 1):
                compare(torch, ms.matmul_row_strip(a, b, h, blocks), want,
                        True, f"E2 strip {h} blocks {blocks} ({m}, {k}, {n})")
        e3 = k % 4 == 0 and n % 4 == 0
        if e3:
            for t in ms.PIPELINED_TILES:
                for st in ms.STAGES:
                    compare(torch, ms.matmul_pipelined(a, b, t, st), want,
                            True, f"E3 {tuple(t)} stages {st} ({m}, {k}, {n})")
        for mode in ms.ROUNDING:
            mma_within_bound(bs, ms, ms.matmul_mma(a, b, mode), a, b, mode,
                             f"E4 {mode} ({m}, {k}, {n})", readings)
        log(f"[kernels] E1-E4 ({m}, {k}, {n}): E1 (12 tiles), E2 (3 strips, "
            f"one block or one per strip){', E3 (2 tiles x 3 stages)' if e3 else ''}"
            " bit-equal to the twin; E4 within its bound")
    r = torch.arange(32, dtype=torch.float32, device=dev)
    a, b = r[:, None] - r[None, :], r[:, None] + r[None, :]
    exact = a.double() @ b.double()
    outs = ([ms.matmul_sweep(a, b, t) for t in ms.SWEEP_TILES]
            + [ms.matmul_row_strip(a, b, h) for h in ms.STRIP_HEIGHTS]
            + [ms.matmul_pipelined(a, b, t, st) for t in ms.PIPELINED_TILES
               for st in ms.STAGES])
    if not all(torch.equal(o.double(), exact) for o in outs):
        raise AssertionError("E1-E3: analytic corner case inexact")
    raised = []
    tall = matmul_operands(torch, dev, 16, 4096, 8, torch.float32, 1)
    odd = matmul_operands(torch, dev, 8, 30, 8, torch.float32, 2)
    for what, fn in (("E2 strip 16 at K=4096",
                      lambda: ms.matmul_row_strip(*tall, 16)),
                     ("E3 K=30", lambda: ms.matmul_pipelined(*odd))):
        try:
            fn()
        except ValueError as e:
            raised.append(f"{what}: {e}")
        else:
            raise AssertionError(f"{what} did not raise")
    log("[kernels] E1-E3 analytic corner case exact; raised as required: "
        + "; ".join(raised))
    log("[kernels] E4 largest |diff| / bound at the edge cases, and the "
        f"unrounded inputs' reading there: {readings}")
    return readings


def matmul_schedules(torch, pm, dev, record) -> None:
    """Phase 10: E1-E4 edge cases, the schedule sweep at the scripts' sizes
    (launches counted), every variant against its twin at 1028^3 and
    2048^3, and each kernel's record at 1028^3."""
    from bm25_tpu_torch.bench import matmul_schedules as bs
    from bm25_tpu_torch.ops import matmul_schedules as ms

    readings = phase_schedule_cases(torch, bs, ms, pm, dev)
    reset(ms.launches, pm.plain_calls)
    rows = bs.bench_schedules(SCHEDULE_SIZES, device=dev, log=log)
    torch.cuda.synchronize()
    launches = dict(ms.launches)
    log(f"[schedules] sweep at {SCHEDULE_SIZES}: launches {launches}, plain "
        f"twin runs {pm.plain_calls}")
    if not all(launches.values()) or any(pm.plain_calls.values()):
        raise AssertionError("the sweep did not run every E1-E4 kernel, or "
                             "ran the plain twin")
    log("[schedules] bench_schedules " + json.dumps(rows))

    twin_ms, mma_err = {}, {}
    for s in SCHEDULE_TWIN_SIZES:
        rng = np.random.default_rng(0)
        a, b = (torch.from_numpy(rng.standard_normal((s, s), dtype=np.float32))
                .to(dev) for _ in range(2))
        t0 = time.perf_counter()
        want = pm.matmul_plain(a, b)
        torch.cuda.synchronize()
        twin_ms[(s, "f32")] = (time.perf_counter() - t0) * 1e3
        for label, fn in bs.variants(s, dev):
            mode = label.get("mode", "f32")
            if mode == "f32":
                compare(torch, fn(a, b), want, True, f"{s}^3 {label}")
            else:
                at_size = {mode: (0.0, 0.0)}
                mma_err[(s, mode)] = mma_within_bound(
                    bs, ms, fn(a, b), a, b, mode, f"{s}^3 {label}", at_size)
                log(f"[kernels] E4 {mode} at {s}^3: |diff| / bound "
                    f"{at_size[mode][0]:.4g}, unrounded inputs "
                    f"{at_size[mode][1]:.4g}")
                if at_size[mode][0] >= readings[mode][0]:
                    readings[mode] = at_size[mode]
        for mode in ms.ROUNDING:
            t0 = time.perf_counter()
            ms.matmul_mma_plain(a, b, mode)
            torch.cuda.synchronize()
            twin_ms[(s, mode)] = (time.perf_counter() - t0) * 1e3
        log(f"[kernels] {s}^3: every E1-E3 variant and E4 f32 bit-equal to "
            f"the twin ({twin_ms[(s, 'f32')]:.1f} ms), E4 default and bf16in "
            f"within their bound; max |diff| / bound so far {readings}")
        del a, b, want

    def pick(**key):
        return next(r for r in rows if r["size"] == MATMUL_N
                    and all(r.get(k) == v for k, v in key.items()))

    for name, row, mode in (
            ("matmul_sweep", pick(variant="sweep", tile=[128, 128, 16]),
             "f32"),
            ("matmul_row_strip", pick(variant="row_strip", strip_m=8), "f32"),
            ("matmul_pipelined", pick(variant="pipelined",
                                      tile=[128, 128, 16], stages=2), "f32"),
            ("matmul_mma", pick(variant="mma", mode="bf16in"), "bf16in")):
        record[name] = kernel_record(
            launches[name], mma_err.get((MATMUL_N, mode), 0.0), row["ms"],
            twin_ms[(MATMUL_N, mode)], (row["bound_ms"], row["bound_by"]),
            row["library_ms"])
        log(f"[kernels] {name} at {MATMUL_N}^3 ({row}): {row['ms']:.4f} ms, "
            f"twin {twin_ms[(MATMUL_N, mode)]:.1f} ms, {row['library']} "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    log(f"[kernels] E4 largest |diff| / (K 2^-22 (|A^| @ |B^|)) over every "
        f"checked case, with the unrounded inputs' reading there: {readings}")


def cli(args: list[str]) -> str:
    """Run the port's CLI in this process; its standard output."""
    import contextlib
    import io

    from bm25_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(args)
    if rc != 0:
        raise AssertionError(f"bm25-tpu-torch {' '.join(args)}: exit {rc}")
    return out.getvalue()


def query_results(text: str) -> list[list[tuple[int, float]]]:
    """The (doc, score) ranks of each query in ``query``'s output."""
    results = []
    for line in text.splitlines():
        if line.startswith("query: "):
            results.append([])
        elif line.lstrip()[:1].isdigit() and " doc=" in line:
            doc = line.split("doc=")[1].split()[0]
            score = line.split("score=")[1].split()[0]
            results[-1].append((int(doc), float(score)))
    return results


def same_ranking(got, want, what: str) -> None:
    """Printed (4-decimal) scores equal within one print step; doc ids
    equal wherever the printed score is clear of its neighbours."""
    if [len(r) for r in got] != [len(r) for r in want] or not want:
        raise AssertionError(f"{what}: result shapes differ")
    for g, w in zip(got, want):
        scores = [s for _, s in w]
        for i, ((gd, gs), (wd, ws)) in enumerate(zip(g, w)):
            if abs(gs - ws) > 1.5e-4:
                raise AssertionError(f"{what}: score {gs} != {ws}")
            near = [abs(scores[i] - scores[j]) <= 2e-4
                    for j in (i - 1, i + 1) if 0 <= j < len(scores)]
            if not any(near) and gd != wd:
                raise AssertionError(f"{what}: doc {gd} != {wd} at rank {i}")


def entry_points(torch, session, index) -> None:
    """Phase 11: the CLI, ``compat.BM25`` and ``compat.BM25v`` on the
    card."""
    import shutil
    import tempfile

    from bm25_tpu_torch import ReferenceEngine, SparseEngine, create_engine
    from bm25_tpu_torch.bench import BenchConfig, make_queries
    from bm25_tpu_torch.compat import BM25, BM25v
    from bm25_tpu_torch.datasets import synthetic_corpus
    from bm25_tpu_torch.ops import gather_rows as gr
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    reset(ops.launches, gr.launches)
    scratch = os.path.join(HERE, "_scratch")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=scratch)
    try:
        docs_file = os.path.join(work, "docs.txt")
        with open(docs_file, "w") as f:
            f.write("\n".join(synthetic_corpus(4000, vocab=3000, avg_len=24,
                                               seed=0)) + "\n")
        idx = os.path.join(work, "idx")
        log("[cli] " + cli(["index", docs_file, "-o", idx, "--stemmer",
                            "none"]).strip())
        info = json.loads(cli(["info", idx]))
        if info["num_docs"] != 4000:
            raise AssertionError(f"info: {info}")
        log(f"[cli] info: {json.dumps(info)}")
        queries = ["w000007^2.5 w000120 w001500", "w000017 w000002",
                   "w000300^0.5 w000044 w002999 w000001"]
        for engine in ("dense", "sparse"):
            args = ["query", idx, *queries, "-k", "10", "--engine", engine,
                    "--explain", "1"]
            got = cli(["--device", "cuda", *args])
            same_ranking(query_results(got),
                         query_results(cli(["--device", "cpu", *args])),
                         f"query --engine {engine}")
            log(f"[cli] query --engine {engine} with boosts: {len(queries)} "
                "queries equal to --device cpu; first lines: "
                + " | ".join(got.splitlines()[:3]))
        demo = cli(["--device", "cuda", "demo"])
        if demo != cli(["--device", "cpu", "demo"]):
            raise AssertionError("demo differs from --device cpu")
        log("[cli] demo equal to --device cpu: "
            + " | ".join(demo.splitlines()[:2]))
        data = os.path.join(HERE, "tests", "data", "mini_beir")
        ev = json.loads(cli(["--device", "cuda", "eval", data, "--stemmer",
                             "none"]))
        ev_cpu = json.loads(cli(["--device", "cpu", "eval", data,
                                 "--stemmer", "none"]))
        if ev != ev_cpu:
            raise AssertionError(f"eval {ev} != --device cpu {ev_cpu}")
        log(f"[cli] eval mini_beir equal to --device cpu: {json.dumps(ev)}")
        bench = cli(["--device", "cuda", "bench", "--suite", "matmul"])
        if len(bench.strip().splitlines()) != 1:
            raise AssertionError("bench --suite matmul: not one line")
        log("[cli] bench --suite matmul " + bench.strip())
    finally:
        shutil.rmtree(work)
    fox = ["The quick brown fox jumps over the lazy dog", "Some other text",
           "The quick rabbit runs past the brown fox",
           "The quick rabbit jumps over the brown dog",
           "The quick dog chases past the lazy fox",
           "The quick dog runs through the tall trees",
           "The quick brown fox jumps over the lazy dog",
           "The brown dog sleeps under the shady tree",
           "The brown rabbit hops under the tall tree",
           "The brown fox runs through the forest trees",
           "The brown fox watches the sleeping rabbit",
           "The lazy fox watches over the sleeping dog",
           "The lazy dog watches the quick rabbit"]
    corpus = [d.lower().split() for d in fox]
    bm25 = BM25(session=session)
    bm25.fit(corpus)
    query = "sleeping rabbit".split()
    want = ReferenceEngine.from_scored_index(bm25._index).get_scores(
        np.array([bm25.term_to_id[t] for t in query]))
    got = bm25.get_scores(query)
    if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
        raise AssertionError("BM25.get_scores differs from the oracle")
    top = bm25.get_top_n(query, fox, n=3)
    if top[0][1] != "The brown fox watches the sleeping rabbit":
        raise AssertionError(f"BM25.get_top_n: {top}")
    log(f"[compat] BM25 on {type(bm25._engine).__name__}: get_scores equal "
        f"to the oracle, top doc {top[0][1]!r}")

    cfg = BenchConfig()
    queries = make_queries(cfg)[: cfg.batch]
    rng = np.random.default_rng(11)
    weights = rng.uniform(0.1, 3.0, queries.shape).astype(np.float32)
    sub = slice(0, CHECKED_QUERIES)
    ref = ReferenceEngine.from_scored_index(index)
    t0 = time.perf_counter()
    model = BM25v(session=session)
    model.index(index.to_csc(), index.doc_lengths)
    torch.cuda.synchronize()
    if not isinstance(model._engine, SparseEngine):
        raise AssertionError(f"BM25v built {type(model._engine).__name__}")
    log(f"[compat] BM25v.index over {index.num_docs} docs routed to "
        f"SparseEngine in {time.perf_counter() - t0:.1f} s")
    k = cfg.top_k
    t0 = time.perf_counter()
    docs, scores = model.search(queries, top_k=k)
    ms_ = (time.perf_counter() - t0) * 1e3
    assert_matches_oracle(docs[sub], scores[sub],
                          *ref.search(queries[sub], top_k=k))
    hot = create_engine(index, mode="sparse", hot_tokens=HOT_TOKENS,
                        hot_budget_bytes=HOT_TOKENS * index.num_docs * 4,
                        max_buckets=MAX_BUCKETS, session=session)
    want = ref.search(queries[sub], top_k=k, weights=weights[sub])
    for name, eng in (("BM25v's engine", model._engine),
                      (f"hot_tokens={HOT_TOKENS}", hot)):
        d, s = eng.search(queries, top_k=k, weights=weights)
        assert_matches_oracle(d[sub], s[sub], *want)
        log(f"[compat] weighted 512 x 8 batch at k={k} on {name}: first "
            f"{CHECKED_QUERIES} queries match ReferenceEngine")
    del hot
    for q in queries[:4]:
        got = model._engine.get_scores(q)
        if not np.allclose(got, ref.get_scores(q), rtol=2e-5, atol=1e-5):
            raise AssertionError("BM25v's get_scores differs from the oracle")
    launches = {"ell_score_fused": ops.launches["ell_score_fused"],
                "gather_add_rows": gr.launches["gather_add_rows"]}
    log(f"[compat] BM25v.search 512 x 8 at k={k}: {ms_:.1f} ms, first "
        f"{CHECKED_QUERIES} match ReferenceEngine; get_scores of 4 queries "
        f"equal the oracle; B1/B3 launches over this phase {launches}")
    if not all(launches.values()):
        raise AssertionError("the entry points did not run B1 and B3")


def drive(torch, dev) -> dict:
    """Phases 2-11 on device ``dev``; returns the kernels' record."""
    from bm25_tpu_torch import Session
    from bm25_tpu_torch.bench import BenchConfig
    from bm25_tpu_torch.ops import _build
    from bm25_tpu_torch.ops import gather_rows as gr
    from bm25_tpu_torch.ops import topk as tk
    from bm25_tpu_torch.utils.counts import split_bf16

    # bm25_tpu_torch.ops re-exports a function of each module's name
    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    pm = importlib.import_module("bm25_tpu_torch.ops.matmul")

    with Phase("2. build"):
        t0 = time.perf_counter()
        libs = _build.build_all(["ell_score", "gather_rows", "topk",
                                 "matmul", "super_row_gather",
                                 "matmul_schedules"])
        log(f"[build] {len(libs)} libraries in "
            f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")
        for name, path in libs.items():
            log(f"[build] {os.path.relpath(path, HERE)}")
            with open(path[:-3] + ".log") as f:
                for line in f.read().splitlines():
                    if "registers" in line or "spill" in line:
                        log(f"[build] {name}: {line.strip()}")

    with Phase("3. kernel edge cases"):
        phase_kernel_cases(torch, ops, split_bf16, dev)
        phase_gather_cases(torch, gr, dev)
        phase_topk_cases(torch, tk, dev)
        phase_gumbel_cases(torch, tk, dev)

    session = Session(dev)
    record = {}
    with Phase("4. sparse main path"):
        index = sparse_main(torch, dev, BenchConfig(), ops, session, record)
        torch.cuda.empty_cache()
    dense_main(torch, dev, BenchConfig(num_docs=DENSE_DOCS), gr, tk, session,
               record)
    torch.cuda.empty_cache()
    with Phase("7. library entry"):
        library_entry(session)
    with Phase("8. op library: matmul and the named ops"):
        matmul_main(torch, pm, dev, record)
        phase_matmul_cases(torch, pm, dev)
        named_ops_cases(torch, dev)
    torch.cuda.empty_cache()
    with Phase("9. selection gather (E5-E7)"):
        selection_gather(torch, dev, record)
    torch.cuda.empty_cache()
    with Phase("10. matmul schedules (E1-E4)"):
        matmul_schedules(torch, pm, dev, record)
    torch.cuda.empty_cache()
    with Phase("11. entry points: CLI, compat, BM25v at full width"):
        entry_points(torch, session, index)

    return {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], **record[name]}
        for name in SOURCES]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "bm25_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (no "
              "bm25_tpu_torch/ beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in full f32
    torch.backends.cudnn.allow_tf32 = False

    import bm25_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(bm25_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        raise RuntimeError(f"imported bm25_tpu_torch from {pkg_dir}, not "
                           "this checkout")

    # 1. environment
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")

    record = drive(torch, torch.device("cuda"))
    jax_pkg = sorted(m for m in sys.modules
                     if m == "bm25_tpu" or m.startswith("bm25_tpu."))
    if jax_pkg:
        raise AssertionError(f"the JAX package was imported: {jax_pkg}")
    log("[env] no module of the JAX package (bm25_tpu) was imported")
    log(f"[phase] total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
