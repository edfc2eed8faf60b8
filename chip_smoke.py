#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device, ``nvcc`` and the repository's sources; it imports no JAX.

Phases (any failure raises and exits nonzero; nothing is caught):

1. environment: the card's name and power limit;
2. build: every CUDA kernel compiles from ``bm25_tpu_torch/csrc``, one
   nvcc per source, all started together, and the native text library
   (tokenizer, Snowball stemmer, counting-sort CSC build) from
   ``bm25_tpu_torch/native/src`` with the C++ compiler beside them;
3. kernels vs their plain PyTorch twins on the card, at small edge-case
   shapes: B1/B2 (pad rows, pad/OOV ids, ragged Q, a bucket wider than 512
   slots, with and without the hot tier and per-token weights, Q = 8 with
   H off the hot kernel's K step, two query blocks on a ragged doc tile:
   the ELL-only base bit-equal, hot results within 2e-5 * max(1, |row
   max|));
   B3 (empty grids, ragged D, bf16, weights, duplicate ids: bit-equal);
   B4 (heavy ties, -inf rows, k = N, ragged rows, rows split over
   blocks, k beyond the shared-memory sort, the side buffer on and off,
   +-0/NaN/+-inf (-0 kept), k wider than JAX's chunk (the tree, counted),
   largest=False: values and indices equal to the twin and the tree); B5
   (rows of NaN, NaN among numbers and NaN after -inf, which must pick the
   first NaN column, in every layout; each layout, the wrapper's pick,
   a warp a row, a block a row and clusters of 2 and 8 blocks, at
   (300, 100), (512, 1,000), (64, 32,768), (8, 131,072) and (13, 50,001),
   deterministic per seed and the twin's choices up to float noise in z;
   rows of -inf with one 0 at each edge of a run, a lane's stride or a
   cluster's slice, which must pick that column, in every layout;
   membership, greedy at temperature -> 0, a fully -inf row through
   ``top_k_fused_sampling``, which must sample its first top-k id, and
   that call with a CUDA generator under
   ``torch.cuda.set_sync_debug_mode("error")``); the
   scan's lookup tables (B2's one-token queries over three tables, rows
   off a multiple of 4, T = 64 and 300, a token in every query, ids past
   16 bits, negative values, zero weights, 1,208 and 1,536 slots): each
   table kernel's tables hold the twin's pairs, B1 and B2 bit-equal;
4. sparse main path: ``SparseEngine`` at the benchmark shape (524,288
   docs, 32,768-token Zipf vocabulary, hot_tokens=1024, 2 buckets) built
   and searched with 512 queries of 8 tokens at k=1000 and k=100, checked
   against ``ReferenceEngine`` under the fuzz campaign's comparator, with
   B1/B2's launch counts taken over this phase alone; one batch through
   ``create_engine(mode="auto", score_dtype="bfloat16")``, which must
   return the f32 batch's docs and its scores rounded to bf16; then each
   kernel against its twin at the main path's own shapes, both timed (B1
   per bucket as a whole and, by ``torch.profiler``, as its scan and its
   hot epilogue, each with its own bound, the batch's matching (query,
   cold posting) pairs counted; the scan
   again on a fan-out batch whose queries share their cold ids, and B1 on
   a chunk of 8 queries, the small-batch path; the chunk's scan tables
   against the twin's), on the batch's unrouted chunk; B1 on routed
   chunks of cold widths 2, 4 and 64 against its twin; cold-width
   routing (``route_cold="auto"``, which routes these batches) against
   ``route_cold=False`` at 512 x 8 and 512 x 64 and k=1000 and k=100,
   both against the oracle and each other bit for bit, with the plan's
   chunks and each device step in turns; 16 of the batch's queries
   searched alone and in the chunks of 8 and 16 holding them, bit-equal
   to their rows of the batch at k=1000, 100 and 10, unweighted and
   weighted, on ``SparseEngine`` and a (1, 4) ``ShardedSparseEngine`` at
   the same layout (``[alone]`` lines); last, masked batches at k=1000 and k=100 (a random
   mask, and one leaving 500 docs eligible, a whole group of 8 eligible
   beside a dropped one) against the oracle, the shortfall doc -1 / score
   0 exactly, and 512 queries of 64 Zipf tokens at k=1000 with dedup off,
   on and "auto", each against the oracle, timed in turns; then the
   benchmark's 2,048 queries at k=1000 and k=100, serial and through
   ``search_pipelined``: wall ms a batch, the card's busy ms
   (``torch.profiler``) and the idle share.  This phase keeps the
   explicit hot_tokens=1024 layout so that B1's hot epilogue stays
   measured: the layout cost model picks no hot tier at this corpus;
4b. layout model and tail tier, on phase 4's corpus: ``choose_layout``'s
   choice at k=1000 and k=100 with each bucket count's modelled ms, that
   layout's device step beside the explicit h=1024 and the h=0 layouts
   (2 buckets); a three-tier engine (h=1024, 2 buckets, tail_cap=512: hot,
   ELL and tail all hold postings, the tail's count logged) at 512 x 8
   and k=1000, plain, weighted and masked, against ``ReferenceEngine``,
   and its device step;
4c. union selection at the layout model's layout (its hot tier, 2
   buckets) and at 4 buckets, 512 x 8 at k=1000: bit-equal to the
   per-bucket path, the device steps of per-bucket, union reading its
   flag, union by ``torch.where`` and union unchecked in turns; an
   all-tied corpus over two buckets, where the fallback must return doc
   ids 0..9;
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
   and B5 against their twins at these shapes (B4 also without its side
   buffer (``SIDE_MAX = 0``), with the fill its side buffer would need
   after an 11- or a 13-bit first digit, and beside ``torch.topk``; B5
   also as the fused step: the logits, then choice and sampled id in one
   launch),
   B4 on 524,288-wide random scores at (512, k=1000), (8, k=100) and (64,
   k=32,768), and B5 on (512, 1,000), (64, 32,768) and (8, 131,072)
   logits from ``default_rng(0)``, all timed, B4 and B5 also per kernel
   (``torch.profiler``);
7. library entry: ``Retriever`` over a small corpus with the engine
   ``create_engine`` picks (dense), then ``Retriever.fit`` building the
   port's engine itself, both against ``ReferenceEngine``, with the
   default (stemmed) tokenizer;
8. op library, matmul and the named ops: ``custom("matrix_multiplication",
   ...)`` (B6) with ``algorithm="naive"``, ``"optimized"`` and ``"xla"`` at
   the reference's 1028^3 in f32 and bf16, and ``bench_matmul()`` there
   (its JSON on one line), with B6's launch counts over these calls; then
   both kernels against their twin (bit-equal) and against ``"xla"``
   (within ``2 K 2^-24 (|A| @ |B|)``, plus one bf16 ulp for bf16), all
   timed; ``"optimized"`` at 2048^3 and 4096^3 f32 against ``"xla"``, both
   timed; B6 edge cases (ragged M, N and K, 1 x 1 x 1, empty M or N, K =
   0, bf16, every tile override, the analytic corner case, which is
   exact); the optimized kernel's ring at its edges in f32 and bf16 at
   every tile, ring depth and on 3 blocks (K = 0, K below the K step, K =
   37 BK + 3, M and N below a tile, K and N at 8 j + 4, views 4 bytes off
   alignment, +-0/inf/NaN: the twin's bits) and into a C prefilled with
   NaN (every element written); each gather/scatter/shape/union op
   through ``custom`` on CUDA tensors, equal to the same call on CPU
   tensors; last, the optimized kernel's device time per call at 1028^3
   and 4096^3 (``torch.profiler``);
9. selection gather (E5-E7): the three ``super_row_gather`` kernels
   against their twin (bit-equal) at edge cases (rows 0 and R - 1, the
   window clamped to R - W, duplicates, unsorted ids, a span wider than
   the window, counted as a fallback tile, KP off a multiple of 32, H = 8
   resident, and R < W and an H above the shared-memory limit, which must
   raise); then ``gather_bench``'s three experiments at the scripts' shapes
   (inputs from ``default_rng(0)``), with the kernels' launch counts over
   these runs, each kernel timed beside its twin and ``torch.gather``;
10. matmul schedules (E1-E4): the four ``ops/matmul_schedules.py`` kernels
   against their twins at edge cases (ragged M, N and K, K off every K step,
   1 x 1 x 1, the analytic corner case: E1-E3 bit-equal at every tile,
   strip height, E2 block count and stage count; E4's pack kernel
   bit-equal to its twin and its TF32 and bf16 products within
   ``K 2^-22 (|A^| @ |B^|)``, also on 128 x 256 tiles with ragged edges
   and on operands 4 bytes off 16-byte alignment; the E2 strip that does
   not fit shared memory and E3 on K % 4 != 0, which must raise; E1 and
   E3's ring body on operands TMA cannot read as they lie (E1 stages
   them), K below the K step, K = 0, M and N below the tile, K = 37 BK + 3
   at every ring depth, and +-0/inf/NaN); then
   ``bench_schedules``'s sweep at the scripts' sizes 1028, 2048 and 4096
   (each variant checked against ``torch.matmul`` or the float64 product
   before it is timed), with the kernels' launches (E4's pack too)
   counted over the sweep; then every variant against its twin at 1028^3
   and 2048^3 (bit-equal, or within E4's bound), E4's pack bit-equal and
   timed at 1028^3; E2's record is the wrapper's default strip height at
   1028, E4's carries both modes; last, E1's device time per call at
   128 x 128 x 16 and E4's pack and product device time per call in both
   modes, at 1028^3 and 4096^3 (``torch.profiler``);
11. entry points, on the card: the port's CLI (``info`` and ``query`` with
   term boosts under ``--engine dense`` and ``sparse`` on an index built
   by the CLI's ``index``, ``demo``, ``eval`` on ``tests/data/mini_beir``,
   ``bench --suite matmul``) against the same commands with ``--device
   cpu``; ``compat.BM25`` on the 13-doc corpus against the
   oracle; ``compat.BM25v`` over phase 4's 524,288-doc CSC, which must route
   to ``SparseEngine`` (the default layout it builds and its batch ms are
   logged): 512 x 8 queries at k=1000, a weighted batch (also on phase
   4's hot-tier layout) and ``get_scores`` against ``ReferenceEngine``;
12. query benchmark harness: ``bench/query_bench.py::run`` at the default
   ``BenchConfig`` on phase 4's corpus, at the cost model's layout
   (``choose_layout``): latency, pipelined and ids-only qps at k=1000 and
   k=100, the device step and its bytes (B1's count,
   ``models.sparse.b1_bytes``, which phase 4 bounds B1 with), the memory
   trade (the ELL-only parity engine, ``overhead_target=3.0`` and the
   headline), the 65,536-doc long-document corpus at the model's layout
   (buckets wider than 512 slots; where the model's layout has none, the
   explicit no-hot 2-bucket layout is checked against the oracle too;
   its engine keeps a hot tier, so its batches must be routed, as its
   record's chunks say) and the synthetic-BEIR eval (dense and sparse);
   every row's recall
   against ``ReferenceEngine`` must read 1.0, and B1, the tables, B3 and
   (where some engine of the run has a hot tier) B2 must have launched,
   no plain twin run; the ``cold_start`` row runs three fresh processes
   (phase 14 reads it).  The compact headline is logged on its own line;
13. serving (``bm25_tpu_torch/serve.py``), every checked response held to
   ``ReferenceEngine`` under the comparator after its load stopped:
   (a) ``Server`` over phase 4's index (saved with the vocabulary w<i>
   and the default ``Tokenizer()`` config) under ``engine_mode="auto"``,
   which must route to ``SparseEngine`` (B1), with a 5 ms micro-batch
   window and warm-up (its first-use breakdown logged): 8 client threads
   for 20 s with the serving soak's query mix at top_k 10 (every 50th
   response of each client checked), ``metrics.requests`` equal to the
   requests sent and batch occupancy above 1; one POST of 512 x 8 queries
   at k=100 (wall beside phase 12's p50 batch; the first 64 checked);
   ``/healthz?deep=1`` green; then ``/reload`` with ``mode="auto"`` (its
   sizing logged) and ``mode="drop"`` under the same load, 503s (with
   Retry-After, retried) only inside the reload windows, and
   ``memory_allocated`` after the drop reload within 2% of one engine's
   device bytes of its value before it (both read with the clients held),
   its peak below one and a half engines; (b) an updatable ``Server``
   over the soak's 131,072-doc corpus (vocabulary 16,384, Poisson(32)
   lengths) under ``engine_mode="auto"`` (``DenseEngine``, B3) with
   auto-compaction at 44 delta docs: 6 clients, a mutator adding batches
   of 8 marker docs and deleting earlier ones by their unique tokens,
   whose sixth batch trips the auto-compaction once, a manual ``/compact``
   folded into the served dir mid-traffic, 32 queries against
   ``ReferenceEngine`` over a fresh build of the live texts, then every
   live marker found and no deleted one returned, and a restart from the
   same dir whose update-log replay (4 records) gives the same results.
   Each server's B1/B2/B3 launches are logged, and the sparse builds'
   device / CSC bytes of phases 4 and 4b beside the auto reload's
   fallback ratio;
14. warm restart: (a) device checkpoints of phase 4's corpus at three
   layouts (the layout model's, the explicit h=1024 / 2 buckets, and
   phase 4b's three tiers at tail_cap=512): save, load and
   ``from_scored_index`` seconds and the bytes on disk, every restored
   tensor ``torch.equal`` to the source's (the bf16 hot pairs, rebuilt by
   B2, bit for bit), 512 x 8 queries at k=1000 and k=100 equal to the
   source's, the first 64 held to ``ReferenceEngine``, and B2 launched
   twice a hot bucket in each load, no plain twin run; (b) a
   ``DenseEngine`` over 16,384 docs of the headline corpus (a 2.1 GB
   table) the same way, B3 on its searches; (c) ``bm25-tpu-torch
   checkpoint`` of phase 13's index dir and ``Server(device_checkpoint=
   ...)`` over it (start seconds beside phase 13's build), 4 clients for
   5 s with every 10th response held to the oracle, deep health green, a
   400 on ``/reload`` with no index dir, and ``updatable=True`` beside a
   checkpoint refused; (d) ``warm_engine`` at top_k 10, 100 and 1000 on
   the restored model-layout engine (no nvcc or load left after phase
   2), ``cache export`` and ``cache import`` through the CLI (the
   fingerprint logged), an archive naming another sm refused without
   ``--force``, and phase 12's ``cold_start`` row: the headline step's
   first call in fresh processes against an empty build directory (nvcc
   runs), this one and an imported copy (no nvcc).
15. the doc-sharded engines on phase 4's corpus and batch, each result
   held to ``ReferenceEngine`` (the first 64 queries) and to the
   single-device engine at the same layout (ids equal, scores within 2e-5
   x the row's largest |score|): (a) ``ShardedSparseEngine`` on
   ``make_mesh()`` (one shard a card) at the model's layout, with
   ``search_ids``, a masked batch, bf16 scores and ``search_pipelined``
   over 2,048 queries; (b) on (1, 4) and (2, 2) meshes over the one card
   and on (1, 4) at hot_tokens=1024, where B2 must build each shard's hot
   pair (its batches routed, its routed chunks logged); each with its
   build seconds, each shard's bytes, its step, its ``local_only`` step
   (the merge is the difference) and the card's busy ms in a step,
   beside ``SparseEngine``'s step; (g) the device checkpoint of that
   (1, 4) hot_tokens=1024 engine and of a (1, 4) ``ShardedEngine`` over
   16,384 docs: saved, loaded (two B2 launches a shard's hot bucket) and
   restored in place, every piece and the results bit-equal, a 2-shard
   mesh refused, with save, load and restore seconds beside the build;
   (c) ``ShardedEngine`` on (1, 1) and (1, 4) over 131,072 docs,
   bit-equal to ``DenseEngine``; (d) a k_local trim, exact, and the
   fallback on planted ties; (e) two ``_multihost_main`` processes
   sharing the card over gloo, which must print ``MULTIHOST_OK`` and
   save and load their own shards of both engines (``CHECKPOINT_OK``);
   (f) ``query --engine sharded_sparse`` equal to ``--engine sparse``.
   B1, B2 and B3 must launch within the phase, no plain twin;
16. the default text path, stemmed text in and top-k out, with no
   ``stemmer=None`` anywhere: the native library's compile seconds into
   an empty build directory; (a) the headline's 524,288 docs as Zipf-word
   text (``datasets.synthetic_corpus``) through ``Tokenizer()`` (C++), its
   first 16,384 docs also through the Python path (equal tokens, timed
   for scale), ``build_scored_index_flat`` with the native CSC and with
   numpy (byte-equal, both timed), ``create_engine`` at the model's
   layout (``SparseEngine``, B1) and 512 text queries of 8 words at
   k=1000 and k=100, the first 64 against ``ReferenceEngine``; (b) 65,536
   docs of 2-6 English fixture sentences, one in 100 with a non-ASCII
   word: the hybrid tokens equal to the Python path's on every doc,
   ``build_index``, ``create_engine`` (B3) and 256 text queries against
   ``ReferenceEngine``, ``Retriever.fit(texts, session=cuda)``,
   ``StreamingIndexBuilder()`` in 4 chunks bit-equal to ``build_index``;
   the CLI's ``index``, ``query`` and ``eval`` on ``tests/data/mini_beir``
   against ``--device cpu``.  B1 and B3 must launch within the phase; the
   host seconds are logged beside the card's name and power limit.

After the last phase no module of the JAX package may have been imported.
The last lines are the kernels' JSON record (each kernel's launches on its
main path, max error against its twin, kernel / twin / one-call library ms
and its bound: the larger of the bytes it must move over 3.35 TB/s and
its operations over the peak rate of their type; B1 as a whole,
``ell_score_fused``, and as its two launches, ``ell_score_scan`` and
``ell_score_hot``, each timed by ``torch.profiler`` inside B1's calls and
bounded by its share of B1's bytes and operations; the scan's tables as
``ell_table``), and the card line from nvidia-smi; the very
last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "ell_score_fused": "bm25_tpu_torch/csrc/ell_score.cu",
    "ell_score_scan": "bm25_tpu_torch/csrc/ell_score.cu",
    "ell_score_hot": "bm25_tpu_torch/csrc/ell_score.cu",
    "ell_score": "bm25_tpu_torch/csrc/ell_score.cu",
    "ell_table": "bm25_tpu_torch/csrc/ell_score.cu",
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
    "matmul_mma_pack": "bm25_tpu_torch/csrc/matmul_schedules.cu",
}
REPLACES = {
    "ell_score_fused": "bm25_tpu/ops/ell_score.py:314",
    "ell_score_scan": "bm25_tpu/ops/ell_score.py:314",
    "ell_score_hot": "bm25_tpu/ops/ell_score.py:314",
    "ell_score": "bm25_tpu/ops/ell_score.py:161",
    "ell_table": "bm25_tpu/ops/ell_score.py:161",
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
    "matmul_mma_pack": "scripts/exp_r4_matmul_precision.py:85",
}
HOT_TOKENS = 1024
MAX_BUCKETS = 2
CHECKED_QUERIES = 64
DENSE_DOCS = 131072  # the JAX bench's sharded_docs corpus
SPARSE_DOCS = 524288  # BenchConfig's default corpus
MATMUL_N = 1028  # the reference's matmul benchmark: M = K = N
MATMUL_BIG = 4096
MATMUL_BIG_SIZES = (2048, MATMUL_BIG)  # B6 optimized beside 1028^3
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
        (8, 8, 1024, 24, 300, 100, 7, False),  # Q = 8, H off the K step
        (200, 8, 1000, 16, 300, 130, 3, True),  # two query blocks, ragged
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


def table_case(rng, q, t, rows, l_pad, vocab, pad_rows, weighted, kind):
    """random_case's bucket and queries, shaped where the scan's lookup
    tables are likeliest to go wrong: "distinct" one distinct id a query
    (B2's build); "hits" half the ids from the bucket's tokens; "shared" a
    token in every query and half the rows; "negative" negative values;
    "zero_weights" weights of 0 in every other column."""
    ids, tokT, valT, did, _, _, w = random_case(
        rng, q, t, rows, l_pad, vocab, 0, pad_rows, weighted)
    if kind == "distinct":
        ids = rng.permutation(vocab)[:q].reshape(q, 1).astype(np.int32)
    elif kind == "hits":
        pick = rng.random(ids.shape) < 0.5
        ids[pick] = rng.choice(tokT[tokT >= 0], int(pick.sum()))
    elif kind == "shared":
        tokT[0, ::2] = vocab + 7
        valT[0, ::2] = rng.standard_normal(len(valT[0, ::2]))
        ids[2:, 2] = vocab + 7
    elif kind == "negative":
        valT = -np.abs(valT)
    elif kind == "zero_weights":
        w[:, ::2] = 0.0
    return ids, tokT, valT, did, w


def phase_table_cases(torch, ops, dev) -> None:
    """B1's and B2's scan on the cases of its lookup tables: each table
    kernel's tables hold what the twin's hold (``table_contents``), B1's
    ELL-only base and B2 bit-equal."""
    rng = np.random.default_rng(1)
    cases = [
        # q, t, rows, l_pad, vocab, pad_rows, weighted, kind
        (300, 1, 1000, 24, 400, 5, False, "distinct"),  # 3 tables, ragged
        (150, 1, 1001, 12, 200, 0, False, "distinct"),  # rows % 4 != 0: B2
        (40, 64, 512, 24, 300, 5, False, "hits"),  # 32 queries a table
        (12, 300, 512, 24, 2000, 5, True, "hits"),  # 4 queries a table
        (512, 8, 1024, 24, 300, 5, False, "shared"),  # one run, 128 pairs
        (512, 8, 1024, 24, 300, 5, True, "shared"),
        (13, 8, 512, 24, 100000, 9, False, "hits"),  # ids past 16 bits
        (13, 8, 512, 24, 80, 9, False, "negative"),
        (13, 8, 512, 24, 80, 9, True, "zero_weights"),
        (140, 4, 1024, 1208, 6000, 5, False, "hits"),  # 3 slot tiles
        (40, 4, 512, 1536, 6000, 5, True, "hits"),
    ]
    for q, t, rows, l_pad, vocab, pad_rows, weighted, kind in cases:
        ids, tokT, valT, did, w = table_case(rng, q, t, rows, l_pad, vocab,
                                             pad_rows, weighted, kind)
        ids_d, tok_d, val_d = (torch.from_numpy(x).to(dev)
                               for x in (ids, tokT, valT))
        w_d = None if w is None else torch.from_numpy(w).to(dev)
        name = (f"q={q} t={t} rows={rows} l_pad={l_pad} {kind}"
                f"{' weighted' if weighted else ''}")
        table = ops.scan_table(ids_d, w_d)
        plain = ops.scan_table_plain(ids_d.cpu(),
                                     None if w_d is None else w_d.cpu())
        if ops.table_contents(table) != ops.table_contents(plain):
            raise AssertionError(f"tables of {name} differ from the twin's")
        if rows % 8 == 0:
            args = (ids_d, tok_d, val_d, torch.from_numpy(did).to(dev))
            for n, x, y in zip(("base", "gmax"),
                               ops.ell_score_fused(*args, weights=w_d,
                                                   table=table),
                               ops.ell_score_fused_plain(*args,
                                                         weights=w_d)):
                compare(torch, x, y, True, f"B1 {n} {name}")
        if w is None:
            compare(torch, ops.ell_score(ids_d, tok_d, val_d, table=table),
                    ops.ell_score_plain(ids_d, tok_d, val_d), True,
                    f"B2 {name}")
        torch.cuda.synchronize()
        held = ["B1"] * (rows % 8 == 0) + ["B2"] * (w is None)
        log(f"[kernels] {name}: tables hold the twin's pairs ({table.qp} "
            f"queries a table); {' and '.join(held)} bit-equal")


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


@contextlib.contextmanager
def side_max(tk, entries: int):
    """B4's side buffer capped at ``entries`` per row (0: off) inside."""
    saved, tk.SIDE_MAX = tk.SIDE_MAX, entries
    try:
        yield
    finally:
        tk.SIDE_MAX = saved


PRIMER = "spin_kernel"  # the kernel of torch.cuda._sleep


def profiled(torch, fn, calls: int):
    """``torch.profiler`` over ``calls`` calls of ``fn()``, after one call
    in the profiler's warm-up step and one short ``PRIMER`` launch in the
    recorded step: the profiler can miss the first launches of a window
    it has only just switched on (one, or on a bad window all of a small
    kernel's ten), so the tracer is prepared a call early and the first
    launch it records is one that no reading counts."""
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
    return prof


def kernel_us(torch, fn, prefixes, calls: int, tries: int = 4) -> dict:
    """{kernel name: (device microseconds, launches recorded)} over
    ``calls`` calls of ``fn()``, for each kernel whose name starts with one
    of ``prefixes`` (``torch.profiler``). A window in which some prefix
    has fewer than ``calls`` launches recorded is profiled again, up to
    ``tries`` windows; the fullest window is kept."""
    best = {}
    for attempt in range(tries):
        out = {}
        for e in profiled(torch, fn, calls).key_averages():
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            if e.device_time_total > 0 and name.startswith(prefixes):
                us, n = out.get(name, (0.0, 0))
                out[name] = (us + e.device_time_total, n + e.count)
        if (sum(n for _, n in out.values())
                > sum(n for _, n in best.values())):
            best = out
        if all(sum(n for name, (_, n) in out.items()
                   if name.startswith(p)) >= calls for p in prefixes):
            break
        got = {name: n for name, (_, n) in out.items()}
        log(f"[kernels] torch.profiler window {attempt + 1} of {tries} "
            f"missed launches of {prefixes}: recorded {got}")
    return best


def device_us(torch, fn, prefixes, calls: int = 5) -> dict:
    """Device microseconds per call of ``fn()`` for each kernel whose name
    starts with one of ``prefixes``, summed by name over ``calls`` calls
    (``torch.profiler``)."""
    return {name: round(us / calls, 1)
            for name, (us, _) in kernel_us(torch, fn, prefixes,
                                           calls).items()}


def launch_us(torch, fn, prefixes, calls: int = 5) -> dict:
    """Device microseconds per launch of each kernel whose name starts
    with one of ``prefixes``: the mean over the launches the profiler
    recorded in ``calls`` calls of ``fn()`` (it may record fewer than were
    made, which a sum per call would read as a faster kernel)."""
    out = {}
    for name, (us, n) in kernel_us(torch, fn, prefixes, calls).items():
        out[name] = round(us / n, 1)
        if n != calls:
            log(f"[kernels] torch.profiler recorded {n} of {calls} "
                f"launches of {name}; the mean is over those {n}")
    return out


def launch_ms(torch, fn, kernels, calls: int) -> list:
    """Device ms a launch of each kernel of ``kernels`` (name prefixes)
    inside ``calls`` calls of ``fn()``, one launch of each a call: the
    mean over the launches ``torch.profiler`` recorded."""
    us = kernel_us(torch, fn, kernels, calls)
    out = []
    for prefix in kernels:
        got = [v for name, v in us.items() if name.startswith(prefix)]
        n = sum(c for _, c in got)
        if not n:
            raise AssertionError(f"torch.profiler recorded no {prefix}")
        out.append(sum(t for t, _ in got) / n / 1e3)
    return out


def b4_kernel_us(torch, tk, x, k, calls: int = 5) -> dict:
    """Device microseconds per call of each of B4's kernels on (x, k)."""
    return device_us(torch, lambda: tk.top_k_two_stage(x, k),
                     ("radix_", "sort_"), calls)


def b5_device_us(torch, tk, logits, calls: int = 10) -> float:
    """Device microseconds a launch of B5's kernel on ``logits``."""
    us = launch_us(torch, lambda: tk.gumbel_choice(logits, 12345),
                   ("gumbel_choice",), calls)
    return sum(us.values()) / max(len(us), 1)


def b4_side_buffer_fill(torch, tk, x, kth, bits: int) -> int:
    """The most keys of any row of ``x`` at or above the top ``bits`` bits
    of its k-th key ``kth``: what B4's side buffer must hold after a first
    digit of that width."""
    shift = 32 - bits
    keys = tk.order_key(x) >> shift
    return int((keys >= (tk.order_key(kth) >> shift)[:, None]).sum(1).max())


def b4_shape(torch, tk, b, n, k) -> str:
    """How B4 cuts and sorts a (b, n) call at k, for the log."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slices, _ = tk.radix_slices(min(b, tk.ROW_CHUNK), n, sms)
    sort = ("shared-memory sort" if k <= tk.SORT_SMEM_KEYS
            else "global LSD sort")
    return f"{slices} slice{'s' if slices > 1 else ''} a row, {sort}"


def phase_topk_cases(torch, tk, dev) -> None:
    """B4 vs its twin and the tree: ties, -inf rows, k = N, ragged rows,
    rows split over blocks, k beyond the shared-memory sort, the side
    buffer on and off, k beyond JAX's chunk (counted tree calls),
    largest=False."""
    rng = np.random.default_rng(2)
    cases = [(5, 100, 7), (4, 16384, 100), (4, 16385, 64), (3, 40000, 16),
             (6, 131072, 1000), (3, 300, 300), (2, 50000, 1),
             (3, 131072, 7300), (3, 20000, 10001), (8, 524288, 100),
             (2, 524288, 20000)]
    for b, n, k in cases:
        x = rng.integers(0, 6, (b, n)).astype(np.float32)  # heavy ties
        x[0] = -np.inf  # exhausted row
        x[1, ::3] = -np.inf
        if b > 2:
            x[2, : n // 2] = -np.inf
        x = torch.from_numpy(x).to(dev)
        want = {"twin": tk.topk_two_stage_plain(x, k),
                "tree": tk.top_k_tree(x, k)}
        for cap in (tk.SIDE_MAX, 0):
            with side_max(tk, cap):
                v, i = tk.top_k_two_stage(x, k)
            for name, (wv, wi) in want.items():
                what = f"B4 ({b}, {n}) k={k} SIDE_MAX={cap} vs {name}"
                compare(torch, v, wv, True, what)
                compare(torch, i, wi, True, what + " (idx)")
        if any(len(set(r)) != k for r in i.cpu().numpy().tolist()):
            raise AssertionError(f"B4 ({b}, {n}) k={k}: repeated indices")
        log(f"[kernels] B4 ({b}, {n}) k={k} ({b4_shape(torch, tk, b, n, k)}; side "
            "buffer on and off): equal to twin and tree, distinct indices")
    x = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0, float("nan"), float("inf"),
                       float("-inf"), float("nan"), -2.5]], device=dev)
    for k in (1, 4, 10):
        v, i = tk.top_k_two_stage(x, k)
        pv, pi = tk.topk_two_stage_plain(x, k)
        compare(torch, v.view(torch.int32), pv.view(torch.int32), True,
                f"B4 +-0/NaN/inf k={k} (bits)")
        compare(torch, i, pi, True, f"B4 +-0/NaN/inf k={k} (idx)")
    log("[kernels] B4 on +-0, NaN and +-inf: values bit-equal to the twin "
        "(-0 kept), indices equal")
    x = torch.from_numpy(rng.standard_normal((4, 40000)).astype(
        np.float32).round(1)).to(dev)
    for k in (50, 6000, 14000):
        tree_before = tk.tree_calls["top_k_two_stage"]
        v, i = tk.top_k(x, k, largest=False, implementation="pallas")
        tv, ti = tk.top_k(x, k, largest=False, implementation="tree")
        compare(torch, v, tv, True, f"B4 largest=False k={k}")
        compare(torch, i, ti, True, f"B4 idx largest=False k={k}")
        beyond = not tk.kernel_serves(40000, k)
        if tk.tree_calls["top_k_two_stage"] != tree_before + beyond:
            raise AssertionError("B4's tree calls are not counted")
        log(f"[kernels] B4 largest=False (4, 40000) k={k}: equal to the tree"
            + (" (k wider than JAX's 13,440-wide chunk: served by the tree, "
               "counted)" if beyond else f" ({b4_shape(torch, tk, 4, 40000, k)})"))


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


def b5_edge_columns(k: int) -> list:
    """Columns at the edges of what a lane, a warp, a block or a cluster's
    block reads in any B5 layout: the row's ends, a lane's 4-column runs,
    the strides of 32-1,024 lanes, and the slices of clusters of 2-8."""
    cols = {0, 1, 2, 3, 4, 5, 31, 32, 33, k - 5, k - 4, k - 3, k - 2, k - 1}
    for lanes in (32, 64, 128, 256, 1024):
        cols |= {4 * lanes - 1, 4 * lanes, 4 * lanes + 1}
    for c in (2, 4, 8):
        s = -(-k // (4 * c)) * 4
        for p in range(1, c):
            cols |= {p * s - 1, p * s, p * s + 1}
    return sorted(c for c in cols if 0 <= c < k)


def b5_nan_rows(torch, dev):
    """Rows whose choice does not depend on the noise -> (logits, the
    choices): all NaN, NaN among numbers (the first NaN wins), all -inf,
    NaN after -inf."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (6, 37)).astype(np.float32))
    x[0] = float("nan")
    x[1, [7, 20]] = float("nan")
    x[2, -1] = float("nan")
    x[3] = float("-inf")
    x[4, :30] = float("-inf")
    x[4, [31, 33]] = float("nan")
    x[5, 0] = float("nan")
    return x.to(dev), [0, 7, 36, 0, 31, 0]


def phase_gumbel_cases(torch, tk, dev) -> None:
    """B5: NaN rows in every layout; twin agreement and determinism per
    seed in every layout at the sampling shapes and a ragged one;
    membership; greedy; a fully -inf row through the sampling call; no
    host sync in the sampling call with a CUDA generator."""
    plans = {"wrapper's": None, "warp": tk.WARP_PLAN,
             "block": tk.ChoicePlan("block", 1024, 1),
             "cluster of 2": tk.ChoicePlan("cluster", 1024, 2),
             "cluster of 8": tk.ChoicePlan("cluster", 1024, 8)}
    x, want = b5_nan_rows(torch, dev)
    wide = torch.full((3, 50001), float("nan"), device=dev)
    wide[1, 40000] = 1.0
    wide[2] = float("-inf")
    wide[2, 49999] = float("nan")
    for name, plan in plans.items():
        for seed in (0, 1, 2**32 - 1):
            got = tk._gumbel_launch(x, seed, plan=plan)
            if got.tolist() != want or not torch.equal(
                    got, tk.gumbel_choice_plain(x, seed)):
                raise AssertionError(f"B5 ({name} layout) on NaN rows: "
                                     f"{got.tolist()}, want {want}")
        got = tk._gumbel_launch(wide, 5, plan=plan).tolist()
        if got != [0, 0, 49999]:
            raise AssertionError(f"B5 ({name} layout) on wide NaN rows: "
                                 f"{got}")
    log("[kernels] B5 on NaN rows (all NaN, NaN among numbers and after "
        "-inf, 37 and 50,001 wide): the first NaN column, equal to the "
        "twin, in every layout")
    for k in (37, 100, 4099, 50001, 131072):
        cols = b5_edge_columns(k)
        x = torch.full((len(cols), k), float("-inf"), device=dev)
        x[torch.arange(len(cols)), torch.tensor(cols)] = 0.0
        for name, plan in plans.items():
            got = tk._gumbel_launch(x, 9, plan=plan).tolist()
            if got != cols:
                raise AssertionError(f"B5 ({name} layout) at k={k} missed an "
                                     f"edge column: {got}, want {cols}")
    log("[kernels] B5 on rows of -inf with one 0 at each edge of a run, a "
        "lane's stride or a cluster's slice (k = 37 to 131,072): that "
        "column, in every layout")
    rng = np.random.default_rng(3)
    for b, k in ((300, 100), (512, 1000), (64, 32768), (8, 131072),
                 (13, 50001)):
        logits = torch.from_numpy(rng.standard_normal((b, k)).astype(
            np.float32)).to(dev)
        logits[0, k // 2:] = float("-inf")
        err = 0.0
        for name, plan in plans.items():
            for seed in (0, 1, 2**32 - 1):
                got = tk._gumbel_launch(logits, seed, plan=plan)
                if not torch.equal(got, tk._gumbel_launch(logits, seed,
                                                          plan=plan)):
                    raise AssertionError(f"B5 ({name} layout) at ({b}, {k})"
                                         ": same seed, different choices")
                err = max(err, choice_err(torch, tk, logits, seed, got,
                                          tk.gumbel_choice_plain(logits,
                                                                 seed)))
                if int(got[0]) >= k // 2:
                    raise AssertionError("B5 chose a -inf column")
        log(f"[kernels] B5 at ({b}, {k}) (the wrapper picks the "
            f"{tk._device_plan(b, k, dev.index or 0).layout} layout): every "
            f"layout deterministic per seed and the twin's choices up to "
            f"float noise (max z gap {err:.3e})")
    x = torch.from_numpy(rng.random((64, 2000), np.float32)).to(dev)
    x[5] = float("-inf")
    _, ti = tk.top_k_tree(x, 10)
    gen = torch.Generator(device=dev)
    _, s1 = tk.top_k_fused_sampling(x, 10, implementation="pallas",
                                    generator=gen.manual_seed(7))
    _, s2 = tk.top_k_fused_sampling(x, 10, implementation="pallas",
                                    generator=gen.manual_seed(7))
    if not torch.equal(s1, s2) or not bool((s1 == ti).any(dim=1).all()):
        raise AssertionError("B5 sampling: not deterministic per seed, or "
                             "a choice outside the top k")
    if int(s1[5, 0]) != 0:
        raise AssertionError("B5 sampling on a fully -inf row: "
                             f"{int(s1[5, 0])}, not its first top-k id 0")
    _, greedy = tk.top_k_fused_sampling(x, 10, temperature=0.0,
                                        implementation="pallas",
                                        generator=gen)
    if not torch.equal(greedy[:, 0], ti[:, 0]):
        raise AssertionError("B5 at temperature 0 is not greedy")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tk.top_k_fused_sampling(x, 10, implementation="pallas",
                                generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("[kernels] B5 sampling: deterministic per seed, members of the top "
        "k, a fully -inf row's first top-k id, greedy at temperature 0, "
        "and no host sync with a CUDA generator (sync debug mode 'error')")


def sparse_main(torch, dev, cfg, ops, session, record):
    """Phase 4: the sparse engine at the benchmark shape; returns its
    index and the index's build timings."""
    from bm25_tpu_torch import ReferenceEngine, SparseEngine, create_engine
    from bm25_tpu_torch.bench import make_queries, make_synthetic_index
    from bm25_tpu_torch.models.sparse import (b1_bytes, hot_counts_for,
                                              hot_ell_for_rows,
                                              split_hot_cold_csr)
    hot_plan = ops.hot_plan
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    t0 = time.perf_counter()
    timings = {}
    index = make_synthetic_index(cfg, timings)
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

    # score_dtype="bfloat16" through create_engine(mode="auto") (sparse at a
    # zero dense budget): the f32 batch's docs, its scores rounded to bf16
    t0 = time.perf_counter()
    bf16 = create_engine(
        index, dense_budget_bytes=0, score_dtype="bfloat16",
        hot_tokens=HOT_TOKENS, hot_budget_bytes=HOT_TOKENS * index.num_docs * 4,
        max_buckets=MAX_BUCKETS, session=session)
    if not isinstance(bf16, SparseEngine) or bf16.score_dtype != "bfloat16":
        raise AssertionError(f"auto built {type(bf16).__name__} "
                             f"{getattr(bf16, 'score_dtype', None)}")
    k = cfg.top_k
    docs, scores = engine.search(queries, top_k=k)
    docs16, scores16 = bf16.search(queries, top_k=k)
    rounded = torch.from_numpy(scores).bfloat16().float().numpy()
    if scores16.dtype != np.float32 or not np.array_equal(docs16, docs) or \
            not np.array_equal(scores16.view(np.uint32),
                               rounded.view(np.uint32)):
        raise AssertionError("score_dtype='bfloat16': not the f32 batch's "
                             "docs and bf16-rounded scores")
    log(f"[sparse] score_dtype='bfloat16' via create_engine(mode='auto'): "
        f"engine built in {time.perf_counter() - t0:.2f} s; the {len(queries)}"
        f"-query batch at k={k} returns the f32 batch's docs and its scores "
        "rounded to bf16, bit for bit")
    del bf16

    # each kernel vs its twin at the main path's shapes: B1 on every
    # bucket (its ms is the batch's total) as its scan and its hot
    # epilogue, the scan's tables once a chunk, B2 on bucket 0's hot ELL;
    # on the batch's unrouted chunk (the routed ones: routed_vs_unrouted)
    engine.route_cold = False
    chunk = engine.plan_chunks(queries)[1][0].padded
    engine.route_cold = "auto"
    ids = session.put(chunk)
    hc, _ = hot_counts_for(ids, engine.hot_table, engine.hot_h)
    plan = hot_plan(hc)  # once per chunk, as the query step makes it
    table = ops.scan_table(ids)  # the same
    # hot tokens some query counts, and the ranks the plan lists (whole
    # groups of 16)
    used = int((hc != 0).any(dim=0).sum())
    listed = int(plan.n_used.item())
    t0 = time.perf_counter()
    plain_table = ops.scan_table_plain(ids.cpu())
    table_plain_ms = (time.perf_counter() - t0) * 1e3
    if ops.table_contents(table) != ops.table_contents(plain_table):
        raise AssertionError("the chunk's tables differ from the twin's")
    table_ms = cuda_ms(torch, lambda: ops.scan_table(ids), 20)
    table_bytes = nbytes(ids, table.words)
    log(f"[kernels] scan tables of ids {tuple(ids.shape)}: {table.qp} "
        f"queries a table, {table.words.shape[0]} tables of "
        f"{table.words.shape[1]} words, the twin's contents; kernel "
        f"{table_ms:.4f} ms, plain (host) {table_plain_ms:.1f} ms")
    hot_pairs = int((hc != 0).sum())
    hot_of = session.get(engine.hot_table)
    # each query's distinct cold ids: a matching (query, cold posting) pair
    # is one FMA of the scan
    cold_ids = [np.unique(r[(r >= 0)][hot_of[r[r >= 0]] < 0])
                for r in chunk]
    # the fan-out case: every query's cold ids replaced by one shared run
    # of the batch's cold ids (the first T in order of appearance)
    seen = list(dict.fromkeys(
        int(x) for r in chunk for x in r if x >= 0 and hot_of[x] < 0))
    shared = np.array(seen[: chunk.shape[1]], np.int32)
    fan = chunk.copy()
    cold = (fan >= 0) & (hot_of[np.maximum(fan, 0)] < 0)
    fan[cold] = np.broadcast_to(shared[np.arange(fan.shape[1])
                                       % len(shared)], fan.shape)[cold]
    fan_ids = session.put(fan)
    fan_table = ops.scan_table(fan_ids)
    fan_cold = [np.unique(r[cold[i]]) for i, r in enumerate(fan)]
    b1_err = scan_err = 0.0
    # the bytes B1 must move on each bucket: the package's count, which the
    # query benchmark's hbm_utilization uses too
    per_bucket = b1_bytes(engine, ids)
    tot = dict.fromkeys(("ms", "plain", "scan", "scan_plain", "hot",
                         "hot_plain", "masked", "fan", "fan_masked", "pairs",
                         "fan_pairs", "scan_bytes", "hot_bytes", "hot_ops"),
                        0.0)
    # B1's two launches, timed inside B1's own calls
    b1_kernels = ("ell_scan_kernel", "ell_hot_kernel")
    for i, b in enumerate(engine.buckets):
        rows = b["doc_ids"].shape[0]
        postings = torch.bincount(b["tokT"][b["tokT"] >= 0].long(),
                                  minlength=index.vocab_size).cpu().numpy()
        pairs = int(sum(postings[c].sum() for c in cold_ids))
        fan_pairs = int(sum(postings[c].sum() for c in fan_cold))
        # B1's bound, as its scan's and its hot epilogue's.  The scan's
        # bytes (b1_bytes): ids and the slots' tokens read once, a value
        # only where the slot's token is some query's cold id, the (Q,
        # rows) base written once; one FMA a matching pair.  The hot
        # epilogue's: what B1 moves beyond that (the used hot rows, hi and
        # lo; the plan's counts; doc_ids; the maxima), no trip of the
        # base; two bf16 products a used (query, hot token, row).  The two
        # add up to B1's.
        matched = per_bucket[i].matched
        tot["scan_bytes"] += per_bucket[i].scan
        tot["hot_bytes"] += per_bucket[i].epilogue
        tot["hot_ops"] += 2 * 2 * hot_pairs * rows
        tot["pairs"] += pairs
        tot["fan_pairs"] += fan_pairs
        args = (ids, b["tokT"], b["valT"], b["doc_ids"], hc, b["hotT"],
                b["hotLo"])
        compare(torch, ops.ell_score_fused(*args[:4], table=table)[0],
                ops.ell_score_fused_plain(*args[:4])[0], True,
                f"B1 ELL-only base, bucket {i}")
        b1_err = max([b1_err] + [
            compare(torch, x, y, False, f"B1 {n}, bucket {i}")
            for n, x, y in zip(("base", "gmax"),
                               ops.ell_score_fused(*args, plan=plan,
                                                   table=table),
                               ops.ell_score_fused_plain(*args))])
        # the scan B1 launches before its hot kernel (no mask): B2's entry
        # runs that kernel, held bit-equal to its twin
        scan_want = ops.ell_score_plain(*args[:3])
        scan_err = max(scan_err, compare(
            torch, ops.ell_score(*args[:3], table=table), scan_want, True,
            f"B1's scan, bucket {i}"))
        del scan_want
        fan_args = (fan_ids, *args[1:4])
        compare(torch, ops.ell_score_fused(*fan_args, table=fan_table)[0],
                ops.ell_score_fused_plain(*fan_args)[0], True,
                f"B1 ELL-only base, fan-out, bucket {i}")

        def b1_call(a=args, p=plan, t=table):
            return ops.ell_score_fused(*a, plan=p, table=t)

        ms = cuda_ms(torch, b1_call, 10)
        scan_ms, hot_ms = launch_ms(torch, b1_call, b1_kernels, 10)
        masked = cuda_ms(torch, lambda: ops.ell_score_fused(
            *args[:4], table=table), 10)
        fan_ms = cuda_ms(torch, lambda: ops.ell_score(
            *fan_args[:3], table=fan_table), 10)
        fan_masked = cuda_ms(torch, lambda: ops.ell_score_fused(
            *fan_args, table=fan_table), 10)
        plain_ms = cuda_ms(torch, lambda: ops.ell_score_fused_plain(*args), 2)
        scan_plain = cuda_ms(torch, lambda: ops.ell_score_plain(*args[:3]), 1)
        # the hot epilogue's twin: the hot products, the mask and the
        # maxima, from a base of +0
        hot_plain = cuda_ms(torch, lambda: ops.ell_score_fused_plain(
            ids, None, None, *args[3:]), 2)
        log(f"[kernels] B1 at ids {tuple(ids.shape)} x bucket {i} "
            f"{tuple(b['tokT'].shape)} + hot {engine.hot_h} ({used} used, "
            f"{listed} listed), "
            f"{pairs} matching (query, cold posting) pairs on {matched} "
            f"slots: kernel {ms:.4f} ms; torch.profiler a launch: scan "
            f"{scan_ms:.4f} + hot epilogue {hot_ms:.4f} ms (the masked scan "
            f"alone, no hot tier: {masked:.4f} ms); plain {plain_ms:.3f} ms "
            f"= scan {scan_plain:.3f} + hot {hot_plain:.3f} ms")
        log(f"[kernels] B1 fan-out at bucket {i}: {fan_pairs} pairs, the "
            f"ELL-only base bit-equal; scan {fan_ms:.4f} ms, masked scan "
            f"{fan_masked:.4f} ms")
        for key, v in (("ms", ms), ("plain", plain_ms), ("scan", scan_ms),
                       ("scan_plain", scan_plain), ("hot", hot_ms),
                       ("hot_plain", hot_plain), ("masked", masked),
                       ("fan", fan_ms), ("fan_masked", fan_masked)):
            tot[key] += v
        # the small-batch path: a chunk of 8 queries (16 a hot block)
        a8 = (ids[:8].contiguous(), *args[1:4], hc[:8].contiguous(),
              *args[5:])
        compare(torch, ops.ell_score_fused(*a8[:4])[0],
                ops.ell_score_fused_plain(*a8[:4])[0], True,
                f"B1 ELL-only base, 8 queries, bucket {i}")
        for n, x, y in zip(("base", "gmax"), ops.ell_score_fused(*a8),
                           ops.ell_score_fused_plain(*a8)):
            compare(torch, x, y, False, f"B1 {n}, 8 queries, bucket {i}")
        plan8, table8 = hot_plan(a8[4]), ops.scan_table(a8[0])

        def b1_call8(a=a8, p=plan8, t=table8):
            return ops.ell_score_fused(*a, plan=p, table=t)

        ms8 = cuda_ms(torch, b1_call8, 50)
        scan8, hot8 = launch_ms(torch, b1_call8, b1_kernels, 10)
        log(f"[kernels] B1 at 8 queries x bucket {i} "
            f"({int(plan8.n_used.item())} hot ranks listed): kernel "
            f"{ms8:.4f} ms; torch.profiler a launch: scan {scan8:.4f} + hot "
            f"epilogue {hot8:.4f} ms; the 8-query chunk matches the twin")
    b0 = engine.buckets[0]
    hot_ids, _, hot_csr = split_hot_cold_csr(index, engine.hot_h)
    htok, hval = hot_ell_for_rows(hot_csr, session.get(b0["doc_ids"]))
    b2_args = (session.put(hot_ids.reshape(-1, 1)), session.put(htok),
               session.put(hval))
    b2_table = ops.scan_table(b2_args[0])
    b2_err = compare(torch, ops.ell_score(*b2_args, table=b2_table),
                     ops.ell_score_plain(*b2_args), True, "B2, main shape")
    b2_ms = cuda_ms(torch, lambda: ops.ell_score(*b2_args, table=b2_table),
                    10)
    # every non-pad slot matches one query: its value read, one FMA
    b2_slots = int((b2_args[1] >= 0).sum())
    b2_bound = bound(nbytes(*b2_args[:2]) + 4 * b2_slots
                     + engine.hot_h * htok.shape[1] * 4,
                     [(2 * b2_slots, F32_OPS_PER_S)])
    b2_plain_ms = cuda_ms(torch, lambda: ops.ell_score_plain(*b2_args), 3)
    log(f"[kernels] B1 per batch (all buckets): kernel {tot['ms']:.4f} ms; "
        f"torch.profiler: scans {tot['scan']:.4f} + hot epilogues "
        f"{tot['hot']:.4f} ms (masked scans alone {tot['masked']:.4f} ms); "
        f"plain {tot['plain']:.3f} ms = scans {tot['scan_plain']:.3f} + hot "
        f"{tot['hot_plain']:.3f} ms, max_abs_err {b1_err:.3e}; "
        f"{int(tot['pairs'])} matching (query, cold posting) pairs a batch; "
        f"fan-out {int(tot['fan_pairs'])} pairs, scans {tot['fan']:.4f} ms "
        f"(masked {tot['fan_masked']:.4f} ms)")
    log(f"[kernels] B2 at hot ids ({engine.hot_h}, 1) x hot ELL "
        f"{tuple(htok.shape)}: kernel {b2_ms:.4f} ms, plain "
        f"{b2_plain_ms:.3f} ms, bit-equal")
    scan_ops = [(2 * tot["pairs"], F32_OPS_PER_S)]
    hot_ops = [(tot["hot_ops"], BF16_TC_OPS_PER_S)]
    record["ell_score_fused"] = kernel_record(
        launches["ell_score_fused"], b1_err, tot["ms"], tot["plain"],
        bound(tot["scan_bytes"] + tot["hot_bytes"], scan_ops + hot_ops))
    record["ell_score_scan"] = kernel_record(
        launches["ell_score_scan"], scan_err, tot["scan"], tot["scan_plain"],
        bound(tot["scan_bytes"], scan_ops))
    record["ell_score_hot"] = kernel_record(
        launches["ell_score_hot"], b1_err, tot["hot"], tot["hot_plain"],
        bound(tot["hot_bytes"], hot_ops))
    record["ell_score"] = kernel_record(launches["ell_score"], b2_err,
                                        b2_ms, b2_plain_ms, b2_bound)
    record["ell_table"] = kernel_record(launches["ell_table"], 0.0, table_ms,
                                        table_plain_ms, bound(table_bytes))
    routed_b1(torch, ops, engine, index)
    routed_vs_unrouted(torch, engine, ref, cfg)
    alone_vs_batch(torch, engine, index, cfg)
    masked_and_dedup(torch, engine, ref, cfg)
    pipeline_busy(torch, engine, cfg)
    return index, timings


def routed_b1(torch, ops, engine, index) -> None:
    """Phase 4: B1 on routed chunks against its twin, on every bucket: 256
    queries of Zipf ids holding 2, 4 and 64 cold ids each (the scan reads
    the (Q, T_c) cold ids, the hot epilogue the counts of the full ids),
    the ELL-only base bit-equal, the fused base and maxima within 2e-5 x
    the row's largest |score|."""
    from bm25_tpu_torch.bench.layout_sweep import routed_rows
    from bm25_tpu_torch.models.sparse import hot_counts_for
    from bm25_tpu_torch.utils.padding import next_pow2_at_least

    session = engine.session
    errs = {}
    for t_c in (2, 4, 64):
        full, cold = routed_rows(index, engine.hot_table_host, 256, t_c,
                                 seed=100 + t_c)
        width = next_pow2_at_least(max(full.shape[1], 8))
        full = np.pad(full, ((0, 0), (0, width - full.shape[1])),
                      constant_values=-1)
        ids, cids = session.put(full), session.put(cold)
        hc, hlo = hot_counts_for(ids, engine.hot_table, engine.hot_h)
        plan, table = ops.hot_plan(hc, hlo), ops.scan_table(cids)
        err = 0.0
        for i, b in enumerate(engine.buckets):
            args = (cids, b["tokT"], b["valT"], b["doc_ids"])
            compare(torch, ops.ell_score_fused(*args, table=table)[0],
                    ops.ell_score_fused_plain(*args)[0], True,
                    f"routed B1 ELL-only base, T_c={t_c}, bucket {i}")
            hot = (hc, b["hotT"], b["hotLo"])
            err = max([err] + [compare(torch, x, y, False,
                                       f"routed B1 {n}, T_c={t_c}, bucket {i}")
                               for n, x, y in zip(
                                   ("base", "gmax"),
                                   ops.ell_score_fused(
                                       *args, *hot, hot_counts_lo=hlo,
                                       plan=plan, table=table),
                                   ops.ell_score_fused_plain(
                                       *args, *hot, hot_counts_lo=hlo))])
        errs[t_c] = (tuple(full.shape), table.qp, err)
    log("[routing] B1 on routed chunks (cold ids T_c, full ids T) against "
        "its twin on every bucket, the ELL-only base bit-equal: " + "; ".join(
            f"T_c={t}: full ids {shape}, {qp} queries a table, max_abs_err "
            f"{e:.3e}" for t, (shape, qp, e) in errs.items()))


def plan_step_ms(torch, engine, plan, k: int, step=None,
                 iters: int = 10) -> float:
    """Device ms of the step over every chunk of ``plan`` (weights and
    cold ids included), back to back on the same inputs (CUDA events,
    ``query_bench._time_enqueued``)."""
    from bm25_tpu_torch.bench.query_bench import _time_enqueued

    step = step or engine.query_step(k)
    put = engine.session.put
    args = [tuple(None if x is None else put(x) for x in c[1:])
            for c in plan[1]]

    def enqueue(n):
        acc = torch.zeros((), device=engine.session.device)
        for _ in range(n):
            for ids, w, cold, wc in args:
                s, _ = step(ids, engine.buckets, engine.offsets,
                            engine.hot_table, w, None, engine._tail, cold,
                            wc)
                acc = acc + s.amax()
        return acc

    return _time_enqueued(enqueue, engine.session.device, iters)


def bit_equal(got, want, what: str) -> None:
    """Two searches of the same queries whose chunks differ (routed and
    not; alone, in a small chunk and in the batch): ids and scores equal
    bit for bit, as a query's hot sums do not depend on its chunk-mates."""
    if not (np.array_equal(got[0], want[0])
            and np.array_equal(np.asarray(got[1]).view(np.uint32),
                               np.asarray(want[1]).view(np.uint32))):
        diff = np.abs(np.asarray(got[1]) - np.asarray(want[1]))
        raise AssertionError(f"{what}: not bit-equal (ids equal: "
                             f"{np.array_equal(got[0], want[0])}, scores "
                             f"differ by up to {diff.max():.3e})")


def routed_vs_unrouted(torch, engine, ref, cfg) -> None:
    """Phase 4: cold-width routing at the explicit h=1024 / 2-bucket
    layout, where JAX's "auto" rule engages: 512 x 8 and 512 x 64 Zipf
    queries at k=1000 and k=100, routed (``route_cold="auto"``) and not
    (False), each against ``ReferenceEngine`` (first 64 queries) and
    against each other bit for bit (``bit_equal``), with the plan's chunks,
    the host ms of the plan alone (``plan_chunks``, median of 5: the
    routed plan runs JAX's chunk DP a row at a time), the device step of
    the whole batch (``plan_step_ms``) and the wall ms of ``search``
    (median of 5: the host's plan included) in turns: routed, unrouted,
    unrouted, routed."""
    from bm25_tpu_torch.bench import make_queries
    from bm25_tpu_torch.models.sparse import maybe_dedup
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    sub = slice(0, CHECKED_QUERIES)
    for t in (8, 64):
        q = make_queries(dataclasses.replace(cfg, query_len=t,
                                             num_queries=cfg.batch))
        qd, wd = maybe_dedup(q, None, engine.dedup_queries,
                             engine.dedup_min_width)
        for k in (cfg.top_k, cfg.top_k2):
            want = ref.search(q[sub], top_k=k)
            res, plans, plan_ms, ms, wall = {}, {}, {}, {}, {}
            for route in ("auto", False, False, "auto"):
                engine.route_cold = route
                if route not in res:
                    res[route] = engine.search(q, top_k=k)
                    assert_matches_oracle(res[route][0][sub],
                                          res[route][1][sub], *want)
                    plans[route] = engine.plan_chunks(qd, wd, k=k)
                    plan_ms[route] = wall_ms(
                        lambda: engine.plan_chunks(qd, wd, k=k))
                ms.setdefault(route, []).append(
                    plan_step_ms(torch, engine, plans[route], k))
                wall.setdefault(route, []).append(wall_ms(
                    lambda: engine.search(q, top_k=k)))
            engine.route_cold = "auto"
            if plans["auto"][0] is None:
                raise AssertionError(f"{t}-token batch at k={k}: 'auto' "
                                     "did not route")
            bit_equal(res["auto"], res[False],
                      f"routed vs unrouted, T={t}, k={k}")
            chunks = [(c.cq, c.padded.shape[0], c.cold_padded.shape[1])
                      for c in plans["auto"][1]]
            log(f"[routing] {len(q)} x {t} queries (planned {qd.shape[1]} "
                f"wide{', dedup weights' if wd is not None else ''}), k={k}: "
                f"routed {len(chunks)} chunks (rows, height, cold width) "
                f"{chunks}, plan {plan_ms['auto']:.3f} ms, device step "
                f"{', '.join(f'{x:.4f}' for x in ms['auto'])} ms, search "
                f"wall {', '.join(f'{x:.3f}' for x in wall['auto'])} ms; "
                f"unrouted {len(plans[False][1])} chunks, plan "
                f"{plan_ms[False]:.3f} ms, step "
                f"{', '.join(f'{x:.4f}' for x in ms[False])} ms, wall "
                f"{', '.join(f'{x:.3f}' for x in wall[False])} ms; both match "
                f"ReferenceEngine (first {CHECKED_QUERIES}) and each other "
                f"bit for bit")


# rows of phase 4's batch searched alone, in chunks of 8 and 16
ALONE_ROWS = (0, 1, 2, 7, 8, 15, 16, 63, 64, 127, 128, 255, 256, 383, 384,
              511)


def alone_vs_batch(torch, engine, index, cfg) -> None:
    """Phase 4: a query's results do not depend on the queries it is
    searched with.  At the explicit h=1024 / 2-bucket layout, on
    ``SparseEngine`` and on a (1, 4) ``ShardedSparseEngine`` over the card
    at the same layout: the batch's 512 x 8 queries at k=1000, 100 and
    10, unweighted and weighted (seeded uniform weights), each searched
    whole (routed: "auto" engages), and ``ALONE_ROWS`` searched one at a
    time, and in the chunks of 8 and of 16 rows holding them: ids and
    scores bit-equal to their rows of the batch (``bit_equal``)."""
    from bm25_tpu_torch import ShardedSparseEngine
    from bm25_tpu_torch.bench import make_queries
    from bm25_tpu_torch.parallel import make_mesh

    queries = make_queries(cfg)[: cfg.batch]
    w = np.random.default_rng(4).uniform(
        0.1, 3.0, queries.shape).astype(np.float32)
    t0 = time.perf_counter()
    sharded = ShardedSparseEngine.from_scored_index(
        index, mesh=make_mesh(4, devices=[engine.session.device] * 4),
        hot_tokens=HOT_TOKENS, hot_budget_bytes=HOT_TOKENS * index.num_docs
        * 4, max_buckets=MAX_BUCKETS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for name, eng in (("SparseEngine", engine),
                      ("(1, 4) ShardedSparseEngine", sharded)):
        if eng.hot_h != HOT_TOKENS:
            raise AssertionError(f"{name}: hot_h {eng.hot_h}")
        searches = 0
        t0 = time.perf_counter()
        for k in (cfg.top_k, cfg.top_k2, 10):
            plan = eng.plan_chunks(queries, k=k) if eng is engine else \
                eng._plan(queries, None, k)
            if plan[0] is None:
                raise AssertionError(f"{name} k={k}: the batch not routed")
            for kw in ({}, {"weights": w}):
                batch = eng.search(queries, top_k=k, **kw)
                spans = {(i, i + 1) for i in ALONE_ROWS}
                spans |= {(i // n * n, i // n * n + n) for i in ALONE_ROWS
                          for n in (8, 16)}
                for a, b in sorted(spans):
                    got = eng.search(queries[a:b], top_k=k, **{
                        n: v[a:b] for n, v in kw.items()})
                    bit_equal(got, (batch[0][a:b], batch[1][a:b]),
                              f"{name} rows {a}:{b} of the batch, k={k}"
                              f"{', weighted' if kw else ''}")
                    searches += 1
        log(f"[alone] {name} at h={eng.hot_h}, {len(eng.buckets)} buckets"
            + (f" (built in {build_s:.2f} s)" if eng is sharded else "")
            + f": {len(ALONE_ROWS)} of the batch's {len(queries)} x "
            f"{queries.shape[1]} queries alone, and the chunks of 8 and 16 "
            f"holding them ({searches} searches, {time.perf_counter() - t0:.1f}"
            f" s), at k={cfg.top_k}, {cfg.top_k2} and 10, unweighted and "
            "weighted: ids and scores bit-equal to their rows of the "
            "routed batch")
    del sharded
    torch.cuda.empty_cache()


def union_selection(torch, session, index, cfg) -> None:
    """Phase 4c: union selection (``union_select=True``) against the
    per-bucket path on phase 4's corpus at the model's layout for k=1000
    (``choose_layout``: its hot tier and 2 buckets) and at 4 buckets, 512
    x 8 queries at k=1000: ids and scores bit-equal, the device step of
    the per-bucket path, of union reading its exactness flag once a chunk
    (the engine's) and of union unchecked (``"unsafe"``), in turns; then
    an all-tied corpus over two buckets, where the flag must trip and the
    fallback give doc ids 0..9."""
    from bm25_tpu_torch import SparseEngine
    from bm25_tpu_torch.bench import make_queries
    from bm25_tpu_torch.models.sparse import (choose_layout,
                                              make_sparse_query_step,
                                              union_applies)
    from bm25_tpu_torch.scoring import build_scored_index

    queries = make_queries(cfg)[: cfg.batch]
    k = cfg.top_k
    layout = choose_layout(index, k, device=session.device)
    h = layout["hot_tokens"]
    for buckets in (layout["max_buckets"], 4):
        t0 = time.perf_counter()
        engine = SparseEngine.from_scored_index(
            index, session=session, hot_tokens=h,
            hot_budget_bytes=max(h, 1) * index.num_docs * 4,
            max_buckets=buckets)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if not union_applies(True, engine.buckets, k):
            raise AssertionError(f"{buckets} buckets: union does not apply")
        per = engine.search(queries, top_k=k)
        engine.union_select = True
        uni = engine.search(queries, top_k=k)
        if not (np.array_equal(uni[0], per[0])
                and np.array_equal(uni[1], per[1])):
            raise AssertionError(f"{buckets} buckets: union differs from "
                                 "the per-bucket path")
        plan = engine.plan_chunks(queries, k=k)
        steps = {"per-bucket": make_sparse_query_step(k, engine.hot_h),
                 "union (flag read)": engine.query_step(k),
                 "union unchecked": make_sparse_query_step(
                     k, engine.hot_h, union_select="unsafe")}
        ms = {}
        for name in (*steps, *reversed(steps)):
            ms.setdefault(name, []).append(
                plan_step_ms(torch, engine, plan, k, steps[name]))
        log(f"[union] h={engine.hot_h}, {len(engine.buckets)} buckets "
            f"(built in {build_s:.2f} s), {len(queries)} x "
            f"{queries.shape[1]} queries at k={k} in {len(plan[1])} chunks: "
            "union's ids and scores equal the per-bucket path's bit for "
            "bit; device step ms, in turns: " + "; ".join(
                f"{n} {', '.join(f'{x:.4f}' for x in v)}"
                for n, v in ms.items()))
        del engine
        torch.cuda.empty_cache()
    tied = build_scored_index([np.array([0, 1], np.int32)] * 2048,
                              vocab_size=4)
    engine = SparseEngine.from_scored_index(tied, session=session,
                                            max_buckets=2)
    engine.union_select = True
    d, s = engine.search(np.array([[0, 1]], np.int32), top_k=10)
    if len(engine.buckets) != 2 or not np.array_equal(d[0], np.arange(10)) \
            or len(set(s[0].tolist())) != 1:
        raise AssertionError(f"the tied union fallback returned {d[0]}")
    log("[union] all-tied corpus over 2 buckets: the flag trips, the "
        "fallback returns doc ids 0..9, every score equal")


def wall_ms(fn, reps: int = 5) -> float:
    """Median host wall ms of ``fn()`` over ``reps`` calls, after one."""
    fn()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def device_busy_ms(torch, fn) -> float:
    """Milliseconds in which the card ran some kernel or copy during one
    call of ``fn()`` (the union of the device spans ``torch.profiler``
    records), after a warm-up call."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in profiled(torch, fn, 1).events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and PRIMER not in e.name)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def pipeline_busy(torch, engine, cfg) -> None:
    """Phase 4, last: the benchmark's 2,048 queries in 512-query batches at
    k=1000 and k=100, serial (``search`` a batch) and pipelined
    (``search_pipelined``): host wall ms a batch (median of 5 passes, no
    profiler), the card's busy ms a batch (``torch.profiler``) and the
    idle share 1 - busy / wall."""
    from bm25_tpu_torch.bench import make_queries

    queries = make_queries(cfg)
    batches = range(0, len(queries), cfg.batch)
    for k in (cfg.top_k, cfg.top_k2):
        for name, fn in (
                ("serial", lambda k=k: [engine.search(
                    queries[i : i + cfg.batch], top_k=k) for i in batches]),
                ("pipelined", lambda k=k: engine.search_pipelined(
                    queries, top_k=k, batch=cfg.batch))):
            wall = wall_ms(fn) / len(batches)
            busy = device_busy_ms(torch, fn) / len(batches)
            if busy <= 0:
                raise AssertionError("torch.profiler recorded no device time")
            log(f"[sparse] {name} search of {len(queries)} queries in "
                f"{cfg.batch}-query batches, k={k}: {wall:.3f} ms a batch "
                f"wall (median of 5; {len(queries) / (wall * len(batches)) * 1e3:.0f}"
                f" qps), {busy:.3f} ms busy (torch.profiler), idle share "
                f"{1 - busy / wall:.3f}")


def masked_and_dedup(torch, engine, ref, cfg) -> None:
    """Phase 4, last: masked batches (a random mask, and one that leaves
    fewer than k docs eligible, with a whole group of 8 eligible beside a
    dropped one) against the oracle, the shortfall doc -1 / score 0
    exactly, timed beside the unmasked batch (host wall, median of 5, and
    the card's busy ms), the random mask also uploaded once as a tensor on
    the card; then 512 queries of 64 Zipf tokens (duplicates) at k=1000
    with dedup off, on and "auto", each against the oracle, timed in
    turns."""
    from bm25_tpu_torch.bench import make_queries
    from bm25_tpu_torch.models.sparse import maybe_dedup
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    queries = make_queries(cfg)[: cfg.batch]
    sub = slice(0, CHECKED_QUERIES)
    rng = np.random.default_rng(5)
    few = np.zeros(engine.num_docs, bool)
    few[rng.choice(engine.num_docs, cfg.top_k // 2, replace=False)] = True
    few[:8], few[8:16] = True, False
    part = rng.random(engine.num_docs) < 0.3
    for name, mask in (("random 30%", part),
                       (f"{int(few.sum())} eligible", few)):
        for k in (cfg.top_k, cfg.top_k2):
            docs, scores = engine.search(queries, top_k=k, doc_mask=mask)
            od, os_ = ref.search(queries[sub], top_k=k, doc_mask=mask)
            assert_matches_oracle(docs[sub], scores[sub], od, os_)
            short = docs < 0
            if not np.array_equal(short[sub], od < 0) or \
                    (scores[short] != 0).any():
                raise AssertionError(f"mask {name}: shortfall slots differ")
            log(f"[sparse] doc mask {name}, k={k}: {int(short.sum())} "
                f"shortfall slots (doc -1, score 0); first "
                f"{CHECKED_QUERIES} queries match ReferenceEngine")
    on_card = torch.from_numpy(part).to(engine.session.device)
    for k in (cfg.top_k, cfg.top_k2):
        cells = []
        for name, kw in (("unmasked", {}), ("random 30% mask", {
                "doc_mask": part}), ("the same mask on the card", {
                "doc_mask": on_card}), (f"{int(few.sum())} eligible", {
                "doc_mask": few})):
            def call(kw=kw, k=k):
                return engine.search(queries, top_k=k, **kw)
            cells.append(f"{name} {wall_ms(call):.3f} ms wall / "
                         f"{device_busy_ms(torch, call):.3f} ms busy")
        log(f"[sparse] {len(queries)}-query batch, k={k} (median of 5; "
            f"torch.profiler): " + "; ".join(cells))
    long_q = make_queries(dataclasses.replace(cfg, query_len=64,
                                              num_queries=cfg.batch))
    k = cfg.top_k
    want = ref.search(long_q[sub], top_k=k)
    times, busy = {}, {}
    for mode in (False, True, "auto", "auto", True, False):
        engine.dedup_queries = mode
        docs, scores = engine.search(long_q, top_k=k)
        assert_matches_oracle(docs[sub], scores[sub], *want)

        def call():
            return engine.search(long_q, top_k=k)
        times.setdefault(str(mode), []).append(wall_ms(call))
        if str(mode) not in busy:
            busy[str(mode)] = device_busy_ms(torch, call)
    engine.dedup_queries = "auto"
    unique = max(len(set(r.tolist())) for r in long_q)
    rule_ms = wall_ms(lambda: maybe_dedup(long_q, None, "auto", 16))
    log(f"[sparse] dedup, {len(long_q)} x 64-token Zipf queries (at most "
        f"{unique} distinct ids a row) at k={k}: median ms of 5 a batch, "
        f"in turns: {json.dumps(times)}; the card's busy ms "
        f"{json.dumps(busy)}; maybe_dedup alone on the host {rule_ms:.3f} "
        f"ms; each mode's first {CHECKED_QUERIES} queries match "
        "ReferenceEngine")


def layout_and_tail(torch, session, index, cfg) -> dict:
    """Phase 4b, on phase 4's corpus: the layout cost model's choice at
    k=1000 and k=100 with each bucket count's modelled ms, that layout's
    device step beside the explicit h=1024 / 2-bucket layout and the
    h=0 / 2-bucket one; then a three-tier engine (hot, ELL and tail all
    holding postings) at 512 x 8 and k=1000, plain, weighted and masked,
    against ``ReferenceEngine`` under the comparator, with B1's launches
    over this phase and no plain twin run.  Returns each engine's device
    bytes over the CSC bytes (``eval.engine_device_bytes``)."""
    from bm25_tpu_torch import ReferenceEngine, SparseEngine
    from bm25_tpu_torch.bench import make_queries
    from bm25_tpu_torch.eval import engine_device_bytes
    from bm25_tpu_torch.bench.query_bench import measure_device_step_ms
    from bm25_tpu_torch.models.sparse import best_layout, layout_candidates
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    reset(ops.launches, ops.plain_calls)
    queries = make_queries(cfg)[: cfg.batch]
    sub = slice(0, CHECKED_QUERIES)
    ks = (cfg.top_k, cfg.top_k2)
    chosen = {}
    for k in ks:
        t0 = time.perf_counter()
        cands = layout_candidates(index, k, q=cfg.batch,
                                  t=max(cfg.query_len, 8),
                                  device=session.device)
        chosen[k] = best_layout(cands)
        log(f"[layout] k={k}: choose_layout -> {chosen[k]} "
            f"({time.perf_counter() - t0:.2f} s on the host); modelled ms "
            + "; ".join(f"B={c['max_buckets']} h={c['hot_tokens']} "
                        f"{c['total_ms']:.3f} (scan+hot "
                        f"{c['scan_hot_ms']:.3f}, selection "
                        f"{c['selection_ms']:.3f})" for c in cands))
    layouts = {(c["hot_tokens"], c["max_buckets"]) for c in chosen.values()}
    layouts |= {(HOT_TOKENS, MAX_BUCKETS), (0, MAX_BUCKETS)}
    steps, ratios = {}, {}
    csc = index.indptr.nbytes + index.indices.nbytes + index.data.nbytes
    for h, mb in sorted(layouts):
        eng = SparseEngine.from_scored_index(
            index, session=session, hot_tokens=h,
            hot_budget_bytes=max(h, 1) * index.num_docs * 4, max_buckets=mb)
        ratios[f"h={h} B={mb}"] = engine_device_bytes(eng) / csc
        for k in ks:
            steps[(h, mb, k)] = measure_device_step_ms(eng, queries, k,
                                                       batch=cfg.batch)
        del eng
        torch.cuda.empty_cache()
    for k in ks:
        c = chosen[k]
        fastest = min((v, h, mb) for (h, mb, kk), v in steps.items()
                      if kk == k)
        log(f"[layout] k={k}: device step ms (measure_device_step_ms, "
            f"512 x 8): the model's h={c['hot_tokens']} "
            f"B={c['max_buckets']} "
            f"{steps[(c['hot_tokens'], c['max_buckets'], k)]:.3f}; "
            + "; ".join(f"h={h} B={mb} {v:.3f}"
                        for (h, mb, kk), v in sorted(steps.items())
                        if kk == k)
            + f"; fastest of these h={fastest[1]} B={fastest[2]}")

    # the three-tier engine: the tail takes the tokens of DF <= 512
    tail_cap = 512
    t0 = time.perf_counter()
    eng = SparseEngine.from_scored_index(
        index, session=session, hot_tokens=HOT_TOKENS,
        hot_budget_bytes=HOT_TOKENS * index.num_docs * 4,
        max_buckets=MAX_BUCKETS, tail_cap=tail_cap)
    torch.cuda.synchronize()
    ell = sum(int((b["tokT"] >= 0).sum()) for b in eng.buckets
              if "tokT" in b)
    tail = int((eng.tail_toks >= 0).sum())
    if eng.hot_h != HOT_TOKENS or not ell or not tail:
        raise AssertionError(f"three tiers: hot_h {eng.hot_h}, ELL "
                             f"postings {ell}, tail postings {tail}")
    log(f"[tail] three-tier engine (hot_tokens={HOT_TOKENS}, "
        f"max_buckets={MAX_BUCKETS}, tail_cap={tail_cap}) built in "
        f"{time.perf_counter() - t0:.2f} s: {ell} ELL postings, {tail} tail "
        f"postings in {tuple(eng.tail_docs.shape)} rows, tail rows a token "
        f"{eng.tail_rows.shape[1]}, device bytes {eng.device_bytes()}")
    ratios[f"h={HOT_TOKENS} B={MAX_BUCKETS} tail_cap={tail_cap}"] = \
        engine_device_bytes(eng) / csc
    ref = ReferenceEngine.from_scored_index(index)
    rng = np.random.default_rng(17)
    weights = rng.uniform(0.1, 3.0, queries.shape).astype(np.float32)
    mask = rng.random(index.num_docs) < 0.3
    k = cfg.top_k
    for name, kw in (("plain", {}), ("weighted", {"weights": weights}),
                     ("masked", {"doc_mask": mask})):
        t0 = time.perf_counter()
        docs, scores = eng.search(queries, top_k=k, **kw)
        ms_ = (time.perf_counter() - t0) * 1e3
        if docs.shape != (len(queries), k) or not np.isfinite(scores).all():
            raise AssertionError(f"three tiers {name}: bad result")
        want = ref.search(queries[sub], top_k=k, **{
            n: (v[sub] if n == "weights" else v) for n, v in kw.items()})
        assert_matches_oracle(docs[sub], scores[sub], *want)
        log(f"[tail] {name} {len(queries)} x {queries.shape[1]} batch at "
            f"k={k}: {ms_:.2f} ms; the first {CHECKED_QUERIES} queries match "
            "ReferenceEngine")
    tail_step = measure_device_step_ms(eng, queries, k, batch=cfg.batch)
    log(f"[tail] three-tier device step at k={k}: {tail_step:.3f} ms")
    launches, plain = dict(ops.launches), dict(ops.plain_calls)
    log(f"[layout] kernel launches over this phase {launches}, plain twin "
        f"runs {plain}")
    if not launches["ell_score_fused"] or any(plain.values()):
        raise AssertionError("the layout phase did not launch B1, or ran a "
                             "plain twin")
    del eng
    torch.cuda.empty_cache()
    return ratios


def dense_main(torch, dev, cfg, gr, tk, session, record) -> None:
    """Phases 5 and 6: the dense engine, then the top-k op library on the
    dense step's scores, then B3-B5 against their twins there."""
    from bm25_tpu_torch.eval import engine_device_bytes
    from bm25_tpu_torch import (DenseEngine, ReferenceEngine, create_engine,
                                top_k)
    from bm25_tpu_torch.bench import make_queries, make_synthetic_index
    from bm25_tpu_torch.bench.b5_times import bound_ms as b5_bound
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
        b4, profiled = {}, []
        for k in (cfg.top_k, cfg.top_k2):
            pv, pi = tk.topk_two_stage_plain(masked, k)
            kv, ki = tk.top_k_two_stage(masked, k)
            err = compare(torch, kv, pv, True, f"B4 k={k} vs twin")
            compare(torch, ki, pi, True, f"B4 idx k={k} vs twin")
            ms = cuda_ms(torch, lambda: tk.top_k_two_stage(masked, k), 10)
            # the cut-over: without the side buffer every pass reads the row
            with side_max(tk, 0):
                whole_ms = cuda_ms(torch, lambda: tk.top_k_two_stage(
                    masked, k), 10)
            # what the side buffer must hold after a first digit of 11 or 13
            # bits, against its cap
            cap = min(masked.shape[1] // tk.SIDE_DIV, tk.SIDE_MAX)
            fill = {bits: b4_side_buffer_fill(torch, tk, masked,
                                              kv[:, k - 1], bits)
                    for bits in (11, 13)}
            log(f"[kernels] B4 at ({masked.shape[0]}, {masked.shape[1]}) "
                f"k={k}: keys at or above the k-th key's first digit, most "
                f"of any row: {fill[11]} (11 bits), {fill[13]} (13 bits) of "
                f"a {cap}-entry side buffer")
            profiled.append((f"({masked.shape[0]}, {masked.shape[1]})",
                             masked, k))
            tree_ms = cuda_ms(torch, lambda: tk.select_top_k(masked, k), 5)
            plain_ms = cuda_ms(torch, lambda: tk.topk_two_stage_plain(masked,
                                                                      k), 2)
            lib_ms = cuda_ms(torch, lambda: torch.topk(masked, k), 10)
            b4[k] = (err, ms, plain_ms, bound(nbytes(masked, kv, ki)), lib_ms)
            log(f"[kernels] B4 at ({masked.shape[0]}, {masked.shape[1]}) "
                f"k={k}: kernel {ms:.4f} ms (without the side buffer "
                f"{whole_ms:.4f} ms), plain {plain_ms:.3f} ms, tree "
                f"(select_top_k) {tree_ms:.3f} ms, torch.topk {lib_ms:.4f} "
                f"ms, bound {b4[k][3][0]:.4f} ms; equal to the twin")
        # B4 at the sparse corpus's width: random scores at k=1000, few rows
        # (each row split over blocks) and k beyond the shared-memory sort
        gen = torch.Generator(device=dev).manual_seed(1)
        for b, k in ((masked.shape[0], cfg.top_k), (8, cfg.top_k2),
                     (64, 32768)):
            wide = torch.rand((b, SPARSE_DOCS), device=dev, generator=gen)
            kv, ki = tk.top_k_two_stage(wide, k)
            for name, (wv, wi) in (("twin", tk.topk_two_stage_plain(wide, k)),
                                   ("tree", tk.select_top_k(wide, k))):
                compare(torch, kv, wv, True, f"B4 ({b}, wide) k={k} vs {name}")
                compare(torch, ki, wi, True,
                        f"B4 ({b}, wide) idx k={k} vs {name}")
            ms = cuda_ms(torch, lambda: tk.top_k_two_stage(wide, k), 5)
            tree_ms = cuda_ms(torch, lambda: tk.select_top_k(wide, k), 3)
            lib_ms = cuda_ms(torch, lambda: torch.topk(wide, k), 5)
            log(f"[kernels] B4 at ({b}, {SPARSE_DOCS}) random k={k} "
                f"({b4_shape(torch, tk, b, SPARSE_DOCS, k)}): kernel "
                f"{ms:.4f} ms, tree (select_top_k) {tree_ms:.3f} ms, "
                f"torch.topk {lib_ms:.4f} ms, bound "
                f"{bound(nbytes(wide, kv, ki))[0]:.4f} ms; equal to the twin "
                "and the tree")
            profiled.append((f"({b}, {SPARSE_DOCS}) random", wide, k))
            del kv, ki
        logits = (vals - vals[:, :1]).contiguous()
        b5_err = choice_err(torch, tk, logits, 12345,
                            tk.gumbel_choice(logits, 12345),
                            tk.gumbel_choice_plain(logits, 12345))
        b5_ms = cuda_ms(torch, lambda: tk.gumbel_choice(logits, 12345), 20)
        b5_plain_ms = cuda_ms(torch, lambda: tk.gumbel_choice_plain(logits,
                                                                    12345), 5)
        b5_bnd = b5_bound(*logits.shape)
        log(f"[kernels] B5 at logits {tuple(logits.shape)}: kernel "
            f"{b5_ms:.4f} ms, device {b5_device_us(torch, tk, logits)} us "
            f"(torch.profiler), plain {b5_plain_ms:.4f} ms, bound "
            f"{b5_bnd[0]:.6f} ms ({b5_bnd[1]}), max z gap of differing "
            f"choices {b5_err:.3e}")
        # the fused step after B4 at k=100 (the logits, then one B5
        # launch), against its twin
        _, idxs = picked[cfg.top_k2]
        seed = torch.tensor([12345], dtype=torch.int64, device=dev)
        got = tk.gumbel_sample(vals, idxs, seed)
        want = tk.gumbel_sample_plain(vals, idxs, seed)
        fused_err = choice_err(torch, tk, logits, 12345,
                               (idxs == got).float().argmax(1),
                               (idxs == want).float().argmax(1))
        fused_ms = cuda_ms(torch, lambda: tk.gumbel_sample(vals, idxs, seed),
                           20)
        log(f"[kernels] B5 fused (the logits, then choice and id in one "
            f"launch) at "
            f"{tuple(vals.shape)}: kernel {fused_ms:.4f} ms, bound "
            f"{b5_bound(*vals.shape, ids=True)[0]:.6f} ms, max z gap "
            f"{fused_err:.3e}")
        # B5 where few rows must fill the card, from default_rng(0)
        rng = np.random.default_rng(0)
        for b, k in ((512, 1000), (64, 32768), (8, 131072)):
            x = torch.from_numpy(rng.standard_normal((b, k)).astype(
                np.float32)).to(dev)
            err = choice_err(torch, tk, x, 12345, tk.gumbel_choice(x, 12345),
                             tk.gumbel_choice_plain(x, 12345))
            ms = cuda_ms(torch, lambda: tk.gumbel_choice(x, 12345), 20)
            bnd = b5_bound(b, k)
            log(f"[kernels] B5 at ({b}, {k}), "
                f"{tk._device_plan(b, k, dev.index or 0).layout} layout: "
                f"kernel {ms:.4f} ms, device {b5_device_us(torch, tk, x)} us "
                f"(torch.profiler), bound {bnd[0]:.6f} ms ({bnd[1]}), max z "
                f"gap {err:.3e}")
        # B4's kernels one by one, after every timing of this phase
        for what, x, k in profiled:
            log(f"[kernels] B4 at {what} k={k}: device us per call "
                f"{b4_kernel_us(torch, tk, x, k)} (torch.profiler)")
        del profiled, wide
    record["gather_add_rows"] = kernel_record(
        b3_launches, 0.0, b3_ms, b3_plain_ms, b3_bound, b3_lib_ms)
    record["top_k_two_stage"] = kernel_record(
        op_launches["top_k_two_stage"], *b4[cfg.top_k])
    record["gumbel_choice"] = kernel_record(
        op_launches["gumbel_choice"], b5_err, b5_ms, b5_plain_ms, b5_bnd)


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
    tokenizer = Tokenizer()
    small, _ = build_index(corpus)
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
    fitted = Retriever.fit(corpus, session=session)
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

    for big in MATMUL_BIG_SIZES:
        a, b = matmul_operands(torch, dev, big, big, big, torch.float32, 6)
        got = pm.matmul(a, b)
        err = order_bound(torch, got, pm.matmul(a, b, algorithm="xla"), a, b)
        ms = cuda_ms(torch, lambda: pm.matmul(a, b), 5)
        xla_ms = cuda_ms(torch, lambda: pm.matmul(a, b, algorithm="xla"), 5)
        big_flops = big * big * (2 * big - 1)
        log(f"[kernels] B6 optimized at {big}^3 f32 "
            f"({pm.b6_plan(big, big, torch.float32, sms=pm.sm_count(dev))}):"
            f" {ms:.4f} ms ({big_flops / ms / 1e6:.1f} GFLOP/s), xla "
            f"{xla_ms:.4f} ms ({big_flops / xla_ms / 1e6:.1f} GFLOP/s); max "
            f"|diff| vs xla {err:.3e} (within the order bound)")
        del a, b, got
    f32, bf16 = torch.float32, torch.bfloat16
    for name, algo in (("matmul_naive", "naive"),
                       ("matmul_tiled", "optimized")):
        record[name] = kernel_record(
            launches[name], 0.0, times[(f32, algo)], times[(f32, "plain")],
            bound(3 * n * n * 4, [(flops, F32_OPS_PER_S)]),
            times[(f32, "xla")])
        # the same kernel on bf16 operands (the xla call widens to f32)
        record[name]["bf16"] = kernel_record(
            launches[name], 0.0, times[(bf16, algo)], times[(bf16, "plain")],
            bound(3 * n * n * 2, [(flops, F32_OPS_PER_S)]),
            times[(bf16, "xla")])


def b6_device_split(torch, pm, dev, record) -> None:
    """B6 optimized's device time per call (one launch) at 1028^3 and
    4096^3 f32 (``torch.profiler``, after every timing of phase 8), beside
    the call's back-to-back time; the 1028^3 figure goes into the kernels
    line as ``device_ms``."""
    for s in (MATMUL_N, MATMUL_BIG):
        a, b = matmul_operands(torch, dev, s, s, s, torch.float32, 0)
        call = cuda_ms(torch, lambda: pm.matmul(a, b), 10)
        us = launch_us(torch, lambda: pm.matmul(a, b),
                       ("matmul_ring_kernel",))
        log(f"[kernels] B6 optimized at {s}^3: device us per call "
            f"{sum(us.values()):.1f} ({us}; torch.profiler), "
            f"{call * 1e3:.1f} us a call back to back")
        if s == MATMUL_N and us:
            record["matmul_tiled"]["device_ms"] = sum(us.values()) / 1e3
        del a, b


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
    b6_ring_edge_cases(torch, pm, dev)


def same_bits(torch, got, want) -> bool:
    """Equal bits, NaN only where the twin has NaN (any payload)."""
    nan = torch.isnan(want)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return (got.dtype == want.dtype and torch.equal(torch.isnan(got), nan)
            and torch.equal(got.masked_fill(nan, 0).view(bits),
                            want.masked_fill(nan, 0).view(bits)))


def b6_ring_edge_cases(torch, pm, dev) -> None:
    """B6 optimized (the ring) at its edges in f32 and bf16, at every tile
    and every ring depth up to the plan's, on the planned grid and on 3
    blocks (many tiles a block): K = 0 (+0), K below the K step, K = 37
    BK + 3 (the phase bits wrap), M and N below a tile, K and N at 8 j +
    4 (bf16 staged), views 4 bytes off alignment (staged), +-0/inf/NaN
    (the twin's bits); then C prefilled with NaN, which the walk
    overwrites."""
    sms = pm.sm_count(dev)

    def check(a, b, what, want=None):
        (m, k), n = a.shape, b.shape[1]
        want = pm.matmul_plain(a, b) if want is None else want
        for tile in pm.TILES[a.dtype]:
            plan = pm.b6_plan(m, n, a.dtype, *tile, sms)
            for stages in range(2, plan.stages + 1):
                for grid in {plan.grid, min(3, plan.grid)}:
                    got = pm._optimized(
                        a, b, plan._replace(stages=stages, grid=grid))
                    if not same_bits(torch, got, want):
                        raise AssertionError(
                            f"B6 ring {tuple(tile)} stages {stages} grid "
                            f"{grid} {what} {a.dtype}: bits differ")
                    if k == 0 and bool((got.view(torch.int16
                                                 if a.dtype == torch.bfloat16
                                                 else torch.int32)).any()):
                        raise AssertionError(f"B6 ring {what}: not +0")
        if not same_bits(torch, pm.matmul(a, b), want):
            raise AssertionError(f"B6 optimized {what} {a.dtype}: bits differ")

    for dt in pm.DTYPES:
        bk = pm.TILES[dt][0].k
        esize = torch.empty((), dtype=dt).element_size()
        for m, k, n in ((9, 0, 36), (70, 5, 132), (70, 37 * bk + 3, 132),
                        (3, 40, 8), (129, 3, 65), (37, 44, 76),
                        (100, 36, 1028)):
            a, b = matmul_operands(torch, dev, m, k, n, dt, m + k)
            check(a, b, f"({m}, {k}, {n})")
        off = 4 // esize  # 4 bytes
        for m, k, n in ((37, 64, 132), (20, 30, 9)):
            a, b = matmul_operands(torch, dev, m, k, n, dt, k)
            x = torch.zeros(a.numel() + off, dtype=dt, device=dev)[off:]
            y = torch.zeros(b.numel() + off, dtype=dt, device=dev)[off:]
            x, y = x.view(m, k), y.view(k, n)
            x.copy_(a)
            y.copy_(b)
            check(x, y, f"({m}, {k}, {n}) 4 bytes off", pm.matmul_plain(a, b))
        a, b = matmul_operands(torch, dev, 40, 36, 72, dt, 5)
        a[0], a[1, ::2], a[2, 3] = -0.0, 0.0, float("inf")
        a[3, 7], a[4, :] = float("nan"), -0.0
        b[5, :8], b[6, 9], b[7, 10] = float("-inf"), float("nan"), float("inf")
        b[:, 11] = -0.0
        check(a, b, "+-0, inf, NaN")
        for m, k, n in ((MATMUL_N, 64, MATMUL_N), (300, 70, 1030)):
            a, b = matmul_operands(torch, dev, m, k, n, dt, 9)
            plan = pm.b6_plan(m, n, dt, sms=sms)
            c = torch.full((m, n), float("nan"), dtype=dt, device=dev)
            got = pm._optimized(a, b, plan, out=c)
            if got is not c or not same_bits(torch, c, pm.matmul_plain(a, b)):
                raise AssertionError(f"B6 ({m}, {k}, {n}) {dt} into a NaN C: "
                                     "an element was not written, or wrong")
    log("[kernels] B6 ring edges in f32 and bf16 at every tile, ring depths "
        "2 to the plan's, the planned grid and 3 blocks: K = 0 (+0), K < "
        "BK, K = 37 BK + 3, M and N below a tile, K and N at 8 j + 4, "
        "views 4 bytes off (staged), +-0/inf/NaN: the twin's bits; a C "
        "prefilled with NaN is overwritten everywhere with the twin's bits")


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


def mma_pack_equal(torch, ms, a, b, mode, what, want=None) -> None:
    """E4's pack kernel bit-equal to its twin (on ``want``'s operands, if
    given: the same values at another address)."""
    got = ms.mma_pack(a, b, mode)
    want = ms.mma_pack_plain(*(want or (a, b)), mode)
    for g, w, name in zip(got, want, ("A", "B")):
        compare(torch, g, w, True, f"E4 pack {name} {mode} {what}")


def phase_schedule_cases(torch, bs, ms, pm, dev) -> dict:
    """E1-E4 edge cases; returns E4's largest |diff| / bound per mode, with
    the unrounded inputs' reading of the same case."""
    readings = {mode: (0.0, 0.0) for mode in ms.ROUNDING}
    shapes = [(67, 130, 200), (1, 1, 1), (33, 13, 70),  # K off every step
              (100, 64, 136), (130, 24, 129), (37, 36, 44), (257, 1028, 260),
              (1100, 13, 2100)]  # E4 on ragged 128 x 256 tiles
    for m, k, n in shapes:
        a, b = matmul_operands(torch, dev, m, k, n, torch.float32, m + k + n)
        want = pm.matmul_plain(a, b)
        for t in ms.SWEEP_TILES:
            compare(torch, ms.matmul_sweep(a, b, t), want, True,
                    f"E1 {tuple(t)} ({m}, {k}, {n})")
        for h in ms.STRIP_HEIGHTS:
            for blocks in (None, 1, 3):
                compare(torch, ms.matmul_row_strip(a, b, h, blocks), want,
                        True, f"E2 strip {h} blocks {blocks} ({m}, {k}, {n})")
        e3 = k % 4 == 0 and n % 4 == 0
        if e3:
            for t in ms.PIPELINED_TILES:
                for st in ms.STAGES:
                    compare(torch, ms.matmul_pipelined(a, b, t, st), want,
                            True, f"E3 {tuple(t)} stages {st} ({m}, {k}, {n})")
        for mode in ms.ROUNDING:
            mma_pack_equal(torch, ms, a, b, mode, f"({m}, {k}, {n})")
            mma_within_bound(bs, ms, ms.matmul_mma(a, b, mode), a, b, mode,
                             f"E4 {mode} ({m}, {k}, {n})", readings)
        bn = ms.mma_plan(m, n, k, "bf16in", ms.sm_count(dev)).bn
        log(f"[kernels] E1-E4 ({m}, {k}, {n}): E1 (12 tiles), E2 (3 strips, "
            f"a block per item or 1 or 3 blocks)"
            f"{', E3 (2 tiles x 3 stages)' if e3 else ''}"
            f" bit-equal to the twin; E4's pack bit-equal to its twin, E4 "
            f"(128 x {bn} tiles) within its bound")
    # E4 reads any 4-byte aligned operand
    a, b = matmul_operands(torch, dev, 37, 64, 132, torch.float32, 3)
    off_a = torch.zeros(a.numel() + 1, device=dev)[1:].view(a.shape)
    off_b = torch.zeros(b.numel() + 1, device=dev)[1:].view(b.shape)
    off_a.copy_(a)
    off_b.copy_(b)
    for mode in ms.ROUNDING:
        mma_pack_equal(torch, ms, off_a, off_b, mode, "4 bytes off", (a, b))
        mma_within_bound(bs, ms, ms.matmul_mma(off_a, off_b, mode), a, b,
                         mode, f"E4 {mode} 4 bytes off", readings)
    log("[kernels] E4 on operands 4 bytes off 16-byte alignment: the pack "
        "bit-equal to its twin, the product within its bound")
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
    ring_edge_cases(torch, ms, pm, dev)
    log("[kernels] E4 largest |diff| / bound at the edge cases, and the "
        f"unrounded inputs' reading there: {readings}")
    return readings


def ring_edge_cases(torch, ms, pm, dev) -> None:
    """E1 and E3's ring body at its edges: operands TMA cannot read as they
    lie (E1 stages them), K below the K step and K = 0 (C is +0), M and N
    below the tile, K = 37 BK + 3 (the ring's phase bits wrap at every
    depth), and +-0, +-inf and NaN (the twin's bits, NaN where it has
    NaN)."""
    calls = ([(f"E1 {tuple(t)}", lambda a, b, t=t: ms.matmul_sweep(a, b, t))
              for t in ms.SWEEP_TILES]
             + [(f"E3 {tuple(t)} stages {st}",
                 lambda a, b, t=t, st=st: ms.matmul_pipelined(a, b, t, st))
                for t in ms.PIPELINED_TILES for st in ms.STAGES])

    def check(a, b, what, e3=True, want=None):
        want = pm.matmul_plain(a, b) if want is None else want
        nan = torch.isnan(want)
        for name, fn in calls:
            if name.startswith("E3") and not e3:
                continue
            got = fn(a, b)
            if not (torch.equal(torch.isnan(got), nan) and torch.equal(
                    got.masked_fill(nan, 0).view(torch.int32),
                    want.masked_fill(nan, 0).view(torch.int32))):
                raise AssertionError(f"{name} {what}: bits differ")

    for m, k, n, off in ((37, 61, 130, 0), (37, 64, 132, 1), (20, 30, 9, 3)):
        a, b = matmul_operands(torch, dev, m, k, n, torch.float32, k)
        x = torch.zeros(a.numel() + off, device=dev)[off:].view(m, k)
        y = torch.zeros(b.numel() + off, device=dev)[off:].view(k, n)
        x.copy_(a)
        y.copy_(b)
        check(x, y, f"staged ({m}, {k}, {n}) {4 * off} bytes off", False,
              pm.matmul_plain(a, b))
    for m, k, n in ((70, 5, 132), (9, 0, 36), (3, 40, 8), (129, 3, 65)):
        a, b = matmul_operands(torch, dev, m, k, n, torch.float32, m + n)
        check(a, b, f"({m}, {k}, {n})", k % 4 == 0 and n % 4 == 0)
    for bk in (8, 16, 32):
        k = 37 * bk + 3
        a, b = matmul_operands(torch, dev, 70, k, 132, torch.float32, bk)
        want = pm.matmul_plain(a, b)
        for t in (t for t in ms.SWEEP_TILES if t.k == bk):
            for stages in range(2, ms.RING_MAX_STAGES + 1):
                compare(torch, ms._ring("matmul_sweep", a, b, t, stages),
                        want, True, f"E1 {tuple(t)} stages {stages} K={k}")
            compare(torch, ms.matmul_sweep(a, b, t), want, True,
                    f"E1 {tuple(t)} K={k}")
    a, b = matmul_operands(torch, dev, 70, 37 * 16 + 4, 132, torch.float32, 7)
    check(a, b, "K = 37 x 16 + 4")
    a, b = matmul_operands(torch, dev, 40, 36, 72, torch.float32, 5)
    a[0], a[1, ::2], a[2, 3] = -0.0, 0.0, float("inf")
    a[3, 7], a[4, :] = float("nan"), -0.0
    b[5, :8], b[6, 9], b[7, 10] = float("-inf"), float("nan"), float("inf")
    b[:, 11] = -0.0
    check(a, b, "+-0, inf, NaN")
    log("[kernels] E1/E3 ring edges: E1 on staged operands (K % 4 != 0, "
        "views 4 and 12 bytes off), K below the K step, K = 0 (+0), M and N "
        "below the tile, K = 37 BK + 3 at ring depths 2-4, and +-0/inf/NaN: "
        "the twin's bits at every tile and E3 stage count")


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

    twin_ms, mma_err, pack = {}, {}, {}
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
            if s == MATMUL_N:
                pack[mode] = e4_pack_record(torch, ms, a, b, mode)
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
            ("matmul_row_strip", pick(variant="row_strip",
                                      strip_m=ms.default_strip(
                                          MATMUL_N, ms.smem_optin_bytes(dev))),
             "f32"),
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
    # E4 carries both modes; its top-level numbers are bf16's
    record["matmul_mma"]["modes"] = {
        mode: {**kernel_record(launches["matmul_mma"],
                               mma_err[(MATMUL_N, mode)], row["ms"],
                               twin_ms[(MATMUL_N, mode)],
                               (row["bound_ms"], row["bound_by"]),
                               row["library_ms"]),
               "library": row["library"]}
        for mode, row in ((m, pick(variant="mma", mode=m))
                          for m in ms.ROUNDING)}
    record["matmul_mma_pack"] = {
        **kernel_record(launches["matmul_mma_pack"], *pack["bf16in"]),
        "modes": {mode: kernel_record(launches["matmul_mma_pack"], *rec)
                  for mode, rec in pack.items()}}
    log(f"[kernels] E4 largest |diff| / (K 2^-22 (|A^| @ |B^|)) over every "
        f"checked case, with the unrounded inputs' reading there: {readings}")
    e1_device_split(torch, ms, dev, record)
    e4_device_split(torch, ms, dev, record)


def e1_device_split(torch, ms, dev, record) -> None:
    """E1's device time per call (one launch) at 128 x 128 x 16 at 1028^3
    and 4096^3 (``torch.profiler``, after every timing of phase 10),
    beside the call's back-to-back time; the 1028^3 figure goes into the
    kernels line as ``device_ms``."""
    tile = ms.Tile(128, 128, 16)
    for s in (MATMUL_N, MATMUL_BIG):
        a, b = matmul_operands(torch, dev, s, s, s, torch.float32, 0)
        call = cuda_ms(torch, lambda: ms.matmul_sweep(a, b, tile), 10)
        us = launch_us(torch, lambda: ms.matmul_sweep(a, b, tile),
                       ("matmul_ring_kernel",))
        log(f"[kernels] E1 {tuple(tile)} at {s}^3: device us per call "
            f"{sum(us.values()):.1f} ({us}; torch.profiler), "
            f"{call * 1e3:.1f} us a call back to back")
        if s == MATMUL_N and us:
            record["matmul_sweep"]["device_ms"] = sum(us.values()) / 1e3
        del a, b


def e4_pack_record(torch, ms, a, b, mode) -> tuple:
    """E4's pack at this size: bit-equal to its twin; (max error, kernel
    ms, twin ms, bound), both timed back to back."""
    mma_pack_equal(torch, ms, a, b, mode, f"{a.shape[0]}^3")
    ms_ = cuda_ms(torch, lambda: ms.mma_pack(a, b, mode), 20)
    plain_ms = cuda_ms(torch, lambda: ms.mma_pack_plain(a, b, mode), 3)
    (m, k), n = a.shape, b.shape[1]
    kp = ms.mma_plan(m, n, k, mode).kp
    moved = nbytes(a, b) + (m + n) * kp * ms.MMA_ELEM_BYTES[mode]
    log(f"[kernels] E4 pack {mode} at {m}^3: {ms_:.4f} ms back to back, "
        f"twin {plain_ms:.4f} ms, bound {bound(moved)[0]:.4f} ms; bit-equal "
        "to the twin")
    return 0.0, ms_, plain_ms, bound(moved)


def e4_device_split(torch, ms, dev, record) -> None:
    """E4's two kernels' device time per call (one launch each) at 1028^3
    and 4096^3 in both modes (``torch.profiler``, after every timing of
    phase 10); the 1028^3 figures go into the kernels line as
    ``device_ms``."""
    for s in (MATMUL_N, MATMUL_BIG):
        a, b = matmul_operands(torch, dev, s, s, s, torch.float32, 0)
        for mode in ms.ROUNDING:
            us = launch_us(torch, lambda: ms.matmul_mma(a, b, mode),
                           ("mma_pack_kernel", "mma_wgmma_kernel"))
            pack_us = sum(v for k, v in us.items() if k.startswith("mma_p"))
            prod_us = sum(v for k, v in us.items() if k.startswith("mma_w"))
            log(f"[kernels] E4 {mode} at {s}^3: device us per call, pack "
                f"{pack_us:.1f} + product {prod_us:.1f} ({us}; "
                "torch.profiler)")
            if s == MATMUL_N and us:
                record["matmul_mma"]["modes"][mode]["device_ms"] = \
                    prod_us / 1e3
                record["matmul_mma_pack"]["modes"][mode]["device_ms"] = \
                    pack_us / 1e3
        del a, b


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
        # the CLI's index command, with its default (stemmed) tokenizer;
        # query reads the saved tokenizer config
        idx = os.path.join(work, "idx")
        corpus = os.path.join(work, "docs.txt")
        with open(corpus, "w") as f:
            f.write("\n".join(synthetic_corpus(4000, vocab=3000, avg_len=24,
                                               seed=0)))
        built = cli(["index", corpus, "-o", idx])
        log(f"[cli] index: {built.strip()}")
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
        ev = json.loads(cli(["--device", "cuda", "eval", data]))
        ev_cpu = json.loads(cli(["--device", "cpu", "eval", data]))
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
    widths = [b["tokT"].shape[0] for b in model._engine.buckets
              if "tokT" in b]
    log(f"[compat] BM25v.index over {index.num_docs} docs routed to "
        f"SparseEngine in {time.perf_counter() - t0:.1f} s, the default "
        f"layout: hot_h={model._engine.hot_h}, "
        f"{len(model._engine.buckets)} buckets of widths {widths}")
    k = cfg.top_k
    model.search(queries, top_k=k)  # warm: the first call's allocations
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        docs, scores = model.search(queries, top_k=k)
        runs.append((time.perf_counter() - t0) * 1e3)
    ms_ = statistics.median(runs)
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
    log(f"[compat] BM25v.search 512 x 8 at k={k}: {ms_:.2f} ms (median "
        f"of 5 after a warm-up call), first "
        f"{CHECKED_QUERIES} match ReferenceEngine; get_scores of 4 queries "
        f"equal the oracle; B1/B3 launches over this phase {launches}")
    if not all(launches.values()):
        raise AssertionError("the entry points did not run B1 and B3")


def harness(torch, session, index, timings) -> dict:
    """Phase 12: the query benchmark harness (``bench/query_bench.py::
    run``) at the default ``BenchConfig`` on phase 4's corpus, with the
    explicit layout; every row's recall must read 1.0, and the path must
    launch B1, B2, the scan's tables and (the dense BEIR-eval row) B3 and
    run no plain twin.  Returns the harness's record."""
    from bm25_tpu_torch.bench import BenchConfig
    from bm25_tpu_torch.bench.query_bench import compact_headline, run
    from bm25_tpu_torch.ops import gather_rows as gr

    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    reset(ops.launches, ops.plain_calls, gr.launches, gr.plain_calls)
    result = run(BenchConfig(), log=lambda *a: log(" ".join(map(str, a))),
                 session=session, index=index, timings=timings)
    launches = {**ops.launches, **gr.launches}
    plain = {**ops.plain_calls, **gr.plain_calls}
    log(f"[harness] record {json.dumps(result)}")
    log(f"[harness] headline {json.dumps(compact_headline(result))}")
    log(f"[harness] kernel launches {launches}, plain twin runs {plain}")
    extra = result["extra"]
    rows = {"headline": extra["headline"], "memory_parity":
            extra["memory_parity"], "longdoc": extra["longdoc"],
            "sharded": extra["sharded"]}
    rows.update({f"shard_scaling S={r['shards']}": {
        "recall_vs_reference": r["recall"]}
        for r in extra["shard_scaling"]["strong"]})
    rows.update({f"secondary k={r['top_k']}": r for r in extra["secondary"]})
    rows.update({f"memory_trade {r['point']}": r
                 for r in extra["memory_trade"]})
    recall = {name: r["recall_vs_reference"] for name, r in rows.items()}
    if set(recall.values()) != {1.0}:
        raise AssertionError(f"harness recall_vs_reference {recall}")
    # B2 builds a hot tier: needed where some engine of the run has one
    hot = (extra["hot_tokens"], extra["longdoc"]["layout"]["hot_tokens"],
           *(r["hot_h"] for r in extra["memory_trade"]))
    needed = ("ell_score_fused", "ell_table", "gather_add_rows") + (
        ("ell_score",) if any(hot) else ())
    if not all(launches[n] for n in needed) or any(plain.values()):
        raise AssertionError(f"the harness did not launch {needed}, or ran "
                             "a plain twin")
    log(f"[harness] the model's layouts: headline {extra['layout']}, "
        f"longdoc {extra['longdoc']['layout']}; memory trade "
        + "; ".join(f"{r['point']} hot_h={r['hot_h']} "
                    f"{r['device_step_ms']} ms"
                    for r in extra["memory_trade"]))
    log(f"[harness] recall_vs_reference 1.0 in every row {sorted(recall)}; "
        f"longdoc bucket widths {extra['longdoc']['bucket_widths']} "
        f"(slot-tiled: {extra['longdoc']['slot_tiled']})")
    # cold-width routing: the long-document row's engine keeps a hot tier
    # beside its scan tier, so "auto" routes its batches
    ld = extra["longdoc"]
    if not ld["chunks"] or any(c["cold_width"] is None
                               for c in ld["chunks"]):
        raise AssertionError(f"the long-document row was not routed: "
                             f"{ld['chunks']}")
    log(f"[harness] longdoc (model h={ld['layout']['hot_tokens']}) routed: "
        f"{len(ld['chunks'])} chunks (rows, height, cold width) "
        f"{[tuple(c.values()) for c in ld['chunks']]}"
        f"; headline (h={extra['hot_tokens']}) chunks "
        f"{[tuple(c.values()) for c in extra['headline']['chunks']]}")
    if not extra["longdoc"]["slot_tiled"]:
        longdoc_slot_tiled(torch, session)
    return result


def longdoc_slot_tiled(torch, session) -> None:
    """Where the model's long-document layout has no bucket wider than
    SLOT_TILE: the harness's long-document corpus at the explicit
    layout (no hot tier, 2 buckets), whose wide bucket runs B1's
    slot-tiled scan, against ``ReferenceEngine``."""
    from bm25_tpu_torch import ReferenceEngine, SparseEngine
    from bm25_tpu_torch.bench import BenchConfig, make_queries
    from bm25_tpu_torch.bench.query_bench import make_longdoc_index
    from bm25_tpu_torch.ops.ell_score import SLOT_TILE
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    cfg = BenchConfig()
    index = make_longdoc_index(cfg)
    eng = SparseEngine.from_scored_index(index, session=session,
                                         hot_tokens=0, max_buckets=2)
    widths = [b["tokT"].shape[0] for b in eng.buckets if "tokT" in b]
    if max(widths) <= SLOT_TILE:
        raise AssertionError(f"longdoc widths {widths}: none slot-tiled")
    queries = make_queries(cfg)[: cfg.batch]
    sub = slice(0, CHECKED_QUERIES)
    docs, scores = eng.search(queries, top_k=cfg.top_k)
    assert_matches_oracle(docs[sub], scores[sub],
                          *ReferenceEngine.from_scored_index(index).search(
                              queries[sub], top_k=cfg.top_k))
    log(f"[harness] longdoc at the explicit layout (widths {widths}, "
        f"slot-tiled): the first {CHECKED_QUERIES} queries match "
        "ReferenceEngine")
    del eng
    torch.cuda.empty_cache()


SERVE_CLIENTS = 8
SERVE_LOAD_S = 20.0
SERVE_CHECK_EVERY = 50  # every 50th response of each client is checked
UPD_DOCS = 131072  # the serving soak's updatable corpus
UPD_VOCAB = 16384
UPD_CLIENTS = 6
UPD_TRIP_DOCS = 44  # the auto-compaction's delta threshold: 6 batches of 8
MEMORY_MARGIN = 0.02  # of one engine's device bytes, quiet to quiet


def http(port: int, path: str, payload=None, timeout: float = 300):
    """(status, JSON body, headers) of one request to the local server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


class Load:
    """Client threads against one server with the serving soak's query
    mix at top_k 10 (``scripts/exp_serve_soak.py``: five terms of w0-w1999,
    plain, weighted or the first three; ``mix="upd"``: plain or weighted).
    A 503 that carries Retry-After is retried; any other failure is kept
    as an error.  Every ``check_every``-th response of each client
    is kept with its query, for the oracle after the load stops.
    ``quiet()`` holds the clients and waits out the server's admitted
    work."""

    def __init__(self, port: int, clients: int, mix: str = "search",
                 check_every: int = SERVE_CHECK_EVERY):
        import threading

        self.port, self.mix, self.check_every = port, mix, check_every
        self.stop_ev, self.go = threading.Event(), threading.Event()
        self.go.set()
        self.lock = threading.Lock()
        self.lat, self.kept, self.errors, self.retries = [], [], [], []
        self.ok = 0
        self.threads = [threading.Thread(target=self._client, args=(c,))
                        for c in range(clients)]

    def _query(self, r):
        terms = [f"w{t}" for t in r.integers(0, 2000, size=5)]
        style = r.integers(0, 2 if self.mix == "upd" else 3)
        if style == 1:
            return {t: float(r.uniform(0.5, 3.0)) for t in terms}
        return " ".join(terms if style == 0 else terms[:3])

    def _client(self, c: int) -> None:
        r = np.random.default_rng(c)
        n = 0
        while not self.stop_ev.is_set():
            self.go.wait()
            q = self._query(r)
            t0 = time.perf_counter()
            try:
                code, body, headers = http(self.port, "/search",
                                           {"queries": [q], "top_k": 10})
            except Exception as e:  # noqa: BLE001 — reported, fails the run
                with self.lock:
                    self.errors.append(f"client {c}: {e!r}")
                return
            t1 = time.perf_counter()
            if code == 503 and headers.get("Retry-After") is not None:
                with self.lock:
                    self.retries.append((t0, t1))
                time.sleep(0.2)
                continue
            row = body.get("results", [[]])[0] if code == 200 else None
            if code != 200 or len(row) != 10:
                with self.lock:
                    self.errors.append(f"client {c}: HTTP {code} {body}")
                return
            n += 1
            with self.lock:
                self.ok += 1
                self.lat.append(t1 - t0)
                if n % self.check_every == 0:
                    self.kept.append((q, row))

    def start(self) -> "Load":
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()
        return self

    def stop(self) -> None:
        self.stop_ev.set()
        self.go.set()
        for t in self.threads:
            t.join(timeout=300)
        self.seconds = time.perf_counter() - self.t0
        alive = [t for t in self.threads if t.is_alive()]
        if alive or self.errors:
            raise AssertionError(f"serving clients: {len(alive)} stuck, "
                                 f"errors {self.errors[:5]}")

    def quiet(self, srv) -> None:
        self.go.clear()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            pending = srv.batcher.pending_rows if srv.batcher else 0
            if pending == 0 and srv._inflight == 0:
                return
            time.sleep(0.01)
        raise AssertionError("the server did not quiesce")

    def summary(self) -> str:
        lat = np.asarray(self.lat) * 1e3
        return (f"{self.ok} requests in {self.seconds:.1f} s "
                f"({self.ok / self.seconds:.1f} requests/s), per-request "
                f"p50 {np.percentile(lat, 50):.2f} ms, p99 "
                f"{np.percentile(lat, 99):.2f} ms, {len(self.retries)} "
                f"503 retries")


def check_windows(load: Load, windows: list, what: str) -> None:
    """Every 503 a client saw overlaps a reload or compaction window."""
    outside = [(a, b) for a, b in load.retries
               if not any(a <= w1 and b >= w0 for w0, w1 in windows)]
    if outside:
        raise AssertionError(f"{what}: {len(outside)} 503s outside the "
                             f"reload/compaction windows")
    if load.retries:
        log(f"[serve] {what}: 503 windows "
            + "; ".join(f"{w1 - w0:.2f} s" for w0, w1 in windows)
            + f"; {len(load.retries)} 503s, all inside them")


def oracle_check(ref, tok, vocab, items, what: str) -> int:
    """Hold (query, result row) pairs of top_k 10 to ``ReferenceEngine``
    under the comparator; returns how many were checked."""
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    for q, row in items:
        if isinstance(q, dict):
            ids, w = tok.tokenize_weighted_queries([q], vocab)
        else:
            ids, w = tok.tokenize_queries([q], vocab), None
        k = len(row)
        docs = np.array([[it["doc"] for it in row]], np.int32)
        scores = np.array([[it["score"] for it in row]], np.float32)
        try:
            assert_matches_oracle(docs, scores,
                                  *ref.search(ids, top_k=k, weights=w))
        except AssertionError as e:
            raise AssertionError(f"{what}: {q!r}: {e}") from None
    return len(items)


def kernel_counts(ops, gr) -> dict:
    return {**ops.launches, **gr.launches}


def search_server(torch, session, index, work, harness_p50) -> float:
    """Phase 13 (a): ``Server`` over phase 4's 524,288-doc index under
    ``engine_mode="auto"`` (it must route to ``SparseEngine``, B1), with
    the micro-batcher and warm-up; the soak's load, a 512-query POST, deep
    health, then an auto and a drop-mode reload mid-traffic.  The index
    dir stays in ``work`` (``search_idx``) for phase 14; returns the
    server's start seconds (load, build and warm-up)."""
    import gc

    from bm25_tpu_torch import ReferenceEngine, Tokenizer
    from bm25_tpu_torch.bench import BenchConfig, make_queries
    from bm25_tpu_torch.eval import engine_device_bytes
    from bm25_tpu_torch.index.io import save_index, save_tokenizer_config
    from bm25_tpu_torch.ops import gather_rows as gr
    from bm25_tpu_torch.serve import Server
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    tok = Tokenizer()
    vocab = {f"w{i}": i for i in range(index.vocab_size)}
    idx_dir = os.path.join(work, "search_idx")
    t0 = time.perf_counter()
    save_index(idx_dir, dataclasses.replace(index, vocab=vocab))
    save_tokenizer_config(idx_dir, tok)
    log(f"[serve] (a) phase 4's index saved with the vocabulary w<i> and the "
        f"default Tokenizer() config in {time.perf_counter() - t0:.1f} s")
    reset(ops.launches, ops.plain_calls, gr.launches, gr.plain_calls)
    t0 = time.perf_counter()
    srv = Server(idx_dir, port=0, engine_mode="auto", batch_window_ms=5.0,
                 warmup_top_k=10, engine_kwargs={"session": session})
    build_s = time.perf_counter() - t0
    stats = srv._handler.runtime.stats
    engine = srv._handler.runtime.engine
    if stats["engine"] != "SparseEngine":
        raise AssertionError(f"auto routed to {stats['engine']}")
    dev_bytes = engine_device_bytes(engine)
    warm = kernel_counts(ops, gr)
    if not (warm["ell_score_fused"] and warm["ell_table"]):
        raise AssertionError(f"the warm-up did not launch B1: {warm}")
    log(f"[serve] (a) launches by the build and the T=8 warm-up query: "
        f"{warm}")
    log(f"[serve] (a) Server up in {build_s:.1f} s: {stats['engine']} "
        f"(hot_h={engine.hot_h}, {len(engine.buckets)} buckets, device "
        f"bytes {dev_bytes}, {dev_bytes / stats['csc_bytes']:.3f} x CSC); "
        f"warm-up breakdown {srv.last_warmup_breakdown}")
    del engine
    srv.start_background()
    ref = ReferenceEngine.from_scored_index(index)

    load = Load(srv.port, SERVE_CLIENTS).start()
    time.sleep(SERVE_LOAD_S)
    load.stop()
    if load.retries:
        raise AssertionError("503s with no reload running")
    n = oracle_check(ref, tok, vocab, load.kept, "(a) load")
    m = http(srv.port, "/healthz")[1]["metrics"]
    log(f"[serve] (a) {SERVE_CLIENTS} clients: {load.summary()}; server "
        f"metrics {m}; {n} kept responses match ReferenceEngine")
    if m["requests"] != load.ok or m["errors"] or m["batch_occupancy"] <= 1:
        raise AssertionError(f"metrics {m} against {load.ok} requests sent")

    cfg = BenchConfig()
    queries = make_queries(cfg)[: cfg.batch]
    texts = [" ".join(f"w{t}" for t in row) for row in queries]
    t0 = time.perf_counter()
    code, body, _ = http(srv.port, "/search",
                         {"queries": texts, "top_k": cfg.top_k2})
    wall = (time.perf_counter() - t0) * 1e3
    if code != 200 or len(body["results"]) != len(texts):
        raise AssertionError(f"512-query POST: HTTP {code}")
    rows = body["results"][:CHECKED_QUERIES]
    ids = tok.tokenize_queries(texts[:CHECKED_QUERIES], vocab)
    assert_matches_oracle(
        np.array([[it["doc"] for it in r] for r in rows], np.int32),
        np.array([[it["score"] for it in r] for r in rows], np.float32),
        *ref.search(ids, top_k=cfg.top_k2))
    log(f"[serve] (a) one POST of {len(texts)} queries x {queries.shape[1]} "
        f"tokens at k={cfg.top_k2}: {wall:.2f} ms wall (phase 12's p50 "
        f"batch at k={cfg.top_k2}: {harness_p50} ms); the first "
        f"{CHECKED_QUERIES} match ReferenceEngine")
    code, h, _ = http(srv.port, "/healthz?deep=1")
    if code != 200 or h["status"] != "ok":
        raise AssertionError(f"deep health {code} {h}")
    log(f"[serve] (a) /healthz?deep=1 green: device_probe "
        f"{h['device_probe']}, engine_probe {h['engine_probe']}")

    def quiet_bytes(load):
        """(memory_allocated, the allocator's requested bytes), read with
        the clients held and no admitted work left."""
        load.quiet(srv)
        torch.cuda.synchronize()
        out = (torch.cuda.memory_allocated(),
               torch.cuda.memory_stats()["requested_bytes.all.current"])
        load.go.set()
        return out

    load = Load(srv.port, SERVE_CLIENTS).start()
    windows = []
    time.sleep(1.0)
    t0 = time.perf_counter()
    code, rl, _ = http(srv.port, "/reload", {"mode": "auto"})
    windows.append((t0, time.perf_counter()))
    if code != 200:
        raise AssertionError(f"auto reload: HTTP {code} {rl}")
    log(f"[serve] (a) /reload mode=auto: chose {rl['mode']} in "
        f"{windows[-1][1] - t0:.2f} s, sizing {rl.get('sizing')}")
    time.sleep(1.0)
    before = quiet_bytes(load)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    code, rl, _ = http(srv.port, "/reload", {"mode": "drop"})
    windows.append((t0, time.perf_counter()))
    if code != 200 or rl["mode"] != "drop":
        raise AssertionError(f"drop reload: HTTP {code} {rl}")
    time.sleep(1.0)
    after = quiet_bytes(load)
    peak = torch.cuda.max_memory_allocated()
    load.stop()
    check_windows(load, windows, "(a) reloads")
    log(f"[serve] (a) /reload mode=drop in {windows[-1][1] - t0:.2f} s "
        f"mid-traffic: memory_allocated {before[0]} -> {after[0]} B, "
        f"requested {before[1]} -> {after[1]} B (one engine {dev_bytes} B, "
        f"margin {MEMORY_MARGIN:.0%} of it), peak in the reload {peak} B; "
        f"clients over both reloads: {load.summary()}")
    if abs(after[0] - before[0]) > MEMORY_MARGIN * dev_bytes:
        raise AssertionError("memory after the drop reload is off by "
                             f"{after[0] - before[0]} B")
    if peak > before[0] + dev_bytes // 2:
        raise AssertionError("the old engine lived on into the drop "
                             "reload's build")
    n = oracle_check(ref, tok, vocab, load.kept, "(a) reloads")
    log(f"[serve] (a) {n} kept responses over the reloads match "
        "ReferenceEngine")
    srv.shutdown()
    counts, plain = kernel_counts(ops, gr), {**ops.plain_calls,
                                             **gr.plain_calls}
    log(f"[serve] (a) kernel launches {counts}, plain twin runs {plain}")
    if not counts["ell_score_fused"] or any(plain.values()):
        raise AssertionError("(a) did not launch B1, or ran a plain twin")
    del srv, ref
    gc.collect()
    torch.cuda.empty_cache()
    return build_s


def updatable_server(torch, session, work) -> None:
    """Phase 13 (b): an updatable ``Server`` over the soak's 131,072-doc
    corpus under ``engine_mode="auto"`` (``DenseEngine``, B3) with
    auto-compaction that trips once; 6 clients, a mutator adding marker
    docs and deleting earlier ones, one manual /compact; then markers,
    deletes, the oracle over a fresh build and a restart's WAL replay."""
    import gc

    from bm25_tpu_torch import ReferenceEngine, Tokenizer, build_index
    from bm25_tpu_torch.bench.query_bench import _zipf_probs
    from bm25_tpu_torch.index.io import MMapCorpus
    from bm25_tpu_torch.ops import gather_rows as gr
    from bm25_tpu_torch.serve import Server
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    tok = Tokenizer()
    rng = np.random.default_rng(0)
    cum = np.cumsum(_zipf_probs(UPD_VOCAB))
    lengths = np.maximum(4, rng.poisson(32, UPD_DOCS))
    t0 = time.perf_counter()
    texts = [" ".join(f"w{t}" for t in np.searchsorted(cum, rng.random(n)))
             for n in lengths]
    idx_dir = os.path.join(work, "upd_idx")
    _, st = build_index(texts, tokenizer=tok, save_to=idx_dir,
                        save_corpus=True)
    log(f"[serve] (b) {UPD_DOCS} docs (vocab {st.vocab_size}, {st.nnz} "
        f"postings) made, built and saved in {time.perf_counter() - t0:.1f} s")
    kw = dict(port=0, engine_mode="auto", batch_window_ms=5.0,
              warmup_top_k=10, updatable=True, auto_compact=True,
              auto_compact_interval_s=0.5,
              auto_compact_delta_docs=UPD_TRIP_DOCS,
              engine_kwargs={"session": session})
    reset(ops.launches, ops.plain_calls, gr.launches, gr.plain_calls)
    t0 = time.perf_counter()
    srv = Server(idx_dir, **kw)
    stats = srv._handler.runtime.stats
    if stats["engine"] != "DenseEngine":
        raise AssertionError(f"auto routed to {stats['engine']}")
    if not gr.launches["gather_add_rows"]:
        raise AssertionError("the warm-up did not launch B3")
    log(f"[serve] (b) updatable Server up in {time.perf_counter() - t0:.1f} "
        f"s: {stats['engine']}; warm-up {srv.last_warmup_breakdown}")
    srv.start_background()
    port = srv.port
    load = Load(port, UPD_CLIENTS, mix="upd").start()
    windows, alive, deleted = [], {}, set()
    mr = np.random.default_rng(99)

    def retry(path, payload):
        while True:
            code, body, headers = http(port, path, payload)
            if code == 503 and headers.get("Retry-After") is not None:
                time.sleep(0.2)
                continue
            if code != 200:
                raise AssertionError(f"{path}: HTTP {code} {body}")
            return body

    def add_batch(n):
        docs = [f"zzmarker{n} zzm{n}d{i} "
                + " ".join(f"w{t}" for t in mr.integers(0, 2000, 8))
                for i in range(8)]
        out = retry("/add", {"docs": docs})
        alive.update({f"zzm{n}d{i}": d for i, d in enumerate(docs)})
        return out

    def delete_marker(n, i):
        token = f"zzm{n}d{i}"
        row = retry("/search", {"queries": [token], "top_k": 1})
        hit = row["results"][0][0]
        if token not in hit["text"] or hit["score"] <= 0:
            raise AssertionError(f"marker {token} not found: {hit}")
        retry("/delete", {"doc_ids": [hit["doc"]]})
        deleted.add(token)
        del alive[token]

    # stage 1: six batches of 8; the sixth crosses the threshold
    for n in range(6):
        out = add_batch(n)
        if n in (2, 4):
            delete_marker(n - 2, 0)
            delete_marker(n - 2, 1)
        if out["needs_compaction"] != (n == 5):
            raise AssertionError(f"batch {n}: needs_compaction {out}")
    t_trip = time.perf_counter()
    deadline = t_trip + 300
    while time.perf_counter() < deadline:
        h = http(port, "/healthz")[1]
        if h.get("updates", {}).get("delta_docs") == 0:
            break
        time.sleep(0.05)
    windows.append((t_trip, time.perf_counter()))
    if h["metrics"]["compactions"] != 1 or h["updates"]["delta_docs"]:
        raise AssertionError(f"auto-compaction: {h}")
    log(f"[serve] (b) auto-compaction folded the delta "
        f"{windows[-1][1] - t_trip:.2f} s after the tripping add: "
        f"{h['updates']}")
    # stage 2: two more batches and deletes, then a manual compact
    for n in (6, 7):
        add_batch(n)
    delete_marker(6, 0)
    delete_marker(1, 2)
    t0 = time.perf_counter()
    out = retry("/compact", {"save_dir": idx_dir})
    windows.append((t0, time.perf_counter()))
    log(f"[serve] (b) manual /compact (folded into the served dir) in "
        f"{windows[-1][1] - t0:.2f} s mid-traffic: {out}")
    live_texts = [d["text"] for d in MMapCorpus.open(idx_dir).batch(
        range(out["live_docs"]))]
    t0 = time.perf_counter()
    fresh, _ = build_index(live_texts, tokenizer=tok)
    ref = ReferenceEngine.from_scored_index(fresh)
    qr = np.random.default_rng(5)
    sample = [" ".join(f"w{t}" for t in qr.integers(0, 2000, 5))
              for _ in range(16)]
    sample += [{f"w{t}": float(qr.uniform(0.5, 3.0))
                for t in qr.integers(0, 2000, 5)} for _ in range(8)]
    sample += [f"zzmarker{n}" for n in range(8)]
    body = retry("/search", {"queries": sample, "top_k": 10})
    n = oracle_check(ref, tok, fresh.vocab, list(zip(sample, body["results"])),
                     "(b) after compaction")
    log(f"[serve] (b) {n} queries match ReferenceEngine over a fresh build "
        f"of the {len(live_texts)} live texts "
        f"({time.perf_counter() - t0:.1f} s)")
    # stage 3: post-compaction ops, which live only in the update log
    for n in (8, 9):
        add_batch(n)
    delete_marker(8, 3)
    delete_marker(3, 4)
    load.stop()
    check_windows(load, windows, "(b) compactions")
    m = http(port, "/healthz")[1]
    log(f"[serve] (b) {UPD_CLIENTS} clients beside the mutator: "
        f"{load.summary()}; server metrics {m['metrics']}; updates "
        f"{m['updates']}")
    if m["metrics"]["errors"] or m["metrics"]["batch_occupancy"] <= 1:
        raise AssertionError(f"metrics {m['metrics']}")
    tokens = sorted(alive) + sorted(deleted)
    body = retry("/search", {"queries": tokens, "top_k": 1})
    for token, row in zip(tokens, body["results"]):
        found = bool(row) and row[0]["score"] > 0 and token in row[0]["text"]
        if found != (token in alive):
            raise AssertionError(f"marker {token}: found {found}, alive "
                                 f"{token in alive}")
    log(f"[serve] (b) {len(alive)} live markers found, {len(deleted)} "
        "deleted ones never returned")
    sample += sorted(alive)[:8]
    before = retry("/search", {"queries": sample, "top_k": 10})
    srv.shutdown()
    del srv
    gc.collect()
    t0 = time.perf_counter()
    srv = Server(idx_dir, **kw)
    replayed = srv._handler.runtime.stats.get("wal_replayed")
    srv.start_background()
    port = srv.port  # retry() posts to the restarted server
    after = retry("/search", {"queries": sample, "top_k": 10})
    log(f"[serve] (b) restart from the same dir in "
        f"{time.perf_counter() - t0:.1f} s replayed {replayed} logged "
        "updates")
    if replayed != 4:
        raise AssertionError(f"restart replayed {replayed} updates, not 4")
    for a, b in zip(before["results"], after["results"]):
        if [it["doc"] for it in a] != [it["doc"] for it in b]:
            raise AssertionError("the restart's results differ")
        assert_matches_oracle(
            np.array([[it["doc"] for it in b]]),
            np.array([[it["score"] for it in b]], np.float32),
            np.array([[it["doc"] for it in a]]),
            np.array([[it["score"] for it in a]], np.float32))
    log(f"[serve] (b) after the restart {len(sample)} queries return the "
        "same docs and scores")
    srv.shutdown()
    counts, plain = kernel_counts(ops, gr), {**ops.plain_calls,
                                             **gr.plain_calls}
    log(f"[serve] (b) kernel launches {counts}, plain twin runs {plain}")
    if not counts["gather_add_rows"] or any(plain.values()):
        raise AssertionError("(b) did not launch B3, or ran a plain twin")
    del srv
    gc.collect()
    torch.cuda.empty_cache()


def serving(torch, session, index, ratios, harness_p50, work) -> float:
    """Phase 13: the HTTP server on the card, (a) and (b), in ``work``;
    returns (a)'s start seconds."""
    from bm25_tpu_torch.serve import FALLBACK_DEVICE_CSC_RATIO

    log("[serve] device bytes / CSC bytes of the sparse builds of phases 4 "
        "and 4b: " + "; ".join(f"{k} {v:.5f}" for k, v in ratios.items())
        + f"; serve.FALLBACK_DEVICE_CSC_RATIO {FALLBACK_DEVICE_CSC_RATIO}")
    if FALLBACK_DEVICE_CSC_RATIO < max(ratios.values()):
        raise AssertionError("the auto reload's fallback ratio is below a "
                             "measured one")
    start_s = search_server(torch, session, index, work, harness_p50)
    updatable_server(torch, session, work)
    return start_s


RESTART_CLIENTS = 4
RESTART_LOAD_S = 5.0
RESTART_CHECK_EVERY = 10  # every 10th response of each client is checked
RESTART_DENSE_DOCS = 16384  # a 2.1 GB f32 table of the headline's vocab
PR17_BUILD_S = 4.0  # phase 13 (a)'s start in PR 17 (PERF.md section 5)


def leaves(engine) -> dict:
    """Every tensor an engine's step reads, keyed as its checkpoint's."""
    from bm25_tpu_torch import DenseEngine

    if isinstance(engine, DenseEngine):
        return {"st": engine.st, "offsets": engine.offsets}
    out = {"offsets": engine.offsets, "hot_table": engine.hot_table}
    for i, b in enumerate(engine.buckets):
        out.update({f"buckets.{i}.{k}": t for k, t in b.items()})
    for key in ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
                "tail_gpos"):
        if getattr(engine, key, None) is not None:
            out[key] = getattr(engine, key)
    return out


def round_trip(torch, session, what, build, queries, oracle, work, counters):
    """Build an engine, save its device checkpoint, load it back: save /
    load / build seconds and bytes on disk logged, every restored tensor
    ``torch.equal`` to the source's (bf16 bits included), ``queries`` at
    k=1000 and k=100 equal to the source's, ids and scores, and the first
    CHECKED_QUERIES held to ``oracle[k]`` under the comparator.  Returns
    the restored engine and the kernels' launches over the load and
    searches (``counters``: (launches, plain runs) dicts, reset here)."""
    from bm25_tpu_torch import load_device_checkpoint, save_device_checkpoint
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    t0 = time.perf_counter()
    engine = build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    path = os.path.join(work, "ck")
    t0 = time.perf_counter()
    save_device_checkpoint(path, engine)
    save_s = time.perf_counter() - t0
    disk = os.path.getsize(path) + os.path.getsize(path + ".meta.json")
    reset(*counters)
    t0 = time.perf_counter()
    restored = load_device_checkpoint(path, session=session)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    at_load = {k: v for c in counters for k, v in c.items() if v}
    got, want = leaves(restored), leaves(engine)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: restored keys {sorted(got)}")
    for key in got:
        if got[key].device != want[key].device or \
                got[key].dtype != want[key].dtype or \
                not torch.equal(got[key], want[key]):
            raise AssertionError(f"{what}: restored {key} differs")
    for k in sorted(oracle, reverse=True):
        rd, rs = restored.search(queries, top_k=k)
        sd, ss = engine.search(queries, top_k=k)
        if not (np.array_equal(rd, sd) and np.array_equal(rs, ss)):
            raise AssertionError(f"{what}: restored k={k} results differ")
        assert_matches_oracle(rd[:CHECKED_QUERIES], rs[:CHECKED_QUERIES],
                              *oracle[k])
    os.unlink(path)
    os.unlink(path + ".meta.json")
    total = {k: v for c in counters for k, v in c.items() if v}
    hot = sum("hotT" in b for b in getattr(engine, "buckets", []))
    log(f"[restart] {what}: from_scored_index {build_s:.2f} s, save "
        f"{save_s:.2f} s, {disk} B on disk (device bytes "
        f"{sum(t.nbytes for t in want.values())}), load_device_checkpoint "
        f"{load_s:.2f} s ({build_s / max(load_s, 1e-9):.1f}x faster than "
        f"the build); {len(got)} tensors torch.equal to the source's"
        f"{', hotT/hotLo bits included' if hot else ''}; "
        f"{len(queries)} queries at k={sorted(oracle, reverse=True)} equal "
        f"to the source's, the first {CHECKED_QUERIES} match "
        f"ReferenceEngine; launches and plain twin runs in the load "
        f"{at_load}, in the load and the searches {total}")
    del engine
    return restored, at_load, hot


def warm_restart(torch, session, index, cfg, work, start_s, harness_result):
    """Phase 14: device checkpoints, serving from one, warm-up and the
    build cache, on phase 4's corpus (made with ``cfg``) and phase 13's
    index dir in ``work``; phase 12's cold-start row read from
    ``harness_result``."""
    import io
    import tarfile

    from bm25_tpu_torch import (DenseEngine, ReferenceEngine, SparseEngine,
                                Tokenizer)
    from bm25_tpu_torch.bench import make_queries, make_synthetic_index
    from bm25_tpu_torch.models.sparse import best_layout, layout_candidates
    from bm25_tpu_torch.ops import _build
    from bm25_tpu_torch.ops import gather_rows as gr
    from bm25_tpu_torch.runtime import cache as cc
    from bm25_tpu_torch.runtime.warmup import warm_engine
    from bm25_tpu_torch.serve import Server

    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    counters = (ops.launches, ops.plain_calls, gr.launches, gr.plain_calls)
    queries = make_queries(cfg)[: cfg.batch]
    ks = (cfg.top_k, cfg.top_k2)
    ref = ReferenceEngine.from_scored_index(index)
    oracle = {k: ref.search(queries[:CHECKED_QUERIES], top_k=k) for k in ks}

    # (a) three sparse layouts of phase 4's corpus
    model = best_layout(layout_candidates(index, cfg.top_k, q=cfg.batch,
                                          t=max(cfg.query_len, 8),
                                          device=session.device))
    layouts = {
        f"model's layout (h={model['hot_tokens']}, "
        f"{model['max_buckets']} buckets)":
            dict(hot_tokens=model["hot_tokens"],
                 max_buckets=model["max_buckets"]),
        f"h={HOT_TOKENS}, {MAX_BUCKETS} buckets":
            dict(hot_tokens=HOT_TOKENS, max_buckets=MAX_BUCKETS),
        f"three tiers (h={HOT_TOKENS}, {MAX_BUCKETS} buckets, "
        "tail_cap=512)":
            dict(hot_tokens=HOT_TOKENS, max_buckets=MAX_BUCKETS,
                 tail_cap=512),
    }
    headline = None
    for what, kw in layouts.items():
        kw["hot_budget_bytes"] = max(kw["hot_tokens"], 1) * index.num_docs * 4
        restored, at_load, hot = round_trip(
            torch, session, what,
            lambda: SparseEngine.from_scored_index(index, session=session,
                                                   **kw),
            queries, oracle, work, counters)
        b2 = at_load.get("ell_score", 0)
        if b2 != 2 * hot or any(c for c in ops.plain_calls.values()):
            raise AssertionError(f"{what}: B2 launched {b2} times in the "
                                 f"load for {hot} hot buckets, or a plain "
                                 "twin ran")
        if "tail_cap" in kw and restored.tail_docs is None:
            raise AssertionError(f"{what}: no tail tier")
        if headline is None:
            headline = restored
        else:
            del restored
        torch.cuda.empty_cache()
    log("[restart] B2 launches in each load: 2 a hot bucket (hi and lo), "
        "no plain twin run")

    # (b) a dense engine at a depth whose table stays near 2 GB
    dindex = make_synthetic_index(
        dataclasses.replace(cfg, num_docs=RESTART_DENSE_DOCS))
    dref = ReferenceEngine.from_scored_index(dindex)
    doracle = {k: dref.search(queries[:CHECKED_QUERIES], top_k=k)
               for k in ks}
    restored, _, _ = round_trip(
        torch, session, f"DenseEngine ({RESTART_DENSE_DOCS} docs)",
        lambda: DenseEngine.from_scored_index(dindex, session=session),
        queries, doracle, work, counters)
    if not gr.launches["gather_add_rows"] or \
            any(gr.plain_calls.values()):
        raise AssertionError("the restored dense engine did not launch B3, "
                             "or ran a plain twin")
    log(f"[restart] B3 launches over the dense searches "
        f"{gr.launches['gather_add_rows']}, no plain twin run")
    del restored, dindex, dref
    torch.cuda.empty_cache()

    # (c) serving from a checkpoint of phase 13's index dir
    idx_dir = os.path.join(work, "search_idx")
    ck = os.path.join(work, "serve_ck")
    t0 = time.perf_counter()
    out = cli(["checkpoint", idx_dir, "-o", ck])
    log(f"[restart] bm25-tpu-torch checkpoint {os.path.basename(idx_dir)} "
        f"-o {os.path.basename(ck)} ({time.perf_counter() - t0:.2f} s): "
        + " | ".join(out.strip().splitlines()))
    reset(*counters)
    t0 = time.perf_counter()
    srv = Server(idx_dir, port=0, device_checkpoint=ck, batch_window_ms=5.0,
                 warmup_top_k=10, engine_kwargs={"session": session})
    up_s = time.perf_counter() - t0
    stats = srv._handler.runtime.stats
    if stats["engine"] != "SparseEngine":
        raise AssertionError(f"the checkpoint holds a {stats['engine']}")
    log(f"[restart] Server(device_checkpoint=...) up in {up_s:.2f} s "
        f"({stats['engine']}, warm-up {srv.last_warmup_breakdown}); phase "
        f"13's build from the index dir {start_s:.2f} s, PR 17's "
        f"{PR17_BUILD_S} s")
    srv.start_background()
    vocab = {f"w{i}": i for i in range(index.vocab_size)}
    load = Load(srv.port, RESTART_CLIENTS,
                check_every=RESTART_CHECK_EVERY).start()
    time.sleep(RESTART_LOAD_S)
    load.stop()
    if load.retries:
        raise AssertionError("503s with no reload running")
    n = oracle_check(ref, Tokenizer(), vocab, load.kept,
                     "(restart) load")
    code, h, _ = http(srv.port, "/healthz?deep=1")
    if code != 200 or h["status"] != "ok":
        raise AssertionError(f"deep health {code} {h}")
    log(f"[restart] {RESTART_CLIENTS} clients: {load.summary()}; {n} kept "
        f"responses match ReferenceEngine; /healthz?deep=1 green; launches "
        f"{kernel_counts(ops, gr)}")
    if not ops.launches["ell_score_fused"] or \
            any(ops.plain_calls.values()):
        raise AssertionError("the restored server did not launch B1, or "
                             "ran a plain twin")
    srv.shutdown()
    # with no index dir a restored server takes the default Tokenizer()
    # (the native Snowball stemmer) and has no index to reload
    bare = Server(None, port=0, device_checkpoint=ck,
                  engine_kwargs={"session": session})
    bare.start_background()
    code, body, _ = http(bare.port, "/reload", {})
    bare.shutdown()
    if code != 400:
        raise AssertionError(f"/reload with no index to reload: HTTP {code}")
    try:
        Server(None, port=0, updatable=True, device_checkpoint=ck,
               engine_kwargs={"session": session})
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("updatable=True beside a checkpoint started")
    log(f"[restart] a restored server with no index dir (the default "
        f"Tokenizer()) answers /reload with 400 ({body['error']!r}); "
        f"updatable=True with a checkpoint raises ValueError ({refused!r})")
    del srv, bare
    torch.cuda.empty_cache()

    # (d) warm-up and the build cache
    report = warm_engine(headline, top_ks=(10, 100, 1000))
    first = {p: round(sum(t[p] for t in report), 4)
             for p in ("nvcc_build_s", "library_load_s")}
    log(f"[restart] warm_engine on the restored model-layout engine: "
        f"{len(report)} tasks, seconds "
        + ", ".join(f"q={t['q']} k={t['top_k']} {t['seconds']}"
                    for t in report) + f"; first-use work {first}")
    if any(first.values()):
        raise AssertionError("warm-up built or loaded a library after "
                             "phase 2")
    del headline
    archive = os.path.join(work, "cache.tar.gz")
    exported = json.loads(cli(["cache", "export", archive]))
    imported_dir = os.path.join(work, "imported_build")
    imported = json.loads(cli(["cache", "import", archive, "--dir",
                               imported_dir]))
    if imported["imported"] != exported["entries"] or \
            imported["mismatches"]:
        raise AssertionError(f"cache import {imported}")
    log(f"[restart] cache export of {_build.build_dir()}: "
        f"{exported['entries']} files, {exported['bytes']} B; import: "
        f"{imported['imported']} files; fingerprint "
        f"{json.dumps(exported['manifest']['fingerprint'])}")
    foreign = os.path.join(work, "foreign.tar.gz")
    with tarfile.open(archive, "r:gz") as tar, \
            tarfile.open(foreign, "w:gz") as dst:
        for m in tar.getmembers():
            data = tar.extractfile(m).read()
            if m.name == cc.MANIFEST_NAME:
                manifest = json.loads(data)
                manifest["fingerprint"]["sm"] = "sm_80"
                data = json.dumps(manifest).encode()
            info = tarfile.TarInfo(m.name)
            info.size = len(data)
            dst.addfile(info, io.BytesIO(data))
    from bm25_tpu_torch.cli.main import main as cli_main

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()) as err:
        rc = cli_main(["cache", "import", foreign, "--dir",
                       os.path.join(work, "foreign_build")])
    if rc != 2 or "sm: archive='sm_80'" not in err.getvalue():
        raise AssertionError(f"a foreign archive: exit {rc} "
                             f"{err.getvalue()!r}")
    forced = json.loads(cli(["cache", "import", foreign, "--dir",
                             os.path.join(work, "foreign_build"),
                             "--force"]))
    log(f"[restart] an archive naming sm_80 is refused without --force "
        f"({err.getvalue().strip()!r}); with --force it imports, reporting "
        f"{forced['mismatches']}")
    cold = harness_result["extra"]["cold_start"]
    log(f"[restart] phase 12's cold_start row: {json.dumps(cold)}")
    use = cold["first_use"]
    if use["cold"]["nvcc_build_s"] <= 0 or \
            use["cache_import"]["nvcc_build_s"] != 0 or \
            use["warm"]["nvcc_build_s"] != 0:
        raise AssertionError("cold_start: the cold child built nothing, or "
                             "a warm or imported child ran nvcc")
    log(f"[restart] first headline step in a fresh process: cold "
        f"{cold['headline_step_cold_compile_s']} s (nvcc "
        f"{use['cold']['nvcc_build_s']} s), warm "
        f"{cold['headline_step_warm_cache_s']} s, after cache import "
        f"{cold['headline_step_cache_import_s']} s (nvcc "
        f"{use['cache_import']['nvcc_build_s']} s)")


def sharded_vs_single(got, want, what: str) -> float:
    """A sharded engine's (docs, scores) against the single-device
    engine's at the same layout: ids equal, scores within 2e-5 x max(1,
    the row's largest |score|).  Returns the largest |difference|, which
    the phase logs."""
    gd, gs = got
    wd, ws = want
    if not np.array_equal(gd, wd):
        raise AssertionError(f"{what}: ids differ from the single-device "
                             "engine's")
    scale = np.maximum(1.0, np.abs(ws).max(axis=1, keepdims=True))
    diff = np.abs(gs - ws)
    if not (diff <= 2e-5 * scale).all():
        raise AssertionError(f"{what}: scores differ by {diff.max():.3e}")
    return float(diff.max())


def mesh_pieces(engine) -> dict:
    """Every (field, row, shard) piece of a sharded engine."""
    fields = ({"st": engine.st, "offsets": engine.offsets}
              if not hasattr(engine, "buckets") else
              {"offsets": engine.offsets, "hot_table": engine.hot_table,
               **{f"buckets.{i}.{k}": t for i, b in enumerate(engine.buckets)
                  for k, t in b.items()}})
    return {(key, r, j): t.on(r, j) for key, t in fields.items()
            for r in range(engine.mesh.devices.shape[0])
            for j in range(engine.mesh.local_docs)}


def sharded_checkpoint(torch, ops, engine, build_s, batch, ks, work,
                       what: str) -> None:
    """Phase 15 (g): save a sharded engine's device checkpoint, load it on
    the engine's mesh (each shard's hot pair rebuilt by two B2 launches)
    and restore it in place: every piece bit-equal to the engine it was
    saved from, the results at each k bit-equal, ``hot_table_host`` the
    restored table's; a mesh of another doc axis refused; save, load and
    restore seconds beside the build's."""
    from bm25_tpu_torch import load_device_checkpoint, save_device_checkpoint
    from bm25_tpu_torch.index.device_checkpoint import (
        restore_device_checkpoint)
    from bm25_tpu_torch.parallel import make_mesh

    def same(a, b, when):
        got, want = mesh_pieces(a), mesh_pieces(b)
        if sorted(got) != sorted(want) or not all(
                got[key].dtype == want[key].dtype
                and torch.equal(got[key], want[key]) for key in want):
            raise AssertionError(f"{what}: {when} pieces differ")

    path = os.path.join(work, "ck")
    t0 = time.perf_counter()
    save_device_checkpoint(path, engine)
    save_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(work, f))
               for f in os.listdir(work) if f.startswith("ck"))
    b2 = ops.launches["ell_score"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_device_checkpoint(path, mesh=engine.mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    b2 = ops.launches["ell_score"] - b2
    hot = sum("hotT" in b for b in getattr(engine, "buckets", []))
    shards = engine.mesh.local_docs
    if b2 != 2 * hot * shards:
        raise AssertionError(f"{what}: B2 ran {b2} times on load, not "
                             f"twice a shard's hot bucket ({hot} x {shards})")
    same(loaded, engine, "loaded")
    for k in ks:
        got, want = loaded.search(batch, top_k=k), engine.search(batch,
                                                                 top_k=k)
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError(f"{what}: the loaded engine's results "
                                 f"differ at k={k}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_device_checkpoint(path, loaded)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same(loaded, engine, "restored")
    if hot and not np.array_equal(loaded.hot_table_host,
                                  loaded.hot_table.numpy()):
        raise AssertionError(f"{what}: hot_table_host is not the table")
    card = engine.mesh.devices[0, 0]
    try:
        load_device_checkpoint(path, mesh=make_mesh(2, devices=[card] * 2))
    except ValueError as e:
        if "doc shards but the restore mesh has 2" not in str(e):
            raise
    else:
        raise AssertionError(f"{what}: a 2-shard mesh was not refused")
    log(f"[sharded] {what}: checkpoint of {size} B saved in {save_s:.2f} s; "
        f"loaded in {load_s:.2f} s (built in {build_s:.2f} s; B2 launches "
        f"{b2} = 2 x {hot} hot buckets x {shards} shards), restored in "
        f"place in {restore_s:.2f} s: every piece and the results at k={ks} "
        "bit-equal to the saved engine; a 2-shard mesh refused")
    del loaded
    torch.cuda.empty_cache()


def sharded(torch, session, index, cfg) -> None:
    """Phase 15: the doc-sharded engines on the card.  (a) a
    ``ShardedSparseEngine`` on ``make_mesh()`` (the (1, 1) mesh), (b) on
    (1, 4) and (2, 2) meshes over the one card and on (1, 4) at an
    explicit hot_tokens=1024 (B2 once a shard), each held to
    ``ReferenceEngine`` and to a ``SparseEngine`` at the same layout, with
    its build, each shard's bytes and its device step (and the card's
    busy ms in it) beside the single engine's; (c) ``ShardedEngine`` over 131,072 docs on (1, 1) and (1, 4)
    against ``DenseEngine``; (d) a forced k_local trim, exact, and its
    fallback on planted ties; (e) two ``_multihost_main`` processes on the
    card over gloo, each saving and loading its shards; (f) the CLI's
    ``query --engine sharded_sparse`` equal to ``--engine sparse``; (g)
    the device checkpoints of the (1, 4) engine at hot_tokens=1024 (which
    routes its batches) and of a (1, 4) ``ShardedEngine`` over 16,384 docs
    (``sharded_checkpoint``).  B1, B2 and B3 must launch, no plain
    twin."""
    import shutil
    import socket
    import tempfile

    from bm25_tpu_torch import (DenseEngine, ReferenceEngine, ShardedEngine,
                                ShardedSparseEngine, SparseEngine,
                                build_index)
    from bm25_tpu_torch.bench import (BenchConfig, make_queries,
                                      make_synthetic_index)
    from bm25_tpu_torch.bench.query_bench import (measure_device_step_ms,
                                                  measure_sharded_step_ms)
    from bm25_tpu_torch.datasets import synthetic_corpus
    from bm25_tpu_torch.ops import gather_rows as gr
    from bm25_tpu_torch.parallel import make_mesh
    from bm25_tpu_torch.parallel import sharded_engine as pse
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    reset(ops.launches, ops.plain_calls, gr.launches, gr.plain_calls)
    card = session.device
    queries = make_queries(cfg)
    batch = queries[: cfg.batch]
    sub = slice(0, CHECKED_QUERIES)
    ks = (cfg.top_k, cfg.top_k2)
    ref = ReferenceEngine.from_scored_index(index)
    want = {k: ref.search(batch[sub], top_k=k) for k in ks}
    rng = np.random.default_rng(15)
    mask = rng.random(index.num_docs) < 0.5
    want_m = ref.search(batch[sub], top_k=cfg.top_k, doc_mask=mask)

    def build(cls, idx, **kw):
        t0 = time.perf_counter()
        eng = cls.from_scored_index(idx, **kw)
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    def sparse_case(what, mesh, layout, single):
        eng, build_s = build(ShardedSparseEngine, index, mesh=mesh,
                             **layout)
        if eng.hot_h != single.hot_h:
            raise AssertionError(f"{what}: hot_h {eng.hot_h} != "
                                 f"{single.hot_h}")
        worst = 0.0
        steps = []
        for k in ks:
            got = eng.search(batch, top_k=k)
            assert_matches_oracle(got[0][sub], got[1][sub], *want[k])
            worst = max(worst, sharded_vs_single(
                got, single.search(batch, top_k=k), f"{what} k={k}"))
            full = measure_sharded_step_ms(eng, batch, k)
            local = measure_sharded_step_ms(eng, batch, k, local_only=True)
            one = measure_device_step_ms(single, batch, k, batch=cfg.batch)
            # the card's busy ms in one step: below the step where the
            # host's launches pace it
            fn, args, _ = eng.bench_step_fn(batch, k)
            busy = device_busy_ms(torch, lambda: fn(*args))
            if busy <= 0:
                raise AssertionError("torch.profiler recorded no device "
                                     "time")
            steps.append(f"k={k} step {full:.3f} ms (local {local:.3f}, "
                         f"merge {full - local:.3f}; device busy "
                         f"{busy:.3f}, idle share {1 - busy / full:.3f}; "
                         f"SparseEngine {one:.3f})")
        log(f"[sharded] {what}: mesh {eng.mesh.shape}, hot_h={eng.hot_h}, "
            f"{len(eng.buckets)} buckets, built in {build_s:.2f} s "
            f"(SparseEngine's layout); shard bytes {eng.shard_bytes()}; "
            f"{'; '.join(steps)}; {cfg.batch} queries at k={ks} match "
            f"ReferenceEngine (first {CHECKED_QUERIES}) and the "
            f"SparseEngine's ids, scores within {worst:.3e}")
        return eng, build_s

    # (a) the (1, 1) mesh of make_mesh() at the model's layout (h from the
    # cost model, 2 buckets), beside the single-device engine's
    layout = {"max_buckets": MAX_BUCKETS}
    mesh = make_mesh()
    if mesh.shape != {"data": 1, "docs": torch.cuda.device_count()}:
        raise AssertionError(f"make_mesh(): {mesh}")
    single, single_s = build(SparseEngine, index, session=session, **layout)
    log(f"[sharded] SparseEngine at the model's layout built in "
        f"{single_s:.2f} s (hot_h={single.hot_h}, {len(single.buckets)} "
        "buckets)")
    eng, _ = sparse_case("(a) make_mesh()", mesh, layout, single)
    # the meshes below take the same layout, whatever their row alignment
    layout = {"max_buckets": MAX_BUCKETS, "hot_tokens": single.hot_h,
              "hot_budget_bytes": 1 << 40}
    k = cfg.top_k
    docs, scores = eng.search(batch, top_k=k)
    if not np.array_equal(eng.search_ids(batch, top_k=k), docs):
        raise AssertionError("(a) search_ids differs from search's ids")
    got_m = eng.search(batch, top_k=k, doc_mask=mask)
    assert_matches_oracle(got_m[0][sub], got_m[1][sub], *want_m)
    sharded_vs_single(got_m, single.search(batch, top_k=k, doc_mask=mask),
                      "(a) masked")
    if not mask[got_m[0][got_m[0] >= 0]].all():
        raise AssertionError("(a) a masked doc was returned")
    eng.score_dtype = "bfloat16"
    d16, s16 = eng.search(batch, top_k=k)
    rounded = torch.from_numpy(scores).bfloat16().float().numpy()
    if not np.array_equal(d16, docs) or not np.array_equal(s16, rounded):
        raise AssertionError("(a) bf16: not the f32 batch's ids and its "
                             "scores rounded to bf16 (plus offsets 0)")
    eng.score_dtype = "float32"
    t0 = time.perf_counter()
    pd, ps = eng.search_pipelined(queries, top_k=k, batch=cfg.batch)
    pipe_s = time.perf_counter() - t0
    sd, ss = eng.search(queries, top_k=k)
    if not (np.array_equal(pd, sd) and np.array_equal(ps, ss)):
        raise AssertionError("(a) search_pipelined differs from search")
    log(f"[sharded] (a) search_ids equal to search's ids; a masked batch "
        f"({int(mask.sum())} docs eligible) matches ReferenceEngine and "
        f"SparseEngine; bf16 scores are the f32 batch's rounded; "
        f"search_pipelined over {len(queries)} queries ({pipe_s * 1e3:.1f} "
        f"ms wall) equals search")
    del eng

    # (b) four doc shards, and 2 x 2, over the one card, then (1, 4) at
    # the explicit hot tier: B2 builds each shard's hot pair
    e14, _ = sparse_case("(b) (1, 4)", make_mesh(4, devices=[card] * 4),
                         layout, single)
    del e14
    e22, _ = sparse_case("(b) (2, 2)", make_mesh(4, data=2,
                                                 devices=[card] * 4),
                         layout, single)
    del e22, single
    torch.cuda.empty_cache()
    hot = {"hot_tokens": HOT_TOKENS,
           "hot_budget_bytes": HOT_TOKENS * index.num_docs * 4,
           "max_buckets": MAX_BUCKETS}
    single, single_s = build(SparseEngine, index, session=session, **hot)
    b2 = ops.launches["ell_score"]
    e14, e14_s = sparse_case("(b) (1, 4) hot_tokens=1024",
                             make_mesh(4, devices=[card] * 4), hot, single)
    b2 = ops.launches["ell_score"] - b2
    if b2 != 4 * len(e14.buckets):
        raise AssertionError(f"B2 ran {b2} times, not once a shard and "
                             "bucket")
    log(f"[sharded] (b) B2 built each shard's hot pair: {b2} launches for 4 "
        f"shards x {len(e14.buckets)} buckets")
    for k in ks:
        perm, chunks = e14._plan(batch, None, k)
        if perm is None:
            raise AssertionError(f"(b) (1, 4) hot_tokens=1024 at k={k}: "
                                 "'auto' did not route")
        shapes = [(c.cq, c.padded.shape[0], c.cold_padded.shape[1])
                  for c in chunks]
        log(f"[sharded] (b) (1, 4) hot_tokens=1024 k={k} routed (the "
            f"ReferenceEngine check above): chunks (rows, height, cold "
            f"width) {shapes}")

    # (g) device checkpoints: the (1, 4) engine at h=1024 saved, loaded
    # and restored; a (1, 4) ShardedEngine over 16,384 docs
    ck_work = tempfile.mkdtemp(prefix="chip_smoke_ck_",
                               dir=os.path.join(HERE, "_scratch"))
    try:
        sharded_checkpoint(torch, ops, e14, e14_s, batch, ks, ck_work,
                           "(g) (1, 4) hot_tokens=1024")
        d16 = make_synthetic_index(BenchConfig(num_docs=16384))
        se, se_s = build(ShardedEngine, d16,
                         mesh=make_mesh(4, devices=[card] * 4))
        b3 = gr.launches["gather_add_rows"]
        sharded_checkpoint(torch, ops, se, se_s,
                           make_queries(BenchConfig(num_docs=16384))[
                               : cfg.batch], ks, ck_work,
                           "(g) (1, 4) ShardedEngine, 16,384 docs")
        if gr.launches["gather_add_rows"] == b3:
            raise AssertionError("(g) the loaded ShardedEngine ran no B3")
        del se
    finally:
        shutil.rmtree(ck_work)

    # (d) the k_local trim: on (1, 4) at k=100 with 50 a shard, exact;
    # then planted ties on (1, 8), where the exactness check must fall back
    counts = dict(pse.trim_counts)
    e14.k_local = cfg.top_k2 // 2
    got = e14.search(batch, top_k=cfg.top_k2)
    assert_matches_oracle(got[0][sub], got[1][sub], *want[cfg.top_k2])
    sharded_vs_single(got, single.search(batch, top_k=cfg.top_k2),
                      "(d) trimmed")
    from bm25_tpu_torch.scoring import build_scored_index

    tied = build_scored_index([np.array([0, 1], np.int32)] * 64,
                              vocab_size=4)
    te = ShardedSparseEngine.from_scored_index(
        tied, mesh=make_mesh(8, devices=[card] * 8))
    te.k_local = 3
    td, ts = te.search(np.array([[0, 1]], np.int32), top_k=16)
    if not np.array_equal(td[0], np.arange(16)) or len(set(ts[0])) != 1:
        raise AssertionError(f"(d) the tied fallback returned {td[0]}")
    delta = {key: pse.trim_counts[key] - counts[key] for key in counts}
    log(f"[sharded] (d) k_local={e14.k_local} of k={cfg.top_k2} on 4 "
        f"shards: exact; planted "
        f"ties on 8 shards at k_local=3: ids 0..15; trims {delta}")
    if delta["fallback"] < 1 or delta["trimmed"] < 2:
        raise AssertionError(f"(d) trim counts {delta}")
    del e14, single, te
    torch.cuda.empty_cache()

    # (c) the dense engines over 131,072 docs (17.2 GB tables)
    dcfg = BenchConfig(num_docs=DENSE_DOCS)
    dindex = make_synthetic_index(dcfg)
    dq = make_queries(dcfg)[: dcfg.batch]
    dref = {k: ReferenceEngine.from_scored_index(dindex).search(
        dq[sub], top_k=k) for k in ks}
    dense, dense_s = build(DenseEngine, dindex, session=session)
    dwall = {k: wall_ms(lambda k=k: dense.search(dq, top_k=k)) for k in ks}
    for what, mesh in (("(c) (1, 1)", make_mesh(1, devices=[card])),
                       ("(c) (1, 4)", make_mesh(4, devices=[card] * 4))):
        eng, build_s = build(ShardedEngine, dindex, mesh=mesh)
        walls = []
        for k in ks:
            got = eng.search(dq, top_k=k)
            assert_matches_oracle(got[0][sub], got[1][sub], *dref[k])
            want_d = dense.search(dq, top_k=k)
            if not (np.array_equal(got[0], want_d[0])
                    and np.array_equal(got[1], want_d[1])):
                raise AssertionError(f"{what} k={k}: not DenseEngine's "
                                     "ids and scores")
            walls.append(f"k={k} {wall_ms(lambda k=k: eng.search(dq, top_k=k)):.2f} "
                         f"ms (DenseEngine {dwall[k]:.2f})")
        log(f"[sharded] {what} ShardedEngine: built in {build_s:.2f} s "
            f"(DenseEngine {dense_s:.2f} s); shard bytes "
            f"{[t.numel() * t.element_size() for t in eng.st.parts[0]]}; "
            f"batch wall {'; '.join(walls)}; DenseEngine's ids and scores "
            "bit for bit, ReferenceEngine's")
        del eng
        torch.cuda.empty_cache()
    del dense
    torch.cuda.empty_cache()

    # (e) two processes sharing the card over gloo, each saving and
    # loading its own shards of both engines' checkpoints
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": HERE}
    ck_work = tempfile.mkdtemp(prefix="chip_smoke_mh_",
                               dir=os.path.join(HERE, "_scratch"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bm25_tpu_torch.parallel._multihost_main",
         str(pid), "2", str(port), "2", "--device", card.type,
         "--checkpoint", os.path.join(ck_work, "ck")], cwd=HERE,
        env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(ck_work, ignore_errors=True)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith(f"[p{pid}]") or "MULTIHOST" in line \
                    or "CHECKPOINT" in line:
                log(f"[sharded] (e) {line}")
        if p.returncode != 0:
            raise AssertionError(f"(e) process {pid} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
    if "MULTIHOST_OK" not in outs[0] or f"(gloo, {card.type}" not in outs[0] \
            or "CHECKPOINT_OK" not in outs[0]:
        raise AssertionError(f"(e) no MULTIHOST_OK and CHECKPOINT_OK over "
                             f"gloo on the card:\n{outs[0][-3000:]}")
    log(f"[sharded] (e) 2 processes x 2 shards on the card over gloo (CUDA "
        f"tensors in all_gather): MULTIHOST_OK, each process's shards "
        f"saved and loaded bit-equal (CHECKPOINT_OK), in "
        f"{time.perf_counter() - t0:.1f} s")

    # (f) the CLI
    work = tempfile.mkdtemp(prefix="chip_smoke_sharded_",
                            dir=os.path.join(HERE, "_scratch"))
    try:
        idx = os.path.join(work, "idx")
        build_index(synthetic_corpus(4000, vocab=3000, avg_len=24, seed=0),
                    save_to=idx)
        texts = ["w000007^2.5 w000120 w001500", "w000017 w000002",
                 "w000300^0.5 w000044 w002999 w000001"]
        out = {engine: cli(["--device", card.type, "query", idx, *texts,
                            "-k", "10", "--engine", engine])
               for engine in ("sharded_sparse", "sparse")}
        # every rank's doc and printed score (the batch ms differs)
        if query_results(out["sharded_sparse"]) != \
                query_results(out["sparse"]):
            raise AssertionError("(f) query --engine sharded_sparse differs "
                                 "from --engine sparse")
        log(f"[sharded] (f) query --engine sharded_sparse equal to --engine "
            f"sparse: " + " | ".join(out["sparse"].splitlines()[:2]))
    finally:
        shutil.rmtree(work)

    launches = {**ops.launches, **gr.launches}
    plain = {**ops.plain_calls, **gr.plain_calls}
    log(f"[sharded] kernel launches within the phase {launches}, plain twin "
        f"runs {plain}")
    needed = ("ell_score_fused", "ell_score", "gather_add_rows")
    if not all(launches[n] for n in needed) or any(plain.values()):
        raise AssertionError("the sharded phase did not launch B1, B2 and "
                             "B3, or ran a plain twin")


TEXT_CHECKED = 64  # queries of corpus (a) held to ReferenceEngine
FIXTURE_DOCS = 65536  # corpus (b)
FIXTURE_QUERIES = 256
PY_SAMPLE_DOCS = 16384  # the Python path's sample, for scale
NON_ASCII_WORDS = ("café", "naïve", "Über", "straße", "résumé", "l’homme",
                   "façade", "smörgåsbord", "Ελλάδα", "coöperate")


def fixture_corpus(n: int, seed: int) -> tuple[list[str], list[str]]:
    """Corpus (b): each document 2-6 sentences of
    ``tests/data/english_fixture.txt`` drawn with replacement; one document
    in 100 carries a word of ``NON_ASCII_WORDS``.  Returns (docs, the
    fixture's sentences)."""
    with open(os.path.join(HERE, "tests", "data", "english_fixture.txt"),
              encoding="utf-8") as f:
        lines = [line for line in f.read().splitlines() if line.strip()]
    rng = np.random.default_rng(seed)
    counts = rng.integers(2, 7, n)
    picks = rng.integers(0, len(lines), int(counts.sum()))
    docs, pos = [], 0
    for i, c in enumerate(counts):
        doc = " ".join(lines[j] for j in picks[pos: pos + c])
        pos += c
        if i % 100 == 0:
            words = doc.split(" ")
            words.insert(int(rng.integers(0, len(words) + 1)),
                         NON_ASCII_WORDS[(i // 100) % len(NON_ASCII_WORDS)])
            doc = " ".join(words)
        docs.append(doc)
    return docs, lines


def fixture_queries(lines: list[str], n: int, seed: int) -> list[str]:
    """3-6 words of one fixture sentence a query; every 8th also carries a
    non-ASCII word."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = lines[int(rng.integers(len(lines)))].split()
        q = [words[j] for j in rng.integers(0, len(words),
                                            int(rng.integers(3, 7)))]
        if i % 8 == 0:
            q.append(NON_ASCII_WORDS[(i // 8) % len(NON_ASCII_WORDS)])
        out.append(" ".join(q))
    return out


def same_index(a, b, what: str) -> None:
    """Two ScoredIndexes equal field for field, arrays byte for byte."""
    for name in ("indptr", "indices", "data", "doc_lengths",
                 "token_offsets"):
        x, y = getattr(a, name), getattr(b, name)
        if (x is None) != (y is None) or (x is not None and (
                x.dtype != y.dtype or x.tobytes() != y.tobytes())):
            raise AssertionError(f"{what}: {name} differs")
    if a.vocab != b.vocab or a.num_docs != b.num_docs:
        raise AssertionError(f"{what}: vocab or doc count differs")


def text_path(torch, session) -> None:
    """Phase 16: the default text path on the card, stemmed text in, top-k
    out, with no ``stemmer=None`` anywhere: the port's native tokenizer,
    Snowball stemmer and counting-sort CSC build (host C++) in front of
    B1 and B3."""
    from bm25_tpu_torch import (ReferenceEngine, Retriever, SparseEngine,
                                StreamingIndexBuilder, Tokenizer,
                                build_index, create_engine)
    from bm25_tpu_torch.bench import BenchConfig, make_queries
    from bm25_tpu_torch.datasets import synthetic_corpus
    from bm25_tpu_torch.native import _build as native_build
    from bm25_tpu_torch.native import loader
    from bm25_tpu_torch.ops import _build
    from bm25_tpu_torch.ops import gather_rows as gr
    from bm25_tpu_torch.scoring import build_scored_index_flat, tf_csc_numpy
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    reset(ops.launches, gr.launches)
    scratch = os.path.join(HERE, "_scratch")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_text_", dir=scratch)
    host = {}
    try:
        # the library's compile alone, into an empty build directory
        saved = os.environ.get(_build.BUILD_DIR_ENV)
        os.environ[_build.BUILD_DIR_ENV] = os.path.join(work, "build")
        try:
            with _build.collect_phases() as ph:
                fresh = native_build.build()
        finally:
            if saved is None:
                del os.environ[_build.BUILD_DIR_ENV]
            else:
                os.environ[_build.BUILD_DIR_ENV] = saved
        host["compile_s"] = ph["native_build_s"]
        log(f"[text] native library compiled from bm25_tpu_torch/native/src "
            f"into an empty build dir in {host['compile_s']:.2f} s "
            f"({os.path.basename(fresh)}, {native_build.find_cxx()}); "
            f"loaded: {os.path.relpath(loader.get().path, HERE)}")

        # (a) the headline's corpus as text
        cfg = BenchConfig()
        t0 = time.perf_counter()
        texts = synthetic_corpus(SPARSE_DOCS, vocab=cfg.vocab,
                                 avg_len=cfg.avg_len, seed=0)
        log(f"[text] (a) {len(texts)} docs of Zipf words made in "
            f"{time.perf_counter() - t0:.1f} s")
        tok = Tokenizer()
        t0 = time.perf_counter()
        tc = tok.tokenize_corpus(texts)
        host["a_tok_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = tok.tokenize_corpus(texts[:PY_SAMPLE_DOCS], vocab={})
        host["a_py_s"] = time.perf_counter() - t0
        nat = tok.tokenize_corpus(texts[:PY_SAMPLE_DOCS])
        if py.vocab != nat.vocab or not all(
                np.array_equal(x, y) for x, y in zip(py.ids, nat.ids)):
            raise AssertionError("(a) native tokens differ from the Python "
                                 "path's")
        flat = np.concatenate(tc.ids)
        lengths = tc.doc_lengths
        csc = {}
        for name, fn in (("numpy", tf_csc_numpy),
                         ("native", loader.get().build_tf_csc)):
            t0 = time.perf_counter()
            csc[name] = fn(flat, lengths, len(tc.vocab))
            host[f"a_csc_{name}_s"] = time.perf_counter() - t0
        for part, x, y in zip(("indptr", "doc ids", "tf"), csc["native"],
                              csc["numpy"]):
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                raise AssertionError(f"(a) native CSC: {part} differs from "
                                     "the numpy oracle's")
        t0 = time.perf_counter()
        index = build_scored_index_flat(flat, lengths,
                                        vocab_size=len(tc.vocab),
                                        vocab=tc.vocab)
        host["a_index_s"] = time.perf_counter() - t0
        log(f"[text] (a) Tokenizer().tokenize_corpus: {len(flat)} tokens, "
            f"vocab {len(tc.vocab)}, {host['a_tok_s']:.2f} s "
            f"({len(texts) / host['a_tok_s']:.0f} docs/s, native); the "
            f"Python path (native stemmer) on the first {PY_SAMPLE_DOCS} "
            f"docs {host['a_py_s']:.2f} s "
            f"({PY_SAMPLE_DOCS / host['a_py_s']:.0f} docs/s), its tokens "
            f"equal")
        log(f"[text] (a) the CSC of {index.nnz} postings: native counting "
            f"sort {host['a_csc_native_s']:.2f} s, numpy oracle "
            f"{host['a_csc_numpy_s']:.2f} s, byte-equal; "
            f"build_scored_index_flat (native CSC, scoring included) "
            f"{host['a_index_s']:.2f} s")
        del csc, py, nat
        t0 = time.perf_counter()
        engine = create_engine(index, session=session)
        torch.cuda.synchronize()
        if not isinstance(engine, SparseEngine):
            raise AssertionError(f"(a) auto built {type(engine).__name__}")
        widths = [b["tokT"].shape[0] for b in engine.buckets if "tokT" in b]
        log(f"[text] (a) create_engine: SparseEngine in "
            f"{time.perf_counter() - t0:.1f} s at the model's layout: "
            f"hot_h={engine.hot_h}, buckets of widths {widths}")
        words = np.array([f"w{i:06d}" for i in range(cfg.vocab)])
        qtexts = [" ".join(words[row])
                  for row in make_queries(cfg)[: cfg.batch]]
        q = tok.tokenize_queries(qtexts, index.vocab)
        if q.shape != (cfg.batch, cfg.query_len):
            raise AssertionError(f"(a) query matrix {q.shape}")
        ref = ReferenceEngine.from_scored_index(index)
        sub = slice(0, TEXT_CHECKED)
        for k in (cfg.top_k, cfg.top_k2):
            t0 = time.perf_counter()
            docs, scores = engine.search(q, top_k=k)
            ms_ = (time.perf_counter() - t0) * 1e3
            if docs.shape != (cfg.batch, k) or not np.isfinite(scores).all():
                raise AssertionError(f"(a) k={k}: bad result {docs.shape}")
            assert_matches_oracle(docs[sub], scores[sub],
                                  *ref.search(q[sub], top_k=k))
            log(f"[text] (a) {cfg.batch} text queries of {cfg.query_len} "
                f"words at k={k}: {ms_:.1f} ms (first call), first "
                f"{TEXT_CHECKED} match ReferenceEngine")
        del engine, ref, index, tc, texts, flat
        torch.cuda.empty_cache()

        # (b) English sentences, one doc in 100 non-ASCII
        docs_b, lines = fixture_corpus(FIXTURE_DOCS, seed=0)
        t0 = time.perf_counter()
        tb = tok.tokenize_corpus(docs_b)
        host["b_tok_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        py_b = tok.tokenize_corpus(docs_b[:PY_SAMPLE_DOCS], vocab={})
        host["b_py_s"] = time.perf_counter() - t0
        py_rest = tok.tokenize_corpus(docs_b, vocab={})
        if py_rest.vocab != tb.vocab or not all(
                np.array_equal(x, y) for x, y in zip(py_rest.ids, tb.ids)):
            raise AssertionError("(b) hybrid native tokens differ from the "
                                 "Python path's")
        non_ascii = sum(not d.isascii() for d in docs_b)
        log(f"[text] (b) {FIXTURE_DOCS} docs of fixture sentences "
            f"({non_ascii} non-ASCII): Tokenizer().tokenize_corpus "
            f"{host['b_tok_s']:.2f} s ({FIXTURE_DOCS / host['b_tok_s']:.0f} "
            f"docs/s, native with the non-ASCII docs in Python), vocab "
            f"{len(tb.vocab)}; the Python path on the first "
            f"{PY_SAMPLE_DOCS} docs {host['b_py_s']:.2f} s "
            f"({PY_SAMPLE_DOCS / host['b_py_s']:.0f} docs/s); on all "
            f"{FIXTURE_DOCS} docs its vocab and ids equal the native ones")
        del py_b, py_rest
        for w in NON_ASCII_WORDS:
            if tok.words(w)[0] not in tb.vocab:
                raise AssertionError(f"(b) {w!r} missing from the vocab")
        t0 = time.perf_counter()
        index_b, stats = build_index(docs_b)
        build_b_s = time.perf_counter() - t0
        engine_b = create_engine(index_b, session=session)
        ref_b = ReferenceEngine.from_scored_index(index_b)
        qb = fixture_queries(lines, FIXTURE_QUERIES, seed=1)
        ids_b = tok.tokenize_queries(qb, index_b.vocab)
        for k in (10, 100):
            assert_matches_oracle(*engine_b.search(ids_b, top_k=k),
                                  *ref_b.search(ids_b, top_k=k))
        log(f"[text] (b) build_index: {stats.num_docs} docs, vocab "
            f"{stats.vocab_size}, {stats.nnz} postings in {build_b_s:.2f} s; "
            f"create_engine: {type(engine_b).__name__}; {len(qb)} text "
            f"queries at k=10 and k=100 match ReferenceEngine")
        del engine_b
        fitted = Retriever.fit(docs_b, session=session)
        got = fitted.retrieve(qb, k=10)
        assert_matches_oracle(*got, *ref_b.search(ids_b, top_k=10))
        log(f"[text] (b) Retriever.fit(texts, session=cuda): "
            f"{type(fitted.engine).__name__} on "
            f"{fitted.engine.session.device}, {len(qb)} text queries match "
            f"ReferenceEngine")
        del fitted
        t0 = time.perf_counter()
        sb = StreamingIndexBuilder()
        step = -(-FIXTURE_DOCS // 4)
        for i in range(0, FIXTURE_DOCS, step):
            sb.add(docs_b[i: i + step])
        streamed = sb.finalize()[0]
        same_index(streamed, index_b, "(b) StreamingIndexBuilder")
        log(f"[text] (b) StreamingIndexBuilder() in 4 chunks: bit-equal to "
            f"build_index ({time.perf_counter() - t0:.2f} s)")
        del streamed, sb, ref_b, index_b
        torch.cuda.empty_cache()

        # the CLI's index, query and eval on tests/data/mini_beir
        data = os.path.join(HERE, "tests", "data", "mini_beir")
        idx = os.path.join(work, "mini_idx")
        cli(["index", os.path.join(data, "corpus.jsonl"), "-o", idx])
        args = ["query", idx, "Solar panels^2 and inverters",
                "rooftop irradiance watts", "photovoltaic grids", "-k", "10"]
        for engine_mode in ("dense", "sparse"):
            a = [*args, "--engine", engine_mode]
            same_ranking(query_results(cli(["--device", "cuda", *a])),
                         query_results(cli(["--device", "cpu", *a])),
                         f"(cli) query --engine {engine_mode}")
        ev = json.loads(cli(["--device", "cuda", "eval", data]))
        ev_cpu = json.loads(cli(["--device", "cpu", "eval", data]))
        if ev != ev_cpu:
            raise AssertionError(f"eval {ev} != --device cpu {ev_cpu}")
        log(f"[text] CLI index / query (dense, sparse) / eval on mini_beir "
            f"with the default tokenizer equal to --device cpu: "
            f"{json.dumps(ev)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {**ops.launches, **gr.launches}
    log(f"[text] kernel launches over this phase {launches}")
    if not (launches["ell_score_fused"] and launches["gather_add_rows"]):
        raise AssertionError("the text path did not run B1 and B3")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("[text] host seconds on the card's machine (" + smi + "): "
        + json.dumps({k: round(v, 3) for k, v in host.items()}))


def drive(torch, dev) -> dict:
    """Phases 2-16 on device ``dev``; returns the kernels' record."""
    from concurrent.futures import ThreadPoolExecutor

    from bm25_tpu_torch import Session
    from bm25_tpu_torch.bench import BenchConfig
    from bm25_tpu_torch.native import _build as native_build
    from bm25_tpu_torch.ops import _build
    from bm25_tpu_torch.ops import gather_rows as gr
    from bm25_tpu_torch.ops import topk as tk
    from bm25_tpu_torch.utils.counts import split_bf16

    # bm25_tpu_torch.ops re-exports a function of each module's name
    ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
    pm = importlib.import_module("bm25_tpu_torch.ops.matmul")

    with Phase("2. build"):
        t0 = time.perf_counter()
        with _build.collect_phases() as ph, ThreadPoolExecutor(1) as pool:
            text_lib = pool.submit(native_build.build)
            libs = _build.build_all(["ell_score", "gather_rows", "topk",
                                     "matmul", "super_row_gather",
                                     "matmul_schedules"])
            text_lib = text_lib.result()
        log(f"[build] {len(libs)} libraries in "
            f"{time.perf_counter() - t0:.1f} s (parallel nvcc), and the "
            f"native text library {os.path.relpath(text_lib, HERE)} beside "
            f"them ({ph['native_build_s']:.1f} s of C++ compile)")
        for name, path in libs.items():
            log(f"[build] {os.path.relpath(path, HERE)}")
            with open(path[:-3] + ".log") as f:
                for line in f.read().splitlines():
                    if ("registers" in line or "spill" in line
                            or "serialized" in line):
                        log(f"[build] {name}: {line.strip()}")

    with Phase("3. kernel edge cases"):
        phase_kernel_cases(torch, ops, split_bf16, dev)
        phase_table_cases(torch, ops, dev)
        phase_gather_cases(torch, gr, dev)
        phase_topk_cases(torch, tk, dev)
        phase_gumbel_cases(torch, tk, dev)

    session = Session(dev)
    record = {}
    with Phase("4. sparse main path"):
        index, timings = sparse_main(torch, dev, BenchConfig(), ops,
                                     session, record)
        torch.cuda.empty_cache()
    with Phase("4b. layout model and tail tier"):
        ratios = layout_and_tail(torch, session, index, BenchConfig())
    with Phase("4c. union selection"):
        union_selection(torch, session, index, BenchConfig())
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
        b6_device_split(torch, pm, dev, record)
    torch.cuda.empty_cache()
    with Phase("9. selection gather (E5-E7)"):
        selection_gather(torch, dev, record)
    torch.cuda.empty_cache()
    with Phase("10. matmul schedules (E1-E4)"):
        matmul_schedules(torch, pm, dev, record)
    torch.cuda.empty_cache()
    with Phase("11. entry points: CLI, compat, BM25v at full width"):
        entry_points(torch, session, index)
    torch.cuda.empty_cache()
    with Phase("12. query benchmark harness"):
        result = harness(torch, session, index, timings)
    torch.cuda.empty_cache()
    scratch = os.path.join(HERE, "_scratch")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_serve_", dir=scratch)
    try:
        with Phase("13. serving"):
            p50 = {r["top_k"]: r["p50_batch_ms"]
                   for r in result["extra"]["secondary"]}
            start_s = serving(torch, session, index, ratios,
                              p50.get(BenchConfig().top_k2), work)
        torch.cuda.empty_cache()
        with Phase("14. warm restart"):
            warm_restart(torch, session, index, BenchConfig(), work,
                         start_s, result)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    with Phase("15. sharded engines"):
        sharded(torch, session, index, BenchConfig())
    del index
    torch.cuda.empty_cache()
    with Phase("16. the default text path"):
        text_path(torch, session)

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
