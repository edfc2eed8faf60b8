"""Sparse engine (hot + ELL + tail tiers) — PyTorch counterpart of
``bm25_tpu/models/sparse.py``.

Tokens are split by document frequency into three tiers:

* **hot** (the top-H tokens by DF): a dense (H, rows) bf16 high + bf16
  residual pair per bucket, built on the device by kernel B2 from the hot
  postings, and scored by kernel B1's epilogue against per-query hot-token
  counts;
* **mid** (the ELL): doc-major padded postings in length buckets, stored
  slot-major and scored by B1's membership-count scan;
* **tail** (tokens of DF at most ``tail_cap``, only where ``tail_cap`` >
  0): token-major postings packed into shared rows; the step gathers a
  query's tail postings, sums them per doc and merges those exact
  candidates with the buckets' own.

Per bucket, B1 writes the masked (Q, rows) base and its group maxima; the
tournament tree selects the bucket's top k from them; one two-key merge
(score descending, doc ascending) across buckets gives the result, and the
per-token offsets are added last.  Ties go to the smaller doc id: bucket
rows are in doc-id order and every merge is stable.

The host layout (``build_ell_buckets_from_csr``, ``split_hot_cold_csr``,
``hot_ell_for_rows``, ``_filter_csr``, ``build_token_tail``) is copied
function for function from the JAX package, which cannot be imported
without JAX, so that both engines build bit-equal arrays.  The layout
cost model (``choose_layout``, ``choose_hot_tokens``, ``hot_tokens="auto"``,
``overhead_target``) keeps JAX's search over hot-tier widths and bucket
counts; its cost terms (``H100Costs``) were fitted on the card.  This
engine serves queries, weighted or not and of any width, with f32 or
bf16-rounded returned scores (``score_dtype``), a doc mask folded into
B1's pad-row mask, long-query dedup (``maybe_dedup``), rankings-only
search (``search_ids``), a pipelined large-batch search
(``search_pipelined``), JAX's cold-width routing with its DP chunk
planner (``route_cold``, ``plan_query_dispatch``; the DP's costs fitted
on the card) and JAX's union selection (``union_select``).
``prepare_doc_mask`` (the JAX module's mask upload) lives here beside the
other copied helpers; ``DenseEngine`` uses it too.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from bm25_tpu_torch.scoring import ScoredIndex
from bm25_tpu_torch.utils.padding import (cdiv, next_multiple,
                                          next_pow2_at_least)
from bm25_tpu_torch.utils.validate import empty_results, validate_query_batch
from bm25_tpu_torch.ops.ell_score import (BLOCK_ROWS, GROUP, NEG_INF,
                                          ell_score, ell_score_fused,
                                          hot_plan, max_hot_tokens,
                                          scan_table, table_geometry)
from bm25_tpu_torch.ops.topk import (DOC_SENTINEL, gather_group_candidates,
                                     select_top_k, top_k_tree_with_maxes,
                                     union_group_select)
from bm25_tpu_torch.runtime.profiling import count, enabled, span
from bm25_tpu_torch.runtime.session import Session, get_session
from bm25_tpu_torch.utils.counts import split_bf16, weighted_counts

logger = logging.getLogger(__name__)

PAD_TOK = -1  # never matches a query id (valid ids are >= 0)

# fraction of device memory usable by the resident index plus transient
# score tiles (the rest covers the allocator's and libraries' own needs)
_USABLE_HBM_FRACTION = 14 / 16
# bucket arrays a state dict may carry (see SparseEngine.from_arrays)
_BUCKET_KEYS = ("doc_ids", "tokT", "valT", "hotT", "hotLo")
# the tail tier's arrays, named as the engine's fields
_TAIL_KEYS = ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
              "tail_gpos")
# most queries per dispatched chunk
CHUNK_QUERIES = 512
# the transient-buffer cap of a chunk's (Q, rows) score tiles, before
# fit_score_buffer_budget fits it to the memory the index leaves
SCORE_BUFFER_BUDGET = 4 << 30
# the JAX model's ceiling on the hot-tier width it considers
_AUTO_MAX_HOT = 8192


# ---------------------------------------------------------------------------
# host-side layout (numpy; copied from bm25_tpu/models/sparse.py)
# ---------------------------------------------------------------------------


@dataclass
class EllBucket:
    tok: np.ndarray  # (rows_pad, L) int32, PAD_TOK padded
    val: np.ndarray  # (rows_pad, L) float32
    doc_ids: np.ndarray  # (rows_pad,) int32 original doc id; -1 for pad rows
    num_real: int


def build_ell_buckets_from_csr(
    csr,
    num_docs: int,
    max_buckets: int = 4,
    row_align: int = 8,
    width_align: int = 8,
) -> list[EllBucket]:
    """ELL bucketing core over a (num_docs, V) CSR of scored postings.

    Bucket membership is by row nnz (bounds the padding waste); *within* a
    bucket rows are ordered by doc id, so position order == doc-id order
    and stable top-k selection preserves the smaller-doc-id tie contract.
    """
    csr.sort_indices()
    row_nnz = np.diff(csr.indptr)
    order = np.argsort(row_nnz, kind="stable")

    d = num_docs
    if d == 0:
        return []
    # every bucket pads its rows to row_align; don't create more buckets
    # than the corpus has aligned row blocks
    max_buckets = max(1, min(max_buckets, d // max(row_align, 1) or 1))
    bounds = sorted(
        {int(q * d) for q in np.linspace(0, 1, max_buckets + 1)[1:]} | {d}
    )
    buckets: list[EllBucket] = []
    start = 0
    for end in bounds:
        if end <= start:
            continue
        rows = np.sort(order[start:end])  # doc-id order within the bucket
        width = int(row_nnz[rows].max(initial=0))
        width = next_multiple(max(width, 1), width_align)
        n = len(rows)
        n_pad = next_multiple(n, row_align)
        tok = np.full((n_pad, width), PAD_TOK, dtype=np.int32)
        val = np.zeros((n_pad, width), dtype=np.float32)
        doc_ids = np.full((n_pad,), -1, dtype=np.int32)
        # vectorized fill: flat nnz of the selected rows -> (row, slot) coords
        nnz_sel = row_nnz[rows]
        starts = csr.indptr[rows]
        flat_rows = np.repeat(np.arange(n, dtype=np.int64), nnz_sel)
        slot = np.arange(len(flat_rows), dtype=np.int64) - np.repeat(
            np.cumsum(nnz_sel) - nnz_sel, nnz_sel
        )
        src = np.repeat(starts, nnz_sel) + slot
        tok[flat_rows, slot] = csr.indices[src]
        val[flat_rows, slot] = csr.data[src]
        doc_ids[:n] = rows
        buckets.append(EllBucket(tok=tok, val=val, doc_ids=doc_ids, num_real=n))
        start = end
    return buckets


def split_hot_cold_csr(
    index: ScoredIndex, hot_tokens: int
) -> tuple[np.ndarray, "object", "object"]:
    """Split the index by document frequency, both halves sparse.

    Returns ``(hot_ids, cold_csr, hot_csr)``: the token ids of the top
    ``hot_tokens`` by DF, and CSR matrices of the cold / hot postings
    (token ids unchanged in both).  The hot half stays sparse so the dense
    (H, rows) device matrices are built on the device from ~nnz_hot*8
    bytes of upload.
    """
    df = index.df()
    h = min(hot_tokens, index.vocab_size)
    hot_ids = np.sort(np.argsort(-df, kind="stable")[:h]).astype(np.int32)
    hot_rank = np.full(index.vocab_size, -1, dtype=np.int32)
    hot_rank[hot_ids] = np.arange(h, dtype=np.int32)

    csr = index.to_csc().tocsr()
    csr.sort_indices()
    is_hot = hot_rank[csr.indices] >= 0
    cold_csr = _filter_csr(csr, ~is_hot, index.num_docs)
    hot_csr = _filter_csr(csr, is_hot, index.num_docs)
    return hot_ids, cold_csr, hot_csr


def hot_ell_for_rows(
    hot_csr, doc_ids: np.ndarray, width_align: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Slot-major (L_hot, rows) hot-postings ELL for one bucket's row order.

    ``doc_ids`` is the bucket's row -> doc mapping (-1 pad rows get all-pad
    slots).  The pair feeds the membership-scan kernel with the H hot token
    ids as single-token "queries", which rebuilds the dense (H, rows) hot
    matrix on the device (each (doc, token) posting matches exactly one
    slot, so the scan's sum is the exact f32 value).
    """
    rows = len(doc_ids)
    real = np.flatnonzero(doc_ids >= 0)
    sel = doc_ids[real].astype(np.int64)
    nnz_sel = np.diff(hot_csr.indptr)[sel]
    width = next_multiple(max(int(nnz_sel.max(initial=0)), 1), width_align)
    tokT = np.full((width, rows), PAD_TOK, dtype=np.int32)
    valT = np.zeros((width, rows), dtype=np.float32)
    starts = hot_csr.indptr[sel].astype(np.int64)
    flat_rows = np.repeat(real, nnz_sel)
    slot = np.arange(len(flat_rows), dtype=np.int64) - np.repeat(
        np.cumsum(nnz_sel) - nnz_sel, nnz_sel
    )
    src = np.repeat(starts, nnz_sel) + slot
    tokT[slot, flat_rows] = hot_csr.indices[src]
    valT[slot, flat_rows] = hot_csr.data[src]
    return tokT, valT


def _filter_csr(csr, keep: np.ndarray, num_docs: int):
    """CSR with only the entries where ``keep`` (flat nnz mask) is True."""
    import scipy.sparse as sp

    row_of = np.repeat(np.arange(num_docs, dtype=np.int64), np.diff(csr.indptr))
    counts = np.bincount(row_of[keep], minlength=num_docs)
    indptr = np.zeros(num_docs + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return sp.csr_matrix(
        (csr.data[keep], csr.indices[keep], indptr), shape=csr.shape
    )


def build_token_tail(
    index: ScoredIndex,
    exclude_ids: np.ndarray,
    tail_cap: int,
    width: int = 512,
) -> tuple[dict | None, np.ndarray]:
    """Token-major tail layout for low-DF tokens (candidate generation).

    Returns ``(tail_arrays, is_tail_mask)``.  Postings of tail tokens are
    concatenated token-major and packed into shared ``width``-wide rows:

    * ``docs/vals/toks (R+1, width)``: doc id, contribution, owning token
      per slot (the last row is all-pad, the gather target for absent row
      ids): no per-token padding, 12 bytes a slot.
    * ``rows (V+1, C)``: for tail token v, the (contiguous) row ids its
      postings touch, -1 padded; all -1 for non-tail tokens.

    Only tokens whose contributions are all non-negative are eligible: the
    merge keeps a doc's first entry in (doc, score desc) order as its
    total, which needs tail >= 0 (negative values arise only from
    robertson/atire IDF at DF > N/2).
    """
    df = index.df()
    v = index.vocab_size
    is_tail = df <= tail_cap
    is_tail[exclude_ids] = False
    if np.any(is_tail):
        # exclude tokens with any negative contribution
        col_min = np.full(v, np.inf, dtype=np.float64)
        nz = np.flatnonzero(np.diff(index.indptr))
        if len(nz):
            mins = np.minimum.reduceat(index.data, index.indptr[nz])
            col_min[nz] = mins
        is_tail &= ~(col_min < 0)
    sel = np.flatnonzero(is_tail).astype(np.int64)
    seg = df[sel].astype(np.int64)
    total = int(seg.sum())
    if total == 0:
        return None, np.zeros(v, dtype=bool)

    starts = index.indptr[sel].astype(np.int64)
    off = np.cumsum(seg) - seg
    flat_src = np.repeat(starts - off, seg) + np.arange(total, dtype=np.int64)
    r = cdiv(total, width)
    pad = (r + 1) * width  # + one all-pad row
    docs = np.full(pad, -1, dtype=np.int32)
    vals = np.zeros(pad, dtype=np.float32)
    toks = np.full(pad, -1, dtype=np.int32)
    docs[:total] = index.indices[flat_src]
    vals[:total] = index.data[flat_src]
    toks[:total] = np.repeat(sel.astype(np.int32), seg)

    first_row = off // width
    last_row = np.where(seg > 0, (off + seg - 1) // width, first_row - 1)
    n_rows = (last_row - first_row + 1).astype(np.int64)  # 0 for DF=0 tokens
    c = max(int(n_rows.max(initial=0)), 1)
    rows = np.full((v + 1, c), -1, dtype=np.int32)
    span = first_row[:, None] + np.arange(c, dtype=np.int64)[None, :]
    rows[sel] = np.where(
        np.arange(c)[None, :] < n_rows[:, None], span, -1
    ).astype(np.int32)
    return (
        {
            "docs": docs.reshape(r + 1, width),
            "vals": vals.reshape(r + 1, width),
            "toks": toks.reshape(r + 1, width),
            "rows": rows,
        },
        is_tail,
    )


def _ell_slot_estimate(
    cold_nnz: np.ndarray, max_buckets: int, row_align: int,
    width_align: int = 8,
) -> int:
    """Padded ELL slot count ``build_ell_buckets_from_csr`` would produce."""
    d = len(cold_nnz)
    if d == 0:
        return 0
    s = np.sort(cold_nnz)
    mb = max(1, min(max_buckets, d // max(row_align, 1) or 1))
    bounds = sorted({int(q * d) for q in np.linspace(0, 1, mb + 1)[1:]} | {d})
    slots, start = 0, 0
    for end in bounds:
        if end <= start:
            continue
        width = next_multiple(max(int(s[end - 1]), 1), width_align)
        slots += next_multiple(end - start, row_align) * width
        start = end
    return slots


# ---------------------------------------------------------------------------
# device layout and memory
# ---------------------------------------------------------------------------


def build_hot_pair_device(
    ids: torch.Tensor, tokT: torch.Tensor, valT: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (H, rows) bf16 high+residual hot pair, computed on the device.

    ``ids`` is the (H, 1) int32 tensor of hot token ids and ``tokT``/
    ``valT`` a bucket's hot-postings ELL; kernel B2 runs the hot ids as
    one-token queries, then ``split_bf16`` makes the pair.
    """
    return split_bf16(ell_score(ids, tokT, valT))


def hot_pair_to_sparse(hi: torch.Tensor, lo: torch.Tensor) -> dict:
    """Sparse (rank, pos, hi, lo) form of a bucket's dense hot pair.

    12 bytes per stored posting instead of 4 bytes per (H x rows) cell.
    Used by the device checkpoints so that a restore ships postings, not
    zeros.  BM25 contributions are never exactly 0, so the nonzero mask
    loses nothing.  The JAX function's numpy, in torch ops on the pair's
    own device (numpy has no bfloat16): only the postings leave the card,
    in ``np.nonzero``'s row-major order.
    """
    nz = (hi != 0) | (lo != 0)
    rank, pos = torch.nonzero(nz, as_tuple=True)
    return {
        "hotNzRank": rank.to(torch.int32),
        "hotNzPos": pos.to(torch.int32),
        "hotNzHi": hi[nz],
        "hotNzLo": lo[nz],
    }


def _sparse_hot_ell(rows: int, rank: torch.Tensor, pos: torch.Tensor,
                    vals: torch.Tensor, width_align: int = 8):
    """(L, rows) slot-major ELL of sparse hot entries, ranks as token ids
    (JAX's numpy, in torch ops on the entries' device)."""
    order = torch.argsort(pos, stable=True)
    pos_s = pos[order].long()
    rank_s = rank[order].to(torch.int32)
    vals_s = vals[order].float()
    counts = torch.bincount(pos_s, minlength=rows)
    most = int(counts.max()) if pos_s.numel() else 0
    width = next_multiple(max(most, 1), width_align)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(pos_s), device=pos_s.device) - \
        torch.repeat_interleave(starts, counts)
    tokT = torch.full((width, rows), PAD_TOK, dtype=torch.int32,
                      device=pos_s.device)
    valT = torch.zeros((width, rows), dtype=torch.float32,
                       device=pos_s.device)
    tokT[slot, pos_s] = rank_s
    valT[slot, pos_s] = vals_s
    return tokT, valT


def rebuild_hot_pair_from_sparse(
    h: int, rows: int, sparse: dict, put,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (H, rows) bf16 pair from its checkpointed sparse form.

    Runs B2 twice, once over the hi values and once over the lo values,
    so the restored pair is bit-identical to what was saved: each (rank,
    row) cell holds one posting, so B2's sum is that value exactly
    (summing hi + lo and re-splitting could flip a round-to-even tie in
    the last bf16 bit).  ``put`` places tensors and host arrays on the
    target device (``session.put``).  On CUDA tensors B2 launches its
    kernel or raises; on CPU tensors its plain twin runs.
    """
    ids = put(np.arange(h, dtype=np.int32).reshape(-1, 1))
    rank, pos = put(sparse["hotNzRank"]), put(sparse["hotNzPos"])
    out = []
    for key in ("hotNzHi", "hotNzLo"):
        tokT, valT = _sparse_hot_ell(rows, rank, pos, put(sparse[key]))
        out.append(ell_score(ids, tokT, valT).to(torch.bfloat16))
    return out[0], out[1]


def device_hbm_bytes(device: torch.device | str) -> int:
    """Memory capacity of the session's device in bytes: the card's total
    (``torch.cuda.mem_get_info``) on CUDA, physical RAM on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def fit_score_buffer_budget(engine: "SparseEngine") -> None:
    """Scale the transient-buffer budget to the memory left next to the
    index: chunks, their (Q, rows) score tiles and the top-k temporaries
    take about 4x the budget at once."""
    hbm = device_hbm_bytes(engine.session.device)
    usable = int(hbm * _USABLE_HBM_FRACTION)
    headroom = max(usable - engine.device_bytes(), 1 << 28)
    engine.score_buffer_budget = int(
        min(engine.score_buffer_budget, headroom // 4)
    )


# ---------------------------------------------------------------------------
# the layout cost model
# ---------------------------------------------------------------------------


def _interp_grid(points, n: float) -> float:
    """Piecewise-linear in rows through measured (rows, cost) points,
    extended past either end with the end segment's slope (floored at
    half the first point's cost below it)."""
    (n0, c0), (n1, c1) = points[0], points[-1]
    if n <= n0:
        slope = (points[1][1] - c0) / (points[1][0] - n0)
        return max(c0 + slope * (n - n0), c0 / 2)
    for (na, ca), (nb, cb) in zip(points[:-1], points[1:]):
        if n <= nb:
            return ca + (cb - ca) * (n - na) / (nb - na)
    slope = (c1 - points[-2][1]) / (n1 - points[-2][0])
    return c1 + slope * (n - n1)


class H100Costs:
    """The layout model's cost terms on the card: what a padded ELL slot,
    a hot-tier row and a bucket's selection cost one query batch.

    Fitted on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
    ``bench/layout_sweep.py``: B1's terms by least squares over its
    ``--sweep`` of 70 layouts (h in {0, 64, ..., 2048} x 2-8 buckets, on
    the query benchmark's 524,288-doc corpus and its 65,536-doc
    long-document corpus, 512 x 8 queries at k = 1000 and 100; B1's
    launches timed by ``torch.profiler``), the selection grid from its
    ``--sel-grid``.  The model sees no queries, so the hot term prices
    every hot token of the tier as used.

    ``choose_layout`` and ``_hot_cost_sweep`` read the module's
    ``LAYOUT_COSTS``; a test swaps in other terms there."""

    # B1's scan: a padded slot costs one lookup a table, and a table holds
    # up to 128 queries (ops/ell_score.py::table_geometry), so a slot is
    # priced per table of the batch; and the write of the (Q, rows) base,
    # a padded row per 128-query block
    SCAN_S_PER_SLOT_TABLE = 9.473e-12
    SCAN_S_PER_ROW_BLOCK = 1.204e-10
    # B1's hot kernel (h > 0): a padded row per 128-query block (the
    # base's read and rewrite, the pass over the doc tiles), and a hot
    # token x padded row x 128-query block (its products)
    HOT_S_PER_ROW_BLOCK = 1.292e-9
    HOT_S_PER_TOKEN_ROW_BLOCK = 5.861e-13
    # a bucket's selection: the tree over its base and kernel maxima,
    # microseconds a query by rows and k, on random (512, rows) bases
    SEL_GRID = {
        100: [(8192, 0.471), (16384, 0.434), (32768, 0.746),
              (65536, 1.266), (131072, 0.811), (262144, 1.201),
              (524288, 1.28), (1048576, 1.692), (2228224, 3.045)],
        1000: [(8192, 1.236), (16384, 1.282), (32768, 1.349),
               (65536, 2.288), (131072, 2.362), (262144, 2.548),
               (524288, 3.752), (1048576, 4.284), (2228224, 5.821)],
    }

    def scan_hot_seconds(self, slots: int, h: int, rows_pad: int, q: int,
                         t: int) -> float:
        """Modelled seconds of B1 on a layout of ``slots`` padded ELL
        slots, ``h`` hot tokens and ``rows_pad`` padded rows (all
        buckets), for one batch of ``q`` queries of ``t`` ids."""
        tables = cdiv(q, table_geometry(q, t)[0])
        blocks = cdiv(q, 128)
        cost = (slots * tables * self.SCAN_S_PER_SLOT_TABLE
                + rows_pad * blocks * self.SCAN_S_PER_ROW_BLOCK)
        if h > 0:
            cost += rows_pad * blocks * (self.HOT_S_PER_ROW_BLOCK
                                         + h * self.HOT_S_PER_TOKEN_ROW_BLOCK)
        return cost

    def selection_us_per_query(self, k: int, n_rows: int) -> float:
        """One bucket's selection a query, interpolated in rows and
        log-linear in k between the measured k = 100 and 1000."""
        lo = _interp_grid(self.SEL_GRID[100], n_rows)
        hi = _interp_grid(self.SEL_GRID[1000], n_rows)
        kc = min(max(k, 100), 1000)
        frac = (np.log(kc) - np.log(100)) / (np.log(1000) - np.log(100))
        return float(lo + (hi - lo) * frac)

    def h_cap(self, max_doc_nnz: int) -> int:
        """The widest hot tier B1 takes: its hot kernel's shared-memory
        list of used tokens (the doc widths do not bound it)."""
        return max_hot_tokens()

    def resident_cap(self, device, num_docs: int) -> int:
        """The resident bytes the auto policy may fill: the usable share
        of the device less the transient room ``fit_score_buffer_budget``
        keeps, 4x the budget a full chunk of (Q, rows) f32 scores takes."""
        usable = int(device_hbm_bytes(device) * _USABLE_HBM_FRACTION)
        chunk = min(SCORE_BUFFER_BUDGET,
                    CHUNK_QUERIES * 4 * next_multiple(max(num_docs, 1),
                                                      BLOCK_ROWS))
        return usable - 4 * chunk


LAYOUT_COSTS = H100Costs()


def _auto_resident_cap(device=None, num_docs: int = 0) -> int:
    if device is None:
        device = get_session().device
    return LAYOUT_COSTS.resident_cap(device, num_docs)


def layout_candidates(
    index: ScoredIndex,
    k: int,
    q: int = 512,
    t: int = 8,
    budget_bytes: int | None = None,
    tail_cap: int = 0,
    bucket_candidates: tuple = (2, 3, 4, 6, 8),
    log=None,
    device=None,
    overhead_target: float | None = None,
) -> list[dict]:
    """Each bucket count's best layout under the model: ``{"max_buckets",
    "hot_tokens", "scan_hot_ms", "selection_ms", "total_ms"}`` a
    candidate, in ``bucket_candidates`` order; ``choose_layout`` takes the
    cheapest (the first of equals)."""
    d = index.num_docs
    sweep = _hot_cost_sweep(
        index, tuple(bucket_candidates), q=q, t=t,
        budget_bytes=budget_bytes, tail_cap=tail_cap, device=device,
        overhead_target=overhead_target,
    )
    out = []
    for mb in bucket_candidates:
        h, cost = sweep[mb]
        rows_b = next_multiple(max(d // max(mb, 1), 1), BLOCK_ROWS)
        sel = mb * LAYOUT_COSTS.selection_us_per_query(k, rows_b) * q * 1e-6
        total = cost + sel
        if log is not None:
            log(f"[layout] B={mb} h={h} scan+hot={cost*1e3:.1f}ms "
                f"sel={sel*1e3:.1f}ms total={total*1e3:.1f}ms")
        out.append({"max_buckets": mb, "hot_tokens": h,
                    "scan_hot_ms": cost * 1e3, "selection_ms": sel * 1e3,
                    "total_ms": total * 1e3})
    return out


def best_layout(candidates: list[dict]) -> dict:
    """The cheapest of ``layout_candidates``'s list, as ``choose_layout``
    returns it."""
    best = None
    for c in candidates:
        if best is None or c["total_ms"] < best["total_ms"]:
            best = c
    return {"max_buckets": best["max_buckets"],
            "hot_tokens": best["hot_tokens"]}


def choose_layout(
    index: ScoredIndex,
    k: int,
    q: int = 512,
    t: int = 8,
    budget_bytes: int | None = None,
    tail_cap: int = 0,
    bucket_candidates: tuple = (2, 3, 4, 6, 8),
    log=None,
    device=None,
    overhead_target: float | None = None,
) -> dict:
    """Jointly pick (max_buckets, hot_tokens) from the cost model.

    Extends :func:`choose_hot_tokens`'s scan + hot model with each
    bucket's selection: more buckets tighten ELL padding (fewer slots to
    scan) but pay one top-k tree each, and the trade moves with k."""
    return best_layout(layout_candidates(
        index, k, q=q, t=t, budget_bytes=budget_bytes, tail_cap=tail_cap,
        bucket_candidates=bucket_candidates, log=log, device=device,
        overhead_target=overhead_target))


def choose_hot_tokens(
    index: ScoredIndex,
    max_buckets: int = 4,
    q: int = 512,
    t: int = 8,
    budget_bytes: int | None = None,
    row_align: int | None = None,
    tail_cap: int = 0,
    log=None,
    device=None,
    overhead_target: float | None = None,
) -> int:
    """Cost-model hot-tier sizing: minimize modelled step time under
    memory.

    Each hot token trades its ELL slots (one lookup a slot and query
    table) for a dense (1, rows) bf16-pair row that B1's hot kernel reads
    for every 128-query block; the first hot token also sends the base
    through the hot kernel.  Under a Zipf DF distribution the slots of
    the rank-h token fall as ~1/h while its row costs the same, so the
    sweep evaluates h = 0 and powers of two with the exact padded-slot
    count the bucketing would produce."""
    h, _cost = _choose_hot_cost(
        index, max_buckets=max_buckets, q=q, t=t,
        budget_bytes=budget_bytes, row_align=row_align, tail_cap=tail_cap,
        log=log, device=device, overhead_target=overhead_target,
    )
    return h


def _choose_hot_cost(
    index: ScoredIndex,
    max_buckets: int = 4,
    q: int = 512,
    t: int = 8,
    budget_bytes: int | None = None,
    row_align: int | None = None,
    tail_cap: int = 0,
    log=None,
    device=None,
    overhead_target: float | None = None,
) -> tuple[int, float]:
    """(best_h, modelled scan+hot seconds per q-batch): choose_hot_tokens'
    core."""
    return _hot_cost_sweep(
        index, (max_buckets,), q=q, t=t, budget_bytes=budget_bytes,
        row_align=row_align, tail_cap=tail_cap, log=log, device=device,
        overhead_target=overhead_target,
    )[max_buckets]


def _hot_cost_sweep(
    index: ScoredIndex,
    bucket_candidates: tuple,
    q: int = 512,
    t: int = 8,
    budget_bytes: int | None = None,
    row_align: int | None = None,
    tail_cap: int = 0,
    log=None,
    device=None,
    overhead_target: float | None = None,
) -> dict:
    """{max_buckets: (best_h, modelled scan+hot seconds)} in one pass.

    JAX's search, with the card's cost terms (``LAYOUT_COSTS``): the per-h
    postings bincounts are shared across every bucket candidate; a tail
    tier's postings leave the modelled ELL and cap h at the tokens above
    ``tail_cap``; ``overhead_target`` admits only the h whose modelled
    device bytes (ELL + hot + doc ids + tables) fit ``overhead_target x``
    the CSC bytes (h = 0, the ELL-only floor, is always admitted); the
    hot bytes must fit ``budget_bytes`` (default: the resident cap less
    the ELL's bytes, at least the CSC bytes), and an h over it is skipped
    alone (freed ELL slots can make a larger h fit).
    """
    costs = LAYOUT_COSTS
    if row_align is None:
        row_align = BLOCK_ROWS
    d, v = index.num_docs, index.vocab_size
    if d == 0 or index.nnz == 0:
        return {mb: (0, 0.0) for mb in bucket_candidates}
    df = index.df()
    order = np.argsort(-df, kind="stable")
    if tail_cap > 0:
        # hot and tail tiers are disjoint (hot = top-DF above the cap,
        # tail = DF <= cap): the build caps h the same way
        v_hot_max = int((df > tail_cap).sum())
        if v_hot_max == 0:
            return {mb: (0, 0.0) for mb in bucket_candidates}
    else:
        v_hot_max = v
    doc_nnz = np.bincount(
        index.indices, minlength=d
    ).astype(np.int64)
    if tail_cap > 0:
        # low-DF tokens leave the ELL before bucketing
        tail_tok = np.flatnonzero(df <= tail_cap).astype(np.int64)
        if len(tail_tok):
            lens = df[tail_tok].astype(np.int64)
            starts = index.indptr[tail_tok].astype(np.int64)
            off = np.cumsum(lens) - lens
            flat = np.repeat(starts - off, lens) + np.arange(
                int(lens.sum()), dtype=np.int64
            )
            doc_nnz = doc_nnz - np.bincount(index.indices[flat], minlength=d)

    csc_bytes = index.data.nbytes + index.indices.nbytes + index.indptr.nbytes
    h_cap = min(v, v_hot_max, _AUTO_MAX_HOT,
                costs.h_cap(int(doc_nnz.max(initial=1))))
    candidates = [0]
    h = 64
    while h < h_cap:
        candidates.append(h)
        h *= 2
    candidates.append(h_cap)
    candidates = sorted(set(candidates))

    best = {mb: (0, float("inf")) for mb in bucket_candidates}
    # queried once, against the device the engine will live on
    resident_cap = (None if budget_bytes is not None
                    else costs.resident_cap(
                        get_session().device if device is None else device,
                        d))
    hot_cnt = np.zeros(d, dtype=np.int64)
    prev = 0
    for h in candidates:
        new = order[prev:h]
        prev = h
        if tail_cap > 0 and len(new):
            # tail tokens' postings are already excluded from doc_nnz
            new = new[df[new] > tail_cap]
        if len(new):
            lens = df[new].astype(np.int64)
            starts = index.indptr[new].astype(np.int64)
            off = np.cumsum(lens) - lens
            flat = np.repeat(starts - off, lens) + np.arange(
                int(lens.sum()), dtype=np.int64
            )
            hot_cnt += np.bincount(index.indices[flat], minlength=d)
        cold_nnz = doc_nnz - hot_cnt
        hot_bytes = h * d * 4
        for mb in bucket_candidates:
            slots = _ell_slot_estimate(cold_nnz, mb, row_align)
            if overhead_target is not None and h > 0:
                # modelled device bytes: ELL (tok int32 + val f32 = 8/slot)
                # + hot bf16 pair (4 B/entry over padded rows) + doc ids
                # + the two (V+1) tables
                rows_pad = next_multiple(d, row_align) + mb * row_align
                est = (slots * 8 + h * rows_pad * 4 + rows_pad * 4
                       + 8 * (v + 1))
                if est > overhead_target * csc_bytes:
                    continue
            budget = budget_bytes if budget_bytes is not None else max(
                csc_bytes, resident_cap - slots * 8
            )
            if hot_bytes > budget:
                # skip this h only: the auto budget grows as hot tokens
                # free ELL slots, so infeasibility is not monotone in h
                continue
            rows_pad = next_multiple(d, row_align) + mb * row_align
            cost = costs.scan_hot_seconds(slots, h, rows_pad, q, t)
            if log is not None:
                log(f"[hot-auto] B={mb} h={h} slots={slots} "
                    f"modeled_step={cost*1e3:.1f}ms")
            if cost < best[mb][1]:
                best[mb] = (h, cost)
    return best


# ---------------------------------------------------------------------------
# device query step
# ---------------------------------------------------------------------------


def hot_counts_for(ids: torch.Tensor, hot_table: torch.Tensor, hot_h: int,
                   w: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(Q, H) per-query hot-token counts as B1 takes them: ``(counts,
    None)`` in bf16, exact for unweighted queries of at most 256 ids (a
    count <= 256 is a bf16 integer); otherwise the exact f32 scatter-add
    counts (each id weighted by ``w``) as a bf16 high + residual pair, as
    in JAX (``bm25_tpu/models/sparse.py:876-902``)."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    hot_ids = torch.where(valid, hot_table[safe], -1)
    cf = weighted_counts(hot_ids, valid.float() if w is None else w, hot_h)
    if w is None and ids.shape[1] <= 256:
        return cf.to(torch.bfloat16), None
    return split_bf16(cf)


def _shift_right(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``x`` moved ``n`` columns right, ``fill`` in the first ``n``."""
    out = torch.full_like(x, fill)
    out[:, n:] = x[:, :-n]
    return out


def tail_candidates(tail: dict, ids: torch.Tensor, w, mask):
    """The tail tier's exact candidates for a chunk of (Q, T) ids, as
    JAX's step makes them (``bm25_tpu/models/sparse.py:915-955``):
    ``(is_cand, cand_docs, cand_tail, gpos)``, each (Q, T*C*P).

    Each query token's tail rows are gathered; a slot counts only where
    the query token owns it (so a duplicated query token counts once a
    copy, and a weight scales the slots of its own token); the (doc,
    value) pairs are sorted by doc (stably: a doc's entries stay in query
    token order) and summed per doc by T-1 shifted adds, the last entry of
    a run holding its doc's total.  ``is_cand`` marks those last entries
    (and, under ``mask``, only eligible docs), ``cand_docs`` their doc (or
    DOC_SENTINEL), ``cand_tail`` the tail sums and ``gpos`` each
    candidate's position across the buckets' rows."""
    q, t = ids.shape
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    qtok = torch.where(valid, ids, -2)  # never matches a slot pad (-1)
    c = tail["rows"].shape[1]
    pad_row = tail["docs"].shape[0] - 1
    vrow = tail["rows"][safe]  # (Q, T, C)
    vrow = torch.where(valid[:, :, None] & (vrow >= 0), vrow, pad_row)
    flat = vrow.reshape(q, t * c).long()
    g_docs = tail["docs"][flat]  # (Q, T*C, P)
    g_vals = tail["vals"][flat]
    mine = tail["toks"][flat] == qtok.repeat_interleave(c, dim=1)[:, :, None]
    n = t * c * g_docs.shape[-1]
    cd = torch.where(mine, g_docs, DOC_SENTINEL).reshape(q, n)
    if w is not None:
        g_vals = g_vals * w.repeat_interleave(c, dim=1)[:, :, None]
    cv = torch.where(mine, g_vals, 0.0).reshape(q, n)
    sd, order = torch.sort(cd, dim=1, stable=True)
    sv = torch.gather(cv, 1, order)
    # a doc appears once per matching query-token occurrence, so runs are
    # at most T long: T-1 shifted adds
    tot = sv
    for s in range(1, t):
        tot = tot + torch.where(_shift_right(sd, s, -9) == sd,
                                _shift_right(sv, s, 0.0), 0.0)
    nxt = torch.full_like(sd, -9)
    nxt[:, :-1] = sd[:, 1:]
    is_cand = (sd != nxt) & (sd != DOC_SENTINEL)
    if mask is not None:
        # filtered search: ineligible docs never become candidates
        is_cand = is_cand & mask[sd.clamp(0, mask.shape[0] - 1).long()]
    cand_docs = torch.where(is_cand, sd, DOC_SENTINEL)
    gpos = tail["gpos"][torch.where(is_cand, sd, 0).long()]
    return is_cand, cand_docs, tot, gpos


def bucket_base(b: dict, ids: torch.Tensor, hot_counts=None, hot_lo=None,
                w=None, mask=None, plan=None, table=None):
    """One bucket's masked (Q, rows) base and its (Q, rows / 8) group
    maxima: B1 over the bucket (``plan`` and ``table`` made once a chunk
    by the caller).

    Shared by the single-device step and each shard of the sharded step
    (``parallel/sharded_engine.py``), as JAX shares
    ``bucket_base_scores``, so that filtered search cannot drift between
    them.  Under ``mask`` ((num_docs,) bool) the ineligible rows fold
    into B1's pad-row mask through a scoring-only copy of the bucket's
    doc ids: base and group maxima come out masked, eligible rows keep
    the unmasked bits, and callers take candidate ids from the real
    ``doc_ids``."""
    did = b["doc_ids"]
    if mask is not None:
        elig = mask[did.clamp(min=0).long()] & (did >= 0)
        did = torch.where(elig, did, -1)
    return ell_score_fused(
        ids, b.get("tokT"), b.get("valT"), did, hot_counts, b.get("hotT"),
        b.get("hotLo"), weights=w, hot_counts_lo=hot_lo, plan=plan,
        table=table,
    )


def bucket_select(base: torch.Tensor, gmax: torch.Tensor, k: int):
    """A bucket's top ``min(k, rows)``, ``(scores, positions)``: the
    tournament tree over B1's group maxima, or one stable sort where the
    bucket is narrow."""
    rows = base.shape[1]
    kk = min(k, rows)
    if rows > max(2 * kk, 4096) and gmax.shape[1] >= kk:
        return top_k_tree_with_maxes(base, gmax, kk, branch=GROUP)
    return select_top_k(base, kk)


def two_key_merge(cs: torch.Tensor, ci: torch.Tensor, k: int):
    """The top ``min(k, width)`` of (Q, width) candidate scores ``cs`` and
    doc ids ``ci`` by score descending, then doc ascending: two stable
    sorts, by doc first, then by score (stability keeps doc order in
    ties).  -> (scores, docs)."""
    kk = min(k, cs.shape[1])
    ci, order = torch.sort(ci, dim=1, stable=True)
    cs = torch.gather(cs, 1, order)
    neg, order = torch.sort(-cs, dim=1, stable=True)
    return -neg[:, :kk], torch.gather(ci, 1, order[:, :kk])


def union_applies(union_select, buckets: list, k: int, mask=None,
                  tail=None) -> bool:
    """Whether union selection runs (JAX's rule): asked for, no doc mask
    (a masked group max breaks the strict-gap check), no tail tier, more
    than one bucket and more than k + 1 groups over all of them."""
    return bool(
        union_select and mask is None and tail is None and len(buckets) > 1
        and sum(b["doc_ids"].shape[0] for b in buckets) // GROUP > k + 1)


def union_top_k(buckets: list, bases: list, gmaxes: list, k: int,
                union_select):
    """JAX's union path: one group tournament over every bucket's group
    maxima (``ops/topk.py::union_group_select``), then one (score desc,
    doc asc) merge of the won groups' rows -> ``(scores, docs)``.

    Exact when the tournament's flag holds (the (k+1)-th group max of
    every query strictly below the k-th); where it does not (a tie across
    the k boundary, e.g. an all-tied corpus) the result is the per-bucket
    path's, selected from the same bases.  ``union_select="unsafe"``
    skips the check.  JAX picks with ``lax.cond`` on the device flag;
    here the flag is read once a chunk and one path runs (computing both
    and picking by ``torch.where``, with no host read, was slower on the
    card: PERF.md section 5).
    """
    with span("step.select"):
        gpos, ok = union_group_select(gmaxes, k)
    dids = [b["doc_ids"] for b in buckets]

    def fast():
        with span("step.merge"):
            return two_key_merge(*gather_group_candidates(bases, dids, gpos,
                                                          GROUP), k)

    def per_bucket():
        cand = []
        for base, gmax in zip(bases, gmaxes):
            with span("step.select"):
                cand.append(bucket_select(base, gmax, k))
        with span("step.merge"):
            return two_key_merge(torch.cat([s for s, _ in cand], dim=1),
                                 torch.cat([d[p] for d, (_, p)
                                            in zip(dids, cand)], dim=1), k)

    if union_select == "unsafe":
        return fast()
    return fast() if bool(ok) else per_bucket()


def buckets_top_k(buckets: list, ids: torch.Tensor, k: int,
                  hot_counts=None, hot_lo=None, w=None, mask=None,
                  plan=None, table=None, union_select=False):
    """The top k over every bucket, ``(scores (Q, kk), docs (Q, kk))``
    with ``kk = min(k, rows)``: each bucket's base by B1 and its own top
    k, freed before the next bucket, then one two-key merge; or, where
    ``union_applies``, every base first and ``union_top_k``.  The
    single-device step without a tail tier and each shard of the sharded
    step run it."""
    args = (hot_counts, hot_lo, w, mask, plan, table)
    if union_applies(union_select, buckets, k, mask):
        bases, gmaxes = [], []
        for b in buckets:
            with span("step.scan"):
                base, gmax = bucket_base(b, ids, *args)
            bases.append(base)
            gmaxes.append(gmax)
        return union_top_k(buckets, bases, gmaxes, k, union_select)
    cand_s, cand_i = [], []
    for b in buckets:
        with span("step.scan"):
            base, gmax = bucket_base(b, ids, *args)
        with span("step.select"):
            s, pos = bucket_select(base, gmax, k)
            del base, gmax  # free this bucket's tile before the next
            cand_s.append(s)
            cand_i.append(b["doc_ids"][pos])
    with span("step.merge"):
        return two_key_merge(torch.cat(cand_s, dim=1),
                             torch.cat(cand_i, dim=1), k)


def make_sparse_query_step(k: int, hot_h: int = 0, ids_only: bool = False,
                           score_dtype=None, union_select=False):
    """The query step over the hot, ELL and tail tiers.

    ``step(ids, buckets, offsets, hot_table, w=None, mask=None, tail=None,
    cold_ids=None, w_cold=None) -> (scores (Q, k), docs (Q, k) int32)``,
    or the docs alone with ``ids_only`` (the scores never leave the
    device); ``buckets`` are dicts of ``doc_ids (rows,)`` and, where
    present, ``tokT``/``valT`` (L, rows) and ``hotT``/``hotLo`` (H,
    rows).  ``w`` (Q, T) f32 weights each query token: its offset, its
    hot count, its ELL matches and its tail postings.  ``mask``
    ((num_docs,) bool on the device, True = eligible) restricts the
    result to a doc subset: slots left when fewer than k docs are
    eligible come back as doc -1 / score 0.  ``tail`` is the tail tier's
    arrays (``docs``, ``vals``, ``toks``, ``rows``, ``gpos``) or None.
    ``score_dtype`` (a torch dtype or None for f32) is the type the
    returned scores are rounded to.

    ``cold_ids`` (Q, T_c) (and ``w_cold``) hold only each query's cold
    (non-hot) ids, as cold-width routing plans them: the offsets and the
    hot counts read the full ids, the scan tables, B1's scan and the tail
    tier the cold ids (hot postings are in neither the ELL nor the tail,
    so a hot id there could never match).  ``union_select`` runs JAX's
    union path where ``union_applies`` (``union_top_k``).
    """

    def step(ids, buckets, offsets, hot_table, w=None, mask=None, tail=None,
             cold_ids=None, w_cold=None):
        with span("step.offsets"):
            valid = ids >= 0
            safe = torch.where(valid, ids, 0).long()
            zero = torch.zeros((), dtype=offsets.dtype,
                               device=offsets.device)
            if w is not None:
                w = torch.where(valid, w.float(), zero)
                qoff = (offsets[safe] * w).sum(dim=1)
            else:
                qoff = torch.where(valid, offsets[safe], zero).sum(dim=1)
        hot_counts = hot_lo = plan = None
        if hot_h:
            with span("step.hot"):
                hot_counts, hot_lo = hot_counts_for(ids, hot_table, hot_h, w)
                plan = hot_plan(hot_counts, hot_lo)  # once for every bucket
        if cold_ids is not None:
            # from here on only the cold ids matter
            ids, w = cold_ids, w_cold
            if w is not None:
                w = torch.where(ids >= 0, w.float(), zero)
        # the card's scan tables, once for every bucket (the CPU twins
        # read none)
        with span("step.table"):
            table = scan_table(ids, w) if ids.is_cuda else None
        if tail is None:
            ms, docs = buckets_top_k(buckets, ids, k, hot_counts, hot_lo, w,
                                     mask, plan, table, union_select)
        else:
            ms, docs = _tail_step(buckets, tail, ids, k, hot_counts, hot_lo,
                                  w, mask, plan, table)
        if mask is not None:
            # slots beyond the eligible count become doc -1 / score 0 on
            # the device, so every fetch (ids only, bf16) stays uniform;
            # unmasked, k <= num_docs leaves >= k finite candidates
            docs = torch.where(ms > NEG_INF, docs, -1)
        docs = docs.to(torch.int32)
        if ids_only:
            return docs
        scores = ms + qoff[:, None]
        if mask is not None:
            scores = torch.where(ms > NEG_INF, scores, 0.0)
        if score_dtype is not None:
            # halves the result-transfer bytes; the ids stay exact
            scores = scores.to(score_dtype)
        return scores, docs

    return step


def _tail_step(buckets, tail, ids, k, hot_counts, hot_lo, w, mask, plan,
               table):
    """The buckets' top k merged with the tail tier's exact candidates:
    each tail candidate's base (its ELL and hot sums) is looked up in the
    bucket that holds its doc, before that bucket's base is freed."""
    with span("step.tail"):
        is_cand, cand_docs, cand_tail, gpos = tail_candidates(tail, ids, w,
                                                              mask)
        cand_base = torch.zeros_like(cand_tail)
    cand_s, cand_i = [], []
    r0 = 0
    for b in buckets:
        with span("step.scan"):
            base, gmax = bucket_base(b, ids, hot_counts, hot_lo, w, mask,
                                     plan, table)
            rows_b = base.shape[1]
            rel = gpos - r0
            in_b = (rel >= 0) & (rel < rows_b) & is_cand
            look = torch.gather(base, 1, torch.where(in_b, rel, 0).long())
            cand_base = cand_base + torch.where(in_b, look, 0.0)
            r0 += rows_b
        with span("step.select"):
            s, pos = bucket_select(base, gmax, k)
            del base, gmax  # free this bucket's tile before the next
            cand_s.append(s)
            cand_i.append(b["doc_ids"][pos])
    with span("step.merge"):
        return _merge_with_tail(
            cand_s, cand_i, cand_docs,
            torch.where(is_cand, cand_tail + cand_base, NEG_INF), k)


def _merge_with_tail(cand_s, cand_i, cand_docs, totals, k: int):
    """The buckets' candidates merged with the tail's, duplicates
    dropped: sorted by (doc asc, score desc) as two stable sorts, a doc's
    first entry is its full total (the tail adds >= 0 to its base) and
    later ones are stale bucket entries, set to -inf with DOC_SENTINEL;
    then the top k (ties to the smaller position, so the smaller doc)."""
    all_s = torch.cat(cand_s + [totals], dim=1)
    all_d = torch.cat(cand_i + [cand_docs], dim=1)
    neg, order = torch.sort(-all_s, dim=1, stable=True)
    dd = torch.gather(all_d, 1, order)
    dd, order = torch.sort(dd, dim=1, stable=True)
    ss = -torch.gather(neg, 1, order)
    ss = torch.where((dd == _shift_right(dd, 1, -9)) | (dd == DOC_SENTINEL),
                     NEG_INF, ss)
    ms, mpos = select_top_k(ss, min(k, ss.shape[1]))
    return ms, torch.gather(dd, 1, mpos)


class B1Bytes(NamedTuple):
    """The bytes kernel B1 must move on one bucket for one chunk."""

    scan: int  # ids (and weights), slot tokens, a value a matching slot,
    # the (Q, rows) base written once
    epilogue: int  # beyond the scan: the used hot rows (hi and lo), the
    # plan's counts, doc_ids, the group maxima (and the base where the
    # bucket has no slots)
    matched: int  # slots whose token is some query's cold id


def b1_bytes(engine: "SparseEngine", ids: torch.Tensor,
             w: torch.Tensor | None = None,
             cold_ids: torch.Tensor | None = None,
             w_cold: torch.Tensor | None = None) -> list[B1Bytes]:
    """The least bytes B1 moves for one chunk of (Q, T) int32 ids (and
    optional weights) on the engine's device, one entry a bucket: each
    input read once and each output written once, counted from these ids
    (a slot's value is read only where its token is some query's cold id,
    a hot row only where some query counts its token).  The base never
    makes a trip between the scan and the hot epilogue.  A routed chunk
    passes its cold ids (and weights), which the scan reads in place of
    ``ids``.  Reads the used hot-token count back to the host."""
    q = ids.shape[0]
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    cold_any = torch.unique(ids[valid & (engine.hot_table[safe] < 0)])
    used = counts = 0
    if engine.hot_h:
        hc, hlo = hot_counts_for(ids, engine.hot_table, engine.hot_h, w)
        plan = hot_plan(hc, hlo)
        nonzero = hc != 0 if hlo is None else (hc != 0) | (hlo != 0)
        used = int(nonzero.any(dim=0).sum())
        counts = sum(_nbytes(c) for c in (plan.counts, plan.counts_lo)
                     if c is not None)
    if cold_ids is not None:
        ids, w = cold_ids, w_cold
    query_bytes = _nbytes(ids) + (0 if w is None else _nbytes(w))
    out = []
    for b in engine.buckets:
        did = b["doc_ids"]
        rows = did.shape[0]
        base = q * rows * 4
        epilogue = (2 * used * rows * 2 * ("hotT" in b)
                    + q * (rows // GROUP) * 4 + counts + _nbytes(did))
        if "tokT" in b:
            matched = int(torch.isin(b["tokT"], cold_any).sum())
            scan = query_bytes + _nbytes(b["tokT"]) + 4 * matched + base
        else:
            matched = scan = 0
            epilogue += base
        out.append(B1Bytes(scan, epilogue, matched))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def prepare_doc_mask(doc_mask, num_docs: int, session: Session):
    """Validate and upload a (num_docs,) bool eligibility mask.

    A tensor passes through (moved to the session's device if it is not
    there: callers can upload a reused tenancy mask once); anything else
    converts to bool and uploads per call.
    """
    if isinstance(doc_mask, torch.Tensor):
        if tuple(doc_mask.shape) != (num_docs,):
            raise ValueError(
                f"doc_mask shape {tuple(doc_mask.shape)} != ({num_docs},)")
        return doc_mask.to(session.device, torch.bool)
    m = np.asarray(doc_mask)
    if m.shape != (num_docs,):
        raise ValueError(f"doc_mask shape {m.shape} != ({num_docs},)")
    return session.put_async(m.astype(bool))


def _score_sdt(score_dtype: str):
    """Validated device dtype for returned scores (None = f32 passthrough)."""
    if score_dtype == "float32":
        return None
    if score_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(
        f"score_dtype must be 'float32' or 'bfloat16', got {score_dtype!r}"
    )


def maybe_dedup(
    queries: np.ndarray, weights: np.ndarray | None,
    dedup: bool | str, min_width: int,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Apply long-query dedup when it actually cheapens the scan.

    The rule is JAX's, kept as it is so that the port dedups exactly
    where JAX does: on a TPU the unweighted scan costs ``2T+2`` VPU ops
    per slot and the weighted one (which dedup switches to) ``3T_u+2``, so
    under ``"auto"`` the swap engages only when ``3*T_u + 2 < 2*T + 2``
    (and the width is at least ``min_width``).  ``dedup=True`` forces it
    on any shrink.  Only unweighted batches are deduplicated.  Counts
    ``dedup.checked`` where the rows were sorted and ``dedup.applied``
    where the deduplicated rows were kept.
    """
    if weights is not None or not (
        dedup is True
        or (dedup == "auto" and queries.shape[1] >= min_width)
    ):
        return queries, weights
    count("dedup.checked")
    ids_u, counts = dedup_query_rows(queries)
    t, t_u = queries.shape[1], ids_u.shape[1]
    if t_u < t and (dedup is True or 3 * t_u + 2 < 2 * t + 2):
        count("dedup.applied")
        return ids_u, counts
    return queries, weights


def dedup_query_rows(queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Collapse each query row to unique token ids + occurrence counts.

    Returns ``(ids_u (Q, T_u) int32, counts (Q, T_u) float32)`` with -1
    pads.  Scoring the deduplicated row with count weights does the same
    math as the full row with T_u <= T columns.
    """
    q = np.asarray(queries, dtype=np.int32)
    if q.size == 0:
        return q, np.zeros_like(q, dtype=np.float32)
    s = np.sort(q, axis=1)[:, ::-1]  # desc: valid ids first, pads (-1) last
    first = np.ones_like(s, dtype=bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    valid = s >= 0
    first &= valid
    t_u = max(int(first.sum(axis=1).max(initial=0)), 1)
    pos = np.cumsum(first, axis=1) - 1  # run index per element
    rows = np.broadcast_to(np.arange(len(q))[:, None], s.shape)
    ids_u = np.full((len(q), t_u), -1, dtype=np.int32)
    counts = np.zeros((len(q), t_u), dtype=np.float32)
    ids_u[rows[first], pos[first]] = s[first]
    np.add.at(counts, (rows[valid], np.maximum(pos[valid], 0)), 1.0)
    return ids_u, counts


def compact_rows(
    ids: np.ndarray, keep: np.ndarray, w: np.ndarray | None = None,
    min_width: int = 1,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Left-compact the kept entries of each row; -1 pads (0 pad weights)."""
    cnt = keep.sum(axis=1)
    t_c = max(int(cnt.max(initial=0)), min_width)
    pos = np.cumsum(keep, axis=1) - 1
    rows = np.broadcast_to(np.arange(len(ids))[:, None], ids.shape)
    out = np.full((len(ids), t_c), -1, dtype=np.int32)
    out[rows[keep], pos[keep]] = ids[keep]
    if w is None:
        return out, None
    wout = np.zeros((len(ids), t_c), dtype=np.float32)
    wout[rows[keep], pos[keep]] = w[keep]
    return out, wout


# The chunk DP's costs on the card, in the scan units of _chunk_bounds_dp
# (a padded row of cold width T costs c0 + 2 T + 2 units, a chunk
# ``fixed`` more).  Fitted on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit by ``bench/layout_sweep.py --route-sweep --iters 50``, run twice
# (routed steps of the query benchmark's 524,288-doc corpus at h=1024 and
# 2 buckets, chunk heights 32-512, cold widths 2-64, k = 100 and 1000),
# and ``--fit-route`` over both passes: the per-row cost that does not
# depend on the width, at k = 100 and 1000, and the cost of a chunk of no
# rows.  A scan unit came to 9.126e-5 ms, a chunk to 1.44 ms (each pass
# alone: 1.38 and 1.50 ms; the host's launches bound small chunks); the
# fit's median error 11.4% over 120 steps (PERF.md section 5).
CHUNK_C0_UNITS = {100: 88.56, 1000: 126.0}
CHUNK_FIXED_UNITS = 15807.8


def chunk_c0_units(k: int | None) -> float:
    """The chunk-packing DP's width-independent per-row cost, in scan
    units: log-linear in k between the card's fits at k = 100 and 1000
    (``CHUNK_C0_UNITS``), their mean without a k.  Shared by the
    single-device and sharded planners, as in JAX."""
    (k0, c0), (k1, c1) = sorted(CHUNK_C0_UNITS.items())
    if k is None:
        return (c0 + c1) / 2
    return float(np.interp(np.log(max(k, 1)), [np.log(k0), np.log(k1)],
                           [c0, c1]))


def _routed_q_pad(cq: int, max_q: int, q_align: int) -> int:
    """Pow2-quantized chunk height that never exceeds the max_q budget."""
    floor = min(32, max_q)
    padded = next_multiple(next_pow2_at_least(max(cq, floor)), q_align)
    if padded > next_multiple(max_q, q_align):
        padded = next_multiple(cq, q_align)
    return padded


def _chunk_bounds_dp(
    cls: np.ndarray, max_q: int, q_align: int, c0_units: float,
    fixed_units: float,
) -> list[int]:
    """Optimal chunk cut points over width-sorted rows (JAX's DP).

    ``cls`` is the pow2 cold-width class per row, ascending.  Chunks take
    pow2 sizes (32..max_q, q_align-rounded); a chunk's width is its widest
    row's class.  Modelled cost per chunk = ``padded_rows * (c0_units +
    2*T + 2) + fixed_units`` in scan units (``CHUNK_C0_UNITS``,
    ``CHUNK_FIXED_UNITS``).  O(n * sizes) on the host.
    """
    n = len(cls)
    sizes = [s for s in (512, 256, 128, 64, 32) if s <= max_q]
    if not sizes:
        # a score-buffer budget below 32 rows stays authoritative:
        # padding above max_q would exceed the memory it bounds
        sizes = [max(8, max_q)]
    best = np.full(n + 1, np.inf)
    best[n] = 0.0
    nxt = np.zeros(n + 1, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        for s in sizes:
            j = min(i + s, n)
            padded = _routed_q_pad(j - i, max_q, q_align)
            t = int(cls[j - 1])  # rows sorted: widest is last
            c = padded * (c0_units + 2 * t + 2) + fixed_units + best[j]
            if c < best[i]:
                best[i] = c
                nxt[i] = j
    bounds = [0]
    while bounds[-1] < n:
        bounds.append(int(nxt[bounds[-1]]))
    return bounds


class Chunk(NamedTuple):
    """One planned dispatch: ``cq`` real rows, the padded (Q_pad, T_pad)
    ids and weights (None unweighted), and under cold-width routing the
    (Q_pad, T_c) cold ids and weights (else None)."""

    cq: int
    padded: np.ndarray
    wpadded: np.ndarray | None
    cold_padded: np.ndarray | None
    wc_padded: np.ndarray | None


def plan_query_dispatch(
    queries: np.ndarray,
    weights: np.ndarray | None,
    *,
    hot_table_host: np.ndarray | None,
    hot_h: int,
    has_scan: bool,
    route: bool | str,
    route_min_queries: int,
    max_q: int,
    q_align: int = 8,
    c0_units: float | None = None,
    fixed_units: float | None = None,
):
    """The dispatch planner of both sparse engines (JAX's).

    Applies cold-width routing (strip hot ids, sort rows by cold count)
    when enabled, then cuts the batch into chunks of at most ``max_q``
    rows padded to ``q_align``; each chunk carries its own narrowest cold
    width.  ``route`` True forces routing, False disables it, and
    ``"auto"`` routes where a hot tier and a scan or tail tier coexist,
    the queries are wider than one id and the batch has at least
    ``route_min_queries`` rows.  Routed rows are cut by ``_chunk_bounds_dp``
    at the costs ``c0_units`` (default ``chunk_c0_units(None)``) and
    ``fixed_units`` (default ``CHUNK_FIXED_UNITS``); unrouted ones into
    ``max_q``-row slices.  Returns
    ``(perm, chunks)``: ``perm`` is the routing permutation (or None) and
    each chunk a ``Chunk`` ``(cq, padded_ids, padded_weights,
    cold_padded, wc_padded)``.  Counts the cells of the ids the scan
    reads (the cold ids where routed): ``plan.cells_real`` (ids >= 0) and
    ``plan.cells_padded`` (Q_pad x T_pad over the chunks).
    """
    queries = queries.astype(np.int32)
    if c0_units is None:
        c0_units = chunk_c0_units(None)
    if fixed_units is None:
        fixed_units = CHUNK_FIXED_UNITS
    split = (
        hot_h > 0 and has_scan
        and hot_table_host is not None
        and (route is True or (
            route == "auto"
            and queries.shape[1] > 1
            and len(queries) >= route_min_queries
        ))
    )
    perm = cold_mask = None
    bounds = None
    if split:
        valid = queries >= 0
        hr = hot_table_host[np.where(valid, queries, 0)]
        cold_mask = valid & (hr < 0)
        counts = cold_mask.sum(axis=1)
        perm = np.argsort(counts, kind="stable")
        queries = queries[perm]
        cold_mask = cold_mask[perm]
        counts = counts[perm]
        if weights is not None:
            weights = weights[perm]
        # chunk the sorted rows by a small DP over pow2 chunk sizes that
        # balances running rows at their narrowest cold width against
        # padding waste and the fixed cost of a chunk; fixed-size cuts are
        # inside its search space
        cls = 1 << np.ceil(np.log2(np.maximum(counts, 2))).astype(np.int64)
        with span("plan.route_dp"):
            bounds = _chunk_bounds_dp(cls, max_q, q_align, c0_units,
                                      fixed_units)
    q_real, t_real = queries.shape
    if bounds is None:
        bounds = list(range(0, q_real, max_q)) + [q_real]
    chunks = []
    cells = 0
    for i, j in zip(bounds[:-1], bounds[1:]):
        chunk = queries[i : j]
        cq = len(chunk)
        if split:
            # routed chunk heights are powers of two (>= 32, within the
            # budget), so that width-boundary cuts give few shapes
            q_pad = _routed_q_pad(cq, max_q, q_align)
        else:
            q_pad = next_multiple(cq, q_align)
        t_pad = next_pow2_at_least(max(t_real, 8))
        padded = np.full((q_pad, t_pad), -1, dtype=np.int32)
        padded[:cq, :t_real] = chunk
        wpadded = None
        if weights is not None:
            wpadded = np.zeros((q_pad, t_pad), dtype=np.float32)
            wpadded[:cq, :t_real] = weights[i : j]
        cold_padded = wc_padded = None
        if split:
            cold_ids, wc = compact_rows(
                chunk, cold_mask[i : j],
                None if weights is None else weights[i : j],
            )
            # at least 2 wide: a row with no cold id keeps a -1 pad
            t_pad_c = next_pow2_at_least(max(cold_ids.shape[1], 2))
            cold_padded = np.full((q_pad, t_pad_c), -1, dtype=np.int32)
            cold_padded[:cq, : cold_ids.shape[1]] = cold_ids
            if wc is not None:
                wc_padded = np.zeros((q_pad, t_pad_c), dtype=np.float32)
                wc_padded[:cq, : wc.shape[1]] = wc
        cells += (padded if cold_padded is None else cold_padded).size
        chunks.append(Chunk(cq, padded, wpadded, cold_padded, wc_padded))
    if enabled():
        count("plan.cells_real",
              int(counts.sum() if split else (queries >= 0).sum()))
        count("plan.cells_padded", cells)
    return perm, chunks


def unpermute(perm: np.ndarray | None, rows: np.ndarray) -> np.ndarray:
    """Rows of a routed batch back in the caller's order."""
    if perm is None:
        return rows
    return rows[np.argsort(perm, kind="stable")]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass
class SparseEngine:
    """Device-resident BM25 engine over ELL buckets, a dense hot tier and
    a token-major tail tier."""

    buckets: list  # dicts: doc_ids, [tokT (L, rows), valT, hotT, hotLo]
    offsets: torch.Tensor  # (V+1,) float32 token offsets
    hot_table: torch.Tensor  # (V+1,) int32 token id -> hot rank or -1
    hot_h: int
    num_docs: int
    vocab_size: int
    session: Session
    # cap on the transient (Q, rows) score tiles of one chunk; shrunk by
    # fit_score_buffer_budget when the index leaves less room
    score_buffer_budget: int = SCORE_BUFFER_BUDGET
    # "bfloat16": the returned scores are rounded to bf16 on the device
    # (selection stays f32-exact; doc ids are exact) and come back as f32
    score_dtype: str = "float32"
    # long-query dedup: score unique tokens with occurrence-count weights.
    # "auto" engages at widths of at least dedup_min_width where JAX's rule
    # (maybe_dedup) says so; True forces it, False disables.
    dedup_queries: bool | str = "auto"
    dedup_min_width: int = 16
    # the index's token -> id map (None for an engine made from arrays)
    vocab: dict[str, int] | None = None
    # tail tier (candidate generation for low-DF tokens); None = disabled
    tail_docs: torch.Tensor | None = None  # (R+1, P) int32 doc ids, -1 pad
    tail_vals: torch.Tensor | None = None  # (R+1, P) float32 contributions
    tail_toks: torch.Tensor | None = None  # (R+1, P) int32 owning token ids
    tail_rows: torch.Tensor | None = None  # (V+1, C) int32 row ids, -1 pad
    tail_gpos: torch.Tensor | None = None  # (D,) int32 doc -> bucket position
    tail_cap: int = 0  # max DF routed to the tail tier
    # most queries a dispatched chunk (the score-buffer budget may cut it)
    chunk_queries: int = CHUNK_QUERIES
    # cold-width routing: hot ids leave the scan's and the tail's ids (the
    # hot epilogue counts them) and queries sort by their count of cold
    # ids, so that most chunks scan a narrow T_c.  "auto" engages where a
    # hot tier and a scan or tail tier coexist and the batch has at least
    # route_min_queries rows (JAX's rule); True forces it, False disables
    route_cold: bool | str = "auto"
    route_min_queries: int = 32
    # host copy of hot_table, for the routing split (token id -> hot rank)
    hot_table_host: np.ndarray | None = None
    # union selection: one group tournament over every bucket's group
    # maxima in place of a top k a bucket, exact (a tie across the k
    # boundary falls back to the per-bucket path, read once a chunk);
    # "unsafe" skips that check.  Off by default, as in JAX
    union_select: bool | str = False

    @classmethod
    def from_scored_index(
        cls,
        index: ScoredIndex,
        session: Session | None = None,
        max_buckets: int = 4,
        hot_tokens: int | str = "auto",
        hot_budget_bytes: int | None = None,
        tail_cap: int = 0,
        tail_width: int = 512,
        score_dtype: str = "float32",
        overhead_target: float | None = None,
    ) -> "SparseEngine":
        """Lay the index out on the session's device.

        ``hot_tokens="auto"`` sizes the hot tier with the cost model
        (``choose_hot_tokens`` at ``max_buckets``) under the resident cap,
        or under ``hot_budget_bytes`` where it is given; an integer is the
        requested width H, capped by ``hot_budget_bytes`` (default: the
        raw CSC bytes) at 4 bytes per (token, doc) entry, by the
        vocabulary and by what B1's hot kernel takes.
        ``overhead_target=R`` (with ``"auto"`` only) also caps the
        modelled device bytes at R x the CSC bytes; a target below the
        ELL-only floor degrades to no hot tier, with a warning.
        ``tail_cap`` > 0 moves the postings of tokens of DF at most
        ``tail_cap`` (none negative, none hot) out of the ELL into the
        tail tier, rows of ``tail_width`` slots.  ``score_dtype``
        ("float32" or "bfloat16") is the type the returned scores are
        rounded to.

        Its spans: ``build.hot_choice``, ``build.split``, ``build.tail``,
        ``build.ell`` and ``build.hot_pair``.
        """
        session = session or get_session()
        _score_sdt(score_dtype)  # validate early, at build time
        if overhead_target is not None:
            if hot_tokens != "auto":
                raise ValueError(
                    "overhead_target steers the auto hot-tier policy; it "
                    "cannot combine with an explicit hot_tokens count"
                )
            if overhead_target <= 0:
                raise ValueError("overhead_target must be positive")
        csc_bytes = (index.data.nbytes + index.indices.nbytes
                     + index.indptr.nbytes)
        with span("build.hot_choice"):
            if hot_tokens == "auto":
                h = choose_hot_tokens(
                    index, max_buckets=max_buckets,
                    budget_bytes=hot_budget_bytes, tail_cap=tail_cap,
                    device=session.device, overhead_target=overhead_target,
                )
                # surface the memory trade the auto policy is making
                logger.info(
                    "hot-auto: h=%d -> hot tier %.2f GB on a %.1f GB device "
                    "(resident cap %.2f GB; raw CSC %.2f GB)",
                    h, h * index.num_docs * 4 / 2**30,
                    device_hbm_bytes(session.device) / 2**30,
                    _auto_resident_cap(session.device, index.num_docs)
                    / 2**30,
                    csc_bytes / 2**30,
                )
            else:
                if isinstance(hot_tokens, str):
                    raise ValueError(
                        f"hot_tokens must be an integer or 'auto', got "
                        f"{hot_tokens!r}")
                if hot_tokens < 0:
                    raise ValueError(
                        f"hot_tokens must be >= 0, got {hot_tokens}")
                budget = (csc_bytes if hot_budget_bytes is None
                          else hot_budget_bytes)
                max_h = budget // max(index.num_docs * 4, 1)
                kernel_h = max_hot_tokens()
                h = int(min(hot_tokens, max_h, index.vocab_size, kernel_h))
                if h < min(int(hot_tokens), index.vocab_size):
                    logger.info("hot_tokens=%s clamped to %d (memory budget "
                                "%d B, hot kernel cap %d)", hot_tokens, h,
                                budget, kernel_h)
        with span("build.split"):
            if h > 0:
                hot_ids, cold_csr, hot_csr = split_hot_cold_csr(index, h)
                h = len(hot_ids)
            else:
                hot_ids, hot_csr = np.zeros(0, np.int32), None
                cold_csr = index.to_csc().tocsr()

        # tail tier: low-DF tokens leave the ELL entirely
        tail = None
        if tail_cap > 0:
            with span("build.tail"):
                tail, is_tail = build_token_tail(index, hot_ids, tail_cap,
                                                 width=tail_width)
                if tail is not None:
                    cold_csr = _filter_csr(
                        cold_csr, ~is_tail[cold_csr.indices], index.num_docs)

        with span("build.ell"):
            if cold_csr.nnz > 0:
                host_buckets = build_ell_buckets_from_csr(
                    cold_csr, index.num_docs, max_buckets=max_buckets,
                    row_align=BLOCK_ROWS,
                )
            else:
                # no mid tier: one identity bucket (original doc order)
                # carrying only the hot matrix and the doc mask
                n_pad = next_multiple(max(index.num_docs, 1), BLOCK_ROWS)
                doc_ids = np.full(n_pad, -1, dtype=np.int32)
                doc_ids[: index.num_docs] = np.arange(index.num_docs,
                                                      dtype=np.int32)
                host_buckets = [EllBucket(tok=None, val=None,
                                          doc_ids=doc_ids,
                                          num_real=index.num_docs)]

        v = index.vocab_size
        hot_table = np.full((v + 1,), -1, dtype=np.int32)
        if h > 0:
            hot_table[hot_ids] = np.arange(h, dtype=np.int32)
            hot_ids_dev = session.put(hot_ids.reshape(-1, 1))

        dev_buckets = []
        gpos_host = np.zeros(max(index.num_docs, 1), dtype=np.int32)
        r0 = 0
        for b in host_buckets:
            entry = {"doc_ids": session.put(b.doc_ids)}
            if b.tok is not None:
                with span("build.ell"):
                    l_pad = next_multiple(b.tok.shape[1], 8)
                    tok_t = np.full((l_pad, b.tok.shape[0]), PAD_TOK,
                                    dtype=np.int32)
                    tok_t[: b.tok.shape[1]] = b.tok.T
                    val_t = np.zeros((l_pad, b.val.shape[0]),
                                     dtype=np.float32)
                    val_t[: b.val.shape[1]] = b.val.T
                entry["tokT"] = session.put(tok_t)
                entry["valT"] = session.put(val_t)
            if h > 0:
                # the hot (H, rows) pair in this bucket's row order, built
                # on the device from the sparse hot postings
                with span("build.hot_pair"):
                    htok, hval = hot_ell_for_rows(hot_csr, b.doc_ids)
                    entry["hotT"], entry["hotLo"] = build_hot_pair_device(
                        hot_ids_dev, session.put(htok), session.put(hval))
            real = b.doc_ids >= 0
            gpos_host[b.doc_ids[real]] = r0 + np.flatnonzero(real).astype(
                np.int32)
            r0 += len(b.doc_ids)
            dev_buckets.append(entry)

        off_host = np.zeros((v + 1,), dtype=np.float32)
        if index.token_offsets is not None:
            off_host[:v] = index.token_offsets
        tail_kw: dict = {}
        if tail is not None:
            tail_kw = {"tail_docs": session.put(tail["docs"]),
                       "tail_vals": session.put(tail["vals"]),
                       "tail_toks": session.put(tail["toks"]),
                       "tail_rows": session.put(tail["rows"]),
                       "tail_gpos": session.put(gpos_host),
                       "tail_cap": tail_cap}
        engine = cls(
            buckets=dev_buckets,
            offsets=session.put(off_host),
            hot_table=session.put(hot_table),
            hot_table_host=hot_table,
            hot_h=h,
            num_docs=index.num_docs,
            vocab_size=v,
            session=session,
            score_dtype=score_dtype,
            vocab=index.vocab,
            **tail_kw,
        )
        fit_score_buffer_budget(engine)
        if overhead_target is not None:
            ratio = engine.device_bytes() / max(csc_bytes, 1)
            if ratio > overhead_target * 1.1:
                logger.warning(
                    "overhead_target=%.2f not reachable: device footprint "
                    "is %.2fx CSC (the ELL-only floor for this corpus); "
                    "targets below the floor degrade to hot_tokens=0",
                    overhead_target, ratio,
                )
        return engine

    @classmethod
    def from_arrays(
        cls,
        arrays: dict[str, np.ndarray],
        *,
        num_docs: int,
        vocab_size: int,
        hot_h: int,
        session: Session,
        tail_cap: int = 0,
        vocab: dict[str, int] | None = None,
        score_dtype: str = "float32",
    ) -> "SparseEngine":
        """An engine from copies of another engine's device arrays.

        Keys: ``"offsets"``, ``"hot_table"``, ``"buckets.<i>.<name>"``
        with ``<name>`` one of doc_ids, tokT, valT, hotT, hotLo, and, for
        a tail tier, all of ``"tail_docs"``, ``"tail_vals"``,
        ``"tail_toks"``, ``"tail_rows"`` and ``"tail_gpos"`` (its
        ``tail_cap`` passed beside) — e.g. the numpy copies of a JAX
        ``SparseEngine``'s ``buckets[i][name]`` and fields (bf16 arrays as
        ``ml_dtypes`` bfloat16), or tensors (a device checkpoint's): a
        tensor already on the session's device is used as it is.
        """
        _score_sdt(score_dtype)
        buckets: dict[int, dict] = {}
        tail = {}
        for key, arr in arrays.items():
            if key in ("offsets", "hot_table"):
                continue
            if key in _TAIL_KEYS:
                tail[key] = session.put(arr)
                continue
            parts = key.split(".")
            if len(parts) != 3 or parts[0] != "buckets" \
                    or parts[2] not in _BUCKET_KEYS:
                raise ValueError(f"unknown state key {key!r}")
            buckets.setdefault(int(parts[1]), {})[parts[2]] = session.put(arr)
        if sorted(buckets) != list(range(len(buckets))) or not buckets:
            raise ValueError(
                f"bucket indices {sorted(buckets)} are not 0..n-1")
        for i, b in buckets.items():
            if "doc_ids" not in b or ("tokT" in b) != ("valT" in b) \
                    or ("hotT" in b) != ("hotLo" in b) \
                    or ("hotT" in b) != (hot_h > 0):
                raise ValueError(f"bucket {i} has keys {sorted(b)} "
                                 f"(hot_h={hot_h})")
        if tail and sorted(tail) != sorted(_TAIL_KEYS):
            raise ValueError(f"a tail tier needs all of {_TAIL_KEYS}, got "
                             f"{sorted(tail)}")
        hot_table = session.put(arrays["hot_table"]).to(torch.int32)
        engine = cls(
            buckets=[buckets[i] for i in range(len(buckets))],
            offsets=session.put(arrays["offsets"]).float(),
            hot_table=hot_table,
            hot_table_host=Session.get(hot_table),
            hot_h=hot_h,
            num_docs=num_docs,
            vocab_size=vocab_size,
            vocab=vocab,
            score_dtype=score_dtype,
            session=session,
            **tail,
            tail_cap=tail_cap if tail else 0,
        )
        fit_score_buffer_budget(engine)
        return engine

    # -- query path ----------------------------------------------------------

    def device_bytes(self) -> int:
        """Resident device footprint: every array the query step reads."""
        total = sum(t.nbytes for b in self.buckets for t in b.values())
        total += self.offsets.nbytes + self.hot_table.nbytes
        return total + sum(getattr(self, key).nbytes for key in _TAIL_KEYS
                           if getattr(self, key) is not None)

    @property
    def total_positions(self) -> int:
        """Doc rows over every bucket, pad rows included."""
        return sum(b["doc_ids"].shape[0] for b in self.buckets)

    @property
    def _tail(self) -> dict | None:
        if self.tail_docs is None:
            return None
        return {"docs": self.tail_docs, "vals": self.tail_vals,
                "toks": self.tail_toks, "rows": self.tail_rows,
                "gpos": self.tail_gpos}

    def plan_chunks(self, queries: np.ndarray,
                    weights: np.ndarray | None = None,
                    has_scan: bool | None = None, k: int | None = None):
        """Plan the dispatches of a query batch (``plan_query_dispatch``):
        ``(perm, chunks)``, ``perm`` the cold-width routing permutation
        of the rows (or None) and each chunk ``(cq, padded_ids,
        padded_weights, cold_padded, wc_padded)``.  A chunk holds at most
        ``chunk_queries`` rows, and few enough that its (Q, rows) f32
        base tiles and the tail tier's (Q, T*C*P) gather and sort
        transients fit the score-buffer budget: one bucket's tile on the
        per-bucket path, every bucket's under union selection (all bases
        are live at its selection).  ``k`` prices the routed DP's rows
        (``chunk_c0_units``).  Shared by the search paths and the
        benchmark's device-step timing."""
        if has_scan is None:
            has_scan = self.tail_docs is not None or any(
                "tokT" in b for b in self.buckets)
        rows = [b["doc_ids"].shape[0] for b in self.buckets]
        if self.union_select and self.tail_docs is None and len(rows) > 1:
            bytes_per_q = 4 * sum(rows)
        else:
            bytes_per_q = 4 * max(rows)
        if self.tail_docs is not None:
            c = self.tail_rows.shape[1]
            p = self.tail_docs.shape[1]
            t_pad = next_pow2_at_least(max(queries.shape[1], 8))
            bytes_per_q += 8 * t_pad * c * p * 4
        max_q = max(8, (self.score_buffer_budget // bytes_per_q) // 8 * 8)
        return plan_query_dispatch(
            queries, weights, hot_table_host=self.hot_table_host,
            hot_h=self.hot_h, has_scan=has_scan, route=self.route_cold,
            route_min_queries=self.route_min_queries,
            max_q=min(max_q, self.chunk_queries), c0_units=chunk_c0_units(k))

    def query_step(self, k: int, ids_only: bool = False):
        """The engine's query step at top ``k`` (``make_sparse_query_step``
        with its score dtype and union selection)."""
        return make_sparse_query_step(
            k, self.hot_h, ids_only=ids_only,
            score_dtype=_score_sdt(self.score_dtype),
            union_select=self.union_select)

    def _query_chunk(self, chunk: Chunk, k: int, ids_only: bool = False,
                     dmask=None):
        put = self.session.put_async
        opt = lambda x: None if x is None else put(x)  # noqa: E731
        return self.query_step(k, ids_only)(
            put(chunk.padded), self.buckets, self.offsets, self.hot_table,
            opt(chunk.wpadded), dmask, self._tail, opt(chunk.cold_padded),
            opt(chunk.wc_padded))

    def search(self, queries: np.ndarray, top_k: int = 100,
               weights: np.ndarray | None = None,
               doc_mask: np.ndarray | torch.Tensor | None = None,
               ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k search -> (docs (Q, k) int32, scores (Q, k) f32).

        ``weights`` (same shape as ``queries``, float) scales each token's
        contribution.  Long queries deduplicate to unique tokens x counts
        automatically (``dedup_queries``).  ``doc_mask`` ((num_docs,) bool,
        True = eligible) restricts results to a doc subset: ineligible docs
        drop to -inf before selection on the device, so the top k over the
        eligible set is exact; slots left when fewer than k docs are
        eligible come back as doc -1 / score 0.  Pass a tensor on the
        session's device to reuse an uploaded mask across calls.
        """
        return self._search_impl(queries, top_k, weights, False, doc_mask)

    def search_ids(self, queries: np.ndarray, top_k: int = 100,
                   weights: np.ndarray | None = None,
                   doc_mask: np.ndarray | torch.Tensor | None = None,
                   ) -> np.ndarray:
        """Rankings only: (Q, k) int32 doc ids.  Selection still runs in
        f32 on the device; the scores never leave it, which halves the
        result bytes.  (JAX's ``pack`` option, scores and ids fetched as
        one f32 array, works around a host round trip per fetch on its TPU
        link; it has no counterpart here, where each result starts its own
        non-blocking copy and one event covers a batch.)"""
        return self._search_impl(queries, top_k, weights, True, doc_mask)[0]

    def _prepare(self, queries, top_k: int, weights, doc_mask):
        """Validated ``(queries, weights, k, dmask)``; dmask is None when
        there is no mask or nothing to search."""
        queries, weights = validate_query_batch(queries, self.vocab_size,
                                                weights)
        if weights is not None and self.tail_docs is not None \
                and np.any(weights < 0):
            raise ValueError(
                "negative query weights are not supported with the tail "
                "tier enabled (tail_cap > 0): the exact-merge argument "
                "requires non-negative tail contributions")
        k = min(top_k, self.num_docs)
        dmask = None
        if doc_mask is not None and len(queries) and k > 0:
            dmask = prepare_doc_mask(doc_mask, self.num_docs, self.session)
        return queries, weights, k, dmask

    def _dispatch_batch(self, queries: np.ndarray, k: int, weights,
                        ids_only: bool, dmask):
        """Plan and enqueue one batch with no host sync: each chunk's
        results start their copy into pinned host memory, and one event
        recorded after the last marks them all fetched.  Returns
        ``(perm, futures, event)`` for ``_collect_batch``."""
        with span("plan.dedup"):
            queries, weights = maybe_dedup(queries, weights,
                                           self.dedup_queries,
                                           self.dedup_min_width)
        with span("plan.chunks"):
            perm, chunks = self.plan_chunks(queries, weights, k=k)
        futures = []
        for chunk in chunks:
            with span("step.launch"):
                res = self._query_chunk(chunk, k, ids_only, dmask)
            res = (res,) if ids_only else res
            with span("fetch.enqueue"):
                futures.append((chunk.cq,
                                [self.session.fetch_async(x) for x in res]))
        return perm, futures, self.session.record_event()

    @staticmethod
    def _collect_batch(perm, futures, event, ids_only: bool):
        """Wait for one dispatched batch's event and assemble its results
        in the caller's row order: ``(docs, scores)``, scores None with
        ``ids_only``."""
        with span("batch.wait"):
            if event is not None:
                event.synchronize()
        with span("batch.assemble"):
            docs = unpermute(perm, np.concatenate(
                [Session.get(res[-1])[:cq] for cq, res in futures]))
            if ids_only:
                return docs, None
            return docs, unpermute(perm, np.concatenate(
                [Session.get(res[0])[:cq] for cq, res in futures]))

    def _search_impl(self, queries, top_k: int, weights, ids_only: bool,
                     doc_mask):
        with span("search.call"):
            with span("search.prepare"):
                queries, weights, k, dmask = self._prepare(
                    queries, top_k, weights, doc_mask)
            if len(queries) == 0 or k <= 0:
                if ids_only:  # the (docs, None) convention of the hot path
                    return empty_results(len(queries), k,
                                         ids_only=True), None
                return empty_results(len(queries), k)
            with span("batch.dispatch", batch=0):
                dispatched = self._dispatch_batch(queries, k, weights,
                                                  ids_only, dmask)
            return self._collect_batch(*dispatched, ids_only)

    def search_pipelined(
        self, queries: np.ndarray, top_k: int = 100, batch: int = 512,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | torch.Tensor | None = None,
        ids_only: bool = False,
    ):
        """Large-batch search in batches of ``batch`` queries, double
        buffered: batch i+1 is dispatched before batch i is collected, so
        the host plans, launches and copies out one batch while the card
        computes the next.  The same contract as :meth:`search`; with
        ``ids_only`` it returns the ids alone, as :meth:`search_ids`."""
        with span("search.call"):
            with span("search.prepare"):
                queries, weights, k, dmask = self._prepare(
                    queries, top_k, weights, doc_mask)
            if len(queries) == 0 or k <= 0:
                return empty_results(len(queries), k, ids_only=ids_only)
            out_docs, out_scores = [], []
            pending = None
            for i in range(0, len(queries), batch):
                wb = None if weights is None else weights[i : i + batch]
                with span("batch.dispatch", batch=i // batch):
                    dispatched = self._dispatch_batch(
                        queries[i : i + batch], k, wb, ids_only, dmask)
                if pending is not None:
                    d, s = self._collect_batch(*pending, ids_only)
                    out_docs.append(d)
                    out_scores.append(s)
                pending = dispatched
            d, s = self._collect_batch(*pending, ids_only)
            out_docs.append(d)
            out_scores.append(s)
            with span("search.concat"):
                docs = np.concatenate(out_docs)
                if ids_only:
                    return docs
                return docs, np.concatenate(out_scores)

    def get_scores(self, query_ids) -> np.ndarray:
        """(num_docs,) f32 scores of one query (every doc ranked)."""
        ids = np.asarray(query_ids, dtype=np.int32).reshape(1, -1)
        docs, scores = self.search(ids, top_k=self.num_docs)
        out = np.zeros(self.num_docs, dtype=np.float32)
        out[docs[0]] = scores[0]
        return out
