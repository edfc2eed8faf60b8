"""Sparse engine (ELL + hot tier) — PyTorch counterpart of
``bm25_tpu/models/sparse.py``.

Tokens are split by document frequency into two tiers:

* **hot** (the top-H tokens by DF): a dense (H, rows) bf16 high + bf16
  residual pair per bucket, built on the device by kernel B2 from the hot
  postings, and scored by kernel B1's epilogue against per-query hot-token
  counts;
* **cold** (every other token): doc-major padded postings (ELL) in length
  buckets, stored slot-major and scored by B1's membership-count scan.

Per bucket, B1 writes the masked (Q, rows) base and its group maxima; the
tournament tree selects the bucket's top k from them; one two-key merge
(score descending, doc ascending) across buckets gives the result, and the
per-token offsets are added last.  Ties go to the smaller doc id: bucket
rows are in doc-id order and every merge is stable.

The host layout (``build_ell_buckets_from_csr``, ``split_hot_cold_csr``,
``hot_ell_for_rows``, ``_filter_csr``) is copied function for function from
the JAX package, which cannot be imported without JAX, so that both
engines build bit-equal arrays.  This engine serves queries, weighted or
not and of any width, through the ELL and hot tiers, with f32 or
bf16-rounded returned scores (``score_dtype``), a doc mask folded into
B1's pad-row mask, long-query dedup (``maybe_dedup``), rankings-only
search (``search_ids``) and a pipelined large-batch search
(``search_pipelined``); the tail tier, cold-width routing and the layout
cost model are ROADMAP items.
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
from bm25_tpu_torch.utils.padding import next_multiple, next_pow2_at_least
from bm25_tpu_torch.utils.validate import empty_results, validate_query_batch
from bm25_tpu_torch.ops.ell_score import (BLOCK_ROWS, GROUP, NEG_INF,
                                          ell_score, ell_score_fused,
                                          hot_plan, scan_table)
from bm25_tpu_torch.ops.topk import select_top_k, top_k_tree_with_maxes
from bm25_tpu_torch.runtime.session import Session, get_session
from bm25_tpu_torch.utils.counts import split_bf16, weighted_counts

logger = logging.getLogger(__name__)

PAD_TOK = -1  # never matches a query id (valid ids are >= 0)

# fraction of device memory usable by the resident index plus transient
# score tiles (the rest covers the allocator's and libraries' own needs)
_USABLE_HBM_FRACTION = 14 / 16
# bucket arrays a state dict may carry (see SparseEngine.from_arrays)
_BUCKET_KEYS = ("doc_ids", "tokT", "valT", "hotT", "hotLo")
# most queries per dispatched chunk
CHUNK_QUERIES = 512


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


def make_sparse_query_step(k: int, hot_h: int = 0, ids_only: bool = False,
                           score_dtype=None):
    """The query step over the ELL and hot tiers.

    ``step(ids, buckets, offsets, hot_table, w=None, mask=None) -> (scores
    (Q, k), docs (Q, k) int32)``, or the docs alone with ``ids_only`` (the
    scores never leave the device); ``buckets`` are dicts of ``doc_ids
    (rows,)`` and, where present, ``tokT``/``valT`` (L, rows) and
    ``hotT``/``hotLo`` (H, rows).  ``w`` (Q, T) f32 weights each query
    token: its offset, its hot count and its ELL matches.  ``mask``
    ((num_docs,) bool on the device, True = eligible) restricts the result
    to a doc subset: slots left when fewer than k docs are eligible come
    back as doc -1 / score 0.  ``score_dtype`` (a torch dtype or None for
    f32) is the type the returned scores are rounded to.
    """

    def step(ids, buckets, offsets, hot_table, w=None, mask=None):
        valid = ids >= 0
        safe = torch.where(valid, ids, 0).long()
        zero = torch.zeros((), dtype=offsets.dtype, device=offsets.device)
        if w is not None:
            w = torch.where(valid, w.float(), zero)
            qoff = (offsets[safe] * w).sum(dim=1)
        else:
            qoff = torch.where(valid, offsets[safe], zero).sum(dim=1)
        hot_counts = hot_lo = plan = None
        if hot_h:
            hot_counts, hot_lo = hot_counts_for(ids, hot_table, hot_h, w)
            plan = hot_plan(hot_counts, hot_lo)  # once for every bucket
        # the card's scan tables, once for every bucket (the CPU twins
        # read none)
        table = scan_table(ids, w) if ids.is_cuda else None

        cand_s, cand_i = [], []
        for b in buckets:
            did = b["doc_ids"]
            score_did = did
            if mask is not None:
                # ineligible rows fold into B1's pad-row mask through a
                # scoring-only copy of the bucket's doc ids (as JAX's
                # bucket_base_scores): base and group maxima come out
                # masked, eligible rows keep the unmasked bits, and the
                # candidates still take their ids from the real doc_ids
                elig = mask[did.clamp(min=0).long()] & (did >= 0)
                score_did = torch.where(elig, did, -1)
            rows_b = did.shape[0]
            base, gmax = ell_score_fused(
                ids, b.get("tokT"), b.get("valT"), score_did, hot_counts,
                b.get("hotT"), b.get("hotLo"), weights=w,
                hot_counts_lo=hot_lo, plan=plan, table=table,
            )
            kk = min(k, rows_b)
            if rows_b > max(2 * kk, 4096) and gmax.shape[1] >= kk:
                s, pos = top_k_tree_with_maxes(base, gmax, kk, branch=GROUP)
            else:
                s, pos = select_top_k(base, kk)
            del base, gmax  # free this bucket's tile before the next
            cand_s.append(s)
            cand_i.append(did[pos])

        cs = torch.cat(cand_s, dim=1)
        ci = torch.cat(cand_i, dim=1)
        kk = min(k, cs.shape[1])
        # two-key merge, score desc then doc asc, as two stable sorts:
        # by doc first, then by score (stability keeps doc order in ties)
        ci, order = torch.sort(ci, dim=1, stable=True)
        cs = torch.gather(cs, 1, order)
        neg, order = torch.sort(-cs, dim=1, stable=True)
        docs = torch.gather(ci, 1, order[:, :kk])
        ms = -neg[:, :kk]
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


class B1Bytes(NamedTuple):
    """The bytes kernel B1 must move on one bucket for one chunk."""

    scan: int  # ids (and weights), slot tokens, a value a matching slot,
    # the (Q, rows) base written once
    epilogue: int  # beyond the scan: the used hot rows (hi and lo), the
    # plan's counts, doc_ids, the group maxima (and the base where the
    # bucket has no slots)
    matched: int  # slots whose token is some query's cold id


def b1_bytes(engine: "SparseEngine", ids: torch.Tensor,
             w: torch.Tensor | None = None) -> list[B1Bytes]:
    """The least bytes B1 moves for one chunk of (Q, T) int32 ids (and
    optional weights) on the engine's device, one entry a bucket: each
    input read once and each output written once, counted from these ids
    (a slot's value is read only where its token is some query's cold id,
    a hot row only where some query counts its token).  The base never
    makes a trip between the scan and the hot epilogue.  Reads the used
    hot-token count back to the host."""
    q = ids.shape[0]
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    cold_any = torch.unique(ids[valid & (engine.hot_table[safe] < 0)])
    used = counts = 0
    if engine.hot_h:
        hc, hlo = hot_counts_for(ids, engine.hot_table, engine.hot_h, w)
        plan = hot_plan(hc, hlo)
        used = int(plan.n_used.item())
        counts = sum(_nbytes(c) for c in (plan.counts, plan.counts_lo)
                     if c is not None)
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
    on any shrink.  Only unweighted batches are deduplicated.
    """
    if weights is not None or not (
        dedup is True
        or (dedup == "auto" and queries.shape[1] >= min_width)
    ):
        return queries, weights
    ids_u, counts = dedup_query_rows(queries)
    t, t_u = queries.shape[1], ids_u.shape[1]
    if t_u < t and (dedup is True or 3 * t_u + 2 < 2 * t + 2):
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


def plan_query_dispatch(queries: np.ndarray, max_q: int,
                        weights: np.ndarray | None = None, q_align: int = 8,
                        ) -> list[tuple[int, np.ndarray, np.ndarray | None]]:
    """Cut a batch into ``max_q``-row chunks: ``(cq, padded_ids,
    padded_weights)`` with rows padded to ``q_align`` and width to a power
    of two >= 8 (-1 id pads, 0 weight pads; weights None if not given).

    The JAX planner's path without cold-width routing.
    """
    queries = queries.astype(np.int32)
    q_real, t_real = queries.shape
    t_pad = next_pow2_at_least(max(t_real, 8))
    chunks = []
    for i in range(0, q_real, max_q):
        chunk = queries[i : i + max_q]
        cq = len(chunk)
        q_pad = next_multiple(cq, q_align)
        padded = np.full((q_pad, t_pad), -1, dtype=np.int32)
        padded[:cq, :t_real] = chunk
        wpadded = None
        if weights is not None:
            wpadded = np.zeros((q_pad, t_pad), dtype=np.float32)
            wpadded[:cq, :t_real] = weights[i : i + max_q]
        chunks.append((cq, padded, wpadded))
    return chunks


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@dataclass
class SparseEngine:
    """Device-resident BM25 engine over ELL buckets plus a dense hot tier."""

    buckets: list  # dicts: doc_ids, [tokT (L, rows), valT, hotT, hotLo]
    offsets: torch.Tensor  # (V+1,) float32 token offsets
    hot_table: torch.Tensor  # (V+1,) int32 token id -> hot rank or -1
    hot_h: int
    num_docs: int
    vocab_size: int
    session: Session
    # cap on the transient (Q, rows) score tiles of one chunk; shrunk by
    # fit_score_buffer_budget when the index leaves less room
    score_buffer_budget: int = 4 << 30
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

    @classmethod
    def from_scored_index(
        cls,
        index: ScoredIndex,
        session: Session | None = None,
        max_buckets: int = 4,
        hot_tokens: int = 0,
        hot_budget_bytes: int | None = None,
        score_dtype: str = "float32",
    ) -> "SparseEngine":
        """Lay the index out on the session's device.

        ``hot_tokens`` is the requested hot-tier width H, capped by
        ``hot_budget_bytes`` (default: the raw CSC bytes) at 4 bytes per
        (token, doc) entry, and by the vocabulary.  The cost model that
        picks H and ``max_buckets`` in the JAX package was measured on a
        TPU and is not ported (ROADMAP.md: the H100 layout cost model), so H
        is always explicit here.
        ``score_dtype`` ("float32" or "bfloat16") is the type the returned
        scores are rounded to.
        """
        _score_sdt(score_dtype)  # validate early, at build time
        session = session or get_session()
        if isinstance(hot_tokens, str) or isinstance(hot_tokens, bool):
            raise NotImplementedError(
                f"hot_tokens={hot_tokens!r}: the layout cost model is not "
                "ported (ROADMAP.md: the H100 layout cost model); pass an "
                "integer"
            )
        if hot_tokens < 0:
            raise ValueError(f"hot_tokens must be >= 0, got {hot_tokens}")
        csc_bytes = (index.data.nbytes + index.indices.nbytes
                     + index.indptr.nbytes)
        budget = csc_bytes if hot_budget_bytes is None else hot_budget_bytes
        max_h = budget // max(index.num_docs * 4, 1)
        h = int(min(hot_tokens, max_h, index.vocab_size))
        if h < min(int(hot_tokens), index.vocab_size):
            logger.info("hot_tokens=%s clamped to %d (memory budget %d B)",
                        hot_tokens, h, budget)
        if h > 0:
            hot_ids, cold_csr, hot_csr = split_hot_cold_csr(index, h)
            h = len(hot_ids)
        else:
            hot_ids, hot_csr = np.zeros(0, np.int32), None
            cold_csr = index.to_csc().tocsr()

        if cold_csr.nnz > 0:
            host_buckets = build_ell_buckets_from_csr(
                cold_csr, index.num_docs, max_buckets=max_buckets,
                row_align=BLOCK_ROWS,
            )
        else:
            # no cold tier: one identity bucket (original doc order)
            # carrying only the hot matrix
            n_pad = next_multiple(max(index.num_docs, 1), BLOCK_ROWS)
            doc_ids = np.full(n_pad, -1, dtype=np.int32)
            doc_ids[: index.num_docs] = np.arange(index.num_docs,
                                                  dtype=np.int32)
            host_buckets = [EllBucket(tok=None, val=None, doc_ids=doc_ids,
                                      num_real=index.num_docs)]

        v = index.vocab_size
        hot_table = np.full((v + 1,), -1, dtype=np.int32)
        if h > 0:
            hot_table[hot_ids] = np.arange(h, dtype=np.int32)
            hot_ids_dev = session.put(hot_ids.reshape(-1, 1))

        dev_buckets = []
        for b in host_buckets:
            entry = {"doc_ids": session.put(b.doc_ids)}
            if b.tok is not None:
                l_pad = next_multiple(b.tok.shape[1], 8)
                tok_t = np.full((l_pad, b.tok.shape[0]), PAD_TOK,
                                dtype=np.int32)
                tok_t[: b.tok.shape[1]] = b.tok.T
                val_t = np.zeros((l_pad, b.val.shape[0]), dtype=np.float32)
                val_t[: b.val.shape[1]] = b.val.T
                entry["tokT"] = session.put(tok_t)
                entry["valT"] = session.put(val_t)
            if h > 0:
                # the hot (H, rows) pair in this bucket's row order, built
                # on the device from the sparse hot postings
                htok, hval = hot_ell_for_rows(hot_csr, b.doc_ids)
                entry["hotT"], entry["hotLo"] = build_hot_pair_device(
                    hot_ids_dev, session.put(htok), session.put(hval))
            dev_buckets.append(entry)

        off_host = np.zeros((v + 1,), dtype=np.float32)
        if index.token_offsets is not None:
            off_host[:v] = index.token_offsets
        engine = cls(
            buckets=dev_buckets,
            offsets=session.put(off_host),
            hot_table=session.put(hot_table),
            hot_h=h,
            num_docs=index.num_docs,
            vocab_size=v,
            session=session,
            score_dtype=score_dtype,
            vocab=index.vocab,
        )
        fit_score_buffer_budget(engine)
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
    ) -> "SparseEngine":
        """An engine from host copies of another engine's device arrays.

        Keys: ``"offsets"``, ``"hot_table"`` and ``"buckets.<i>.<name>"``
        with ``<name>`` one of doc_ids, tokT, valT, hotT, hotLo — e.g. the
        numpy copies of a JAX ``SparseEngine``'s ``buckets[i][name]``
        (bf16 arrays as ``ml_dtypes`` bfloat16).
        """
        buckets: dict[int, dict] = {}
        for key, arr in arrays.items():
            if key in ("offsets", "hot_table"):
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
        engine = cls(
            buckets=[buckets[i] for i in range(len(buckets))],
            offsets=session.put(np.asarray(arrays["offsets"], np.float32)),
            hot_table=session.put(np.asarray(arrays["hot_table"], np.int32)),
            hot_h=hot_h,
            num_docs=num_docs,
            vocab_size=vocab_size,
            session=session,
        )
        fit_score_buffer_budget(engine)
        return engine

    # -- query path ----------------------------------------------------------

    def device_bytes(self) -> int:
        """Resident device footprint: every array the query step reads."""
        total = sum(t.nbytes for b in self.buckets for t in b.values())
        return total + self.offsets.nbytes + self.hot_table.nbytes

    def plan_chunks(self, queries: np.ndarray,
                    weights: np.ndarray | None = None):
        """Chunks small enough that one bucket's (Q, rows) f32 base tile
        fits the score-buffer budget, at most CHUNK_QUERIES rows:
        ``(cq, padded_ids, padded_weights or None)``."""
        base_rows = max(b["doc_ids"].shape[0] for b in self.buckets)
        max_q = max(8, (self.score_buffer_budget // (4 * base_rows)) // 8 * 8)
        return plan_query_dispatch(queries, min(max_q, CHUNK_QUERIES),
                                   weights)

    def _query_chunk(self, padded: np.ndarray, wpadded, k: int,
                     ids_only: bool = False, dmask=None):
        step = make_sparse_query_step(k, self.hot_h, ids_only=ids_only,
                                      score_dtype=_score_sdt(self.score_dtype))
        w = None if wpadded is None else self.session.put_async(wpadded)
        return step(self.session.put_async(padded), self.buckets,
                    self.offsets, self.hot_table, w, dmask)

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
        ``(futures, event)`` for ``_collect_batch``."""
        queries, weights = maybe_dedup(queries, weights, self.dedup_queries,
                                       self.dedup_min_width)
        futures = []
        for cq, padded, wpadded in self.plan_chunks(queries, weights):
            res = self._query_chunk(padded, wpadded, k, ids_only, dmask)
            res = (res,) if ids_only else res
            futures.append((cq, [self.session.fetch_async(x) for x in res]))
        return futures, self.session.record_event()

    @staticmethod
    def _collect_batch(futures, event, ids_only: bool):
        """Wait for one dispatched batch's event and assemble its results:
        ``(docs, scores)``, scores None with ``ids_only``."""
        if event is not None:
            event.synchronize()
        docs = np.concatenate([Session.get(res[-1])[:cq]
                               for cq, res in futures])
        if ids_only:
            return docs, None
        return docs, np.concatenate([Session.get(res[0])[:cq]
                                     for cq, res in futures])

    def _search_impl(self, queries, top_k: int, weights, ids_only: bool,
                     doc_mask):
        queries, weights, k, dmask = self._prepare(queries, top_k, weights,
                                                   doc_mask)
        if len(queries) == 0 or k <= 0:
            if ids_only:  # the (docs, None) convention of the hot path
                return empty_results(len(queries), k, ids_only=True), None
            return empty_results(len(queries), k)
        return self._collect_batch(
            *self._dispatch_batch(queries, k, weights, ids_only, dmask),
            ids_only)

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
        queries, weights, k, dmask = self._prepare(queries, top_k, weights,
                                                   doc_mask)
        if len(queries) == 0 or k <= 0:
            return empty_results(len(queries), k, ids_only=ids_only)
        out_docs, out_scores = [], []
        pending = None
        for i in range(0, len(queries), batch):
            wb = None if weights is None else weights[i : i + batch]
            dispatched = self._dispatch_batch(queries[i : i + batch], k, wb,
                                              ids_only, dmask)
            if pending is not None:
                d, s = self._collect_batch(*pending, ids_only)
                out_docs.append(d)
                out_scores.append(s)
            pending = dispatched
        d, s = self._collect_batch(*pending, ids_only)
        out_docs.append(d)
        out_scores.append(s)
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
