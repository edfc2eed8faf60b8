"""CPU reference engine (scipy CSC) — search-semantics oracle and bench baseline.

Re-implements, from its observable behaviour, the reference's sparse scorer
``BM25v`` (``reference/bm25_native.py:32-214``):

* index = pre-scored doc x token ``scipy.sparse.csc_matrix`` + doc lengths,
* ``search(queries[Q,T] int32, top_k)``: negative token ids are padding and
  are dropped per query (``bm25_native.py:151``), scores = sum of gathered
  CSC columns, top-k via argpartition + descending sort of the k slice
  (``bm25_native.py:204-214``),
* token-id bounds check against the vocab size (``bm25_native.py:116-121``).

Tie-breaking contract (stricter than the reference, which inherits numpy
argpartition's arbitrary order): among equal scores the smaller doc id wins,
matching the stability fixup of the reference's CPU top-k kernel
(``reference/operations/topk.mojo:234-258``).  All device engines are
tested against this oracle.  The port's copy of ``bm25_tpu/reference.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .scoring import BM25Params, ScoredIndex, build_scored_index
from .utils.validate import empty_results, validate_query_batch


def topk_descending(scores: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k (indices, values) sorted by descending value, ties -> smaller index.

    Semantics of ``_topk`` (``reference/bm25_native.py:204-214``) plus
    the deterministic tie order of ``_top_k_cpu``
    (``reference/operations/topk.mojo:234-258``).
    """
    n = scores.shape[-1]
    k = min(k, n)
    if k <= 0:
        # argpartition(-0)[-0:] selects EVERYTHING; k=0 must return empty
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    if k == n:
        idx = np.arange(n)
    else:
        # argpartition alone is tie-unstable at the k-th boundary: tied
        # candidates with smaller indices can be left outside the partition.
        # Rebuild the candidate set exactly: everything strictly above the
        # threshold, then the smallest-index ties at the threshold.
        part = np.argpartition(scores, -k)[-k:]
        kth_val = scores[part].min()
        above = np.flatnonzero(scores > kth_val)
        ties = np.flatnonzero(scores == kth_val)
        idx = np.concatenate([above, ties[: k - len(above)]])
    # stable two-key sort: primary score desc, secondary index asc
    order = np.lexsort((idx, -scores[idx]))
    idx = idx[order]
    return idx.astype(np.int32), scores[idx].astype(np.float32)


class ReferenceEngine:
    """Host scipy-CSC BM25 engine with BM25v-compatible API."""

    def __init__(self, k1: float = 1.5, b: float = 0.75):
        self.params = BM25Params(k1=k1, b=b)
        self.doc_toks: sp.csc_matrix | None = None
        self.doc_lengths = np.zeros((0,), dtype=np.int32)
        self.token_offsets: np.ndarray | None = None
        self.num_docs = 0

    # -- BM25v-compatible API ------------------------------------------------

    def index(self, doc_toks: sp.csc_matrix, doc_lengths: np.ndarray) -> None:
        """Index a pre-scored doc x token CSC matrix (bm25_native.py:59-74)."""
        self.doc_toks = doc_toks.tocsc()
        self.doc_toks.sort_indices()
        self.doc_lengths = np.asarray(doc_lengths)
        self.num_docs = doc_toks.shape[0]
        # a re-index replaces the matrix; offsets from a previous
        # from_scored_index belong to the OLD vocab and would corrupt
        # every score (from_scored_index re-sets them after this call)
        self.token_offsets = None

    @classmethod
    def from_scored_index(cls, idx: ScoredIndex) -> "ReferenceEngine":
        eng = cls(k1=idx.params.k1, b=idx.params.b)
        eng.params = idx.params
        eng.index(idx.to_csc(), idx.doc_lengths)
        eng.token_offsets = idx.token_offsets
        return eng

    @classmethod
    def fit(cls, doc_token_ids: list[np.ndarray], vocab_size: int | None = None,
            params: BM25Params | None = None) -> "ReferenceEngine":
        return cls.from_scored_index(
            build_scored_index(doc_token_ids, vocab_size=vocab_size, params=params)
        )

    @property
    def avg_doc_length(self) -> float:
        return float(np.mean(self.doc_lengths)) if self.num_docs else 0.0

    def search(
        self, queries: np.ndarray, top_k: int = 100,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k search over padded query-token-id rows.

        Args:
            queries: (Q, T) int32; negative entries are padding/OOV.
            top_k: number of results per query.
            weights: optional (Q, T) float per-token weights (pad entries
                ignored); scores become weighted column sums.
            doc_mask: optional (num_docs,) bool, True = eligible (filtered
                search); slots beyond the eligible count come back as
                doc -1 / score 0.

        Returns:
            (top_docs (Q, k) int32, top_scores (Q, k) float32), each row sorted
            by descending score.
        """
        if self.doc_toks is None:
            raise ValueError("index not built; call index() first")
        queries, weights = validate_query_batch(
            queries, self.doc_toks.shape[1], weights,
            weights_dtype=np.float64,
        )
        if doc_mask is not None:
            doc_mask = np.asarray(doc_mask).astype(bool)
            if doc_mask.shape != (self.num_docs,):
                raise ValueError(
                    f"doc_mask shape {doc_mask.shape} != ({self.num_docs},)"
                )
        k = min(top_k, self.num_docs)
        if len(queries) == 0 or k <= 0:
            return empty_results(len(queries), k)
        top_docs = np.zeros((queries.shape[0], k), dtype=np.int32)
        top_scores = np.zeros((queries.shape[0], k), dtype=np.float32)
        for i in range(len(queries)):
            q = queries[i]
            keep = q >= 0
            q = q[keep]
            if weights is None:
                scores = np.asarray(self.doc_toks[:, q].sum(axis=1)).ravel()
                if self.token_offsets is not None and len(q):
                    scores = scores + float(self.token_offsets[q].sum())
            else:
                w = weights[i][keep]
                scores = np.asarray(self.doc_toks[:, q] @ w).ravel()
                if self.token_offsets is not None and len(q):
                    scores = scores + float(self.token_offsets[q] @ w)
            scores = scores.astype(np.float32)
            if doc_mask is not None:
                scores = np.where(doc_mask, scores, -np.inf)
            top_docs[i], top_scores[i] = topk_descending(scores, k)
        if doc_mask is not None:
            # slots beyond the eligible count: doc -1 / score 0 (matches
            # the device engines' filtered-search contract)
            bad = ~np.isfinite(top_scores)
            top_docs[bad] = -1
            top_scores[bad] = 0.0
        return top_docs, top_scores

    def get_scores(self, query_ids: np.ndarray) -> np.ndarray:
        """Dense per-doc scores for one query (list/array of token ids)."""
        if self.doc_toks is None:
            raise ValueError("index not built; call index() first")
        q = np.asarray(query_ids)
        q = q[q >= 0]
        scores = np.asarray(self.doc_toks[:, q].sum(axis=1)).ravel()
        if self.token_offsets is not None and len(q):
            scores = scores + float(self.token_offsets[q].sum())
        return scores.astype(np.float32)
