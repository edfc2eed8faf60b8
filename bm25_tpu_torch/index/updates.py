"""Incremental index updates: delta segment + tombstones + compaction.

The reference (and bm25s, whose on-disk format we share) is build-once:
changing the corpus means a full refit (``reference/bm25_test.py:22-35``
rebuilds from scratch).  A serving deployment needs live mutation, so this
module adds the segment architecture search engines use for it (Lucene-style):

* the **base segment** is the existing device engine, frozen with the corpus
  statistics (N, avgdl, df) captured at its build;
* **added docs** land in a small host-side :class:`DeltaSegment`, scored with
  the SAME frozen statistics snapshot, so base and delta scores are mutually
  consistent and merge exactly;
* **deletes** are tombstones — filtered out of results at query time (the
  base engine over-fetches just enough to stay exact);
* :func:`UpdatableEngine.search` merges base and delta candidates with the
  library-wide tie contract (equal scores -> smaller doc id);
* **compaction** rebuilds one fresh base segment from the live corpus,
  restoring true current-corpus statistics, and reports the doc-id remap.

Score semantics contract: between compactions every score is exactly what a
full build over the *base-snapshot* corpus statistics would produce (new
terms, absent from the snapshot, use their delta document frequency).  BM25
scores of existing docs legitimately shift when N/avgdl/df change; deferring
that shift to compaction is the standard trade (precomputed-score engines
cannot cheaply rescore 10^8 postings per added doc).  ``compact()`` makes
scores exact for the current corpus again — bit-identical to a fresh build.

Thread safety: mutators swap one immutable snapshot reference; ``search``
reads it once.  Concurrent searches during an ``add``/``delete`` see either
the old or the new corpus, never a mix.

The port's copy of ``bm25_tpu/index/updates.py``: host numpy/scipy over
the port's engines, and the same update-log format on disk, so a log
either package wrote replays in the other.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from bm25_tpu_torch.scoring import (
    BM25Params,
    ScoredIndex,
    idf,
    tf_saturation,
    zero_tf_offset,
)
from bm25_tpu_torch.utils.validate import validate_query_batch


def _round_up_k(extra: int, quantum: int = 64) -> int:
    """Over-fetch amount rounded up so tombstone count changes don't mint a
    new compiled top-k shape on every delete (bounded shape family)."""
    if extra <= 0:
        return 0
    return -(-extra // quantum) * quantum


@dataclass(frozen=True)
class StatsSnapshot:
    """Frozen corpus statistics the base segment was scored with."""

    num_docs: int
    avgdl: float
    df: np.ndarray  # (V0,) document frequencies at snapshot time
    params: BM25Params

    @classmethod
    def from_index(cls, index: ScoredIndex) -> "StatsSnapshot":
        return cls(
            num_docs=index.num_docs,
            avgdl=index.avgdl,
            df=index.df(),
            params=index.params,
        )


class DeltaSegment:
    """Host-scored segment of recently added docs (frozen-stats scoring).

    LSM-style layout so ``add`` cost does not grow with the delta size
    (a naive full rebuild measured ~3 s/add at the 50K-doc compaction
    cap): snapshot-era terms' IDF is FROZEN, so each add batch's postings
    for them become an immutable pre-scored block, merged geometrically
    (amortized O(nnz log n) total, O(log n) blocks).  Only post-snapshot
    terms' df legitimately grows as docs arrive — their postings live in
    one small matrix rebuilt per add over new-term nnz only.

    Scoring keeps the per-nnz f32 rounding points of
    ``build_scored_index_flat`` (scoring.py), so a delta doc identical to
    a base doc scores identically; per-doc accumulation groups
    snapshot-era terms before new terms (the same tier-order summation
    the device engines use across hot/cold/tail).
    """

    def __init__(self, stats: StatsSnapshot, vocab_size: int):
        self.stats = stats
        self.base_vocab_size = vocab_size
        self.doc_token_ids: list[np.ndarray] = []
        self.vocab_size = vocab_size
        # snapshot-era terms: immutable pre-scored blocks (frozen idf)
        self._blocks: list[sp.csc_matrix] = []   # each (rows_b, base_vocab)
        self._block_starts: list[int] = []       # row offset per block
        self._idf_old: np.ndarray | None = None  # (base_vocab,) frozen
        # new terms (id >= base_vocab): COO postings accumulated per add
        # batch + one small matrix rebuilt per add (df grows with the
        # delta); per-batch arrays keep add cost O(new-term nnz), not O(m)
        self._new_rows: list[np.ndarray] = []    # per batch: doc indices
        self._new_cols: list[np.ndarray] = []    # per batch: ids - bv
        self._dl: list[int] = []                 # full doc lengths
        self._new_csc: sp.csc_matrix | None = None  # (m, v - base_vocab)
        self._token_offsets: np.ndarray | None = None  # (vocab,) idf*base

    def __len__(self) -> int:
        return len(self.doc_token_ids)

    def clone(self) -> "DeltaSegment":
        """Copy for copy-on-write mutation: concurrent readers keep scoring
        the old segment while ``add`` updates the new one (the _State swap
        is what publishes it — mutating a published segment in place would
        let ``score_all`` see the grown ``vocab_size`` next to the old,
        narrower matrices and index out of bounds).  Blocks are immutable,
        so the copy shares them."""
        c = DeltaSegment(self.stats, self.base_vocab_size)
        c.doc_token_ids = list(self.doc_token_ids)
        c.vocab_size = self.vocab_size
        c._blocks = list(self._blocks)
        c._block_starts = list(self._block_starts)
        c._idf_old = self._idf_old
        c._new_rows = list(self._new_rows)
        c._new_cols = list(self._new_cols)
        c._dl = list(self._dl)
        c._new_csc = self._new_csc
        c._token_offsets = self._token_offsets
        return c

    def add(self, doc_token_ids: list[np.ndarray]) -> None:
        batch = [np.asarray(t, dtype=np.int32) for t in doc_token_ids]
        row0 = len(self.doc_token_ids)
        self.doc_token_ids.extend(batch)
        for t in batch:
            if len(t):
                self.vocab_size = max(self.vocab_size, int(t.max()) + 1)
        self._dl.extend(len(t) for t in batch)
        bv = self.base_vocab_size
        rows, cols = [], []
        for j, t in enumerate(batch):
            new = t[t >= bv]
            if len(new):
                rows.append(np.full(len(new), row0 + j, dtype=np.int64))
                cols.append((new - bv).astype(np.int64))
        if rows:
            self._new_rows.append(np.concatenate(rows))
            self._new_cols.append(np.concatenate(cols))
        self._append_old_block(batch)
        self._rebuild_new()

    def _dl_norm(self, dl: np.ndarray) -> np.ndarray:
        params, avgdl = self.stats.params, self.stats.avgdl
        if avgdl > 0:
            return (1.0 - params.b + params.b
                    * (dl.astype(np.float64) / avgdl)).astype(np.float32)
        return np.full(len(dl), 1.0 - params.b, dtype=np.float32)

    def _transform(self, tf_mat: sp.csc_matrix, dl: np.ndarray,
                   idf_vec: np.ndarray) -> sp.csc_matrix:
        """tf -> pre-scored values at the SAME f32 rounding points as
        build_scored_index_flat (scoring.py) for bitwise consistency."""
        params = self.stats.params
        v = tf_mat.shape[1]
        dl_norm = self._dl_norm(dl)
        col_of = np.repeat(
            np.arange(v, dtype=np.int64), np.diff(tf_mat.indptr)
        )
        row_of = tf_mat.indices
        sat = tf_saturation(
            params.method, tf_mat.data, dl_norm[row_of],
            np.float32(params.k1), np.float32(params.delta),
        )
        base = np.float32(zero_tf_offset(params.method, params.k1,
                                         params.delta))
        return sp.csc_matrix(
            ((idf_vec[col_of] * (sat - base)).astype(np.float32),
             tf_mat.indices, tf_mat.indptr),
            shape=tf_mat.shape,
        )

    @staticmethod
    def _tf_matrix(per_doc: list[np.ndarray], v: int) -> sp.csc_matrix:
        dl = np.array([len(t) for t in per_doc], dtype=np.int64)
        flat = (np.concatenate(per_doc) if per_doc
                else np.zeros(0, np.int32))
        rows = np.repeat(np.arange(len(per_doc), dtype=np.int64), dl)
        tf_mat = sp.csc_matrix(
            (np.ones(len(flat), np.float32), (rows, flat)),
            shape=(len(per_doc), v),
        )
        tf_mat.sum_duplicates()
        tf_mat.sort_indices()
        return tf_mat

    def _append_old_block(self, batch: list[np.ndarray]) -> None:
        stats, params = self.stats, self.stats.params
        bv = self.base_vocab_size
        if self._idf_old is None:
            df_old = np.zeros(bv, dtype=np.int64)
            v0 = min(len(stats.df), bv)
            df_old[:v0] = stats.df[:v0]
            self._idf_old = idf(
                params.effective_idf_method, stats.num_docs, df_old
            ).astype(np.float32)
        # full doc lengths (dl_norm counts new-term occurrences too)
        dl = np.array([len(t) for t in batch], dtype=np.int32)
        tf_mat = self._tf_matrix([t[t < bv] for t in batch], bv)
        blk = self._transform(tf_mat, dl, self._idf_old)
        self._blocks.append(blk)
        # geometric merge keeps the block count O(log n); values are
        # final (frozen idf), so a merge is a pure row concatenation
        while (len(self._blocks) >= 2
               and self._blocks[-1].shape[0] >= self._blocks[-2].shape[0]):
            b = self._blocks.pop()
            a = self._blocks.pop()
            self._blocks.append(sp.vstack([a, b], format="csc"))
        starts, s = [], 0
        for blk in self._blocks:
            starts.append(s)
            s += blk.shape[0]
        self._block_starts = starts

    def _rebuild_new(self) -> None:
        stats, params = self.stats, self.stats.params
        bv = self.base_vocab_size
        v_new = self.vocab_size - bv
        base = np.float32(zero_tf_offset(params.method, params.k1,
                                         params.delta))
        offs_old = (
            (self._idf_old * base).astype(np.float32) if base != 0.0
            else np.zeros(bv, dtype=np.float32)
        )
        if v_new <= 0:
            self._new_csc = None
            self._token_offsets = offs_old
            return
        m = len(self.doc_token_ids)
        dl = np.asarray(self._dl, dtype=np.int32)
        rows = (np.concatenate(self._new_rows) if self._new_rows
                else np.zeros(0, np.int64))
        cols = (np.concatenate(self._new_cols) if self._new_cols
                else np.zeros(0, np.int64))
        tf_mat = sp.csc_matrix(
            (np.ones(len(rows), np.float32), (rows, cols)),
            shape=(m, v_new),
        )
        tf_mat.sum_duplicates()
        tf_mat.sort_indices()
        # new terms did not exist at snapshot time: their df is the delta
        # document frequency, growing as docs arrive
        df_new = np.diff(tf_mat.indptr)
        idf_new = idf(
            params.effective_idf_method, stats.num_docs, df_new
        ).astype(np.float32)
        self._new_csc = self._transform(tf_mat, dl, idf_new)
        offs_new = (
            (idf_new * base).astype(np.float32) if base != 0.0
            else np.zeros(v_new, dtype=np.float32)
        )
        self._token_offsets = np.concatenate([offs_old, offs_new])

    def score_all(
        self, queries: np.ndarray, weights: np.ndarray | None = None
    ) -> np.ndarray:
        """(Q, M) dense scores of every delta doc for every query row."""
        m = len(self.doc_token_ids)
        q_n = len(queries)
        out = np.zeros((q_n, m), dtype=np.float32)
        if m == 0 or q_n == 0:
            return out
        bv = self.base_vocab_size
        offs = self._token_offsets
        for i in range(q_n):
            q = queries[i]
            keep = (q >= 0) & (q < self.vocab_size)
            q_i = q[keep]
            if not len(q_i):
                continue
            w = (None if weights is None
                 else weights[i][keep].astype(np.float64))
            is_new = q_i >= bv
            q_old = q_i[~is_new]
            if len(q_old):
                w_old = None if w is None else w[~is_new]
                for start, blk in zip(self._block_starts, self._blocks):
                    sl = slice(start, start + blk.shape[0])
                    if w is None:
                        out[i, sl] += np.asarray(
                            blk[:, q_old].sum(axis=1)
                        ).ravel()
                    else:
                        out[i, sl] += np.asarray(
                            blk[:, q_old] @ w_old
                        ).ravel()
            if is_new.any() and self._new_csc is not None:
                qn = q_i[is_new] - bv
                if w is None:
                    out[i] += np.asarray(
                        self._new_csc[:, qn].sum(axis=1)
                    ).ravel()
                else:
                    out[i] += np.asarray(
                        self._new_csc[:, qn] @ w[is_new]
                    ).ravel()
            # zero-tf offsets (bm25l/bm25+): doc-independent constants
            if w is None:
                out[i] += np.float32(offs[q_i].sum())
            else:
                out[i] += np.float32(offs[q_i] @ w)
        return out


@dataclass(frozen=True)
class _State:
    """One immutable corpus snapshot; ``search`` reads a single reference."""

    delta: DeltaSegment | None
    tombs: np.ndarray  # bool (num_docs_total,)
    tomb_base: int     # tombstones among base docs
    tomb_delta: int
    num_total: int


class UpdatableEngine:
    """Mutable-corpus facade over a frozen device engine (engine-level API).

    Wraps any of the port's engines: ``search``/``search_ids`` take
    the usual (Q, T) padded token-id matrices and return global doc ids —
    base docs keep their build-time ids, added docs number onward from
    ``base_num_docs``.  See the module docstring for the score-consistency
    contract.
    """

    def __init__(self, base_engine, base_index: ScoredIndex):
        self.base = base_engine
        self.base_num_docs = int(base_index.num_docs)
        if self.base_num_docs == 0:
            raise ValueError(
                "base engine has no documents; build the initial index "
                "with at least one doc (stats snapshots need a corpus)"
            )
        self.base_vocab_size = int(base_index.vocab_size)
        self.stats = StatsSnapshot.from_index(base_index)
        self._lock = threading.Lock()
        self._state = _State(
            delta=None,
            tombs=np.zeros(self.base_num_docs, dtype=bool),
            tomb_base=0, tomb_delta=0,
            num_total=self.base_num_docs,
        )

    # -- introspection ------------------------------------------------------

    @property
    def num_docs(self) -> int:
        """Total addressable doc ids (live + tombstoned)."""
        return self._state.num_total

    @property
    def live_docs(self) -> int:
        st = self._state
        return st.num_total - st.tomb_base - st.tomb_delta

    @property
    def delta_docs(self) -> int:
        st = self._state
        return 0 if st.delta is None else len(st.delta)

    @property
    def deleted_docs(self) -> int:
        st = self._state
        return st.tomb_base + st.tomb_delta

    @property
    def vocab_size(self) -> int:
        st = self._state
        return (self.base_vocab_size if st.delta is None
                else st.delta.vocab_size)

    # -- mutation -----------------------------------------------------------

    def add(self, doc_token_ids: list[np.ndarray]) -> np.ndarray:
        """Append docs (per-doc token-id arrays); returns their global ids."""
        with self._lock:
            st = self._state
            delta = (st.delta.clone() if st.delta is not None
                     else DeltaSegment(self.stats, self.base_vocab_size))
            start = self.base_num_docs + len(delta)
            delta.add(doc_token_ids)
            new_total = self.base_num_docs + len(delta)
            tombs = np.zeros(new_total, dtype=bool)
            tombs[: len(st.tombs)] = st.tombs
            self._state = _State(
                delta=delta, tombs=tombs,
                tomb_base=st.tomb_base, tomb_delta=st.tomb_delta,
                num_total=new_total,
            )
            return np.arange(start, start + len(doc_token_ids),
                             dtype=np.int64)

    def delete(self, doc_ids) -> int:
        """Tombstone global doc ids; returns how many were newly deleted."""
        ids = np.atleast_1d(np.asarray(doc_ids, dtype=np.int64))
        with self._lock:
            st = self._state
            if ids.size and (
                int(ids.min()) < 0 or int(ids.max()) >= st.num_total
            ):
                raise ValueError(
                    f"doc id out of range [0, {st.num_total}) in delete"
                )
            tombs = st.tombs.copy()
            before = int(tombs.sum())
            tombs[ids] = True
            newly = int(tombs.sum()) - before
            self._state = _State(
                delta=st.delta, tombs=tombs,
                tomb_base=int(tombs[: self.base_num_docs].sum()),
                tomb_delta=int(tombs[self.base_num_docs:].sum()),
                num_total=st.num_total,
            )
            return newly

    # -- search -------------------------------------------------------------

    def search(
        self, queries: np.ndarray, top_k: int = 100,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k over the LIVE corpus (tombstones never returned).

        ``doc_mask`` ((num_docs,) bool over GLOBAL ids, True = eligible)
        composes with tombstones: the base engine masks on device, delta
        docs filter in the merge; shortfall slots are doc -1 / score 0
        (the engines' shared filtered-search contract).
        """
        st = self._state  # one snapshot: delta + tombs stay coherent
        vmax = (self.base_vocab_size if st.delta is None
                else st.delta.vocab_size)
        # oov="clamp": under concurrent updates the searchable vocab can
        # lag a racing add's tokenization (the retriever grows the shared
        # vocab before the engine publishes), and a FAILED add leaves the
        # grown terms behind permanently — both must score as OOV (zero),
        # not raise
        queries, weights = validate_query_batch(queries, vmax, weights,
                                                oov="clamp")
        if doc_mask is not None:
            doc_mask = np.asarray(doc_mask).astype(bool)
            if (doc_mask.ndim != 1 or doc_mask.shape[0] > st.num_total
                    or doc_mask.shape[0] < self.base_num_docs):
                # any mask built against THIS engine generation is at
                # least base-length; shorter means a stale/mismatched
                # mask, not the concurrent-add race — reject loudly
                # rather than return silently-empty results
                raise ValueError(
                    f"doc_mask shape {doc_mask.shape} != ({st.num_total},) "
                    "(current base + delta doc count)"
                )
            if doc_mask.shape[0] < st.num_total:
                # a mask built from a num_docs snapshot that a concurrent
                # add outgrew (bounded by the delta size): docs newer than
                # the snapshot are simply ineligible (the same tolerance
                # the serving layer gives racing queries' grown-vocab ids)
                doc_mask = np.pad(
                    doc_mask, (0, st.num_total - doc_mask.shape[0])
                )
        q_n = len(queries)
        live = st.num_total - st.tomb_base - st.tomb_delta
        k = min(top_k, live)
        if q_n == 0 or k <= 0:
            return (np.zeros((q_n, max(k, 0)), np.int32),
                    np.zeros((q_n, max(k, 0)), np.float32))

        # base candidates: strip post-snapshot token ids (the base engine
        # has no postings for them; they still score in the delta), and
        # over-fetch by the (shape-quantized) base tombstone count so the
        # top k live base docs are always inside the candidate set
        base_q = queries
        stripped = None
        if queries.size and int(queries.max()) >= self.base_vocab_size:
            stripped = queries >= self.base_vocab_size
            base_q = np.where(stripped, np.int32(-1), queries)
        k_base = min(k + _round_up_k(st.tomb_base), self.base_num_docs)
        base_kw = {}
        if doc_mask is not None:
            base_kw["doc_mask"] = doc_mask[: self.base_num_docs]
        docs_b, scores_b = self.base.search(base_q, top_k=k_base,
                                            weights=weights, **base_kw)
        docs_b = np.asarray(docs_b, dtype=np.int64)
        scores_b = np.asarray(scores_b, dtype=np.float32)
        if stripped is not None and st.delta is not None:
            # token offsets (bm25l/bm25+ nonoccurrence term) are
            # doc-independent: the delta adds them for new terms, so base
            # rows need the same constant or cross-segment order skews
            offs = st.delta._token_offsets
            per_tok = offs[np.where(stripped, queries, 0)] * stripped
            if weights is not None:
                per_tok = per_tok * weights
            corr = per_tok.sum(axis=1, dtype=np.float64).astype(np.float32)
            scores_b = scores_b + corr[:, None]

        if st.delta is None or len(st.delta) == 0:
            if st.tomb_base == 0 and doc_mask is None:
                return docs_b[:, :k].astype(np.int32), scores_b[:, :k]
            return self._filter_merge(
                docs_b, scores_b, None, None, st.tombs, k, elig=doc_mask
            )

        # delta candidates: score EVERY delta doc (the segment is small by
        # contract), shift to global ids
        scores_d_all = st.delta.score_all(queries, weights)
        docs_d = (np.arange(len(st.delta), dtype=np.int64)
                  + self.base_num_docs)
        docs_d = np.broadcast_to(docs_d, scores_d_all.shape)
        return self._filter_merge(
            docs_b, scores_b, docs_d, scores_d_all, st.tombs, k,
            elig=doc_mask,
        )

    def search_ids(
        self, queries: np.ndarray, top_k: int = 100,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | None = None,
    ) -> np.ndarray:
        """Rankings only (docs matrix)."""
        return self.search(queries, top_k=top_k, weights=weights,
                           doc_mask=doc_mask)[0]

    @staticmethod
    def _filter_merge(docs_b, scores_b, docs_d, scores_d, tombs, k,
                      elig=None):
        """Per-query: drop tombstones (and mask-ineligible docs), two-key
        merge (score desc, id asc); under a mask, shortfall slots are
        doc -1 / score 0."""
        q_n = len(docs_b)
        out_docs = np.zeros((q_n, k), dtype=np.int32)
        out_scores = np.zeros((q_n, k), dtype=np.float32)
        for i in range(q_n):
            d, s = docs_b[i], scores_b[i]
            if docs_d is not None:
                d = np.concatenate([d, docs_d[i]])
                s = np.concatenate([s, scores_d[i]])
            if elig is None:
                keep = ~tombs[d]
            else:
                # the masked base engine pads shortfalls with doc -1;
                # np.maximum keeps the lookups in bounds, `valid` drops them
                valid = d >= 0
                safe = np.maximum(d, 0)
                keep = valid & ~tombs[safe] & elig[safe]
            d, s = d[keep], s[keep]
            order = np.lexsort((d, -s))[:k]
            n = len(order)
            out_docs[i, :n] = d[order]
            out_scores[i, :n] = s[order]
            if elig is not None and n < k:
                out_docs[i, n:] = -1  # scores already 0
        return out_docs, out_scores

    # -- compaction hooks ---------------------------------------------------

    def needs_compaction(
        self, max_delta_docs: int = 50_000, max_deleted_frac: float = 0.2
    ) -> bool:
        st = self._state
        deleted = st.tomb_base + st.tomb_delta
        return (self.delta_docs > max_delta_docs
                or deleted > max_deleted_frac * max(st.num_total, 1))

    def live_mask(self) -> np.ndarray:
        """Bool (num_docs,): True = live.  Basis for the compaction remap."""
        return ~self._state.tombs


class UpdateLog:
    """Append-only JSONL write-ahead log for live index updates.

    Durability contract for serving: a mutation is acknowledged (HTTP 200)
    only after its record is flushed *and fsynced* here, so every acked
    ``/add``/``/delete``/``/compact`` survives a process kill and is
    replayed on the next start.  A crash mid-append may leave a torn final
    line — that op was never acked, so dropping it (with a warning) keeps
    the at-most-once-loss guarantee.  The reference has no analog (it is
    build-once: ``reference/bm25_test.py:22-35`` refits from scratch);
    this is the standard translog/WAL design search engines pair with a
    segment architecture.

    Record shapes (one JSON object per line)::

        {"op": "add", "docs": ["text", ...]}
        {"op": "delete", "doc_ids": [id, ...]}
        {"op": "compact"}            # in-memory compact: replay re-runs the
                                     # deterministic rebuild so later ops'
                                     # doc ids line up with the remap

    A compact that PERSISTS the new base to the served index dir folds all
    prior records into the base, so the log is reset instead.

    Base-generation fencing: the first record is a signature of the base
    artifacts (``{"op": "base", "sig": [...]}``).  Replay compares it to
    the current base — a mismatch means the base changed under the log
    (a persisted compact crashed between ``save_index`` and the log
    reset, or the index was rebuilt out-of-band), so replaying would
    re-apply folded ops (duplicate docs, deletes landing on remapped
    ids).  Mismatched logs are discarded with a warning, never replayed.
    The reset itself is a single atomic ``os.replace`` of a fresh
    sig-only file, so there is no torn-truncation window.
    """

    FILENAME = "updates.wal"

    def __init__(self, index_dir: str):
        import os

        self.index_dir = os.fspath(index_dir)
        self.path = os.path.join(self.index_dir, self.FILENAME)
        self._lock = threading.Lock()
        self._f = None

    def base_sig(self) -> list:
        """Fingerprint of the base artifact generation: (size, mtime_ns)
        of the postings data file — ``save_index`` rewrites it on every
        persisted compact, so any fold-in changes the signature."""
        import os

        try:
            st = os.stat(os.path.join(self.index_dir, "data.csc.index.npy"))
        except FileNotFoundError:
            return [0, 0]
        return [int(st.st_size), int(st.st_mtime_ns)]

    def read(self) -> list[dict]:
        """Parse the log; [] if absent.  Tolerates exactly one torn line at
        the tail (crash mid-append, never acked); garbage followed by valid
        records means real corruption and raises."""
        import json
        import os
        import warnings

        self._torn_at = None  # byte offset of a dropped torn tail, if any
        if not os.path.exists(self.path):
            return []
        ops: list[dict] = []
        bad_at = None
        bad_off = None
        with open(self.path, "rb") as f:
            offset = 0
            for lineno, raw in enumerate(f, 1):
                start, offset = offset, offset + len(raw)
                line = raw.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict) or "op" not in rec:
                        raise ValueError("record is not an op object")
                except (ValueError, json.JSONDecodeError):
                    if bad_at is None:
                        bad_at, bad_off = lineno, start
                        continue
                    raise ValueError(
                        f"{self.path}: corrupt record at line {bad_at} "
                        f"followed by more data — refusing to replay a log "
                        f"with a hole (delete the file to start fresh)"
                    ) from None
                if bad_at is not None:
                    raise ValueError(
                        f"{self.path}: corrupt record at line {bad_at} "
                        f"followed by more data — refusing to replay a log "
                        f"with a hole (delete the file to start fresh)"
                    )
                ops.append(rec)
        if bad_at is not None:
            self._torn_at = bad_off
            warnings.warn(
                f"{self.path}: dropping torn final record at line {bad_at} "
                "(crash mid-append; the op was never acknowledged)",
                stacklevel=2,
            )
        return ops

    def _repair_tail(self) -> None:
        """Physically drop a torn tail so later appends start on a clean
        line.  Without this, a record appended after tolerated torn bytes
        glues onto them — the NEXT restart then sees garbage followed by
        valid data and refuses the whole log (acked ops unrecoverable).
        Only bytes ``read()`` judged unparseable are cut; the op they
        belonged to was never acknowledged."""
        import os

        off = getattr(self, "_torn_at", None)
        if off is None:
            return
        with self._lock:
            if self._f is not None:  # keep any append fd consistent
                self._f.close()
                self._f = None
            with open(self.path, "rb+") as f:
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
        self._torn_at = None

    def read_pending(self) -> list[dict]:
        """Ops safe to replay against the CURRENT base.

        Parses the log and checks the base-generation signature; a
        mismatch (base changed under the log) discards the records with
        a warning and resets the log — replaying them would corrupt the
        index.  Logs written before the signature header existed replay
        as-is (their base cannot have been fold-compacted, since that
        code path always writes the header).
        """
        import warnings

        records = self.read()
        self._repair_tail()  # cut tolerated torn bytes before any append
        if not records:
            return []
        if records[0].get("op") != "base":
            return records  # legacy header-less log
        head, ops = records[0], records[1:]
        if head.get("sig") != self.base_sig():
            if ops:
                warnings.warn(
                    f"{self.path}: base artifacts changed under the "
                    f"update log ({len(ops)} record(s) discarded) — a "
                    "persisted compaction folded them, or the index was "
                    "rebuilt out-of-band",
                    stacklevel=2,
                )
            self.reset()
            return []
        return ops

    def append(self, record: dict) -> None:
        """Write one record; returns only after flush + fsync (ack gate)."""
        import json
        import os

        with self._lock:
            created = False
            if self._f is None:
                self._close_tail_unlocked()
                created = not os.path.exists(self.path)
                fresh = (created or os.path.getsize(self.path) == 0)
                self._f = open(self.path, "a", encoding="utf-8")
                if fresh:  # new log: lead with the base-generation sig
                    self._f.write(json.dumps(
                        {"op": "base", "sig": self.base_sig()}
                    ) + "\n")
            self._f.write(json.dumps(record, ensure_ascii=False) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            if created:
                # a brand-new log file: fsyncing its DATA is not enough —
                # the directory entry must reach disk too, or a crash can
                # vanish the whole file with every acked op in it (reset()
                # gives its rename the same treatment)
                dfd = os.open(os.path.dirname(self.path) or ".",
                              os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)

    def _close_tail_unlocked(self) -> None:
        """Before the first append: make sure the log ends on a newline.

        Applies ``read()``'s own judgment to an unterminated final line so
        the logical log is unchanged: a parseable record (the crash lost
        only its newline — ``read`` replays such a tail) is terminated in
        place; unparseable bytes (``read`` drops them) are truncated.
        Callers that went through ``read_pending`` already got the repair;
        this covers direct ``append`` use on a dirty log."""
        import json
        import os

        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size == 0:
            return
        with open(self.path, "rb+") as f:
            f.seek(size - 1)
            if f.read(1) == b"\n":
                return
            # find the start of the unterminated final line
            pos = size - 1
            chunk = 4096
            start = 0
            while pos > 0:
                lo = max(0, pos - chunk)
                f.seek(lo)
                buf = f.read(pos - lo)
                nl = buf.rfind(b"\n")
                if nl >= 0:
                    start = lo + nl + 1
                    break
                pos = lo
            f.seek(start)
            tail = f.read()
            try:
                rec = json.loads(tail)
                ok = isinstance(rec, dict) and "op" in rec
            except ValueError:
                ok = False
            if ok:
                f.seek(0, os.SEEK_END)
                f.write(b"\n")
            else:
                f.truncate(start)
            f.flush()
            os.fsync(f.fileno())

    def reset(self) -> None:
        """Atomically replace the log with a sig-only header (its records
        are folded into a persisted base, or discarded as stale).  One
        ``os.replace`` — no torn-truncation window."""
        import json
        import os

        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(
                    {"op": "base", "sig": self.base_sig()}
                ) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            dfd = os.open(self.index_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)  # make the rename itself durable
            finally:
                os.close(dfd)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class UpdatableRetriever:
    """Text-level mutable retrieval: add/delete/compact + batched search.

    The live corpus is ``self.corpus`` (deleted texts stay in place until
    compaction so global doc ids remain stable between compactions).  The
    vocab grows in place as added docs introduce new terms; queries always
    tokenize against the full live vocab.

    Thread safety: mutators serialize on an internal lock and publish
    texts before their doc ids, so concurrent ``retrieve`` calls always
    resolve returned ids to the right texts between compactions.  A
    retrieve racing a COMPACTION may still observe mixed pre/post-remap
    state (ids are reassigned); serving deployments that need an atomic
    swap should use :class:`bm25_tpu_torch.serve.Server`, which snapshots one
    runtime reference per request.
    """

    def __init__(self, index: ScoredIndex, engine, tokenizer, corpus,
                 engine_mode: str = "auto",
                 max_delta_docs: int = 50_000,
                 max_deleted_frac: float = 0.2,
                 engine_kwargs: dict | None = None):
        if index.vocab is None:
            raise ValueError("UpdatableRetriever needs an index with a vocab")
        self.index = index
        self.engine = UpdatableEngine(engine, index)
        self.tokenizer = tokenizer
        self.vocab = index.vocab  # grows in place on add
        self.corpus = list(corpus)
        self.engine_mode = engine_mode
        self.max_delta_docs = max_delta_docs
        self.max_deleted_frac = max_deleted_frac
        self.engine_kwargs = engine_kwargs or {}
        # serializes mutators: two concurrent add_documents calls could
        # otherwise interleave their corpus.extend and engine.add in
        # different orders, permanently misaligning doc ids and texts
        self._lock = threading.Lock()

    # -- construction --------------------------------------------------------

    @classmethod
    def fit(cls, corpus, params: BM25Params | None = None,
            tokenizer=None, engine_mode: str = "auto",
            **kwargs) -> "UpdatableRetriever":
        from bm25_tpu_torch.index.builder import build_index
        from bm25_tpu_torch.models.auto import create_engine
        from bm25_tpu_torch.text.tokenizer import Tokenizer

        tokenizer = tokenizer or Tokenizer()
        corpus = list(corpus)
        index, _ = build_index(corpus, params=params, tokenizer=tokenizer)
        # engine_kwargs must shape the INITIAL engine too, or the engine
        # configuration (score_dtype, hot sizing, ...) silently changes at
        # the first compaction (which passes them — _compact_locked)
        engine = create_engine(index, mode=engine_mode,
                               **(kwargs.get("engine_kwargs") or {}))
        return cls(index=index, engine=engine, tokenizer=tokenizer,
                   corpus=corpus, engine_mode=engine_mode, **kwargs)

    # -- mutation ------------------------------------------------------------

    def add_documents(self, texts) -> np.ndarray:
        """Add texts; returns their doc ids (post-compaction ids if the add
        tripped the auto-compaction thresholds)."""
        texts = list(texts)
        if not texts:
            return np.zeros(0, dtype=np.int64)
        with self._lock:
            tc = self.tokenizer.tokenize_corpus(texts, vocab=self.vocab)
            # texts land in the corpus BEFORE the engine publishes their
            # ids: a racing retrieve(return_text=True) must never see a
            # doc id whose text lookup would fall off the corpus end
            self.corpus.extend(texts)
            try:
                ids = self.engine.add(tc.ids)
            except BaseException:
                del self.corpus[len(self.corpus) - len(texts):]
                raise
            if self.engine.needs_compaction(self.max_delta_docs,
                                            self.max_deleted_frac):
                remap = self._compact_locked()
                ids = remap[ids]
            return ids

    def delete_documents(self, doc_ids) -> int:
        with self._lock:
            n = self.engine.delete(doc_ids)
            if (self.engine.needs_compaction(self.max_delta_docs,
                                             self.max_deleted_frac)
                    and self.engine.live_mask().any()):
                # skip (don't raise) when everything is deleted: the
                # tombstones are already committed, and compaction is an
                # optimization that needs >= 1 live doc to rebuild from —
                # it re-arms on the next add
                self._compact_locked()
            return n

    def compact(self) -> np.ndarray:
        """Rebuild one fresh base segment from the live corpus.

        Returns the id remap: ``remap[old_id] -> new_id`` (-1 for deleted
        docs).  After compaction scores are exact for the current corpus —
        bit-identical to ``UpdatableRetriever.fit`` on the live texts.
        """
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> np.ndarray:
        from bm25_tpu_torch.index.builder import build_index
        from bm25_tpu_torch.models.auto import create_engine

        live = self.engine.live_mask()
        remap = np.full(len(live), -1, dtype=np.int64)
        remap[live] = np.arange(int(live.sum()), dtype=np.int64)
        corpus = [t for t, alive in zip(self.corpus, live) if alive]
        if not corpus:
            raise ValueError(
                "compaction would empty the corpus; engines need >= 1 doc "
                "(delete fewer docs or rebuild from scratch)"
            )
        # fresh vocab: ids reassigned in first-occurrence order, terms that
        # only occurred in deleted docs drop out
        tokenizer = self.tokenizer
        index, _ = build_index(corpus, params=self.index.params,
                               tokenizer=tokenizer)
        engine = create_engine(index, mode=self.engine_mode,
                               **self.engine_kwargs)
        self.index = index
        self.vocab = index.vocab
        self.corpus = corpus
        self.engine = UpdatableEngine(engine, index)
        return remap

    # -- retrieval -----------------------------------------------------------

    def retrieve(self, queries, k: int = 10, return_text: bool = False):
        """Batched text retrieval over the live corpus (see Retriever)."""
        queries = list(queries)
        if any(isinstance(q, dict) for q in queries):
            ids, wts = self.tokenizer.tokenize_weighted_queries(
                queries, self.vocab
            )
            docs, scores = self.engine.search(ids, top_k=k, weights=wts)
        else:
            ids = self.tokenizer.tokenize_queries(queries, self.vocab)
            docs, scores = self.engine.search(ids, top_k=k)
        if not return_text:
            return docs, scores
        texts = [[self.text(int(d)) for d in row] for row in docs]
        return docs, scores, texts

    def text(self, doc_id: int) -> str:
        return self.corpus[doc_id]

    def save(self, path: str, with_corpus: bool = True) -> None:
        """Compact (making scores current-corpus-exact), then save."""
        from bm25_tpu_torch.index.io import save_index

        if self.engine.delta_docs or self.engine.deleted_docs:
            self.compact()
        save_index(path, self.index,
                   corpus=self.corpus if with_corpus else None)
        from bm25_tpu_torch.index.io import save_tokenizer_config

        save_tokenizer_config(path, self.tokenizer)
