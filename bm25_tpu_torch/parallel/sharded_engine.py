"""Doc-sharded BM25 engines — PyTorch counterpart of
``bm25_tpu/parallel/sharded_engine.py``.

Every doc shard scores only its documents and selects its local top-k
candidates; the candidates of a data row's shards are copied to the row's
first device (and, across processes, all-gathered) in shard order, and
one merge there gives the result.  Ties go to the smaller global doc id:
the dense engine's shards hold contiguous doc ranges and its merge is
positional (shard 0's candidates first), and the sparse engine merges by
two keys (score descending, doc ascending) both across its buckets and
across its shards.

The kernels are the single-device engines' own: B3 (``gather_add_rows``)
in each shard of ``ShardedEngine``; B1 (``ell_score_fused``) in each
shard of ``ShardedSparseEngine``, and B2 (``ell_score``) at its build for
each shard's hot pair.  The merge is plain torch, as it is plain JAX in
the reference.

A JAX array sharded over the mesh becomes a ``MeshTensor``: one piece a
mesh cell, shared by the cells on one device.  Each shard's work runs on
its device's current stream (shards on one card share it); a copy to the
merge device is ordered by events on both devices' current streams
(torch's cross-device copy), so nothing on the step's path waits on the
host except the ``k_local`` trim's exactness flag, read once a chunk
where the trim engages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from bm25_tpu_torch.parallel.distributed import all_gather_shards
from bm25_tpu_torch.parallel.mesh import (DATA_AXIS, DOC_AXIS, Mesh,
                                          default_mesh, make_mesh)
from bm25_tpu_torch.runtime.session import Session
from bm25_tpu_torch.scoring import ScoredIndex
from bm25_tpu_torch.utils.padding import next_multiple, next_pow2_at_least
from bm25_tpu_torch.utils.validate import empty_results, validate_query_batch

NEG_INF = float("-inf")

# sparse merges by the k_local trim: "trimmed" merges taken from each
# shard's top k_local candidates, "fallback" those whose exactness check
# failed and merged the full candidate width again (no re-scoring)
trim_counts = {"trimmed": 0, "fallback": 0}


class MeshTensor:
    """One logical array over a mesh: the counterpart of a JAX array under
    a ``NamedSharding``.

    ``parts[r][j]`` is the piece on ``mesh.devices[r, j]``; the cells of
    one device share one tensor.  ``axis`` is the axis split over the doc
    shards (None: replicated).  ``shape``, ``numel`` and ``element_size``
    are the global array's, as a JAX array's are: this process's shards
    hold ``held_bytes()``."""

    def __init__(self, parts: list[list[torch.Tensor]], axis: int | None,
                 n_shards: int):
        self.parts = parts
        self.axis = axis
        self.n_shards = n_shards

    def on(self, r: int, j: int) -> torch.Tensor:
        return self.parts[r][j]

    @property
    def shape(self) -> tuple[int, ...]:
        shape = list(self.parts[0][0].shape)
        if self.axis is not None:
            shape[self.axis] *= self.n_shards
        return tuple(shape)

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return self.parts[0][0].element_size()

    @property
    def nbytes(self) -> int:
        return self.numel() * self.element_size()

    def pieces(self) -> list[torch.Tensor]:
        """Each distinct tensor once."""
        seen: dict[int, torch.Tensor] = {}
        for row in self.parts:
            for t in row:
                seen.setdefault(id(t), t)
        return list(seen.values())

    def held_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.pieces())

    def numpy(self) -> np.ndarray:
        """This process's data row 0 as one host array (doc shards
        concatenated along ``axis``); a replicated array's one copy."""
        row = [Session.get(t) for t in self.parts[0]]
        if self.axis is None:
            return row[0]
        return np.concatenate(row, axis=self.axis)


def place(mesh: Mesh, make, axis: int | None) -> MeshTensor:
    """A ``MeshTensor`` whose piece for local shard j on device d is
    ``make(j, d)``, called once a (shard, device) pair (once a device when
    replicated)."""
    made: dict = {}
    parts = []
    for r in range(mesh.devices.shape[0]):
        row = []
        for j in range(mesh.local_docs):
            dev = mesh.devices[r, j]
            key = (None if axis is None else j, dev)
            if key not in made:
                made[key] = make(j, dev)
            row.append(made[key])
        parts.append(row)
    return MeshTensor(parts, axis, mesh.shape[DOC_AXIS])


def _put(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return Session(dev).put(x)


class QueryShards(NamedTuple):
    """One chunk's padded queries on the mesh: data row r's slice of the
    (Q, T) ids (and weights) on each distinct device of the row."""

    padded: np.ndarray  # (Q, T) int32 host ids, -1 pads
    wpadded: np.ndarray | None  # (Q, T) float32 host weights
    ids: list[dict]  # [row] -> {device: (Q / rows, T) int32}
    w: list[dict] | None  # [row] -> {device: (Q / rows, T) float32}


def put_queries(mesh: Mesh, padded: np.ndarray,
                wpadded: np.ndarray | None = None) -> QueryShards:
    """Split a padded chunk over the data axis and upload each row's slice
    once to each distinct device of the row (pinned, not waiting)."""
    rows = mesh.devices.shape[0]
    q_r = padded.shape[0] // rows
    ids, ws = [], []
    for r in range(rows):
        sl = slice(r * q_r, (r + 1) * q_r)
        ids_r, w_r = {}, {}
        for dev in dict.fromkeys(mesh.devices[r]):
            session = Session(dev)
            ids_r[dev] = session.put_async(padded[sl])
            if wpadded is not None:
                w_r[dev] = session.put_async(wpadded[sl])
        ids.append(ids_r)
        ws.append(w_r)
    return QueryShards(padded, wpadded, ids, ws if wpadded is not None
                       else None)


def _to_merge(mesh: Mesh, r: int, parts: list[torch.Tensor]) -> torch.Tensor:
    """Local shards' (q, w) tensors stacked on row r's first device, then
    every rank's gathered: (shards, q, w) in global shard order."""
    dev = mesh.devices[r, 0]
    stacked = torch.stack([p.to(dev, non_blocking=True) for p in parts])
    return all_gather_shards(stacked)


def _flat(g: torch.Tensor) -> torch.Tensor:
    """(S, q, w) gathered candidates -> (q, S*w), shard 0's first."""
    return g.transpose(0, 1).reshape(g.shape[1], -1)


def make_sharded_query_step(mesh: Mesh, num_docs: int, k: int):
    """The sharded dense step: ``step(st, offsets, queries, mask=None) ->
    [(scores (q_r, k) f32, docs (q_r, k) int32)]``, one pair a data row on
    the row's first device.

    ``st`` is the (V_pad, D_pad) table split over the doc axis, ``offsets``
    the replicated (V_pad,) offsets, ``queries`` a ``QueryShards`` and
    ``mask`` the (D_pad,) eligibility mask split like the table's columns.
    Each shard runs B3 on its (V_pad, d_local) slice, masks its padded and
    ineligible columns and selects its top ``min(k, d_local)``; the merge
    takes the top k of the candidates in shard order (ties to the smaller
    position: the smaller global doc id) and adds the per-token offsets.
    """
    from bm25_tpu_torch.ops.gather_rows import gather_add_rows
    from bm25_tpu_torch.ops.topk import select_top_k

    def step(st, offsets, queries: QueryShards, mask=None):
        outs = []
        for r in range(mesh.devices.shape[0]):
            cand_s, cand_i = [], []
            for j in range(mesh.local_docs):
                st_l = st.on(r, j)
                ids = queries.ids[r][mesh.devices[r, j]]
                w = None if queries.w is None else \
                    queries.w[r][mesh.devices[r, j]]
                d_local = st_l.shape[1]
                valid = ids >= 0
                safe = torch.where(valid, ids, st_l.shape[0] - 1)
                if w is not None:
                    w = torch.where(valid, w.float(), 0.0)
                scores = gather_add_rows(st_l, safe.to(torch.int32),
                                         weights=w)
                doc_base = mesh.shard_index(j) * d_local
                elig = (torch.arange(d_local, device=st_l.device) + doc_base
                        < num_docs)
                if mask is not None:
                    elig = elig & mask.on(r, j)
                scores = torch.where(elig, scores, NEG_INF)
                top_s, top_i = select_top_k(scores, min(k, d_local))
                cand_s.append(top_s)
                cand_i.append(top_i.to(torch.int32) + doc_base)
            # the offsets are doc-independent: the merge device adds them
            dev = mesh.devices[r, 0]
            ids = queries.ids[r][dev]
            valid = ids >= 0
            off = offsets.on(r, 0)[torch.where(valid, ids, 0).long()]
            if queries.w is None:
                qoff = torch.where(valid, off, 0.0).sum(dim=1)
            else:
                qoff = (off * torch.where(valid, queries.w[r][dev].float(),
                                          0.0)).sum(dim=1)
            cs = _flat(_to_merge(mesh, r, cand_s))
            ci = _flat(_to_merge(mesh, r, cand_i))
            merged_s, pos = select_top_k(cs, min(k, cs.shape[1]))
            merged_i = torch.gather(ci, 1, pos)
            final = merged_s.float() + qoff[:, None]
            if mask is not None:
                # slots beyond the eligible count: doc -1 / score 0
                ok = merged_s > NEG_INF
                merged_i = torch.where(ok, merged_i, -1)
                final = torch.where(ok, final, 0.0)
            outs.append((final, merged_i))
        return outs

    return step


def _put_doc_sharded_dense(index: ScoredIndex, mesh: Mesh, v_pad: int,
                           d_pad: int, dtype: torch.dtype) -> MeshTensor:
    """The (V_pad, D_pad) table, doc shard by doc shard, each built on its
    device from its own slice of the postings, as
    ``DenseEngine.from_scored_index`` builds its table: the host never
    holds a dense block (at the corpus sizes the sharded engine exists
    for, the full matrix is num_docs x vocab x 4 bytes), only one shard's
    postings at a time."""
    # to_csc() is (num_docs, vocab): doc ranges are row slices of its CSR
    csr = index.to_csc().tocsr()
    d = index.num_docs
    d_local = d_pad // mesh.shape[DOC_AXIS]

    def make(j, dev):
        lo = min(mesh.shard_index(j) * d_local, d)
        hi = min(lo + d_local, d)
        sub = csr[lo:hi]
        docs = np.repeat(np.arange(hi - lo, dtype=np.int64),
                         np.diff(sub.indptr))
        flat = sub.indices.astype(np.int64) * d_local + docs
        st = torch.zeros((v_pad, d_local), dtype=dtype, device=dev)
        st.view(-1)[_put(flat, dev)] = _put(
            np.asarray(sub.data, np.float32), dev).to(dtype)
        return st

    return place(mesh, make, axis=1)


def _replicated(mesh: Mesh, host: np.ndarray) -> MeshTensor:
    return place(mesh, lambda _j, dev: _put(host, dev), axis=None)


class _Fetch(NamedTuple):
    """One dispatched chunk: its real rows and each data row's results in
    pinned host buffers (valid once the batch's events complete)."""

    cq: int
    qoff: np.ndarray | None  # host offsets to add (the sparse engine)
    docs: list[torch.Tensor]
    scores: list[torch.Tensor] | None


def _fetch(cq, qoff, outs, ids_only: bool) -> _Fetch:
    if ids_only:
        return _Fetch(cq, qoff, [Session.fetch_async(o) for o in outs], None)
    return _Fetch(cq, qoff, [Session.fetch_async(d) for _, d in outs],
                  [Session.fetch_async(s) for s, _ in outs])


def _record_events(mesh: Mesh) -> list:
    """One event on each distinct CUDA device's current stream: the
    batch's copies to the host have landed once all have completed."""
    return [Session(dev).record_event() for dev in mesh.distinct_devices()
            if dev.type == "cuda"]


def _wait(events) -> None:
    for e in events:
        e.synchronize()


def _rows(parts: list[torch.Tensor]) -> np.ndarray:
    return np.concatenate([Session.get(p) for p in parts])


@dataclass
class ShardedEngine:
    """Doc-sharded dense BM25 engine over a (data, docs) mesh."""

    st: MeshTensor  # (V_pad, D_pad) split over docs, last row 0
    offsets: MeshTensor  # (V_pad,) replicated
    num_docs: int
    vocab_size: int
    mesh: Mesh
    vocab: dict[str, int] | None = None
    # transient (Q, d_local) score tiles a shard are bounded by chunking
    # queries, as in the single-device engines
    score_buffer_budget: int = 4 << 30
    chunk_queries: int = 2048

    @classmethod
    def from_scored_index(
        cls,
        index: ScoredIndex,
        mesh: Mesh | None = None,
        dtype=torch.float32,
        session: Session | None = None,
    ) -> "ShardedEngine":
        """Lay the index out over ``mesh`` (default: every visible card,
        or ``session``'s device where it is the CPU): each doc shard's
        (V_pad, d_local) block of the table on its device, built there
        from its slice of the postings."""
        from bm25_tpu_torch.models.dense import table_dtype
        from bm25_tpu_torch.ops.gather_rows import doc_pad

        mesh = mesh or default_mesh(session)
        n_doc = mesh.shape[DOC_AXIS]
        v, d = index.vocab_size, index.num_docs
        # each shard's width is B3's own column quantum (doc_pad)
        d_pad = doc_pad(-(-max(d, 1) // n_doc)) * n_doc
        v_pad = next_multiple(v + 1, 8)
        st = _put_doc_sharded_dense(index, mesh, v_pad, d_pad,
                                    table_dtype(dtype))
        off_host = np.zeros((v_pad,), dtype=np.float32)
        if index.token_offsets is not None:
            off_host[:v] = index.token_offsets
        return cls(st=st, offsets=_replicated(mesh, off_host), num_docs=d,
                   vocab_size=v, mesh=mesh, vocab=index.vocab)

    @property
    def session(self) -> Session:
        """The session of the first merge device (where results land)."""
        return Session(self.mesh.devices[0, 0])

    def _max_chunk(self) -> int:
        """Queries per dispatch bounded by each shard's transient budget.

        Queries split over the data axis, so each shard's transient score
        tile is (q/n_data, d_local): the budget buys n_data times more
        global query rows than a single shard's tile would."""
        n_doc = self.mesh.shape[DOC_AXIS]
        n_data = self.mesh.shape[DATA_AXIS]
        d_local = self.st.shape[1] // n_doc
        align = 8 * n_data
        max_q = max(
            align,
            (self.score_buffer_budget // (4 * d_local) * n_data)
            // align * align,
        )
        return min(max_q, self.chunk_queries)

    def search(
        self, queries: np.ndarray, top_k: int = 100,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k: (Q, T) int (-1 = pad) -> (docs (Q, k) int32,
        scores (Q, k) f32), with optional (Q, T) ``weights`` and a
        (num_docs,) bool ``doc_mask`` (slots beyond the eligible count
        come back as doc -1 / score 0)."""
        queries, weights = validate_query_batch(
            queries, self.vocab_size, weights
        )
        if doc_mask is not None:
            m = np.asarray(doc_mask)
            if m.shape != (self.num_docs,):
                raise ValueError(
                    f"doc_mask shape {m.shape} != ({self.num_docs},)"
                )
        k = min(top_k, self.num_docs)
        if len(queries) == 0 or k <= 0:
            return empty_results(len(queries), k)
        dmask = None
        if doc_mask is not None:
            # doc-sharded like the table's columns
            mp = np.zeros(self.st.shape[1], dtype=bool)
            mp[: self.num_docs] = m.astype(bool)
            d_local = self.st.shape[1] // self.mesh.shape[DOC_AXIS]
            dmask = place(self.mesh, lambda j, dev: _put(
                mp[self.mesh.shard_index(j) * d_local:][:d_local], dev),
                axis=0)
        step = make_sharded_query_step(self.mesh, self.num_docs, k)
        n_data = self.mesh.shape[DATA_AXIS]
        q_real, t_real = queries.shape
        t_pad = next_pow2_at_least(max(t_real, 8))
        max_q = self._max_chunk()
        futures = []
        for i in range(0, q_real, max_q):
            chunk = queries[i : i + max_q]
            cq = len(chunk)
            q_pad = next_multiple(cq, 8 * n_data)
            padded = np.full((q_pad, t_pad), -1, dtype=np.int32)
            padded[:cq, :t_real] = chunk.astype(np.int32)
            wp = None
            if weights is not None:
                wp = np.zeros((q_pad, t_pad), dtype=np.float32)
                wp[:cq, :t_real] = weights[i : i + max_q]
            outs = step(self.st, self.offsets,
                        put_queries(self.mesh, padded, wp), dmask)
            futures.append(_fetch(cq, None, outs, ids_only=False))
        _wait(_record_events(self.mesh))
        docs = np.concatenate([_rows(f.docs)[: f.cq] for f in futures])
        scores = np.concatenate([_rows(f.scores)[: f.cq] for f in futures])
        return docs, scores


def choose_k_local(k: int, n_shards: int) -> int:
    """Shard-local candidate count for the two-stage merge.

    The JAX package's policy, kept as it is (its cost model was measured
    on a TPU pod's links and is not a figure of this port): full k below
    32 shards, where the gathered (Q, S*k) merge is a small share of the
    step; at S >= 32 each shard returns ``ceil(2k/S) + 64`` candidates (2x
    a shard's expected share of a uniformly split top-k, plus slack), and
    the step checks exactness after the merge (each shard's last trimmed
    candidate strictly below the merged k-th) with a full-width fallback.
    """
    if n_shards < 32:
        return k
    return min(k, -(-2 * k // n_shards) + 64)


class _DeviceInputs(NamedTuple):
    """One chunk's operands on one device, made once for every shard of
    the row that lives there."""

    ids: torch.Tensor
    w: torch.Tensor | None
    hot_counts: torch.Tensor | None
    hot_lo: torch.Tensor | None
    plan: object
    table: object
    mask: torch.Tensor | None


def shard_candidates(buckets: list[dict], inp: _DeviceInputs, k: int):
    """One shard's local top k: each bucket's top k through the
    single-device step's per-bucket body (``models.sparse.bucket_top_k``),
    then a two-key merge (score desc, doc asc) across the buckets, whose
    rows interleave doc ids."""
    from bm25_tpu_torch.models.sparse import bucket_top_k, two_key_merge

    cand_s, cand_i = [], []
    for b in buckets:
        s, pos = bucket_top_k(b, inp.ids, k, inp.hot_counts, inp.hot_lo,
                              inp.w, inp.mask, inp.plan, inp.table)[:2]
        cand_s.append(s)
        cand_i.append(b["doc_ids"][pos])
    return two_key_merge(torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1),
                         k)


def make_sharded_ell_step(mesh: Mesh, k: int, hot_h: int, buckets: list,
                          score_dtype=None, ids_only: bool = False,
                          k_local: int | None = None,
                          local_only: bool = False):
    """Doc-sharded multi-bucket ELL scoring + gathered top-k merge:
    ``step(hot_table, queries, mask=None)`` -> one result a data row on
    the row's first device: ``(scores (q_r, k), docs (q_r, k) int32)``,
    the docs alone with ``ids_only``.

    ``buckets`` are dicts of ``MeshTensor`` s split over the doc axis
    (``doc_ids`` (rows,), ``tokT``/``valT``/``hotT``/``hotLo`` (L or H,
    rows)), ``hot_table`` the replicated (V+1,) token -> hot rank table,
    ``queries`` a ``QueryShards`` and ``mask`` the replicated (num_docs,)
    bool eligibility mask, which each shard reads by its own global doc
    ids (bucket rows interleave them).  Each shard runs the single-device
    step's bucket body on its row slice of every bucket
    (``shard_candidates``); the hot counts, B1's plan and the scan tables
    are made once a device.  The shards' candidates merge by two keys on
    the row's first device.  ``k_local`` trims each shard's candidates to
    its top ``k_local`` before the merge, with the exactness check and
    full-width fallback of JAX's step; ``local_only`` stops after the
    shards' local top k (an instrumentation cut: the merge costs
    t(full) - t(local_only)) and returns each row's list of (scores,
    docs) a shard.  The merged scores come back rounded to
    ``score_dtype`` (None: f32) without the per-token offsets, which the
    engine adds on the host.
    """
    from bm25_tpu_torch.models.sparse import (hot_counts_for, hot_plan,
                                              two_key_merge)
    from bm25_tpu_torch.ops.ell_score import scan_table

    n_shards = mesh.shape[DOC_AXIS]

    def device_inputs(r, dev, hot_table, queries, mask):
        ids = queries.ids[r][dev]
        w = None if queries.w is None else queries.w[r][dev]
        if w is not None:
            w = torch.where(ids >= 0, w.float(), 0.0)
        hot_counts = hot_lo = plan = None
        j = list(mesh.devices[r]).index(dev)
        if hot_h:
            hot_counts, hot_lo = hot_counts_for(ids, hot_table.on(r, j),
                                                hot_h, w)
            plan = hot_plan(hot_counts, hot_lo)
        # the card's scan tables (the CPU twins read none)
        table = scan_table(ids, w) if ids.is_cuda else None
        return _DeviceInputs(ids, w, hot_counts, hot_lo, plan, table,
                             None if mask is None else mask.on(r, j))

    def merge(r, cand):
        ls = [s for s, _ in cand]
        li = [i for _, i in cand]
        kk = ls[0].shape[1]
        m = k if k_local is None else min(k_local, kk)
        if m < kk and n_shards * m >= k:
            # gather only each shard's top m; if any shard's m-th still
            # scores >= the merged k-th, that shard may hold more of the
            # top k (or tie at the boundary with a smaller doc id): merge
            # the full width of the candidates already computed
            gs = _to_merge(mesh, r, [s[:, :m] for s in ls])
            gi = _to_merge(mesh, r, [i[:, :m] for i in li])
            t_s, t_i = two_key_merge(_flat(gs), _flat(gi), k)
            last = gs[:, :, m - 1]
            ok = ((last < t_s[:, -1][None, :]) | (last == NEG_INF)).all()
            trim_counts["trimmed"] += 1
            if bool(ok):
                return t_s, t_i
            trim_counts["fallback"] += 1
        return two_key_merge(_flat(_to_merge(mesh, r, ls)),
                             _flat(_to_merge(mesh, r, li)), k)

    def step(hot_table, queries: QueryShards, mask=None):
        outs = []
        for r in range(mesh.devices.shape[0]):
            inputs = {dev: device_inputs(r, dev, hot_table, queries, mask)
                      for dev in dict.fromkeys(mesh.devices[r])}
            cand = []
            for j in range(mesh.local_docs):
                local = [{key: t.on(r, j) for key, t in b.items()}
                         for b in buckets]
                cand.append(shard_candidates(
                    local, inputs[mesh.devices[r, j]], k))
            if local_only:
                outs.append(cand)
                continue
            out_s, out_i = merge(r, cand)
            if mask is not None:
                # slots beyond the eligible count: doc -1 / score 0
                elig = out_s > NEG_INF
                out_i = torch.where(elig, out_i, -1)
                out_s = torch.where(elig, out_s, 0.0)
            if ids_only:
                outs.append(out_i)
                continue
            if score_dtype is not None:
                # halves the result-transfer bytes; ids stay exact
                out_s = out_s.to(score_dtype)
            outs.append((out_s, out_i))
        return outs

    return step


@dataclass
class ShardedSparseEngine:
    """Doc-sharded multi-bucket ELL BM25 engine.

    The single-device ``SparseEngine``'s hot and ELL tiers (length-
    bucketed ELL postings scored by B1, a dense hot-token pair built by
    B2), with every bucket's row axis split over the mesh's doc axis and
    the two-stage top-k merge on each data row's first device.
    """

    buckets: list  # dicts of MeshTensor: doc_ids, [tokT, valT, hotT, hotLo]
    hot_table: MeshTensor  # (V+1,) replicated; token id -> hot rank or -1
    hot_h: int
    offsets: MeshTensor  # (V+1,) replicated
    num_docs: int
    vocab_size: int
    mesh: Mesh
    vocab: dict[str, int] | None = None
    # transient (Q, rows_local) score tiles a shard are bounded by
    # chunking queries, as in the single-device engine
    score_buffer_budget: int = 4 << 30
    chunk_queries: int = 512
    # long-query dedup: the single-device engine's policy
    dedup_queries: bool | str = "auto"
    dedup_min_width: int = 16
    # JAX's cold-width routing fields, kept with their defaults: the port
    # does not route (ROADMAP.md: cold-width routing in both engines), and
    # the results are the same either way
    route_cold: bool | str = "auto"
    route_min_queries: int = 32
    hot_table_host: np.ndarray | None = None
    # "bfloat16": the merged scores are rounded to bf16 on the device
    # (selection stays f32) before the host adds the offsets
    score_dtype: str = "float32"
    # shard-local candidate trim for the merge: "auto" applies
    # choose_k_local (full k below 32 shards), an int forces m, None
    # disables
    k_local: int | str | None = "auto"
    # host copy of the replicated offsets, for the host qoff add
    _offsets_host: np.ndarray | None = field(default=None, repr=False)

    @classmethod
    def from_scored_index(
        cls, index: ScoredIndex, mesh: Mesh | None = None,
        hot_tokens: int | str = "auto", hot_budget_bytes: int | None = None,
        max_buckets: int = 4, score_dtype: str = "float32",
        overhead_target: float | None = None,
        session: Session | None = None,
    ) -> "ShardedSparseEngine":
        """Lay the index out over ``mesh`` (default: every visible card,
        or ``session``'s device where it is the CPU).

        The hot tier is sized as the single-device engine sizes it, with
        every bucket's rows aligned to B1's row block times the doc
        shards, so that each shard's slice stays block-aligned.  Each
        shard's slice of every bucket goes to its device, where B2 builds
        the shard's hot pair; the hot table and the offsets go to each
        distinct device once.  (JAX's ``dtype`` option has no
        counterpart: B1 reads f32 values, as the single-device engine's.)
        """
        from bm25_tpu_torch.models.sparse import (
            PAD_TOK, _score_sdt, build_ell_buckets_from_csr,
            build_hot_pair_device, choose_hot_tokens, hot_ell_for_rows,
            split_hot_cold_csr)
        from bm25_tpu_torch.ops.ell_score import BLOCK_ROWS, max_hot_tokens

        _score_sdt(score_dtype)  # validate at build time
        mesh = mesh or default_mesh(session)
        n_doc = mesh.shape[DOC_AXIS]
        if overhead_target is not None and hot_tokens != "auto":
            raise ValueError(
                "overhead_target steers the auto hot-tier policy; it "
                "cannot combine with an explicit hot_tokens count"
            )
        if hot_tokens == "auto":
            # the single-device cost model; each shard scores rows/n_doc
            # of every bucket, so a shard's trade is the same
            h = choose_hot_tokens(
                index, max_buckets=max_buckets,
                budget_bytes=hot_budget_bytes,
                row_align=BLOCK_ROWS * n_doc,
                device=mesh.devices.flat[0],
                overhead_target=overhead_target,
            )
        else:
            budget = hot_budget_bytes
            if budget is None:
                budget = (index.data.nbytes + index.indices.nbytes
                          + index.indptr.nbytes)
            max_h = budget // max(index.num_docs * 4, 1)
            h = int(min(hot_tokens, max_h, index.vocab_size,
                        max_hot_tokens()))
        if h > 0:
            hot_ids, source_csr, hot_csr = split_hot_cold_csr(index, h)
            h = len(hot_ids)
        else:
            hot_ids, hot_csr = np.zeros(0, np.int32), None
            source_csr = index.to_csc().tocsr()
        host_buckets = build_ell_buckets_from_csr(
            source_csr, index.num_docs, max_buckets=max_buckets,
            row_align=BLOCK_ROWS * n_doc,
        )
        v = index.vocab_size
        hot_table = np.full((v + 1,), -1, dtype=np.int32)
        if h > 0:
            hot_table[hot_ids] = np.arange(h, dtype=np.int32)
            hot_ids_dev = {dev: _put(hot_ids.reshape(-1, 1), dev)
                           for dev in mesh.distinct_devices()}

        dev_buckets = []
        for b in host_buckets:
            rl = len(b.doc_ids) // n_doc

            def cols(x):
                # local shard j's columns of a (.., rows) host array
                return lambda j, dev: _put(
                    x[..., mesh.shard_index(j) * rl:][..., :rl], dev)

            entry = {"doc_ids": place(mesh, cols(b.doc_ids), axis=0)}
            if b.tok is not None and b.tok.size:
                l_pad = next_multiple(b.tok.shape[1], 8)
                tok_t = np.full((l_pad, b.tok.shape[0]), PAD_TOK,
                                dtype=np.int32)
                tok_t[: b.tok.shape[1]] = b.tok.T
                val_t = np.zeros((l_pad, b.val.shape[0]), dtype=np.float32)
                val_t[: b.val.shape[1]] = b.val.T
                entry["tokT"] = place(mesh, cols(tok_t), axis=1)
                entry["valT"] = place(mesh, cols(val_t), axis=1)
            if h > 0:
                # the shard's hot pair, built on its device by B2 from its
                # slice of the sparse hot postings
                htok, hval = hot_ell_for_rows(hot_csr, b.doc_ids)
                pairs: dict = {}

                def pair(j, dev, part):
                    if (j, dev) not in pairs:
                        pairs[j, dev] = build_hot_pair_device(
                            hot_ids_dev[dev],
                            cols(htok)(j, dev), cols(hval)(j, dev))
                    return pairs[j, dev][part]

                entry["hotT"] = place(mesh, lambda j, d: pair(j, d, 0), 1)
                entry["hotLo"] = place(mesh, lambda j, d: pair(j, d, 1), 1)
            dev_buckets.append(entry)

        off_host = np.zeros((v + 1,), dtype=np.float32)
        if index.token_offsets is not None:
            off_host[:v] = index.token_offsets
        return cls(
            buckets=dev_buckets,
            hot_table=_replicated(mesh, hot_table),
            hot_table_host=hot_table,
            hot_h=h, offsets=_replicated(mesh, off_host),
            num_docs=index.num_docs, vocab_size=v, mesh=mesh,
            vocab=index.vocab, score_dtype=score_dtype,
        )

    @property
    def session(self) -> Session:
        """The session of the first merge device (where results land)."""
        return Session(self.mesh.devices[0, 0])

    def shard_bytes(self) -> list[int]:
        """Device bytes of each local doc shard of data row 0: its slice
        of every bucket (the replicated tables not counted)."""
        return [sum(t.on(0, j).numel() * t.on(0, j).element_size()
                    for b in self.buckets for t in b.values())
                for j in range(self.mesh.local_docs)]

    def _max_chunk(self) -> int:
        """Queries per chunk: one shard's (Q / n_data, rows_local) f32
        tile of its widest bucket within the budget, in multiples of 8, at
        most ``chunk_queries`` (the single-device engine's rule for B1)."""
        n_doc = self.mesh.shape[DOC_AXIS]
        n_data = self.mesh.shape[DATA_AXIS]
        max_rows = max(
            b["doc_ids"].shape[0] // n_doc for b in self.buckets
        )
        # queries split over the data axis: each shard's tile holds only
        # q/n_data rows, so the budget buys n_data x more global rows
        max_q = max(
            8,
            (self.score_buffer_budget // (4 * max_rows) * n_data) // 8 * 8,
        )
        return min(max_q, self.chunk_queries)

    def search(
        self, queries: np.ndarray, top_k: int = 100,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        return self._dispatch(queries, top_k, weights, ids_only=False,
                              doc_mask=doc_mask)

    def search_ids(
        self, queries: np.ndarray, top_k: int = 100,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | None = None,
    ) -> np.ndarray:
        """Rankings only: the scores never leave the device.  Selection
        and the cross-shard merge still run in f32 on the device, as in
        ``SparseEngine.search_ids``."""
        return self._dispatch(queries, top_k, weights, ids_only=True,
                              doc_mask=doc_mask)

    def _plan(self, queries, weights, k: int):
        """Dedup + chunk planning: ``(cq, padded, wpadded)`` chunks, the
        one source that ``_dispatch_batch`` and ``bench_step_fn`` share.
        Rows pad to ``8 * n_data`` so that every data row gets the same
        slice."""
        from bm25_tpu_torch.models.sparse import (maybe_dedup,
                                                  plan_query_dispatch)

        queries, weights = maybe_dedup(
            queries, weights, self.dedup_queries, self.dedup_min_width
        )
        align = 8 * self.mesh.shape[DATA_AXIS]
        return plan_query_dispatch(
            queries, next_multiple(self._max_chunk(), align), weights,
            q_align=align)

    def _k_local(self, k: int):
        if self.k_local == "auto":
            return choose_k_local(k, self.mesh.shape[DOC_AXIS])
        return self.k_local

    def _step_fn(self, k: int, ids_only: bool, local_only: bool = False):
        """The sharded step for one configuration, built in exactly one
        place so that ``bench_step_fn`` and ``_dispatch_batch`` run the
        same step."""
        from bm25_tpu_torch.models.sparse import _score_sdt

        return make_sharded_ell_step(
            self.mesh, k, self.hot_h, self.buckets,
            score_dtype=None if ids_only else _score_sdt(self.score_dtype),
            ids_only=ids_only, k_local=self._k_local(k),
            local_only=local_only,
        )

    def bench_step_fn(self, queries: np.ndarray, top_k: int,
                      local_only: bool = False):
        """The production step and its device operands for the FIRST
        planned chunk (unmasked, scores and ids): ``(fn, args,
        n_chunks)``; ``fn(*args)`` enqueues one step and returns its
        device results without a fetch.  Planning (dedup included) goes
        through ``_plan``, so the timed chunk is the production chunk;
        ``args[1].padded`` is its padded (Q, T) ids.  ``local_only`` stops
        after the shards' local top k (``make_sharded_ell_step``)."""
        queries, _ = validate_query_batch(queries, self.vocab_size, None)
        k = min(top_k, self.num_docs)
        chunks = self._plan(queries, None, k)
        _cq, padded, wpadded = chunks[0]
        fn = self._step_fn(k, ids_only=False, local_only=local_only)
        return (fn, (self.hot_table, put_queries(self.mesh, padded, wpadded)),
                len(chunks))

    def _prepare_doc_mask(self, doc_mask):
        if doc_mask is None:
            return None
        m = np.asarray(doc_mask)
        if m.shape != (self.num_docs,):
            raise ValueError(
                f"doc_mask shape {m.shape} != ({self.num_docs},)"
            )
        # replicated: bucket rows interleave global ids, so the mask
        # cannot split over the doc axis (each shard reads it by its ids)
        return _replicated(self.mesh, m.astype(bool))

    def _dispatch_batch(self, queries, k: int, weights, ids_only: bool,
                        dmask):
        """Plan and enqueue one batch with no host sync (outside the
        k_local trim's flag): each chunk's results start their copy into
        pinned host memory, and one event a device recorded after the last
        marks them fetched.  Returns ``(futures, events)``."""
        chunks = self._plan(queries, weights, k)
        weighted = bool(chunks) and chunks[0][2] is not None
        if not ids_only and self._offsets_host is None:
            self._offsets_host = self.offsets.numpy()
        step = self._step_fn(k, ids_only)
        futures = []
        for cq, padded, wpadded in chunks:
            outs = step(self.hot_table,
                        put_queries(self.mesh, padded, wpadded), dmask)
            qoff = None
            if not ids_only:
                # token offsets are doc-independent: added on the host in
                # f32 after the device's rounding to score_dtype (padded
                # ids' pad slots read offset row 0 with zero weight)
                valid = padded[:cq] >= 0
                off = self._offsets_host
                wv = wpadded[:cq] if weighted else 1.0
                qoff = (np.where(
                    valid, off[np.where(valid, padded[:cq], 0)], 0.0
                ) * wv).sum(1)
            futures.append(_fetch(cq, qoff, outs, ids_only))
        return futures, _record_events(self.mesh)

    @staticmethod
    def _collect_batch(futures, events, ids_only: bool, masked: bool):
        """Wait for one dispatched batch's events and assemble its
        results: the docs, or ``(docs, scores)``."""
        _wait(events)
        docs = [_rows(f.docs)[: f.cq] for f in futures]
        if ids_only:
            return np.concatenate(docs)
        out = []
        for f, d in zip(futures, docs):
            s = (_rows(f.scores).astype(np.float32)[: f.cq]
                 + f.qoff[:, None]).astype(np.float32)
            if masked:
                # the host add reached the doc -1 shortfall slots too;
                # restore their score-0 contract
                s[d == -1] = 0.0
            out.append(s)
        return np.concatenate(docs), np.concatenate(out)

    def _dispatch(self, queries, top_k, weights, ids_only: bool,
                  doc_mask=None):
        queries, weights = validate_query_batch(
            queries, self.vocab_size, weights
        )
        dmask = self._prepare_doc_mask(doc_mask)
        k = min(top_k, self.num_docs)
        if len(queries) == 0 or k <= 0:
            return empty_results(len(queries), k, ids_only=ids_only)
        return self._collect_batch(
            *self._dispatch_batch(queries, k, weights, ids_only, dmask),
            ids_only, masked=dmask is not None)

    def search_pipelined(
        self, queries: np.ndarray, top_k: int = 100, batch: int = 512,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | None = None, ids_only: bool = False,
    ):
        """Double-buffered large-batch search: batch i+1 is dispatched
        before batch i is collected, so the host plans, launches and
        copies out one batch while the card computes the next.  Same
        contract as :meth:`search` (ids only with ``ids_only``), one set
        of events a batch, as ``SparseEngine.search_pipelined``."""
        queries, weights = validate_query_batch(
            queries, self.vocab_size, weights
        )
        dmask = self._prepare_doc_mask(doc_mask)
        masked = dmask is not None
        k = min(top_k, self.num_docs)
        if len(queries) == 0 or k <= 0:
            return empty_results(len(queries), k, ids_only=ids_only)
        out_docs, out_scores = [], []

        def collect(pending):
            res = self._collect_batch(*pending, ids_only, masked=masked)
            if ids_only:
                out_docs.append(res)
            else:
                out_docs.append(res[0])
                out_scores.append(res[1])

        pending = None
        for i in range(0, len(queries), batch):
            qb = queries[i : i + batch]
            wb = None if weights is None else weights[i : i + batch]
            dispatched = self._dispatch_batch(qb, k, wb, ids_only, dmask)
            if pending is not None:
                collect(pending)
            pending = dispatched
        collect(pending)
        docs = np.concatenate(out_docs)
        if ids_only:
            return docs
        return docs, np.concatenate(out_scores)


def dryrun_sharded_step(n_devices: int, device=None) -> None:
    """One full sharded query step on tiny shapes, over a mesh that names
    ``device`` (default: the card) ``n_devices`` times.

    Exercises the option surface: dense and sparse sharded engines,
    weighted queries, budget-driven query chunking, rankings-only search,
    doc masks and a slot-tiled wide bucket, all oracle-checked.
    """
    from bm25_tpu_torch.ops.ell_score import SLOT_TILE
    from bm25_tpu_torch.reference import ReferenceEngine
    from bm25_tpu_torch.scoring import build_scored_index

    device = torch.device("cuda" if device is None else device)
    rng = np.random.default_rng(0)
    ids = [
        rng.integers(0, 64, size=rng.integers(3, 12)).astype(np.int32)
        for _ in range(40)
    ]
    index = build_scored_index(ids, vocab_size=64)
    data = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, data=data, devices=[device] * n_devices)
    engine = ShardedEngine.from_scored_index(index, mesh=mesh)
    queries = rng.integers(-1, 64, size=(9, 5), dtype=np.int32)
    docs, scores = engine.search(queries, top_k=7)
    assert docs.shape == (9, 7) and scores.shape == (9, 7)
    assert int(docs.max()) < index.num_docs

    oracle = ReferenceEngine.from_scored_index(index)
    od, os_ = oracle.search(queries, top_k=7)
    np.testing.assert_allclose(scores, os_, rtol=1e-5, atol=1e-6)

    # dense path with a budget small enough to force query chunking
    engine.score_buffer_budget = engine.st.shape[1] * 4 * 8 * data
    docs_c, scores_c = engine.search(queries, top_k=7)
    np.testing.assert_allclose(scores_c, os_, rtol=1e-5, atol=1e-6)

    # the doc-sharded ELL path over the same mesh: weighted + chunked,
    # plus rankings-only (route_cold is set as JAX's dry run sets it; the
    # port does not route)
    sp = ShardedSparseEngine.from_scored_index(index, mesh=mesh, hot_tokens=4)
    sp.route_cold = True
    sp.chunk_queries = 8 * data
    w = np.where(queries >= 0, 1.0, 0.0).astype(np.float32)
    docs2, scores2 = sp.search(queries, top_k=7, weights=w)
    np.testing.assert_allclose(np.sort(scores2, axis=1), np.sort(os_, axis=1),
                               rtol=1e-5, atol=1e-6)
    ids_only = sp.search_ids(queries, top_k=7)
    np.testing.assert_array_equal(ids_only, docs2)

    # filtered search over both engines (replicated mask on the ELL path,
    # doc-sharded mask on the dense path)
    mask = rng.random(index.num_docs) < 0.5
    om, _ = oracle.search(queries, top_k=7, doc_mask=mask)
    dm, _ = engine.search(queries, top_k=7, doc_mask=mask)
    np.testing.assert_array_equal(dm == -1, om == -1)
    assert mask[dm[dm >= 0]].all()
    dm2, _ = sp.search(queries, top_k=7, doc_mask=mask)
    np.testing.assert_array_equal(dm2 == -1, om == -1)
    assert mask[dm2[dm2 >= 0]].all()

    # a slot-tiled wide bucket in the shards: a long-document corpus
    # whose widest ELL bucket exceeds SLOT_TILE
    wvocab = 2048
    wdocs = [
        rng.integers(0, wvocab, size=int(n)).astype(np.int32)
        for n in rng.integers(3, 12, size=24)
    ] + [
        rng.choice(wvocab, size=SLOT_TILE + 104, replace=False)
        .astype(np.int32)
        for _ in range(4)
    ]
    widx = build_scored_index(wdocs, vocab_size=wvocab)
    wsp = ShardedSparseEngine.from_scored_index(
        widx, mesh=mesh, hot_tokens=0, max_buckets=2
    )
    widths = [b["tokT"].shape[0] for b in wsp.buckets if "tokT" in b]
    assert max(widths) > SLOT_TILE, f"bucket widths {widths} single-tile"
    wq = rng.integers(-1, wvocab, size=(6, 5), dtype=np.int32)
    wd, ws = wsp.search(wq, top_k=5)
    wod, wos = ReferenceEngine.from_scored_index(widx).search(wq, top_k=5)
    np.testing.assert_allclose(ws, wos, rtol=1e-5, atol=1e-6)
