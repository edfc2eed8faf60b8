"""Dense engine — PyTorch counterpart of ``bm25_tpu/models/dense.py``.

The index lives on the device as one token-major score table
``st[V_pad, D_pad]`` (``st[v, d]`` is token v's BM25 contribution to doc
d; the last row is all zero).  A query's score row is the sum of its
tokens' table rows, which kernel B3 (``ops/gather_rows.py``) gathers and
accumulates in one pass; padded doc columns (and docs outside a
``doc_mask``) become -inf, and the exact top-k tree selects the result,
ties to the smaller doc id.  Per-token offsets (bm25l / bm25+) are added
last.

Padding contract: query id -1 (pad/OOV) indexes the all-zero last row, so
it adds nothing; doc columns are padded to ``doc_pad(D)``, the kernel's
vector quantum.  PyTorch runs eagerly on any shape, so the JAX module's
query padding (Q to a multiple of 8, T to a power of two) and its compile
cache are gone.

``scoring="matmul"`` is the full-vocabulary product of exact f32 token
counts (a scatter-add) with the table, ``torch.matmul`` in f32; the JAX
module splits the table into a bf16 high/residual pair for the TPU's
matrix unit, which f32 on the card does not need.  The product runs in
full f32 (TF32 off) whatever the caller's float32 matmul setting.

Suitable where V * D fits the device; ``create_engine`` picks it then,
and ``SparseEngine`` otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bm25_tpu_torch.scoring import ScoredIndex
from bm25_tpu_torch.utils.padding import next_multiple
from bm25_tpu_torch.utils.validate import empty_results, validate_query_batch
from bm25_tpu_torch.ops.gather_rows import doc_pad, gather_add_rows
from bm25_tpu_torch.ops.topk import select_top_k
from bm25_tpu_torch.models.sparse import device_hbm_bytes, prepare_doc_mask
from bm25_tpu_torch.runtime.session import (Session, full_f32_matmul,
                                             get_session)
from bm25_tpu_torch.utils.counts import weighted_counts

NEG_INF = float("-inf")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def table_dtype(dtype) -> torch.dtype:
    """The torch dtype of a table: torch.float32 or torch.bfloat16, given
    as a torch dtype, a numpy / ml_dtypes dtype or its name."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"table dtype must be float32 or bfloat16, not {dtype}")
    return _DTYPES[name]


def table_bytes(vocab_size: int, num_docs: int, dtype=torch.float32) -> int:
    """Device bytes of the (V+1 rounded to 8) x doc_pad(D) table."""
    v_pad = next_multiple(vocab_size + 1, 8)
    return v_pad * doc_pad(num_docs) * table_dtype(dtype).itemsize


def make_query_step(num_docs: int, k: int, scoring: str = "gather"):
    """The (st, offsets, ids) -> (top_scores (Q, k) f32, top_docs (Q, k)
    int32) step for ``num_docs`` real docs.

    ``ids`` is (Q, T) int32 with -1 for pads; ``w`` (Q, T) f32 weights and
    ``dmask`` a (num_docs,) bool mask are optional; ``st_pair`` is the
    matmul scoring's f32 copy of a bf16 table (``DenseEngine._st_pair``).
    """
    if scoring not in ("gather", "matmul"):
        raise ValueError(f"unknown scoring {scoring!r}")

    def step(st, offsets, ids, st_pair=None, w=None, dmask=None):
        d_pad = st.shape[1]
        zero_row = st.shape[0] - 1  # the all-zero pad/OOV target
        valid = ids >= 0
        safe = torch.where(valid, ids, zero_row).to(torch.int32)
        if w is not None:
            w = torch.where(valid, w.float(), 0.0)
        if scoring == "matmul":
            table = st if st.dtype == torch.float32 else st_pair[0]
            cf = weighted_counts(torch.where(valid, ids, -1),
                                 valid.float() if w is None else w,
                                 st.shape[0])
            with full_f32_matmul():
                scores = cf @ table
        else:
            scores = gather_add_rows(st, safe, weights=w)

        # doc-independent per-token offsets (bm25l / bm25+)
        off = offsets[safe.long()]
        if w is not None:
            qoff = (off * w).sum(dim=1)
        else:
            qoff = torch.where(valid, off, 0.0).sum(dim=1)

        elig = torch.arange(d_pad, device=st.device) < num_docs
        if dmask is not None:  # filtered search: True = eligible
            elig = elig & torch.cat([dmask, dmask.new_zeros(d_pad - num_docs)])
        masked = torch.where(elig, scores, NEG_INF)
        top_scores, top_docs = select_top_k(masked, k)
        top_docs = top_docs.to(torch.int32)
        final = top_scores.float() + qoff[:, None]
        if dmask is not None:
            # slots beyond the eligible count: doc -1 / score 0
            ok = top_scores > NEG_INF
            top_docs = torch.where(ok, top_docs, -1)
            final = torch.where(ok, final, 0.0)
        return final, top_docs

    return step


@dataclass
class DenseEngine:
    """Device-resident dense BM25 engine."""

    st: torch.Tensor  # (V_pad, D_pad) f32 or bf16, token-major, last row 0
    offsets: torch.Tensor  # (V_pad,) f32 per-token offsets
    num_docs: int
    vocab_size: int
    session: Session
    vocab: dict[str, int] | None = None
    scoring: str = "gather"  # or "matmul" (full-vocabulary product)
    # the matmul scoring's f32 copy of a bf16 table, built on first use
    # (the JAX engine keeps its bf16 high/residual split here); an f32
    # table needs none
    _st_pair: tuple | None = None

    # -- construction --------------------------------------------------------

    @classmethod
    def from_scored_index(
        cls,
        index: ScoredIndex,
        session: Session | None = None,
        max_bytes: int | None = None,
        dtype=torch.float32,
    ) -> "DenseEngine":
        """Lay the index out as the dense table on the session's device.

        ``max_bytes`` (default: half the device's memory) caps the table;
        past it a ``MemoryError`` points to ``SparseEngine``.  The table is
        filled on the device: the CSC postings are uploaded and scattered
        into a zeroed table, so host memory stays near the index size.
        """
        session = session or get_session()
        dtype = table_dtype(dtype)
        v, d = index.vocab_size, index.num_docs
        v_pad = next_multiple(v + 1, 8)  # +1 zero row for pad/OOV ids
        d_pad = doc_pad(d)
        if max_bytes is None:
            max_bytes = device_hbm_bytes(session.device) // 2
        need = table_bytes(v, d, dtype)
        if need > max_bytes:
            raise MemoryError(
                f"dense engine needs {need / 2**30:.1f} GiB ({v_pad} x "
                f"{d_pad} {dtype}) > budget {max_bytes / 2**30:.1f} GiB; use "
                "models.sparse.SparseEngine"
            )
        csc = index.to_csc()
        tok = np.repeat(np.arange(v, dtype=np.int64), np.diff(csc.indptr))
        flat = tok * d_pad + csc.indices.astype(np.int64)
        st = torch.zeros((v_pad, d_pad), dtype=dtype, device=session.device)
        st.view(-1)[session.put(flat)] = session.put(
            np.asarray(csc.data, np.float32)).to(dtype)
        off_host = np.zeros((v_pad,), dtype=np.float32)
        if index.token_offsets is not None:
            off_host[:v] = index.token_offsets
        return cls(st=st, offsets=session.put(off_host), num_docs=d,
                   vocab_size=v, session=session, vocab=index.vocab)

    @classmethod
    def from_arrays(
        cls,
        st: np.ndarray,
        offsets: np.ndarray,
        num_docs: int,
        vocab_size: int,
        session: Session | None = None,
        vocab: dict[str, int] | None = None,
        scoring: str = "gather",
    ) -> "DenseEngine":
        """An engine from copies of another engine's table and offsets,
        e.g. ``np.asarray`` of a JAX ``DenseEngine``'s ``st`` (bf16 as
        ``ml_dtypes`` bfloat16) and ``offsets``: the doc axis of an array
        is re-padded from the other engine's width to this one's
        ``doc_pad``.  A tensor (a device checkpoint's) keeps its own
        padding, a whole number of ``doc_pad``'s quanta, and is used as it
        is where it already lies on the session's device."""
        session = session or get_session()
        v_pad = next_multiple(vocab_size + 1, 8)
        if st.ndim != 2 or st.shape[0] != v_pad or st.shape[1] < num_docs:
            raise ValueError(f"st shape {tuple(st.shape)} does not hold "
                             f"({v_pad}, >= {num_docs})")
        table_dtype(st.dtype)
        if isinstance(st, torch.Tensor):
            if doc_pad(st.shape[1]) != st.shape[1]:
                raise ValueError(f"st's {st.shape[1]} doc columns are not "
                                 "a doc_pad width")
        else:
            st = np.asarray(st)
            d_pad = doc_pad(num_docs)
            if st.shape[1] >= d_pad:
                st = st[:, :d_pad]
            else:
                wide = np.zeros((v_pad, d_pad), dtype=st.dtype)
                wide[:, : st.shape[1]] = st
                st = wide
        offsets = session.put(offsets).float()
        if tuple(offsets.shape) != (v_pad,):
            raise ValueError(f"offsets shape {tuple(offsets.shape)} != "
                             f"({v_pad},)")
        return cls(st=session.put(st), offsets=offsets,
                   num_docs=num_docs, vocab_size=vocab_size, session=session,
                   vocab=vocab, scoring=scoring)

    # -- query path -----------------------------------------------------------

    def search(
        self, queries: np.ndarray, top_k: int = 100,
        weights: np.ndarray | None = None,
        doc_mask: np.ndarray | torch.Tensor | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched top-k: (Q, T) int (-1 = pad) -> (docs (Q, k) int32,
        scores (Q, k) f32).

        ``weights`` (same shape, float) scales each token's contribution
        (pad entries ignored).  ``doc_mask`` ((num_docs,) bool, True =
        eligible; a tensor on the session's device is used as it is)
        restricts results to a doc subset; slots beyond the eligible count
        come back as doc -1 / score 0.
        """
        queries, weights = validate_query_batch(queries, self.vocab_size,
                                                weights)
        queries = queries.astype(np.int32)
        k = min(top_k, self.num_docs)
        if len(queries) == 0 or k <= 0:
            return empty_results(len(queries), k)
        dmask = None
        if doc_mask is not None:
            dmask = prepare_doc_mask(doc_mask, self.num_docs, self.session)
        scores, docs = self._dispatch(queries, k, weights, dmask)
        return self.session.get(docs), self.session.get(scores)

    def search_pipelined(
        self, queries: np.ndarray, top_k: int = 100, batch: int = 512
    ) -> tuple[np.ndarray, np.ndarray]:
        """Large-batch search in sub-batches of ``batch`` queries: every
        sub-batch is enqueued on the current stream without waiting, and
        the results are fetched once at the end."""
        queries, _ = validate_query_batch(queries, self.vocab_size)
        queries = queries.astype(np.int32)
        k = min(top_k, self.num_docs)
        if len(queries) == 0 or k <= 0:
            return empty_results(len(queries), k)
        outs = [self._dispatch(queries[i : i + batch], k)
                for i in range(0, len(queries), batch)]
        docs = self.session.get(torch.cat([d for _, d in outs]))
        scores = self.session.get(torch.cat([s for s, _ in outs]))
        return docs, scores

    def _dispatch(self, queries: np.ndarray, k: int,
                  weights: np.ndarray | None = None, dmask=None):
        """Enqueue one sub-batch; returns its device (scores, docs)."""
        step = make_query_step(self.num_docs, k, self.scoring)
        if self.scoring == "matmul" and self.st.dtype != torch.float32 \
                and self._st_pair is None:
            self._st_pair = (self.st.float(),)
        w = None
        if weights is not None:
            w = self.session.put(np.asarray(weights, np.float32))
        return step(self.st, self.offsets, self.session.put(queries),
                    self._st_pair, w, dmask)

    def get_scores(self, query_ids) -> np.ndarray:
        """Dense (D,) scores for a single query."""
        ids = np.asarray(query_ids, dtype=np.int32).reshape(1, -1)
        docs, scores = self.search(ids, top_k=self.num_docs)
        out = np.zeros(self.num_docs, dtype=np.float32)
        out[docs[0]] = scores[0]
        return out
