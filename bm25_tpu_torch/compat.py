"""Drop-in API compatibility with the reference's Python classes.

``BM25``  mirrors ``reference/bm25.py:6`` (fit / get_scores /
get_top_n on token-string corpora) and ``BM25v`` mirrors
``reference/bm25_native.py:32`` (index / search on pre-scored sparse
matrices) — same signatures and return conventions, backed by the port's
engines.

The port's copy of ``bm25_tpu/compat.py``.  Both classes take one more
keyword, ``session``: the engine is built by the port's ``create_engine`` on
it, by default on the process's CUDA session (``get_session()``), which
raises where there is no CUDA device.  There is no host fallback: the JAX
version's switch to ``ReferenceEngine`` when no accelerator is present is
not copied.  Tests pass ``Session("cpu")``.

A reference user can switch imports:
    from bm25_tpu_torch.compat import BM25, BM25v
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from bm25_tpu_torch.models.auto import create_engine
from bm25_tpu_torch.runtime.session import Session, get_session
from bm25_tpu_torch.scoring import BM25Params, ScoredIndex, build_scored_index


class BM25:
    """Reference ``bm25.py`` API: corpora of pre-tokenized string lists.

    Scoring formula parity: ``method='classic'`` is exactly
    ``bm25.py:96-121`` (lucene idf x (k1+1)-saturation).
    """

    def __init__(self, k1: float = 1.5, b: float = 0.75,
                 session: Session | None = None):
        self.k1 = k1
        self.b = b
        self.session = session
        self.corpus_size = 0
        self.avgdl = 0.0
        self.doc_len: list[int] = []
        self.vocabulary: list[str] = []
        self.term_to_id: dict[str, int] = {}
        self.bm25_matrix = None  # dense (docs x terms), like the reference
        self._engine = None
        self._index: ScoredIndex | None = None

    def fit(self, corpus: list[list[str]]) -> None:
        self.corpus_size = len(corpus)
        if self.corpus_size == 0:
            # reset state from any previous fit (the reference rebuilds its
            # term maps every fit): stale term_to_id/_engine would answer
            # get_scores for the OLD corpus while corpus_size says 0
            self.vocabulary = []
            self.term_to_id = {}
            self.doc_len = []
            self.avgdl = 0.0
            self.bm25_matrix = None
            self._engine = None
            self._index = None
            return
        # reference vocabulary order: sorted unique terms (bm25.py:63)
        vocab_terms = sorted({t for doc in corpus for t in doc})
        self.vocabulary = vocab_terms
        self.term_to_id = {t: i for i, t in enumerate(vocab_terms)}
        ids = [
            np.array([self.term_to_id[t] for t in doc], dtype=np.int32)
            for doc in corpus
        ]
        self.doc_len = [len(d) for d in corpus]
        self.avgdl = float(np.mean(self.doc_len)) if corpus else 0.0
        self._index = build_scored_index(
            ids,
            vocab_size=len(vocab_terms),
            params=BM25Params(k1=self.k1, b=self.b, method="classic"),
            vocab=dict(self.term_to_id),
        )
        self.bm25_matrix = self._index.to_csc().toarray()
        self._engine = create_engine(self._index,
                                     session=self.session or get_session())

    def get_scores(self, query: list[str]) -> np.ndarray:
        if self._index is None:
            return np.zeros(self.corpus_size)
        q = [self.term_to_id[t] for t in query if t in self.term_to_id]
        if not q:
            return np.zeros(self.corpus_size)
        return self._engine.get_scores(np.array(q, dtype=np.int32))

    def get_top_n(self, query: list[str], corpus: list, n: int = 5):
        if n <= 0:
            return []
        scores = self.get_scores(query)
        if scores is None or scores.shape[0] == 0:
            return []
        n = min(n, self.corpus_size)
        top = np.argsort(scores)[::-1][:n]
        return [(scores[i], corpus[i]) for i in top]


class BM25v:
    """Reference ``bm25_native.py`` API: pre-scored CSC matrix in, top-k out."""

    def __init__(self, k1: float = 1.5, b: float = 0.75,
                 session: Session | None = None):
        self.k1 = k1
        self.b = b
        self.session = session
        self.dtype = np.float32
        self.doc_toks: sp.csc_matrix | None = None
        self.doc_lengths = np.zeros((0,), dtype=self.dtype)
        self.avg_doc_length = 0.0
        self.num_docs = 0
        self._engine = None

    def index(self, doc_toks: sp.csc_matrix, doc_lengths: np.ndarray) -> None:
        self.doc_toks = doc_toks
        self.doc_lengths = doc_lengths
        self.avg_doc_length = float(np.mean(doc_lengths))
        self.num_docs = doc_toks.shape[0]
        csc = doc_toks.tocsc()
        csc.sort_indices()
        scored = ScoredIndex(
            indptr=csc.indptr.astype(np.int32),
            indices=csc.indices.astype(np.int32),
            data=csc.data.astype(np.float32),
            num_docs=self.num_docs,
            doc_lengths=np.asarray(doc_lengths).astype(np.int32),
            params=BM25Params(k1=self.k1, b=self.b),
        )
        self._engine = create_engine(scored,
                                     session=self.session or get_session())

    def search(self, queries: np.ndarray, top_k: int = 100):
        """(Q, T) int32 (negative = padding) -> (docs (Q,k), scores (Q,k))."""
        if self._engine is None:
            raise ValueError("BM25v index not built. Call index() first.")
        queries = np.asarray(queries)
        if len(queries) == 0:
            # (0, k_eff) so per-batch results concatenate cleanly
            k = min(top_k, self._engine.num_docs)
            return (
                np.zeros((0, max(k, 0)), dtype=self.dtype),
                np.zeros((0, max(k, 0)), dtype=self.dtype),
            )
        return self._engine.search(queries, top_k=top_k)

    def get_scores(self, queries: np.ndarray, top_k: int):
        return self.search(queries, top_k)
