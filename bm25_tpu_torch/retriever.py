"""High-level retrieval facade: text in, ranked documents out.

The bm25s-style UX the reference pipeline uses
(``reference/bm25_test.py:22-31``: tokenize -> index -> retrieve ->
save/load) as one object bundling tokenizer + vocab + device engine +
optional corpus store.  The port's copy of ``bm25_tpu/retriever.py``:
``fit`` and ``load`` build the port's engines, on ``session`` (default:
the CUDA session).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from bm25_tpu_torch.index.builder import build_index
from bm25_tpu_torch.index.io import MMapCorpus, load_index, save_index
from bm25_tpu_torch.scoring import BM25Params, ScoredIndex
from bm25_tpu_torch.text.tokenizer import Tokenizer


@dataclass
class Retriever:
    index: ScoredIndex
    engine: object
    tokenizer: Tokenizer
    corpus: object | None = None  # MMapCorpus or list[str]

    # -- construction --------------------------------------------------------

    @classmethod
    def fit(
        cls,
        corpus: Sequence[str],
        params: BM25Params | None = None,
        tokenizer: Tokenizer | None = None,
        engine_mode: str = "auto",
        save_to: str | None = None,
        session=None,
    ) -> "Retriever":
        """Index a text corpus and stand up a device engine."""
        from bm25_tpu_torch.models.auto import create_engine

        tokenizer = tokenizer or Tokenizer()
        # materialize BEFORE indexing: build_index consumes its input, so
        # a generator corpus would leave the stored text list empty
        corpus = list(corpus)
        index, _ = build_index(
            corpus, params=params, tokenizer=tokenizer, save_to=save_to
        )
        engine = create_engine(index, mode=engine_mode, session=session)
        return cls(index=index, engine=engine, tokenizer=tokenizer,
                   corpus=corpus)

    @classmethod
    def load(
        cls,
        index_dir: str,
        engine_mode: str = "auto",
        tokenizer: Tokenizer | None = None,
        mmap: bool = False,
        session=None,
    ) -> "Retriever":
        """Load a saved (bm25s-format) index directory.

        The tokenizer persisted at build time (tokenizer.index.json) is
        reconstructed automatically; pass ``tokenizer`` only to override
        it (e.g. an index built with custom callables, which are not
        persistable).  ``mmap=True`` maps the npy triplet read-only
        (bm25s ``BM25.load(..., mmap=True)`` analog): host RAM stays
        O(1) in nnz while the engine build streams pages from disk.
        """
        from bm25_tpu_torch.index.io import load_tokenizer_config
        from bm25_tpu_torch.models.auto import create_engine

        index = load_index(index_dir, mmap=mmap)
        if index.vocab is None:
            raise ValueError(f"{index_dir} has no vocab.index.json")
        engine = create_engine(index, mode=engine_mode, session=session)
        try:
            corpus = MMapCorpus.open(index_dir)
        except FileNotFoundError:
            corpus = None
        if tokenizer is None:
            tokenizer = load_tokenizer_config(index_dir) or Tokenizer()
        return cls(index=index, engine=engine,
                   tokenizer=tokenizer, corpus=corpus)

    # -- retrieval -----------------------------------------------------------

    def retrieve(
        self, queries: Sequence, k: int = 10, return_text: bool = False,
        doc_mask=None,
    ):
        """Batched text retrieval -> (docs (Q,k), scores (Q,k) [, texts]).

        Each query is a plain string, or a ``{term: weight}`` mapping for
        weighted retrieval (query expansion etc.) — weighted terms scale
        their tokens' score contributions on device.  ``doc_mask``
        ((num_docs,) bool, True = eligible) restricts results to a doc
        subset; shortfall slots are doc -1 / score 0 (their texts come
        back empty).
        """
        if isinstance(queries, (str, dict)):
            # a bare string would explode into per-CHARACTER queries via
            # list(); treat single query values as a batch of one
            queries = [queries]
        queries = list(queries)
        kw = {} if doc_mask is None else {"doc_mask": doc_mask}
        if any(isinstance(q, dict) for q in queries):
            ids, wts = self.tokenizer.tokenize_weighted_queries(
                queries, self.index.vocab
            )
            docs, scores = self.engine.search(ids, top_k=k, weights=wts, **kw)
        else:
            ids = self.tokenizer.tokenize_queries(queries, self.index.vocab)
            docs, scores = self.engine.search(ids, top_k=k, **kw)
        if not return_text:
            return docs, scores
        texts = [[self.text(int(d)) if int(d) >= 0 else "" for d in row]
                 for row in docs]
        return docs, scores, texts

    def explain(self, query, doc_id: int) -> dict:
        """Per-term score breakdown for one (query, document) pair.

        Lucene-``explain``-style relevance debugging, absent from the
        reference: decomposes exactly the quantity the engines score
        (reference semantics ``reference/bm25_native.py:129-158`` —
        sum of gathered pre-scored CSC columns, plus the per-token
        nonoccurrence offset for bm25l/bm25+) into one entry per query
        term, so "why did/didn't this document rank" is answerable.

        ``query`` is a plain string or a ``{term: weight}`` mapping —
        the same surface ``retrieve`` accepts.  Plain-query duplicates
        aggregate into one entry with their occurrence count as the
        weight (the engines score per occurrence; the sum is identical).
        OOV/stopword-only terms appear with ``token_id=-1`` and zero
        contribution rather than being silently dropped.

        Returns ``{"doc_id", "score", "terms": [{"term", "token",
        "token_id", "weight", "df", "idf", "tf_score", "offset",
        "contribution", "matched"}, ...]}`` where ``score`` is the sum of
        contributions — equal (up to float32 accumulation order) to the
        score ``retrieve`` would report for this document.
        """
        from bm25_tpu_torch.scoring import explain_score

        return explain_score(self.index, self.tokenizer, query, doc_id)

    def text(self, doc_id: int) -> str:
        if self.corpus is None:
            raise ValueError("no corpus stored with this retriever")
        doc = self.corpus[doc_id]
        return doc["text"] if isinstance(doc, dict) else doc

    def save(self, path: str, with_corpus: bool = True) -> None:
        import os

        from bm25_tpu_torch.index.io import save_tokenizer_config

        corpus = self.corpus if with_corpus else None
        if isinstance(corpus, MMapCorpus) and os.path.realpath(
            corpus.path
        ) == os.path.realpath(os.path.join(os.fspath(path), "corpus.jsonl")):
            # saving into the directory the mmap corpus is reading from:
            # rewriting corpus.jsonl would truncate the file under the
            # reader; the corpus is already persisted there, skip it
            corpus = None
        # dict records pass through save_corpus intact (metadata survives)
        # and any indexable corpus streams one doc at a time — an
        # MMapCorpus is never materialized in host RAM
        save_index(path, self.index, corpus=corpus)
        save_tokenizer_config(path, self.tokenizer)
