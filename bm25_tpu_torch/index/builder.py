"""End-to-end index build pipeline: raw texts -> scored CSC index (+ save).

The TPU-native counterpart of the reference's canonical build flow
(``reference/bm25_test.py:16-36``: tokenize -> BM25().index -> save).
The port's copy of ``bm25_tpu/index/builder.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

from bm25_tpu_torch.scoring import BM25Params, ScoredIndex, build_scored_index
from bm25_tpu_torch.text.tokenizer import Tokenizer

from .io import save_index, save_tokenizer_config


@dataclass
class BuildStats:
    num_docs: int
    vocab_size: int
    nnz: int
    tokenize_seconds: float
    score_seconds: float

    @property
    def docs_per_second(self) -> float:
        total = self.tokenize_seconds + self.score_seconds
        return self.num_docs / total if total > 0 else float("inf")


def _tokenize_shard(args):
    """Worker for the parallel build: tokenize one contiguous doc range."""
    texts, cfg = args
    from bm25_tpu_torch.text.tokenizer import Tokenizer

    return Tokenizer(**cfg).tokenize_corpus(texts)


def build_index(
    corpus: Sequence[str],
    params: BM25Params | None = None,
    tokenizer: Tokenizer | None = None,
    save_to: str | None = None,
    save_corpus: bool = True,
    workers: int = 1,
) -> tuple[ScoredIndex, BuildStats]:
    """Tokenize + score a corpus; optionally persist in bm25s layout.

    ``workers > 1`` tokenizes contiguous doc shards in spawned worker
    processes and merges them (same bit-exact merge as the multi-host
    build, ``index/merge.py``) — a near-linear speedup on multi-core
    hosts since tokenization dominates build time.  Requires a tokenizer
    whose config is picklable (strings/None for stopwords and stemmer;
    custom callables fall back to single-process).
    """
    tokenizer = tokenizer or Tokenizer()
    t0 = time.perf_counter()
    tok = None
    if workers > 1 and len(corpus) >= 2 * workers:
        cfg = {
            "stopwords": tokenizer.stopwords,
            "stemmer": tokenizer.stemmer,
            "token_pattern": tokenizer.token_pattern,
            "lower": tokenizer.lower,
            "use_native": tokenizer.use_native,
        }
        if all(v is None
               or isinstance(v, (str, bool, frozenset, set, list, tuple))
               for v in (cfg["stopwords"], cfg["stemmer"])):
            import multiprocessing as mp

            from bm25_tpu_torch.index.merge import merge_tokenized_shards

            corpus = list(corpus)
            per = -(-len(corpus) // workers)
            chunks = [
                (corpus[i : i + per], cfg)
                for i in range(0, len(corpus), per)
            ]
            # spawn (not fork): never inherit an initialized accelerator
            # runtime into workers
            with mp.get_context("spawn").Pool(len(chunks)) as pool:
                shards = pool.map(_tokenize_shard, chunks)
            tok = merge_tokenized_shards(shards)
    if tok is None:
        tok = tokenizer.tokenize_corpus(corpus)
    t1 = time.perf_counter()
    index = build_scored_index(
        tok.ids, vocab_size=len(tok.vocab), params=params, vocab=tok.vocab
    )
    t2 = time.perf_counter()
    stats = BuildStats(
        num_docs=index.num_docs,
        vocab_size=index.vocab_size,
        nnz=index.nnz,
        tokenize_seconds=t1 - t0,
        score_seconds=t2 - t1,
    )
    if save_to is not None:
        save_index(save_to, index, corpus=list(corpus) if save_corpus else None)
        save_tokenizer_config(save_to, tokenizer)
    return index, stats
