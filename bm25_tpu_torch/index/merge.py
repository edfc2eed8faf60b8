"""Merging per-host partial indexes into one global index.

Completes the multi-host (DCN) build path (SURVEY.md section 5): each host
tokenizes and scores its contiguous doc range (parallel.distributed.
DocShardPlan), producing a partial ScoredIndex with a host-local vocab;
``merge_shard_indexes`` re-maps vocabularies onto a shared global vocab,
offsets doc ids, recomputes the corpus-global DF/IDF, and re-scores — so
the merged index is bit-identical to a single-host build over the full
corpus (tested in tests/test_merge.py).

Why re-score: BM25 weights depend on corpus-global statistics (df, N,
avgdl), which no shard knows alone.  Shards therefore carry their
TOKENIZED corpora (per-doc token-id streams + a host-local vocab);
the merge remaps every stream onto one global vocab (first-occurrence
order, so it is deterministic in shard order) and re-runs the
counting-sort scoring build over the combined streams — O(total corpus
tokens), the same cost as the single-host build it replaces.  The port's
copy of ``bm25_tpu/index/merge.py``.
"""

from __future__ import annotations

import numpy as np

from bm25_tpu_torch.scoring import BM25Params, ScoredIndex, build_scored_index
from bm25_tpu_torch.text.tokenizer import TokenizedCorpus


def remap_vocab(local_vocab: dict, global_vocab: dict) -> np.ndarray:
    """Local-id -> global-id remap array; grows ``global_vocab`` in place
    (first-occurrence order).  Shared by the shard merge and the
    streaming builder so the two can't drift."""
    remap = np.empty(max(len(local_vocab), 1), dtype=np.int32)
    for term, tid in local_vocab.items():
        gid = global_vocab.get(term)
        if gid is None:
            gid = len(global_vocab)
            global_vocab[term] = gid
        remap[tid] = gid
    return remap


def merge_tokenized_shards(shards: list[TokenizedCorpus]) -> TokenizedCorpus:
    """Concatenate per-host tokenized shards under one global vocab."""
    global_vocab: dict[str, int] = {}
    ids: list[np.ndarray] = []
    for shard in shards:
        remap = remap_vocab(shard.vocab, global_vocab)
        ids.extend(remap[doc] for doc in shard.ids)
    return TokenizedCorpus(ids=ids, vocab=global_vocab)


def merge_shard_indexes(
    shards: list[TokenizedCorpus], params: BM25Params | None = None
) -> ScoredIndex:
    """Global scored index from per-host tokenized shards (order = doc order)."""
    merged = merge_tokenized_shards(shards)
    return build_scored_index(
        merged.ids,
        vocab_size=len(merged.vocab),
        params=params,
        vocab=merged.vocab,
    )
