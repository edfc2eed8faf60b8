"""Streaming (chunked) index build for corpora that don't fit as one list.

The port's copy of ``bm25_tpu/index/streaming.py``.  Each chunk
tokenizes with a chunk-local vocab, so the tokenizer's native path
(``bm25_tpu_torch/native``) runs on its ASCII documents, and the scoring
at ``finalize()`` builds the CSC with the native counting sort.

Scale path of the build pipeline (SURVEY.md section 7, step 5): documents
arrive in batches (file shards, generators, datasets); tokenization runs
per chunk, token-id streams accumulate in
flat int32 arrays, and scoring happens once at finalize.  Combined with
a doc-range plan (``parallel.distributed.DocShardPlan``), each host
builds only its doc range and the shards concatenate positionally.

With ``spill_dir`` set, buffered token-id streams spill to a flat binary
file once they exceed ``spill_threshold_bytes``, and ``finalize()`` reads
them back through a memmap — accumulation RAM stays O(chunk) instead of
O(corpus tokens), so a small-RAM host can tokenize a corpus whose id
stream only has to fit at the final scoring step (and that step reads the
memmap, saving one full in-RAM copy).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from bm25_tpu_torch.index.builder import BuildStats
from bm25_tpu_torch.scoring import BM25Params, ScoredIndex, build_scored_index
from bm25_tpu_torch.text.tokenizer import Tokenizer


@dataclass
class StreamingIndexBuilder:
    """Accumulates tokenized chunks; finalize() produces the scored index."""

    params: BM25Params | None = None
    tokenizer: Tokenizer = field(default_factory=Tokenizer)
    # spill buffered token ids to <spill_dir>/tokens.bin beyond the
    # threshold; None keeps everything in RAM
    spill_dir: str | None = None
    spill_threshold_bytes: int = 1 << 30

    _vocab: dict = field(default_factory=dict, repr=False)
    _chunks: list = field(default_factory=list, repr=False)
    _lengths: list = field(default_factory=list, repr=False)
    _num_docs: int = 0
    _tokenize_s: float = 0.0
    _buffered_bytes: int = 0
    _spilled_tokens: int = 0
    _spill_started: bool = False
    _spill_name: str | None = None

    def add(self, texts: Sequence[str]) -> int:
        """Tokenize and buffer one chunk of documents; returns docs so far."""
        from bm25_tpu_torch.index.merge import remap_vocab

        t0 = time.perf_counter()
        # tokenize with a chunk-local vocab (lets the native fast path run),
        # then remap chunk-local ids onto the shared streaming vocab (the
        # same remap helper the multi-host shard merge uses); the remap
        # applies to the FLAT stream — one vectorized gather, not one
        # array per document (this is the 20M-doc ingest path)
        tok = self.tokenizer.tokenize_corpus(texts)
        remap = remap_vocab(tok.vocab, self._vocab)
        dl = np.array([len(d) for d in tok.ids], dtype=np.int32)
        flat_local = (np.concatenate(tok.ids) if tok.ids
                      else np.zeros(0, np.int32))
        chunk = (remap[flat_local] if flat_local.size
                 else np.zeros(0, np.int32))
        self._tokenize_s += time.perf_counter() - t0
        if len(tok.ids):
            self._chunks.append(chunk)
            self._buffered_bytes += chunk.nbytes
            self._lengths.append(dl)
            if (
                self.spill_dir is not None
                and self._buffered_bytes >= self.spill_threshold_bytes
            ):
                self._spill()
        self._num_docs += len(texts)
        return self._num_docs

    @property
    def _spill_path(self) -> str:
        # unique per builder: two builders sharing one spill_dir (e.g. two
        # DocShardPlan processes on one host) must not truncate/append
        # into each other's stream
        if self._spill_name is None:
            self._spill_name = f"tokens.{os.getpid()}-{id(self):x}.bin"
        return os.path.join(self.spill_dir, self._spill_name)

    def _spill(self) -> None:
        os.makedirs(self.spill_dir, exist_ok=True)
        # truncate on this builder's FIRST spill: a stale file at the same
        # path (a previous run's pid/id collision) would otherwise be
        # silently prepended to this corpus's stream
        mode = "ab" if self._spill_started else "wb"
        self._spill_started = True
        with open(self._spill_path, mode) as f:
            for chunk in self._chunks:
                f.write(np.ascontiguousarray(chunk, dtype=np.int32).tobytes())
                self._spilled_tokens += len(chunk)
        self._chunks.clear()
        self._buffered_bytes = 0

    def add_iter(self, docs: Iterable[str], chunk_size: int = 10000) -> int:
        batch = []
        for d in docs:
            batch.append(d)
            if len(batch) >= chunk_size:
                self.add(batch)
                batch = []
        if batch:
            self.add(batch)
        return self._num_docs

    def finalize(self) -> tuple[ScoredIndex, BuildStats]:
        from bm25_tpu_torch.scoring import build_scored_index_flat

        t0 = time.perf_counter()
        lengths = (
            np.concatenate(self._lengths) if self._lengths else np.zeros(0, np.int32)
        )
        if self._spilled_tokens:
            self._spill()  # flush the remainder, then read back via memmap
            flat = np.memmap(
                self._spill_path, dtype=np.int32, mode="r",
                shape=(self._spilled_tokens,),
            )
        else:
            flat = (
                np.concatenate(self._chunks) if self._chunks else np.zeros(0, np.int32)
            )
        index = build_scored_index_flat(
            flat,
            lengths,
            vocab_size=len(self._vocab),
            params=self.params,
            vocab=dict(self._vocab),
        )
        if self._spilled_tokens:
            # the spill stream is consumed; leaving it behind accumulates
            # corpus-token-sized files in spill_dir across builds (the
            # unique naming guarantees no later run reuses it)
            del flat  # release the memmap before unlinking
            try:
                os.unlink(self._spill_path)
            except OSError:
                pass
            self._spill_started = False
            self._spilled_tokens = 0
        score_s = time.perf_counter() - t0
        stats = BuildStats(
            num_docs=index.num_docs,
            vocab_size=index.vocab_size,
            nnz=index.nnz,
            tokenize_seconds=self._tokenize_s,
            score_seconds=score_s,
        )
        return index, stats
