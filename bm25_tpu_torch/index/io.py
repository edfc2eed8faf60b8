"""On-disk index format: bm25s v0.2.12-compatible save/load.

Artifact set (byte-compatible with ``reference/animal_index_bm25/``,
produced there by ``bm25s.BM25.save`` — see ``reference/bm25_test.py:35``):

* ``data.csc.index.npy``    float32 (nnz,)  precomputed BM25 contributions
* ``indices.csc.index.npy`` int32   (nnz,)  doc ids, ascending per column
* ``indptr.csc.index.npy``  int32   (V+1,)  token-column offsets
* ``vocab.index.json``      term -> id, plus the ``""`` padding token at id V
* ``params.index.json``     k1/b/delta/method/idf_method/dtype/int_dtype/
                            num_docs/version/backend
* ``corpus.jsonl``          one ``{"id": i, "text": ...}`` object per line
* ``corpus.mmindex.json``   byte offset of each line for mmap/seek access

Doc lengths are not persisted by the format (they are baked into the scores),
so ``load_index`` reconstructs ``doc_lengths`` as zeros unless the caller
recomputes them; searching needs only the scores.  The port's copy of
``bm25_tpu/index/io.py``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from bm25_tpu_torch.scoring import BM25Params, ScoredIndex

FORMAT_VERSION = "0.2.12"
PAD_TOKEN = ""


def _params_to_json(p: BM25Params, num_docs: int, int_dtype: str = "int32") -> dict:
    return {
        "k1": p.k1,
        "b": p.b,
        "delta": p.delta,
        "method": p.method,
        "idf_method": p.effective_idf_method,
        "dtype": "float32",
        "int_dtype": int_dtype,
        "num_docs": num_docs,
        "version": FORMAT_VERSION,
        "backend": "jax-tpu",
    }


def save_index(
    path: str | os.PathLike,
    index: ScoredIndex,
    corpus: list[str] | None = None,
    doc_ids: list | None = None,
) -> None:
    """Write a scored index (and optionally its corpus) in bm25s layout."""
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    # copy=False: the arrays usually already have the target dtype, and a
    # gratuitous astype copy transiently doubles RSS at 20M-doc scale
    np.save(os.path.join(path, "data.csc.index.npy"),
            index.data.astype(np.float32, copy=False))
    np.save(os.path.join(path, "indices.csc.index.npy"),
            index.indices.astype(np.int32, copy=False))
    # bm25s pins int32 offsets; above 2^31-1 postings an int32 cast would
    # silently wrap, so keep int64 (recorded in params.index.json int_dtype;
    # load_index reads either width)
    indptr_dtype = np.int32 if index.nnz < 2**31 else np.int64
    np.save(
        os.path.join(path, "indptr.csc.index.npy"),
        index.indptr.astype(indptr_dtype, copy=False),
    )

    vocab = dict(index.vocab) if index.vocab else {
        str(i): i for i in range(index.vocab_size)
    }
    if PAD_TOKEN not in vocab:
        vocab[PAD_TOKEN] = len(vocab)
    with open(os.path.join(path, "vocab.index.json"), "w") as f:
        json.dump(vocab, f)

    with open(os.path.join(path, "params.index.json"), "w") as f:
        json.dump(
            _params_to_json(
                index.params, index.num_docs, int_dtype=np.dtype(indptr_dtype).name
            ),
            f,
            indent=4,
        )

    if index.token_offsets is not None and np.any(index.token_offsets):
        np.save(
            os.path.join(path, "nonoccurrence_array.index.npy"),
            index.token_offsets.astype(np.float32),
        )

    # doc lengths are an extension record (bm25s does not persist them);
    # stored so engines can round-trip avgdl without re-tokenizing.
    np.save(
        os.path.join(path, "doc_lengths.index.npy"),
        index.doc_lengths.astype(np.int32),
    )

    if corpus is not None:
        save_corpus(path, corpus, doc_ids=doc_ids)


def save_tokenizer_config(path: str | os.PathLike, tokenizer) -> None:
    """Persist the tokenizer pipeline next to the index (extension record).

    Without it, loading an index built with a non-default tokenizer
    silently tokenizes queries with the default pipeline — query terms
    miss the stemmed/filtered vocab with no error.  Skipped (with no
    file) when the tokenizer carries unserializable custom callables.
    """
    cfg = tokenizer.config() if hasattr(tokenizer, "config") else None
    if cfg is None:
        return
    with open(os.path.join(os.fspath(path), "tokenizer.index.json"),
              "w") as f:
        json.dump(cfg, f)


def load_tokenizer_config(path: str | os.PathLike):
    """The Tokenizer persisted by save_tokenizer_config, or None."""
    p = os.path.join(os.fspath(path), "tokenizer.index.json")
    if not os.path.exists(p):
        return None
    from bm25_tpu_torch.text.tokenizer import Tokenizer

    with open(p) as f:
        return Tokenizer.from_config(json.load(f))


def save_corpus(path: str | os.PathLike, corpus, doc_ids=None) -> None:
    """Write corpus.jsonl + corpus.mmindex.json (line byte offsets).

    ``corpus`` items are plain texts or dict records; dicts pass through
    with every field intact (an ``id`` is added if absent) so metadata
    survives a load -> save round trip.  Any indexable sequence streams
    one document at a time (an ``MMapCorpus`` is never materialized).

    Both files are written beside their targets and moved into place
    (``os.replace``): an ``MMapCorpus`` still open on the old files (a
    server whose compaction persists into the directory it serves) keeps
    reading the old ones instead of a file truncated under it.
    """
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    offsets = []
    pos = 0
    jsonl = os.path.join(path, "corpus.jsonl")
    with open(jsonl + ".tmp", "wb") as f:
        for i, doc in enumerate(corpus):
            offsets.append(pos)
            did = doc_ids[i] if doc_ids is not None else i
            if isinstance(doc, dict):
                rec = dict(doc)
                rec.setdefault("id", did)
            else:
                rec = {"id": did, "text": doc}
            line = json.dumps(rec) + "\n"
            data = line.encode("utf-8")
            f.write(data)
            pos += len(data)
    mmindex = os.path.join(path, "corpus.mmindex.json")
    with open(mmindex + ".tmp", "w") as f:
        json.dump(offsets, f)
    os.replace(jsonl + ".tmp", jsonl)
    os.replace(mmindex + ".tmp", mmindex)


def load_index(path: str | os.PathLike, mmap: bool = False) -> ScoredIndex:
    """Load a bm25s-format index directory into a host ScoredIndex.

    ``mmap=True`` maps the npy triplet read-only instead of reading it
    into RAM (the analog of ``bm25s.BM25.load(..., mmap=True)`` —
    the reference's canonical loader is ``bm25s.BM25.load`` at
    ``reference/bm25_test.py:40``).  Host memory stays O(1) in nnz;
    pages stream in as the engine build or the host oracle touches them.
    Safe because nothing downstream mutates the triplet in place (the
    engine builders only read/fancy-index it); anything needing a
    writable array must copy first.
    """
    path = os.fspath(path)
    mode = "r" if mmap else None
    data = np.load(os.path.join(path, "data.csc.index.npy"), mmap_mode=mode)
    indices = np.load(
        os.path.join(path, "indices.csc.index.npy"), mmap_mode=mode
    )
    indptr = np.load(
        os.path.join(path, "indptr.csc.index.npy"), mmap_mode=mode
    )
    with open(os.path.join(path, "params.index.json")) as f:
        pj = json.load(f)
    method = pj.get("method", "lucene")
    idf_method = pj.get("idf_method")
    params = BM25Params(
        k1=float(pj.get("k1", 1.5)),
        b=float(pj.get("b", 0.75)),
        delta=float(pj.get("delta", 0.5)),
        method=method,
        idf_method=None if idf_method == method else idf_method,
    )
    vocab = None
    vpath = os.path.join(path, "vocab.index.json")
    if os.path.exists(vpath):
        with open(vpath) as f:
            vocab = json.load(f)
        # drop the "" padding symbol if it is not a real matrix column
        if PAD_TOKEN in vocab and vocab[PAD_TOKEN] >= len(indptr) - 1:
            vocab = {k: v for k, v in vocab.items() if k != PAD_TOKEN}
    num_docs = int(pj["num_docs"])
    dlpath = os.path.join(path, "doc_lengths.index.npy")
    if os.path.exists(dlpath):
        doc_lengths = np.load(dlpath, mmap_mode=mode)
    else:
        doc_lengths = np.zeros(num_docs, dtype=np.int32)
    token_offsets = None
    nopath = os.path.join(path, "nonoccurrence_array.index.npy")
    if os.path.exists(nopath):
        token_offsets = np.load(nopath, mmap_mode=mode)
    return ScoredIndex(
        indptr=indptr,
        indices=indices,
        data=data,
        num_docs=num_docs,
        doc_lengths=doc_lengths,
        params=params,
        vocab=vocab,
        token_offsets=token_offsets,
    )


@dataclass
class MMapCorpus:
    """Seekable corpus reader over corpus.jsonl using corpus.mmindex.json.

    Mirrors the byte-offset convention of the reference artifacts
    (``reference/animal_index_bm25/corpus.mmindex.json``) so individual
    documents are retrievable without loading the whole file.

    Offsets are held as one int64 array with a file-size sentinel (a
    JSON-parsed Python list costs ~50+ bytes per entry — ~1 GB of pure
    offset overhead at 20M docs), so every line's byte extent is known
    up front and reads go through a persistent fd via ``os.pread`` —
    positionless, hence thread-safe on the serving hot path with no lock
    and no per-document ``open()`` syscall.
    """

    path: str
    offsets: np.ndarray  # int64 (n+1,): line starts + total-size sentinel
    _fd: int | None = None

    @classmethod
    def open(cls, index_dir: str | os.PathLike) -> "MMapCorpus":
        index_dir = os.fspath(index_dir)
        with open(os.path.join(index_dir, "corpus.mmindex.json")) as f:
            offsets = np.asarray(json.load(f), dtype=np.int64)
        path = os.path.join(index_dir, "corpus.jsonl")
        offsets = np.append(offsets, os.path.getsize(path))
        # open the fd eagerly: a lazy first-read init would need a lock to
        # avoid two racing threads each os.open()ing (one fd leaks)
        return cls(path=path, offsets=offsets,
                   _fd=os.open(path, os.O_RDONLY))

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def _pread(self, i: int) -> bytes:
        if self._fd is None:
            self._fd = os.open(self.path, os.O_RDONLY)
        start = int(self.offsets[i])
        return os.pread(self._fd, int(self.offsets[i + 1]) - start, start)

    def __getitem__(self, i: int):
        if not 0 <= i < len(self):
            raise IndexError(i)
        return json.loads(self._pread(i))

    def batch(self, ids) -> list:
        out = []
        for i in ids:
            i = int(i)
            if not 0 <= i < len(self):
                # the engines' -1 shortfall sentinel (and any stale id)
                # must raise, not silently return some other document
                raise IndexError(i)
            out.append(json.loads(self._pread(i)))
        return out

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):  # best-effort fd release
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
