"""Device-layout snapshots: persist engine-ready padded arrays.

The port's copy of ``bm25_tpu/index/snapshot.py`` (numpy only; the same
``.npz`` format, so a snapshot saved by either package loads in the
other).

Checkpoint/resume parity (SURVEY.md section 5): the reference persists only
the CSC index (bm25s save/load, ``reference/bm25_test.py:35-42``); the
TPU build adds a second artifact — the engine's device layout (dense
token-major matrix or ELL buckets) serialized as an ``.npz`` so serving
restarts skip the CSC -> device-layout rebuild and upload straight from the
snapshot.
"""

from __future__ import annotations

import json
import os

import numpy as np

from bm25_tpu_torch.scoring import BM25Params, ScoredIndex

SNAPSHOT_VERSION = 1


def save_snapshot(path: str | os.PathLike, index: ScoredIndex) -> None:
    """Write a single-file engine snapshot (csc triplet + metadata)."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta = {
        "version": SNAPSHOT_VERSION,
        "num_docs": index.num_docs,
        "params": {
            "k1": index.params.k1,
            "b": index.params.b,
            "delta": index.params.delta,
            "method": index.params.method,
            # idf_method must round-trip: dropping it silently changes
            # effective_idf_method for every rescoring consumer of the
            # loaded index (UpdatableEngine add-path, save_index)
            "idf_method": index.params.idf_method,
        },
        "vocab": index.vocab,
    }
    # write via temp + atomic rename: a crash mid-save must not leave a
    # truncated zip at the snapshot path (same torn-write discipline as
    # the update WAL)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp.npz"
    np.savez_compressed(
        tmp,
        indptr=index.indptr,
        indices=index.indices,
        data=index.data,
        doc_lengths=index.doc_lengths,
        token_offsets=(
            index.token_offsets
            if index.token_offsets is not None
            else np.zeros(0, np.float32)
        ),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )
    os.replace(tmp, final)


def load_snapshot(path: str | os.PathLike) -> ScoredIndex:
    path = os.fspath(path)
    # np.savez_compressed appends .npz to extension-less save paths; accept
    # the same path the caller passed to save_snapshot
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] != SNAPSHOT_VERSION:
            raise ValueError(f"unsupported snapshot version {meta['version']}")
        token_offsets = z["token_offsets"]
        if not (token_offsets.size and np.any(token_offsets)):
            token_offsets = None
        return ScoredIndex(
            indptr=z["indptr"],
            indices=z["indices"],
            data=z["data"],
            num_docs=int(meta["num_docs"]),
            doc_lengths=z["doc_lengths"],
            params=BM25Params(**meta["params"]),
            vocab=meta["vocab"],
            token_offsets=token_offsets,
        )
