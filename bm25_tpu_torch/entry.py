"""Entry points of the port: the dense query step over a tiny index, and
the multi-device dry run.

The counterpart of ``__graft_entry__.py``: ``entry(session)`` returns
``(fn, args)`` such that ``fn(*args)`` runs the dense engine's query step
(kernel B3's gather-accumulate, the masked top-k, the offsets) over the
same tiny index and the same four query rows, on the session's device;
``dryrun_multichip(n)`` runs one sharded step of both sharded engines
over an n-shard mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from bm25_tpu_torch.scoring import build_scored_index
from bm25_tpu_torch.models.dense import DenseEngine, make_query_step
from bm25_tpu_torch.runtime.session import Session, get_session

QUERY_IDS = [[1, 5, 9, -1], [2, 2, 7, 11], [0, -1, -1, -1], [3, 4, 5, 6]]


def tiny_index(num_docs: int = 64, vocab: int = 96, seed: int = 0):
    """The entry step's index: random token ids from ``seed``."""
    rng = np.random.default_rng(seed)
    ids = [
        rng.integers(0, vocab, size=rng.integers(4, 24)).astype(np.int32)
        for _ in range(num_docs)
    ]
    return build_scored_index(ids, vocab_size=vocab)


def entry(session: Session | None = None):
    """(fn, args): the dense query step at k=8 and its arguments
    ``(st, offsets, ids)`` on the session's device."""
    session = session or get_session()
    index = tiny_index()
    engine = DenseEngine.from_scored_index(index, session=session)
    fn = make_query_step(num_docs=index.num_docs, k=8)
    ids = torch.tensor(QUERY_IDS, dtype=torch.int32, device=session.device)
    return fn, (engine.st, engine.offsets, ids)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full sharded step of both sharded engines over an
    ``n_devices``-shard mesh (queries split over a data axis of 2 where n
    is even): per-shard scoring, local top-k and the merge, on tiny
    shapes, checked against the host oracle.  The mesh names ``device``
    (the card by default; ``"cpu"`` off it) ``n_devices`` times, so any
    shard count runs on one device, where JAX's dry run needs a fresh
    process with that many virtual CPU devices."""
    from bm25_tpu_torch.parallel.sharded_engine import dryrun_sharded_step

    dryrun_sharded_step(n_devices, device=device)
