"""bm25_tpu_torch: the PyTorch / CUDA port of bm25-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``bm25_tpu``.  It keeps that
package's module layout and names, runs eagerly on an explicit
``torch.device``, and launches hand-written CUDA kernels (``csrc/``) on
the query paths of both engines and in the top-k op library, and serves
them over HTTP with live updates (``Server``, ``UpdatableRetriever``),
restarting warm from device checkpoints (``save_device_checkpoint``,
``load_device_checkpoint``), and shards an index over several devices or
processes (``ShardedEngine``, ``ShardedSparseEngine``: imported on first
access, with ``bm25_tpu_torch.parallel``).  It
imports neither JAX nor ``bm25_tpu``: the host layer (tokenizer, scoring maths,
index builders, bm25s index I/O, the oracle, ``Retriever`` and the eval
helpers) is the port's own copy of ``bm25_tpu``'s JAX-free modules, under
the same names.
"""

from bm25_tpu_torch.compat import BM25, BM25v
from bm25_tpu_torch.index.builder import build_index
from bm25_tpu_torch.index.device_checkpoint import (load_device_checkpoint,
                                                     save_device_checkpoint)
from bm25_tpu_torch.index.io import MMapCorpus, load_index, save_index
from bm25_tpu_torch.index.snapshot import load_snapshot, save_snapshot
from bm25_tpu_torch.index.streaming import StreamingIndexBuilder
from bm25_tpu_torch.index.updates import UpdatableRetriever
from bm25_tpu_torch.models.auto import create_engine
from bm25_tpu_torch.models.dense import DenseEngine
from bm25_tpu_torch.models.sparse import SparseEngine
from bm25_tpu_torch.ops.registry import custom
from bm25_tpu_torch.ops.topk import top_k
from bm25_tpu_torch.reference import ReferenceEngine, topk_descending
from bm25_tpu_torch.retriever import Retriever
from bm25_tpu_torch.runtime.session import Session, get_session
from bm25_tpu_torch.scoring import (BM25Params, ScoredIndex,
                                    build_scored_index, explain_score)
from bm25_tpu_torch.serve import Server
from bm25_tpu_torch.text.tokenizer import (TokenizedCorpus, Tokenizer,
                                           pad_token_lists)

_LAZY = {
    "ShardedEngine": ("bm25_tpu_torch.parallel.sharded_engine",
                      "ShardedEngine"),
    "ShardedSparseEngine": ("bm25_tpu_torch.parallel.sharded_engine",
                            "ShardedSparseEngine"),
}


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module), attr)


__all__ = [
    "BM25Params", "ScoredIndex", "build_scored_index", "explain_score",
    "ReferenceEngine", "topk_descending",
    "Tokenizer", "TokenizedCorpus", "pad_token_lists",
    "build_index", "load_index", "save_index", "MMapCorpus", "Retriever",
    "Session", "get_session", "SparseEngine", "DenseEngine", "create_engine",
    "top_k", "custom", "BM25", "BM25v", "Server", "UpdatableRetriever",
    "StreamingIndexBuilder", "save_snapshot", "load_snapshot",
    "save_device_checkpoint", "load_device_checkpoint", *_LAZY,
]
