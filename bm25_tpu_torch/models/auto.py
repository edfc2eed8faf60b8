"""Engine selection — PyTorch counterpart of ``bm25_tpu/models/auto.py``.

Dense (the token-major table and kernel B3) when the table fits the
device budget; beyond that the sparse ELL + hot-tier engine keeps device
memory near the CSC footprint.
"""

from __future__ import annotations

import inspect

from bm25_tpu_torch.scoring import ScoredIndex
from bm25_tpu_torch.models.dense import DenseEngine, table_bytes
from bm25_tpu_torch.models.sparse import SparseEngine, device_hbm_bytes
from bm25_tpu_torch.runtime.profiling import span
from bm25_tpu_torch.runtime.session import get_session


def _build(cls, index, kwargs, filter_kwargs: bool):
    """The engine ``cls`` built from ``index``: the span ``build.engine``."""
    # explicit modes keep strict kwargs: a typo or an option the chosen
    # engine doesn't support must raise, not silently no-op
    if filter_kwargs:
        # mode="auto": keep only the kwargs the chosen engine understands,
        # so engine-specific options (e.g. the sparse engine's hot_tokens
        # and score_dtype) compose
        params = inspect.signature(cls.from_scored_index).parameters
        kwargs = {k: v for k, v in kwargs.items() if k in params}
    with span("build.engine"):
        return cls.from_scored_index(index, **kwargs)


def create_engine(
    index: ScoredIndex,
    mode: str = "auto",
    dense_budget_bytes: int | None = None,
    **kwargs,
):
    """Build the device engine for this index.

    mode: "auto" / "dense" / "sparse" / "sharded" / "sharded_sparse" (the
    doc-sharded engines of ``parallel/sharded_engine.py``, over ``mesh=``
    or by default every visible card).  Extra
    kwargs pass through to the chosen engine's ``from_scored_index``.
    Under mode="auto" kwargs the chosen engine doesn't take are dropped;
    explicit modes keep strict kwargs and raise on unknown options.

    ``mode="auto"`` picks ``DenseEngine`` when its real table, (V+1
    rounded to 8) x ``doc_pad(D)`` x the dtype's size, fits
    ``dense_budget_bytes``: by default half of the session device's
    memory, capped by a ``max_bytes`` kwarg, and forwarded as the dense
    engine's ``max_bytes``.
    """
    if mode == "sharded":
        from bm25_tpu_torch.parallel.sharded_engine import ShardedEngine

        return _build(ShardedEngine, index, kwargs, filter_kwargs=False)
    if mode == "sharded_sparse":
        from bm25_tpu_torch.parallel.sharded_engine import \
            ShardedSparseEngine

        return _build(ShardedSparseEngine, index, kwargs, filter_kwargs=False)
    if mode == "dense":
        return _build(DenseEngine, index, kwargs, filter_kwargs=False)
    if mode == "sparse":
        return _build(SparseEngine, index, kwargs, filter_kwargs=False)
    if mode != "auto":
        raise ValueError(f"unknown engine mode {mode!r}")

    if dense_budget_bytes is None:
        session = kwargs.get("session") or get_session()
        dense_budget_bytes = device_hbm_bytes(session.device) // 2
    # a user's max_bytes is a hard cap on the dense engine: the decision
    # respects it, or auto would pick dense and then fail on its MemoryError
    if kwargs.get("max_bytes") is not None:
        dense_budget_bytes = min(dense_budget_bytes, kwargs["max_bytes"])
    need = table_bytes(index.vocab_size, index.num_docs,
                       kwargs.get("dtype") or "float32")
    if need <= dense_budget_bytes:
        kw = dict(kwargs)
        kw["max_bytes"] = dense_budget_bytes
        return _build(DenseEngine, index, kw, filter_kwargs=True)
    return _build(SparseEngine, index, kwargs, filter_kwargs=True)
