"""Device checkpoints: warm restart without the host rebuild.

The port's copy of ``bm25_tpu/index/device_checkpoint.py``.  An engine's
checkpoint holds every device tensor its query step reads, plus a JSON
sidecar ``<path>.meta.json`` with the scalar fields (``num_docs``,
``hot_h``, ...) and the vocab.  ``load_device_checkpoint`` rebuilds the
engine object from the sidecar and places the tensors straight on the
session's device, skipping ``from_scored_index`` (the ELL layout and the
hot/cold split) entirely.

The on-disk format is the port's own.  The JAX package writes an Orbax
directory, which needs JAX; here ``path`` is one file, a ``torch.save``
of a flat dict of CPU tensors keyed as ``SparseEngine.from_arrays`` takes
them (``buckets.<i>.<name>``, ``offsets``, ``hot_table``, ``tail_*``;
``st`` and ``offsets`` for ``DenseEngine``), read back by ``torch.load(...,
weights_only=True, mmap=True)`` onto the session's device, so that a
restore does not hold a second host copy of the tensors.  bf16 tensors
stay bf16 on disk.  The sidecar keeps JAX's fields one for one
(``version`` 4, ``engine``, ``num_docs``, ``vocab_size``, ``vocab``,
``hot_h``, ``tail_cap``, ``score_dtype`` and ``tree``, the nested
[shape, dtype name] of each tensor with JAX's dtype names).  As in JAX
v4, a bucket's hot tier is stored sparse (``hotNz{Rank,Pos,Hi,Lo}``) and
the dense bf16 pair is rebuilt on the device at restore by two B2 scans
(``models/sparse.py::rebuild_hot_pair_from_sparse``); a dense
``hotT``/``hotLo`` pair restores as it is.

What differs from JAX: a path that is a directory (an Orbax checkpoint
of the JAX package) is refused with a ``ValueError`` that names the
format; the sharded engines are not ported (``NotImplementedError``);
and ``restore_device_checkpoint`` needs the sidecar, since the port never
wrote a checkpoint without one (JAX's pre-sidecar Orbax path has no
counterpart here).
"""

from __future__ import annotations

import json
import os

import torch

CHECKPOINT_VERSION = 4
_SHARDED_ENGINES = ("ShardedEngine", "ShardedSparseEngine")
_HOT_SPARSE = ("hotNzRank", "hotNzPos", "hotNzHi", "hotNzLo")
_TAIL_KEYS = ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
              "tail_gpos")


def _refuse_sharded(name: str) -> None:
    if name in _SHARDED_ENGINES:
        raise NotImplementedError(
            f"{name}: the sharded engines are not ported yet (ROADMAP.md: "
            "the sharded engines)")


def _compact_buckets(buckets: list) -> list:
    """Bucket state with dense hot pairs replaced by their sparse form."""
    from bm25_tpu_torch.models.sparse import hot_pair_to_sparse

    out = []
    for b in buckets:
        entry = {k: v for k, v in b.items() if k not in ("hotT", "hotLo")}
        if "hotT" in b:
            entry.update(hot_pair_to_sparse(b["hotT"], b["hotLo"]))
        out.append(entry)
    return out


def _engine_state(engine, compact: bool = True) -> dict:
    """Every device tensor the engine's query step reads.

    ``compact=True`` (the save path) stores bucket hot tiers sparse;
    ``compact=False`` keeps the live dense pairs.
    """
    name = type(engine).__name__
    _refuse_sharded(name)
    if name == "DenseEngine":
        return {"st": engine.st, "offsets": engine.offsets}
    if name == "SparseEngine":
        state = {
            "buckets": (_compact_buckets(engine.buckets) if compact
                        else list(engine.buckets)),
            "offsets": engine.offsets,
            "hot_table": engine.hot_table,
        }
        for key in _TAIL_KEYS:
            t = getattr(engine, key, None)
            if t is not None:
                state[key] = t
        return state
    raise TypeError(
        f"unsupported engine type {name}; use index/snapshot.py for "
        "host-side index state"
    )


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _engine_meta(engine, state: dict | None = None) -> dict:
    """Metadata sidecar; pass the already-computed ``state`` from the save
    path (recomputing it would sparsify the hot pairs a second time)."""
    if state is None:
        state = _engine_state(engine)
    tree = {
        key: ([{k: [list(t.shape), _dtype_name(t)] for k, t in b.items()}
               for b in val] if key == "buckets"
              else [list(val.shape), _dtype_name(val)])
        for key, val in state.items()
    }
    return {
        "version": CHECKPOINT_VERSION,
        "engine": type(engine).__name__,
        "num_docs": int(engine.num_docs),
        "vocab_size": int(engine.vocab_size),
        "vocab": engine.vocab,
        "hot_h": int(getattr(engine, "hot_h", 0)),
        "tail_cap": int(getattr(engine, "tail_cap", 0)),
        "score_dtype": getattr(engine, "score_dtype", "float32"),
        "tree": tree,
    }


def _flatten(state: dict) -> dict[str, torch.Tensor]:
    """``buckets.<i>.<name>`` and the top-level keys, as CPU tensors."""
    flat = {}
    for key, val in state.items():
        if key == "buckets":
            for i, b in enumerate(val):
                for name, t in b.items():
                    flat[f"buckets.{i}.{name}"] = t.detach().contiguous().cpu()
        else:
            flat[key] = val.detach().contiguous().cpu()
    return flat


def _meta_path(path: str) -> str:
    return path + ".meta.json"


def _check_not_orbax(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package "
            "(bm25_tpu).  bm25_tpu_torch reads its own format, one "
            "torch.save file beside its .meta.json sidecar; save the "
            "checkpoint again from the port's engine")


def _write_checkpoint(path: str, engine, compact: bool) -> None:
    state = _engine_state(engine, compact=compact)
    tmp = path + ".partial"
    try:
        torch.save(_flatten(state), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(_meta_path(path), "w") as f:
        json.dump(_engine_meta(engine, state), f)


def save_device_checkpoint(path: str | os.PathLike, engine) -> None:
    """Write the engine's device tensors + metadata sidecar."""
    path = os.path.abspath(os.fspath(path))
    _check_not_orbax(path)
    _write_checkpoint(path, engine, compact=True)


def _read_meta(path: str) -> dict:
    _check_not_orbax(path)
    meta_path = _meta_path(path)
    if not os.path.exists(meta_path):
        raise ValueError(
            f"{path}: no metadata sidecar at {meta_path}; the port writes "
            "one beside every checkpoint, put it back alongside")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta["version"] > CHECKPOINT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    return meta


def _restore_state(path: str, device: torch.device) -> dict:
    """The checkpoint's flat dict of tensors, on ``device``."""
    return torch.load(path, map_location=device, weights_only=True,
                      mmap=True)


def _rebuild_buckets(flat: dict, hot_h: int, put) -> dict:
    """The flat state with every bucket's sparse hot leaves rebuilt into
    its dense (H, rows) bf16 pair (two B2 scans a bucket)."""
    from bm25_tpu_torch.models.sparse import rebuild_hot_pair_from_sparse

    out = {k: v for k, v in flat.items() if k.split(".")[-1]
           not in _HOT_SPARSE}
    n_buckets = len({k.split(".")[1] for k in flat
                     if k.startswith("buckets.")})
    for i in range(n_buckets):
        pre = f"buckets.{i}."
        if pre + "hotNzRank" not in flat:
            continue
        sparse = {k: flat[pre + k] for k in _HOT_SPARSE}
        rows = flat[pre + "doc_ids"].shape[0]
        out[pre + "hotT"], out[pre + "hotLo"] = rebuild_hot_pair_from_sparse(
            hot_h, rows, sparse, put)
    return out


def load_device_checkpoint(path: str | os.PathLike, mesh=None,
                           session=None):
    """Reconstruct an engine from a checkpoint: metadata only, no host
    index.

    This is the warm-restart path: no ScoredIndex, no ELL re-bucketing, no
    hot/cold re-split; tensors restore straight onto ``session``'s device
    (the default CUDA session when None).  ``mesh`` belongs to the
    sharded engines, which are not ported.
    """
    path = os.path.abspath(os.fspath(path))
    meta = _read_meta(path)
    name = meta["engine"]
    _refuse_sharded(name)
    if mesh is not None:
        raise NotImplementedError(
            "a mesh restores the sharded engines, which are not ported yet "
            "(ROADMAP.md: the sharded engines)")
    vocab = meta["vocab"]
    if vocab is not None:
        vocab = dict(vocab)
    if name not in ("DenseEngine", "SparseEngine"):
        raise TypeError(f"unsupported engine type {name} in checkpoint")

    from bm25_tpu_torch.runtime.session import get_session

    session = session or get_session()
    flat = _restore_state(path, session.device)
    if name == "DenseEngine":
        from bm25_tpu_torch.models.dense import DenseEngine

        return DenseEngine.from_arrays(
            flat["st"], flat["offsets"], num_docs=meta["num_docs"],
            vocab_size=meta["vocab_size"], session=session, vocab=vocab)
    from bm25_tpu_torch.models.sparse import SparseEngine

    # from_arrays re-applies the score-buffer budget (fit_score_buffer_
    # budget), as JAX's load does
    return SparseEngine.from_arrays(
        _rebuild_buckets(flat, meta["hot_h"], session.put),
        num_docs=meta["num_docs"], vocab_size=meta["vocab_size"],
        hot_h=meta["hot_h"], session=session,
        tail_cap=meta.get("tail_cap", 0), vocab=vocab,
        score_dtype=meta.get("score_dtype", "float32"))


def restore_device_checkpoint(path: str | os.PathLike, engine) -> None:
    """Restore device tensors in place of an already-built engine's.

    Prefer ``load_device_checkpoint`` (no host rebuild needed); this
    variant restores into a live engine whose session should be kept.
    """
    path = os.path.abspath(os.fspath(path))
    meta = _read_meta(path)
    # refuse mismatched restores up front: a wrong-engine or wrong-corpus
    # checkpoint whose shapes happen to line up would otherwise set its
    # tensors cleanly and serve wrong results with no error
    live_name = type(engine).__name__
    _refuse_sharded(live_name)
    if meta.get("engine") not in (None, live_name):
        raise ValueError(
            f"{path}: checkpoint holds {meta['engine']} state; the live "
            f"engine is a {live_name}"
        )
    for field in ("num_docs", "vocab_size", "hot_h"):
        saved = meta.get(field)
        live = getattr(engine, field, None)
        if saved is not None and live is not None and int(saved) != int(live):
            raise ValueError(
                f"{path}: checkpoint {field}={saved} != live engine "
                f"{field}={live}; restore into a matching engine or use "
                "load_device_checkpoint (which rebuilds the engine object "
                "from the checkpoint metadata)"
            )
    session = engine.session
    flat = _restore_state(path, session.device)
    if live_name == "DenseEngine":
        engine.st, engine.offsets = flat["st"], flat["offsets"]
        engine._st_pair = None
        return
    flat = _rebuild_buckets(flat, meta.get("hot_h", 0), session.put)
    buckets: dict[int, dict] = {}
    for key, t in flat.items():
        if key.startswith("buckets."):
            _, i, name = key.split(".")
            buckets.setdefault(int(i), {})[name] = t
        else:
            setattr(engine, key, t)
    engine.buckets = [buckets[i] for i in range(len(buckets))]
