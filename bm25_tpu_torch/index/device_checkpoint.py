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

The sharded engines (``ShardedEngine``, ``ShardedSparseEngine``) store
each doc shard's piece of every ``MeshTensor`` under its global shard
index (``st.<s>``, ``buckets.<i>.<name>.<s>``; one piece a shard, even
where several shards share a device) and the replicated tensors once
(``offsets``, ``hot_table``); each shard's hot pair is stored sparse and
rebuilt on its device by two B2 scans.  The sidecar adds JAX's
``mesh_shape``, and its ``tree`` gives the global shapes JAX's does.  On
a mesh across processes each process writes its own shards, process 0
to ``path`` and process p to ``<path>.p<p>`` (the sidecar, written by
process 0, then records ``processes``), as JAX's Orbax checkpoint has
each process write its own shards; a load reads each shard from the file
that holds it.  ``load_device_checkpoint(path, mesh)`` restores onto
``mesh`` (default: ``make_mesh()``, or the session's CPU), which must
have the saved doc axis.

What differs from JAX: a path that is a directory (an Orbax checkpoint
of the JAX package) is refused with a ``ValueError`` that names the
format, and ``restore_device_checkpoint`` needs the sidecar, since the
port never wrote a checkpoint without one (JAX's pre-sidecar Orbax path
has no counterpart here).
"""

from __future__ import annotations

import json
import os

import torch

from bm25_tpu_torch.runtime.session import Session

CHECKPOINT_VERSION = 4
_SHARDED_ENGINES = ("ShardedEngine", "ShardedSparseEngine")
_HOT_SPARSE = ("hotNzRank", "hotNzPos", "hotNzHi", "hotNzLo")
_TAIL_KEYS = ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
              "tail_gpos")


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


def _engine_meta(engine, state: dict | None = None,
                 tree: dict | None = None) -> dict:
    """Metadata sidecar; pass the already-computed ``state`` from the save
    path (recomputing it would sparsify the hot pairs a second time), or
    a sharded engine's ``tree`` of global shapes."""
    if tree is None:
        if state is None:
            state = _engine_state(engine)
        tree = {
            key: ([{k: [list(t.shape), _dtype_name(t)]
                    for k, t in b.items()} for b in val]
                  if key == "buckets"
                  else [list(val.shape), _dtype_name(val)])
            for key, val in state.items()
        }
    meta = {
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
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:
        # a sharded bucket's rows align to B1's row block times the doc
        # axis at build: a load onto another doc axis is refused by name
        meta["mesh_shape"] = {str(k): int(v) for k, v in mesh.shape.items()}
        if mesh.process_count > 1:
            meta["processes"] = mesh.process_count
    return meta


def _piece_file(path: str, process: int) -> str:
    """The file of one process's shards: ``path`` for process 0."""
    return path if process == 0 else f"{path}.p{process}"


def _sharded_leaves(engine) -> tuple[dict, dict]:
    """This process's pieces of a sharded engine, flat (``st.<s>``,
    ``buckets.<i>.<name>.<s>`` for global shard s, the replicated
    ``offsets`` and ``hot_table`` once) with every hot pair sparse, and
    the sidecar's tree of global shapes (a sparse hot leaf's length
    summed over every process's shards)."""
    from bm25_tpu_torch.models.sparse import hot_pair_to_sparse
    from bm25_tpu_torch.parallel.distributed import all_gather_shards

    mesh = engine.mesh
    shards = [mesh.shard_index(j) for j in range(mesh.local_docs)]

    def leaf(t):
        return [list(t.shape), _dtype_name(t.parts[0][0])]

    flat = {"offsets": engine.offsets.on(0, 0)}
    if type(engine).__name__ == "ShardedEngine":
        flat.update({f"st.{s}": engine.st.on(0, j)
                     for j, s in enumerate(shards)})
        return flat, {"st": leaf(engine.st), "offsets": leaf(engine.offsets)}
    flat["hot_table"] = engine.hot_table.on(0, 0)
    tree = []
    for i, b in enumerate(engine.buckets):
        node = {}
        for name, t in b.items():
            if name in ("hotT", "hotLo"):
                continue
            node[name] = leaf(t)
            flat.update({f"buckets.{i}.{name}.{s}": t.on(0, j)
                         for j, s in enumerate(shards)})
        if "hotT" in b:
            nnz = []
            for j, s in enumerate(shards):
                sp = hot_pair_to_sparse(b["hotT"].on(0, j),
                                        b["hotLo"].on(0, j))
                flat.update({f"buckets.{i}.{k}.{s}": v for k, v in sp.items()})
                nnz.append(len(sp["hotNzRank"]))
            total = int(all_gather_shards(torch.tensor(
                nnz, device=mesh.devices[0, 0])).sum())
            node.update({k: [[total], _dtype_name(flat[
                f"buckets.{i}.{k}.{shards[0]}"])] for k in _HOT_SPARSE})
        tree.append(node)
    return flat, {"buckets": tree, "offsets": leaf(engine.offsets),
                  "hot_table": leaf(engine.hot_table)}


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


def _save_file(flat: dict, path: str) -> None:
    tmp = path + ".partial"
    try:
        torch.save({k: t.detach().contiguous().cpu()
                    for k, t in flat.items()}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _write_checkpoint(path: str, engine, compact: bool) -> None:
    if type(engine).__name__ in _SHARDED_ENGINES:
        _write_sharded(path, engine)
        return
    state = _engine_state(engine, compact=compact)
    _save_file(_flatten(state), path)
    with open(_meta_path(path), "w") as f:
        json.dump(_engine_meta(engine, state), f)


def _write_sharded(path: str, engine) -> None:
    """Each process writes its own shards' file; process 0 the sidecar;
    in a process group every rank waits for the others."""
    import torch.distributed as dist

    flat, tree = _sharded_leaves(engine)
    mesh = engine.mesh
    _save_file(flat, _piece_file(path, mesh.process_index))
    if mesh.process_index == 0:
        with open(_meta_path(path), "w") as f:
            json.dump(_engine_meta(engine, tree=tree), f)
    if mesh.process_count > 1:
        dist.barrier()


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


def _check_mesh(path: str, meta: dict, mesh) -> None:
    """JAX's refusal of a mesh whose doc axis is not the saved one."""
    from bm25_tpu_torch.parallel.mesh import DOC_AXIS

    saved = meta.get("mesh_shape")
    live = int(mesh.shape[DOC_AXIS])
    if saved is not None and int(saved.get(DOC_AXIS, live)) != live:
        raise ValueError(
            f"{path}: checkpoint was saved on a mesh with "
            f"{saved.get(DOC_AXIS)} doc shards but the restore "
            f"mesh has {live} — bucket row alignment is "
            "fixed at build time; restore on a matching mesh or "
            "rebuild the engine from the host index"
        )


def _sharded_state(path: str, meta: dict, mesh) -> dict:
    """The checkpoint's engine fields as ``MeshTensor`` s on ``mesh``:
    each shard's pieces read (``mmap``) from the file that holds it and
    moved to its device, each shard's hot pair rebuilt there by two B2
    scans (``rebuild_hot_pair_from_sparse``); every process reads only
    the shards its mesh holds."""
    from bm25_tpu_torch.models.sparse import rebuild_hot_pair_from_sparse
    from bm25_tpu_torch.parallel.mesh import DOC_AXIS
    from bm25_tpu_torch.parallel.sharded_engine import place

    _check_mesh(path, meta, mesh)
    per_file = mesh.shape[DOC_AXIS] // meta.get("processes", 1)
    files: dict[int, dict] = {}

    def read(key: str, shard: int) -> torch.Tensor:
        p = shard // per_file
        if p not in files:
            files[p] = _restore_state(_piece_file(path, p),
                                      torch.device("cpu"))
        return files[p][key if key in ("offsets", "hot_table")
                        else f"{key}.{shard}"]

    first = mesh.shard_index(0)

    def replicated(key):
        host = read(key, first)
        return place(mesh, lambda _j, dev: host.to(dev), axis=None)

    def sharded(key, axis):
        return place(mesh, lambda j, dev: read(key, mesh.shard_index(j))
                     .to(dev), axis=axis)

    tree = meta["tree"]
    if meta["engine"] == "ShardedEngine":
        return {"st": sharded("st", 1), "offsets": replicated("offsets")}
    buckets = []
    for i, node in enumerate(tree["buckets"]):
        entry = {name: sharded(f"buckets.{i}.{name}", 0 if name == "doc_ids"
                               else 1)
                 for name in node if name not in _HOT_SPARSE}
        if "hotNzRank" in node:
            pairs: dict = {}

            def pair(j, dev, part, i=i, pairs=pairs):
                if (j, dev) not in pairs:
                    s = mesh.shard_index(j)
                    sparse = {k: read(f"buckets.{i}.{k}", s)
                              for k in _HOT_SPARSE}
                    rows = read(f"buckets.{i}.doc_ids", s).shape[0]
                    pairs[j, dev] = rebuild_hot_pair_from_sparse(
                        meta["hot_h"], rows, sparse, Session(dev).put)
                return pairs[j, dev][part]

            entry["hotT"] = place(mesh, lambda j, d, f=pair: f(j, d, 0), 1)
            entry["hotLo"] = place(mesh, lambda j, d, f=pair: f(j, d, 1), 1)
        buckets.append(entry)
    return {"buckets": buckets, "offsets": replicated("offsets"),
            "hot_table": replicated("hot_table")}


def _load_sharded(path: str, meta: dict, mesh, session, vocab):
    from bm25_tpu_torch.parallel.mesh import default_mesh
    from bm25_tpu_torch.parallel.sharded_engine import (ShardedEngine,
                                                        ShardedSparseEngine)

    mesh = mesh or default_mesh(session)
    state = _sharded_state(path, meta, mesh)
    common = dict(num_docs=meta["num_docs"], vocab_size=meta["vocab_size"],
                  mesh=mesh, vocab=vocab)
    if meta["engine"] == "ShardedEngine":
        return ShardedEngine(**state, **common)
    return ShardedSparseEngine(
        **state, **common, hot_h=meta["hot_h"],
        # host copies, so that cold-width routing and the offsets' host
        # add work after a warm restart
        hot_table_host=state["hot_table"].numpy(),
        _offsets_host=state["offsets"].numpy(),
        score_dtype=meta.get("score_dtype", "float32"))


def load_device_checkpoint(path: str | os.PathLike, mesh=None,
                           session=None):
    """Reconstruct an engine from a checkpoint: metadata only, no host
    index.

    This is the warm-restart path: no ScoredIndex, no ELL re-bucketing, no
    hot/cold re-split; tensors restore straight onto ``session``'s device
    (the default CUDA session when None), a sharded engine's onto
    ``mesh`` (default: every visible card, ``make_mesh()``, or the
    session's device where it is the CPU), whose doc axis must be the
    saved one.
    """
    path = os.path.abspath(os.fspath(path))
    meta = _read_meta(path)
    name = meta["engine"]
    vocab = meta["vocab"]
    if vocab is not None:
        vocab = dict(vocab)
    if name in _SHARDED_ENGINES:
        return _load_sharded(path, meta, mesh, session, vocab)
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
    variant restores into a live engine whose session (or mesh) should be
    kept.
    """
    path = os.path.abspath(os.fspath(path))
    meta = _read_meta(path)
    # refuse mismatched restores up front: a wrong-engine or wrong-corpus
    # checkpoint whose shapes happen to line up would otherwise set its
    # tensors cleanly and serve wrong results with no error
    live_name = type(engine).__name__
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
    if live_name in _SHARDED_ENGINES:
        # onto the live engine's mesh, with its host copies refreshed
        for key, val in _sharded_state(path, meta, engine.mesh).items():
            setattr(engine, key, val)
        if live_name == "ShardedSparseEngine":
            engine.hot_table_host = engine.hot_table.numpy()
            engine._offsets_host = engine.offsets.numpy()
        return
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
    # the routing's host copy follows the restored table (a checkpoint of
    # the same shapes may mark other tokens hot)
    engine.hot_table_host = Session.get(engine.hot_table)
