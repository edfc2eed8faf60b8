"""The port's device checkpoints (index/device_checkpoint.py) against the
JAX package's, on the CPU.

Four engines (a sparse engine with no hot tier, one with a hot tier over
three buckets, a three-tier engine with a tail, and a dense engine) are
built by both packages at the same explicit layout from the same seeded
corpus.  Each package saves and loads its own engine (JAX through Orbax,
the port through ``torch.save``): the restored engines agree under the
campaign comparator, the port's restore is bit-equal to its source
(bf16 hot pairs included, rebuilt by two B2 scans a bucket) and the
port's sidecar carries JAX's fields.  Then the refusals, and the hot
pair's sparse form against JAX's arrays.

The sharded engines (the counterparts of ``tests/test_aux.py``'s sharded
checkpoint tests) are built by both packages on meshes of the same shape,
JAX's on the 8 virtual CPU devices and the port's on ``[cpu] * 8``: each
saves and loads (or restores in place) its own, the port's load is bit-
equal piece by piece to its source, matches JAX's load under the
comparator, rebuilds every shard's hot pair by two B2 scans and refills
the routing's host table.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_zipf_corpus

import bm25_tpu.index.device_checkpoint as jax_dc
import bm25_tpu.models.sparse as jax_sparse
from bm25_tpu.models.dense import DenseEngine as JaxDenseEngine
from bm25_tpu.reference import ReferenceEngine
from bm25_tpu.scoring import BM25Params, build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import (DenseEngine, Session, SparseEngine,
                            load_device_checkpoint, save_device_checkpoint)
from bm25_tpu_torch.index import device_checkpoint as dc
from bm25_tpu_torch.models import sparse as port_sparse
from bm25_tpu_torch.ops.gather_rows import doc_pad
from bm25_tpu_torch.parallel.mesh import make_mesh
from bm25_tpu_torch.parallel.sharded_engine import (ShardedEngine,
                                                    ShardedSparseEngine)
from bm25_tpu_torch.utils.parity import assert_matches_oracle

# bm25_tpu_torch.ops re-exports the function ell_score under its module's
# name
ops = importlib.import_module("bm25_tpu_torch.ops.ell_score")
CPU = Session("cpu")
TAIL_KEYS = ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
             "tail_gpos")
LAYOUTS = {
    "sparse_h0": dict(hot_tokens=0, max_buckets=2),
    "sparse_hot": dict(hot_tokens=32, max_buckets=3,
                       hot_budget_bytes=1 << 24),
    "three_tier": dict(hot_tokens=16, max_buckets=2, tail_cap=40,
                       hot_budget_bytes=1 << 24),
    "dense": None,
}


@pytest.fixture(scope="module")
def index():
    corpus = make_zipf_corpus(2000, vocab=400, avg_len=25, seed=11)
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    return build_scored_index(out.ids, vocab_size=len(out.vocab),
                              params=BM25Params(), vocab=out.vocab)


@pytest.fixture(scope="module")
def queries(index):
    return np.random.default_rng(5).integers(
        -1, index.vocab_size, (12, 6)).astype(np.int32)


def build_pair(index, layout):
    """(JAX engine, port engine) at the same explicit layout."""
    kw = LAYOUTS[layout]
    if kw is None:
        return (JaxDenseEngine.from_scored_index(index),
                DenseEngine.from_scored_index(index, session=CPU))
    return (jax_sparse.SparseEngine.from_scored_index(index, **kw),
            SparseEngine.from_scored_index(index, session=CPU, **kw))


def port_leaves(engine) -> dict:
    """Every tensor the engine's step reads, keyed as the checkpoint's."""
    if isinstance(engine, DenseEngine):
        return {"st": engine.st, "offsets": engine.offsets}
    out = {"offsets": engine.offsets, "hot_table": engine.hot_table}
    for i, b in enumerate(engine.buckets):
        out.update({f"buckets.{i}.{k}": t for k, t in b.items()})
    out.update({k: getattr(engine, k) for k in TAIL_KEYS
                if getattr(engine, k) is not None})
    return out


def assert_bit_equal(got, want):
    a, b = port_leaves(got), port_leaves(want)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_round_trip_matches_jax_and_its_source(index, queries, layout,
                                               tmp_path):
    jax_engine, port = build_pair(index, layout)
    if layout == "three_tier":
        assert port.tail_docs is not None and jax_engine.tail_docs is not None
    jax_path, port_path = str(tmp_path / "jax_ck"), str(tmp_path / "ck")
    jax_dc.save_device_checkpoint(jax_path, jax_engine)
    jax_restored = jax_dc.load_device_checkpoint(jax_path)
    save_device_checkpoint(port_path, port)
    assert os.path.isfile(port_path)
    before = dict(ops.plain_calls)
    restored = load_device_checkpoint(port_path, session=CPU)
    b2 = ops.plain_calls["ell_score"] - before["ell_score"]
    assert type(restored) is type(port)
    hot_buckets = sum("hotT" in b for b in getattr(port, "buckets", []))
    assert b2 == 2 * hot_buckets  # hi and lo, one B2 scan each
    assert (hot_buckets > 0) == (layout in ("sparse_hot", "three_tier"))
    assert_bit_equal(restored, port)
    assert restored.vocab == port.vocab == index.vocab
    if isinstance(port, SparseEngine):
        assert restored.tail_cap == port.tail_cap
        assert restored.score_buffer_budget == port.score_buffer_budget
    weights = np.random.default_rng(1).uniform(
        0.5, 2.0, queries.shape).astype(np.float32)
    for k, w in ((10, None), (100, weights)):
        d1, s1 = restored.search(queries, top_k=k, weights=w)
        d0, s0 = port.search(queries, top_k=k, weights=w)
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(s1, s0)
        assert_matches_oracle(d1, s1, *jax_restored.search(
            queries, top_k=k, weights=w))

    with open(port_path + ".meta.json") as f:
        meta = json.load(f)
    with open(jax_path + ".meta.json") as f:
        want = json.load(f)
    assert meta == dc._engine_meta(port)
    assert meta.pop("vocab") == want.pop("vocab")  # as dicts: any key order
    if layout == "dense":
        # the port pads the doc axis to doc_pad(D), JAX to its lane width
        v_pad = want["tree"]["st"][0][0]
        want["tree"]["st"][0] = [v_pad, doc_pad(index.num_docs)]
    assert meta == want


def test_restore_in_place(index, queries, tmp_path):
    _, port = build_pair(index, "sparse_hot")
    path = str(tmp_path / "ck")
    save_device_checkpoint(path, port)
    other = SparseEngine.from_scored_index(index, session=CPU,
                                           **LAYOUTS["sparse_hot"])
    for b in other.buckets:
        b["hotT"] = torch.zeros_like(b["hotT"])
    dc.restore_device_checkpoint(path, other)
    assert_bit_equal(other, port)
    np.testing.assert_array_equal(other.search(queries, top_k=20)[0],
                                  port.search(queries, top_k=20)[0])
    _, dense = build_pair(index, "dense")
    dpath = str(tmp_path / "dk")
    save_device_checkpoint(dpath, dense)
    fresh = DenseEngine.from_scored_index(index, session=CPU)
    fresh.st = torch.zeros_like(fresh.st)
    dc.restore_device_checkpoint(dpath, fresh)
    assert_bit_equal(fresh, dense)


def test_refusals(index, tmp_path):
    _, port = build_pair(index, "sparse_hot")
    path = str(tmp_path / "ck")
    save_device_checkpoint(path, port)
    _, dense = build_pair(index, "dense")
    with pytest.raises(ValueError, match="holds SparseEngine"):
        dc.restore_device_checkpoint(path, dense)
    small = SparseEngine.from_scored_index(
        build_scored_index([[1, 2], [2, 3]], vocab_size=index.vocab_size),
        session=CPU, hot_tokens=32, hot_budget_bytes=1 << 24)
    with pytest.raises(ValueError, match="num_docs"):
        dc.restore_device_checkpoint(path, small)
    narrow = SparseEngine.from_scored_index(index, session=CPU,
                                            hot_tokens=8, max_buckets=3,
                                            hot_budget_bytes=1 << 24)
    with pytest.raises(ValueError, match="hot_h"):
        dc.restore_device_checkpoint(path, narrow)

    meta_path = path + ".meta.json"
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump({**meta, "version": dc.CHECKPOINT_VERSION + 1}, f)
    with pytest.raises(ValueError, match="unsupported checkpoint version"):
        load_device_checkpoint(path, session=CPU)
    # a sharded checkpoint onto a mesh of another doc axis: JAX's refusal
    mesh4 = make_mesh(4, devices=[torch.device("cpu")] * 4)
    sharded = ShardedSparseEngine.from_scored_index(
        index, mesh=mesh4, hot_tokens=8, hot_budget_bytes=1 << 24)
    spath = str(tmp_path / "sk")
    save_device_checkpoint(spath, sharded)
    for docs in (2, 8):
        other = make_mesh(docs, devices=[torch.device("cpu")] * docs)
        with pytest.raises(ValueError, match=f"saved on a mesh with 4 doc "
                           f"shards but the restore mesh has {docs}"):
            load_device_checkpoint(spath, mesh=other)
    with pytest.raises(ValueError, match="holds ShardedSparseEngine"):
        dc.restore_device_checkpoint(spath, port)
    os.unlink(meta_path)
    with pytest.raises(ValueError, match="no metadata sidecar") as e:
        load_device_checkpoint(path, session=CPU)
    assert meta_path in str(e.value)
    with pytest.raises(ValueError, match="no metadata sidecar"):
        dc.restore_device_checkpoint(path, port)

    class Odd:
        pass

    with pytest.raises(TypeError, match="snapshot.py"):
        save_device_checkpoint(str(tmp_path / "x"), Odd())

    # an Orbax directory of the JAX package: refused by name, never read
    jax_engine = JaxDenseEngine.from_scored_index(index)
    orbax = str(tmp_path / "orbax_ck")
    jax_dc.save_device_checkpoint(orbax, jax_engine)
    assert os.path.isdir(orbax) and os.path.isfile(orbax + ".meta.json")
    for call in (lambda: load_device_checkpoint(orbax, session=CPU),
                 lambda: dc.restore_device_checkpoint(orbax, dense)):
        with pytest.raises(ValueError, match="Orbax"):
            call()


def jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def test_hot_pair_sparse_form_equals_jax(index):
    jax_engine, port = build_pair(index, "sparse_hot")
    for jb, pb in zip(jax_engine.buckets, port.buckets):
        want = jax_sparse.hot_pair_to_sparse(jb["hotT"], jb["hotLo"])
        got = port_sparse.hot_pair_to_sparse(pb["hotT"], pb["hotLo"])
        for key in want:
            np.testing.assert_array_equal(port_bits(got[key]),
                                          jax_bits(want[key]), err_msg=key)
        rows = pb["doc_ids"].shape[0]
        for vals in ("hotNzHi", "hotNzLo"):
            jt, jv = jax_sparse._sparse_hot_ell(
                rows, want["hotNzRank"], want["hotNzPos"], want[vals])
            pt, pv = port_sparse._sparse_hot_ell(
                rows, got["hotNzRank"], got["hotNzPos"], got[vals])
            np.testing.assert_array_equal(pt.numpy(), jt)
            np.testing.assert_array_equal(pv.numpy(), jv)
        hi, lo = port_sparse.rebuild_hot_pair_from_sparse(
            port.hot_h, rows, got, CPU.put)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert torch.equal(hi.view(torch.int16), pb["hotT"].view(torch.int16))
        assert torch.equal(lo.view(torch.int16),
                           pb["hotLo"].view(torch.int16))
    # no postings: a one-slot ELL of pads, and an all-zero pair
    empty = port_sparse.hot_pair_to_sparse(
        torch.zeros((4, 16), dtype=torch.bfloat16),
        torch.zeros((4, 16), dtype=torch.bfloat16))
    tok, val = port_sparse._sparse_hot_ell(16, empty["hotNzRank"],
                                           empty["hotNzPos"],
                                           empty["hotNzHi"])
    jt, jv = jax_sparse._sparse_hot_ell(16, np.zeros(0, np.int32),
                                        np.zeros(0, np.int32),
                                        np.zeros(0, np.float32))
    np.testing.assert_array_equal(tok.numpy(), jt)
    np.testing.assert_array_equal(val.numpy(), jv)
    hi, lo = port_sparse.rebuild_hot_pair_from_sparse(4, 16, empty, CPU.put)
    assert not hi.any() and not lo.any() and hi.shape == (4, 16)


# -- the sharded engines ------------------------------------------------------


def sharded_pair(index, cls_name, data, docs):
    """(JAX engine, port engine) of ``cls_name`` on meshes of one shape;
    the sparse pair at 8 hot tokens and 2 buckets."""
    import bm25_tpu.parallel.mesh as jax_mesh
    import bm25_tpu.parallel.sharded_engine as jax_sharded

    kw = ({} if cls_name == "ShardedEngine"
          else dict(hot_tokens=8, max_buckets=2))
    n = data * docs
    jeng = getattr(jax_sharded, cls_name).from_scored_index(
        index, mesh=jax_mesh.make_mesh(n, data=data), **kw)
    if kw:
        kw["hot_budget_bytes"] = 1 << 24
    pmesh = make_mesh(n, data=data, devices=[torch.device("cpu")] * 8)
    port = {"ShardedEngine": ShardedEngine,
            "ShardedSparseEngine": ShardedSparseEngine}[cls_name]
    return jeng, port.from_scored_index(index, mesh=pmesh, **kw)


def sharded_leaves(engine) -> dict:
    """Every (row, shard) piece of the engine's mesh tensors."""
    fields = ({"st": engine.st, "offsets": engine.offsets}
              if isinstance(engine, ShardedEngine) else
              {"offsets": engine.offsets, "hot_table": engine.hot_table,
               **{f"buckets.{i}.{k}": t for i, b in enumerate(engine.buckets)
                  for k, t in b.items()}})
    return {(key, r, j): t.on(r, j) for key, t in fields.items()
            for r in range(engine.mesh.devices.shape[0])
            for j in range(engine.mesh.local_docs)}


@pytest.mark.parametrize("cls_name,data,docs", [
    ("ShardedSparseEngine", 1, 4), ("ShardedSparseEngine", 2, 4),
    ("ShardedEngine", 1, 4)])
def test_sharded_round_trip_matches_jax(index, queries, tmp_path, cls_name,
                                        data, docs):
    from bm25_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jeng, port = sharded_pair(index, cls_name, data, docs)
    jax_path, path = str(tmp_path / "jax_ck"), str(tmp_path / "ck")
    jax_dc.save_device_checkpoint(jax_path, jeng)
    jax_loaded = jax_dc.load_device_checkpoint(
        jax_path, mesh=jax_make_mesh(data * docs, data=data))
    save_device_checkpoint(path, port)
    before = ops.plain_calls["ell_score"]
    loaded = load_device_checkpoint(path, mesh=port.mesh)
    b2 = ops.plain_calls["ell_score"] - before
    assert type(loaded) is type(port)
    hot = sum("hotT" in b for b in getattr(port, "buckets", []))
    assert (hot > 0) == (cls_name == "ShardedSparseEngine")
    assert b2 == 2 * hot * docs  # hi and lo, on each shard
    got, want = sharded_leaves(loaded), sharded_leaves(port)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert loaded.vocab == port.vocab
    if cls_name == "ShardedSparseEngine":
        np.testing.assert_array_equal(loaded.hot_table_host,
                                      loaded.hot_table.numpy())
        np.testing.assert_array_equal(loaded.hot_table_host,
                                      np.asarray(jax_loaded.hot_table_host))
    oracle_w = np.random.default_rng(2).uniform(
        0.5, 2.0, queries.shape).astype(np.float32)
    oracle = ReferenceEngine.from_scored_index(index)
    for k, w in ((10, None), (100, oracle_w)):
        d1, s1 = loaded.search(queries, top_k=k, weights=w)
        d0, s0 = port.search(queries, top_k=k, weights=w)
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(s1, s0)
        assert_matches_oracle(d1, s1, *jax_loaded.search(
            queries, top_k=k, weights=w))
        assert_matches_oracle(d1, s1, *oracle.search(queries, top_k=k,
                                                     weights=w))

    with open(path + ".meta.json") as f:
        meta = json.load(f)
    with open(jax_path + ".meta.json") as f:
        want_meta = json.load(f)
    assert meta.pop("vocab") == want_meta.pop("vocab")
    if cls_name == "ShardedEngine":
        # the port pads each shard to doc_pad(d_local), JAX to its lanes
        assert meta["tree"]["st"][0][0] == want_meta["tree"]["st"][0][0]
        want_meta["tree"]["st"][0][1] = meta["tree"]["st"][0][1]
    assert meta == want_meta


def test_sharded_restore_in_place(index, queries, tmp_path):
    """Counterparts of JAX's sharded restores: a fresh engine on the same
    mesh, its ELL values and hot pairs zeroed, restored to the source's
    pieces and results."""
    _, port = sharded_pair(index, "ShardedSparseEngine", 1, 4)
    path = str(tmp_path / "ck")
    save_device_checkpoint(path, port)
    fresh = ShardedSparseEngine.from_scored_index(
        index, mesh=port.mesh, hot_tokens=8, max_buckets=2,
        hot_budget_bytes=1 << 24)
    for b in fresh.buckets:
        for key in ("valT", "hotT", "hotLo"):
            for t in b[key].pieces():
                t.zero_()
    fresh.hot_table_host = None
    dc.restore_device_checkpoint(path, fresh)
    got, want = sharded_leaves(fresh), sharded_leaves(port)
    assert all(torch.equal(got[key], want[key]) for key in want)
    np.testing.assert_array_equal(fresh.hot_table_host,
                                  port.hot_table_host)
    for k in (5, 50):
        d1, s1 = fresh.search(queries, top_k=k)
        d0, s0 = port.search(queries, top_k=k)
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(s1, s0)


def test_restore_refreshes_the_routing_host_table(index, tmp_path):
    """JAX's test of the routing's host table: a restore in place of a
    checkpoint whose hot tokens differ (same shapes) leaves the host copy
    equal to the restored device table."""
    kw = dict(hot_tokens=4, hot_budget_bytes=1 << 24)
    e_a = SparseEngine.from_scored_index(index, session=CPU, **kw)
    e_b = SparseEngine.from_scored_index(index, session=CPU, **kw)
    tbl = e_a.hot_table_host.copy()
    hot_ids = np.flatnonzero(tbl >= 0)
    rolled = np.full_like(tbl, -1)
    rolled[(hot_ids + 1) % (len(tbl) - 1)] = tbl[hot_ids]
    e_a.hot_table = CPU.put(rolled)
    e_a.hot_table_host = rolled
    path = str(tmp_path / "ck")
    save_device_checkpoint(path, e_a)
    dc.restore_device_checkpoint(path, e_b)
    np.testing.assert_array_equal(e_b.hot_table_host, rolled)
    assert load_device_checkpoint(path, session=CPU).hot_table_host \
        .tolist() == rolled.tolist()


def test_cli_and_server_take_a_sharded_checkpoint(tmp_path, animal_corpus,
                                                  capsys):
    """The CLI's ``checkpoint --engine sharded_sparse`` writes a sharded
    checkpoint (a (1, 1) mesh on the CPU session); ``warm`` and
    ``Server(device_checkpoint=)`` restore it, as JAX's take theirs."""
    import urllib.request

    from bm25_tpu_torch import Server, create_engine, load_index
    from bm25_tpu_torch.cli.main import main

    corpus = tmp_path / "docs.txt"
    corpus.write_text("\n".join(animal_corpus))
    idx, ck = str(tmp_path / "idx"), str(tmp_path / "ck")
    assert main(["index", str(corpus), "-o", idx]) == 0
    assert main(["--device", "cpu", "checkpoint", idx, "-o", ck,
                 "--engine", "sharded_sparse"]) == 0
    with open(ck + ".meta.json") as f:
        meta = json.load(f)
    assert meta["engine"] == "ShardedSparseEngine"
    assert meta["mesh_shape"] == {"data": 1, "docs": 1}
    loaded = load_device_checkpoint(ck, session=CPU)
    built = create_engine(load_index(idx), mode="sharded_sparse",
                          session=CPU)
    q = np.array([[0, 1, 2, -1], [3, 3, 4, 5]], np.int32)
    for got, want in zip(loaded.search(q, top_k=3), built.search(q, top_k=3)):
        np.testing.assert_array_equal(got, want)
    capsys.readouterr()
    assert main(["--device", "cpu", "warm", "--device-checkpoint", ck,
                 "--top-k", "2", "--batch-sizes", "1"]) == 0
    assert json.loads(capsys.readouterr().out)["shapes"] == 2
    srv = Server(idx, port=0, device_checkpoint=ck,
                 engine_kwargs={"session": CPU})
    srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/search",
            data=json.dumps({"queries": [animal_corpus[0]],
                             "top_k": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            hits = json.loads(r.read())["results"][0]
    finally:
        srv.shutdown()
    assert type(srv._handler.runtime.engine).__name__ == \
        "ShardedSparseEngine"
    assert hits[0]["doc"] == 0
