"""The port's doc-sharded engines (``bm25_tpu_torch/parallel``) against the
JAX package's, on the CPU: one counterpart of each test of
``tests/test_sharded_engine.py``, at its mesh shapes.

The JAX engines run on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's on a mesh that names the CPU eight times
(``make_mesh(..., devices=[cpu] * 8)``), its counterpart of
``jax_num_cpu_devices``.  The same seeded inputs go through both and
through ``ReferenceEngine``, compared under the fuzz campaign's comparator
(``utils/parity.py``) and, as JAX's tests compare, scores within
``rtol=1e-5, atol=1e-6`` (2e-5 weighted) and ids equal at
``strict_positions``; exactly equal where JAX's test asserts exact ties.

``test_eight_devices_available`` has no counterpart: a port mesh names
devices explicitly, so there is no process-wide device count to check
(``test_make_mesh_grid_and_repeated_devices`` checks the grid instead).
Where a JAX test reads its compile cache or a jaxpr, the counterpart
checks the same contract through what the port has: the bench chunk is
the dispatch's first planned chunk, and the k_local trim is counted.
"""

import numpy as np
import pytest
import torch

from conftest import strict_positions

import bm25_tpu.parallel.mesh as jax_mesh_mod
import bm25_tpu.parallel.sharded_engine as jax_sharded
from bm25_tpu.reference import ReferenceEngine
from bm25_tpu.scoring import BM25Params, build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import Session
from bm25_tpu_torch.parallel import distributed as port_dist
from bm25_tpu_torch.parallel import sharded_engine as port_sharded
from bm25_tpu_torch.parallel.mesh import make_mesh
from bm25_tpu_torch.parallel.sharded_engine import (ShardedEngine,
                                                    ShardedSparseEngine,
                                                    choose_k_local,
                                                    dryrun_sharded_step)
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = torch.device("cpu")
MESHES = [(1, 8), (2, 4), (4, 2), (8, 1)]


def meshes(data, docs):
    """(port mesh, JAX mesh) of the same (data, docs) shape."""
    n = data * docs
    return (make_mesh(n, data=data, devices=[CPU] * 8),
            jax_mesh_mod.make_mesh(n, data=data))


def zipf_index(corpus, method="lucene"):
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    return build_scored_index(out.ids, vocab_size=len(out.vocab),
                              params=BM25Params(method=method))


@pytest.fixture(scope="module")
def setup(request):
    idx = zipf_index(request.getfixturevalue("zipf_corpus_small"))
    return idx, ReferenceEngine.from_scored_index(idx)


def check(got, jax_res, oracle_res, rtol=1e-5, atol=1e-6, exact=False):
    """The port's (docs, scores) against JAX's and the oracle's."""
    gd, gs = got
    jd, js = jax_res
    od, os_ = oracle_res
    assert gd.dtype == np.int32 and gs.dtype == np.float32
    assert_matches_oracle(gd, gs, od, os_)
    np.testing.assert_allclose(gs, os_, rtol=rtol, atol=atol)
    np.testing.assert_allclose(gs, np.asarray(js), rtol=rtol, atol=atol)
    strict = strict_positions(os_)
    np.testing.assert_array_equal(gd[strict], od[strict])
    np.testing.assert_array_equal(gd[strict], np.asarray(jd)[strict])
    np.testing.assert_array_equal(gd == -1, od == -1)
    if exact:
        np.testing.assert_array_equal(gd, od)
        np.testing.assert_array_equal(gd, np.asarray(jd))


def both(cls_name, idx, data, docs, **kw):
    """The port's and JAX's engine of ``cls_name`` on one mesh shape.  A
    sparse pair left at ``hot_tokens="auto"`` takes JAX's choice: the two
    cost models are fitted on different chips."""
    pm, jm = meshes(data, docs)
    jeng = getattr(jax_sharded, cls_name).from_scored_index(
        idx, mesh=jm, **kw)
    if cls_name == "ShardedSparseEngine" and "hot_tokens" not in kw:
        kw.update(hot_tokens=jeng.hot_h, hot_budget_bytes=1 << 30)
    return (getattr(port_sharded, cls_name).from_scored_index(
                idx, mesh=pm, **kw), jeng)


@pytest.mark.parametrize("data,docs", MESHES)
def test_sharded_matches_oracle(setup, data, docs):
    idx, oracle = setup
    eng, jeng = both("ShardedEngine", idx, data, docs)
    queries = np.random.default_rng(3).integers(
        -1, idx.vocab_size, size=(16, 6), dtype=np.int32)
    k = 17
    check(eng.search(queries, top_k=k), jeng.search(queries, top_k=k),
          oracle.search(queries, top_k=k))


def test_sharded_k_larger_than_shard(setup):
    """k bigger than one shard's doc slice still returns the global top k."""
    idx, oracle = setup
    eng, jeng = both("ShardedEngine", idx, 1, 8)
    assert eng.st.shape[1] // 8 < 100
    q = np.array([[0, 1, 2, 3]], dtype=np.int32)
    check(eng.search(q, top_k=100), jeng.search(q, top_k=100),
          oracle.search(q, top_k=100))


def test_dryrun_hook_all_device_counts():
    for n in (1, 2, 4, 8):
        dryrun_sharded_step(n, device="cpu")


def test_entry_points_contract():
    """The counterpart of test_graft_entry_contract: the port's entry step
    and its multi-device dry run (``entry.py``), over the CPU, and the dry
    run's command line."""
    from bm25_tpu_torch.entry import dryrun_multichip, entry
    from bm25_tpu_torch.parallel import _dryrun_main

    fn, args = entry(Session("cpu"))
    out = fn(*args)
    assert len(out) == 2
    dryrun_multichip(8, device="cpu")
    assert _dryrun_main.main(["1", "--device", "cpu"]) == 0


@pytest.mark.parametrize("data,docs", MESHES)
def test_sharded_sparse_matches_oracle(setup, data, docs):
    idx, oracle = setup
    eng, jeng = both("ShardedSparseEngine", idx, data, docs)
    assert eng.hot_h == jeng.hot_h
    queries = np.random.default_rng(11).integers(
        -1, idx.vocab_size, size=(16, 6), dtype=np.int32)
    want = oracle.search(queries, top_k=13)
    check(eng.search(queries, top_k=13), jeng.search(queries, top_k=13),
          want)
    # the port's own layout model, at the default hot_tokens="auto"
    auto = ShardedSparseEngine.from_scored_index(idx, mesh=eng.mesh)
    assert_matches_oracle(*auto.search(queries, top_k=13), *want)


def test_device_state_bit_equal_to_jax(setup):
    """Both engines lay the index out as JAX's do: every bucket array
    (the B2-built bf16 hot pair included) and the dense table, globally,
    over a (2, 4) mesh."""
    idx, _ = setup
    eng, jeng = both("ShardedSparseEngine", idx, 2, 4, hot_tokens=8)
    assert eng.hot_h == jeng.hot_h == 8
    assert len(eng.buckets) == len(jeng.buckets)
    for b, jb in zip(eng.buckets, jeng.buckets):
        assert set(b) == set(jb)
        for key in b:
            assert b[key].shape == tuple(jb[key].shape), key
            got = b[key].numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jb[key]).astype(got.dtype))
    np.testing.assert_array_equal(eng.hot_table.numpy(),
                                  np.asarray(jeng.hot_table))
    np.testing.assert_array_equal(eng.offsets.numpy(),
                                  np.asarray(jeng.offsets))
    dense, jdense = both("ShardedEngine", idx, 2, 4)
    d = idx.num_docs
    np.testing.assert_array_equal(dense.st.numpy()[:, :d],
                                  np.asarray(jdense.st)[:, :d])
    # each shard's slice lives once on its device: data rows share it here
    assert dense.st.held_bytes() == dense.st.nbytes


def test_sharded_sparse_duplicate_tokens(setup):
    idx, oracle = setup
    eng, jeng = both("ShardedSparseEngine", idx, 1, 4)
    q = np.array([[2, 2, 9, -1]], dtype=np.int32)
    check(eng.search(q, top_k=5), jeng.search(q, top_k=5),
          oracle.search(q, top_k=5))


def test_sharded_engines_tie_contract_smallest_doc_id():
    """Equal scores resolve to ascending doc ids across shard boundaries
    (doc-ordered rows + stable merge)."""
    corpus = ["identical words here"] * 41
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))
    q = np.array([[0, 1]], dtype=np.int32)
    for name in ("ShardedEngine", "ShardedSparseEngine"):
        eng, jeng = both(name, idx, 1, 4)
        dd, ds = eng.search(q, top_k=9)
        assert len(set(ds[0].tolist())) == 1, name
        np.testing.assert_array_equal(dd[0], np.arange(9))
        np.testing.assert_array_equal(dd, np.asarray(jeng.search(q, 9)[0]))


def test_sharded_sparse_multibucket_chunked_matches_oracle():
    """Multi-bucket layout + query chunking: exact parity incl. doc-id
    ties (duplicated docs tie across bucket boundaries)."""
    rng = np.random.default_rng(42)
    vocab = 64
    ids = []
    for i in range(3600):
        n = int(rng.integers(2, 5)) if i % 3 else int(rng.integers(20, 40))
        ids.append(rng.integers(0, vocab, size=n).astype(np.int32))
    for i in range(0, 40, 2):
        ids[i + 1] = ids[i].copy()  # duplicates -> ties
    idx = build_scored_index(ids, vocab_size=vocab)
    eng, jeng = both("ShardedSparseEngine", idx, 1, 2, max_buckets=3,
                     hot_tokens=8)
    assert len(eng.buckets) >= 2
    eng.chunk_queries = jeng.chunk_queries = 8
    queries = rng.integers(-1, vocab, size=(17, 5), dtype=np.int32)
    assert len(eng._plan(queries, None, 9)) == 3
    check(eng.search(queries, top_k=9), jeng.search(queries, top_k=9),
          ReferenceEngine.from_scored_index(idx).search(queries, top_k=9),
          exact=True)


def test_sharded_weighted_search_matches_oracle(setup):
    idx, oracle = setup
    eng, jeng = both("ShardedEngine", idx, 2, 4)
    rng = np.random.default_rng(33)
    queries = rng.integers(-1, idx.vocab_size, size=(8, 5), dtype=np.int32)
    weights = rng.uniform(0.1, 2.5, size=queries.shape).astype(np.float32)
    check(eng.search(queries, top_k=9, weights=weights),
          jeng.search(queries, top_k=9, weights=weights),
          oracle.search(queries, top_k=9, weights=weights),
          rtol=2e-5, atol=2e-5)


def test_sharded_sparse_weighted_search_matches_oracle(setup):
    idx, oracle = setup
    eng, jeng = both("ShardedSparseEngine", idx, 2, 4, hot_tokens=8)
    rng = np.random.default_rng(34)
    queries = rng.integers(-1, idx.vocab_size, size=(8, 5), dtype=np.int32)
    weights = rng.uniform(0.1, 2.5, size=queries.shape).astype(np.float32)
    check(eng.search(queries, top_k=9, weights=weights),
          jeng.search(queries, top_k=9, weights=weights),
          oracle.search(queries, top_k=9, weights=weights),
          rtol=2e-5, atol=2e-5)


def test_sharded_sparse_long_query_dedup_matches_oracle(setup):
    idx, oracle = setup
    eng, jeng = both("ShardedSparseEngine", idx, 2, 4, hot_tokens=8)
    rng = np.random.default_rng(35)
    base = rng.integers(0, idx.vocab_size, size=(8, 5))
    pick = rng.integers(0, 5, size=(8, 24))
    queries = np.take_along_axis(base.astype(np.int32), pick, axis=1)
    assert queries.shape[1] >= eng.dedup_min_width
    # dedup engages: the planned chunk is the deduplicated, weighted one
    (_cq, padded, wpadded), = eng._plan(queries, None, 9)
    assert padded.shape[1] < queries.shape[1] and wpadded is not None
    check(eng.search(queries, top_k=9), jeng.search(queries, top_k=9),
          oracle.search(queries, top_k=9), rtol=2e-5, atol=2e-5)


def test_sharded_sparse_cold_routing_matches_oracle(setup):
    """JAX routes wide batches through a cold-width scan; the port keeps
    ``route_cold`` and does not route, with the same results."""
    idx, oracle = setup
    eng, jeng = both("ShardedSparseEngine", idx, 2, 4, hot_tokens=32)
    eng.route_cold = jeng.route_cold = True
    rng = np.random.default_rng(71)
    queries = rng.integers(-1, idx.vocab_size, size=(24, 8), dtype=np.int32)
    queries[0] = -1
    check(eng.search(queries, top_k=9), jeng.search(queries, top_k=9),
          oracle.search(queries, top_k=9), rtol=2e-5, atol=2e-5)
    w = rng.uniform(0.2, 2.0, size=queries.shape).astype(np.float32)
    check(eng.search(queries, top_k=9, weights=w),
          jeng.search(queries, top_k=9, weights=w),
          oracle.search(queries, top_k=9, weights=w), rtol=5e-5, atol=5e-5)


def test_k_local_trim_exact_with_fallback(zipf_corpus_small):
    """The shard-local candidate trim (k_local < k) stays exact: the fast
    path on ordinary data, the full-width fallback on planted cross-shard
    ties at the merge boundary."""
    assert choose_k_local(1000, 8) == 1000
    assert choose_k_local(1000, 64) == -(-2000 // 64) + 64
    for k, s in ((1000, 31), (1000, 32), (100, 128), (10, 64)):
        assert choose_k_local(k, s) == jax_sharded.choose_k_local(k, s)

    idx = zipf_index(zipf_corpus_small)
    oracle = ReferenceEngine.from_scored_index(idx)
    queries = np.random.default_rng(17).integers(
        -1, idx.vocab_size, size=(10, 6), dtype=np.int32)
    eng, jeng = both("ShardedSparseEngine", idx, 1, 8)
    k = 24
    eng.k_local = jeng.k_local = max(2 * k // 8 + 2, 1)
    check(eng.search(queries, top_k=k), jeng.search(queries, top_k=k),
          oracle.search(queries, top_k=k))

    # every shard's m-th candidate ties the merged k-th: the exactness
    # flag trips and the full-width fallback keeps the smaller-id order
    tied = build_scored_index([np.array([0, 1], np.int32)] * 64,
                              vocab_size=4)
    te, jte = both("ShardedSparseEngine", tied, 1, 8)
    te.k_local = jte.k_local = 3
    q = np.array([[0, 1]], np.int32)
    d, s = te.search(q, top_k=16)
    np.testing.assert_array_equal(d[0], np.arange(16))
    assert np.allclose(s[0], s[0][0])
    np.testing.assert_array_equal(d, np.asarray(jte.search(q, top_k=16)[0]))


def test_k_local_trim_actually_engages(monkeypatch):
    """The trim runs where k_local < the local width and the shards' m
    candidates cover k, and nowhere else: counted per merge (JAX's test
    reads the fallback ``cond`` in the step's jaxpr).  On a corpus that
    fills every shard the trimmed merge stands and is exact; planted ties
    trip the fallback."""
    from conftest import make_zipf_corpus

    idx = zipf_index(make_zipf_corpus(4096, vocab=500, avg_len=20, seed=7))
    oracle = ReferenceEngine.from_scored_index(idx)
    eng = ShardedSparseEngine.from_scored_index(
        idx, mesh=make_mesh(8, devices=[CPU] * 8), hot_tokens=0)
    queries = np.random.default_rng(5).integers(
        0, idx.vocab_size, size=(8, 8), dtype=np.int32)
    counts = {"trimmed": 0, "fallback": 0}
    monkeypatch.setattr(port_sharded, "trim_counts", counts)
    eng.k_local = None
    eng.search(queries, top_k=24)
    eng.k_local = "auto"  # full k below 32 shards
    eng.search(queries, top_k=24)
    assert counts == {"trimmed": 0, "fallback": 0}
    eng.k_local = 12  # 8 shards x 12 >= 24: trimmed, and exact
    assert_matches_oracle(*eng.search(queries, top_k=24),
                          *oracle.search(queries, top_k=24))
    assert counts == {"trimmed": 1, "fallback": 0}
    eng.k_local = 2  # 8 x 2 < 24: the trim cannot cover k
    eng.search(queries, top_k=24)
    assert counts == {"trimmed": 1, "fallback": 0}

    tied = build_scored_index([np.array([0, 1], np.int32)] * 64,
                              vocab_size=4)
    te = ShardedSparseEngine.from_scored_index(
        tied, mesh=make_mesh(8, devices=[CPU] * 8))
    te.k_local = 3
    te.search(np.array([[0, 1]], np.int32), top_k=16)
    assert counts == {"trimmed": 2, "fallback": 1}


# -- filtered search (doc_mask) over the mesh --------------------------------


def test_sharded_dense_doc_mask_matches_oracle(setup):
    idx, oracle = setup
    eng, jeng = both("ShardedEngine", idx, 2, 4)
    rng = np.random.default_rng(21)
    queries = rng.integers(-1, idx.vocab_size, size=(16, 6), dtype=np.int32)
    mask = rng.random(idx.num_docs) < 0.4
    got = eng.search(queries, top_k=12, doc_mask=mask)
    check(got, jeng.search(queries, top_k=12, doc_mask=mask),
          oracle.search(queries, top_k=12, doc_mask=mask))
    dd = got[0]
    assert mask[dd[dd >= 0]].all()


def test_sharded_sparse_doc_mask_matches_oracle(setup):
    """Mask through the sharded ELL step: B1's pad-row mask, the hot tier,
    weights, and the shortfall sentinel after the host offset add."""
    idx, oracle = setup
    eng, jeng = both("ShardedSparseEngine", idx, 2, 4, hot_tokens=8)
    rng = np.random.default_rng(22)
    queries = rng.integers(-1, idx.vocab_size, size=(16, 6), dtype=np.int32)
    mask = rng.random(idx.num_docs) < 0.4
    got = eng.search(queries, top_k=12, doc_mask=mask)
    check(got, jeng.search(queries, top_k=12, doc_mask=mask),
          oracle.search(queries, top_k=12, doc_mask=mask))
    assert mask[got[0][got[0] >= 0]].all()

    w = rng.uniform(0.2, 3.0, size=queries.shape).astype(np.float32)
    check(eng.search(queries, top_k=12, weights=w, doc_mask=mask),
          jeng.search(queries, top_k=12, weights=w, doc_mask=mask),
          oracle.search(queries, top_k=12, weights=w, doc_mask=mask),
          rtol=2e-5, atol=2e-5)

    # shortfall: 3 eligible docs, k=8: sentinels, scores exactly 0 despite
    # the host-side offset add
    tiny = np.zeros(idx.num_docs, bool)
    tiny[rng.choice(idx.num_docs, size=3, replace=False)] = True
    od, os_ = oracle.search(queries[:4], top_k=8, doc_mask=tiny)
    dd, ds = eng.search(queries[:4], top_k=8, doc_mask=tiny)
    np.testing.assert_array_equal(dd == -1, od == -1)
    assert (ds[dd == -1] == 0.0).all()
    check((dd, ds), jeng.search(queries[:4], top_k=8, doc_mask=tiny),
          (od, os_))
    di = eng.search_ids(queries[:4], top_k=8, doc_mask=tiny)
    np.testing.assert_array_equal(di == -1, od == -1)


def test_direct_dataclass_construction_searches(setup):
    """The public dataclass constructors work from another engine's
    fields."""
    idx, oracle = setup
    mesh = make_mesh(4, devices=[CPU] * 4)
    built = ShardedEngine.from_scored_index(idx, mesh=mesh)
    eng = ShardedEngine(st=built.st, offsets=built.offsets,
                        num_docs=built.num_docs, vocab_size=built.vocab_size,
                        mesh=mesh)
    q = np.array([[0, 1, 2, 3]], dtype=np.int32)
    od, os_ = oracle.search(q, top_k=5)
    assert_matches_oracle(*eng.search(q, top_k=5), od, os_)

    sbuilt = ShardedSparseEngine.from_scored_index(idx, mesh=mesh,
                                                   hot_tokens=8)
    seng = ShardedSparseEngine(
        buckets=sbuilt.buckets, hot_table=sbuilt.hot_table,
        hot_h=sbuilt.hot_h, offsets=sbuilt.offsets,
        num_docs=sbuilt.num_docs, vocab_size=sbuilt.vocab_size, mesh=mesh,
        hot_table_host=sbuilt.hot_table_host,
    )
    assert_matches_oracle(*seng.search(q, top_k=5), od, os_)


def test_make_mesh_rejects_oversubscription():
    with pytest.raises(ValueError, match="only 8 devices"):
        make_mesh(16, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="not divisible by data=3"):
        make_mesh(8, data=3, devices=[CPU] * 8)


def test_make_mesh_grid_and_repeated_devices():
    mesh = make_mesh(8, data=2, devices=[CPU] * 8)
    assert mesh.shape == {"data": 2, "docs": 4}
    assert mesh.devices.shape == (2, 4) and mesh.local_docs == 4
    assert mesh.distinct_devices() == [CPU]
    assert [mesh.shard_index(j) for j in range(4)] == [0, 1, 2, 3]
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 1, "docs": 3}
    # a data axis cannot span processes
    from bm25_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(NotImplementedError, match="across processes"):
        Mesh(mesh.devices, process_index=0, process_count=2)


def test_cluster_detection_env_markers(monkeypatch):
    for key in port_dist._CLUSTER_ENVS + ("WORLD_SIZE",):
        monkeypatch.delenv(key, raising=False)
    assert not port_dist._cluster_detected()
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert not port_dist._cluster_detected()  # single-task slurm job
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert port_dist._cluster_detected()
    monkeypatch.delenv("SLURM_NTASKS")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    assert port_dist._cluster_detected()
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
    monkeypatch.setenv("WORLD_SIZE", "2")  # torchrun's, JAX_NUM_PROCESSES'
    assert port_dist._cluster_detected()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    assert not port_dist._cluster_detected()  # an explicit count wins
    # outside a group: one process, no-op initialize, the plan of JAX's
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("SLURM_NTASKS")
    port_dist.initialize()
    assert port_dist.process_info() == (0, 1)
    plan = port_dist.DocShardPlan(num_docs=10, num_hosts=3,
                                  num_devices_global=4)
    assert [plan.host_range(h) for h in range(3)] == [(0, 4), (4, 8),
                                                      (8, 10)]
    assert plan.device_range(3) == (9, 10)
    assert port_dist.make_plan(10).num_hosts == 1
    assert port_dist.default_backend(2) == (
        "nccl" if torch.cuda.device_count() >= 2 else "gloo")


def test_sharded_sparse_wide_bucket_slot_tiled(setup):
    """A long-document corpus whose widest ELL bucket exceeds SLOT_TILE:
    the slot-tiled scan in every shard still matches."""
    from bm25_tpu_torch.ops.ell_score import SLOT_TILE

    vocab = 2048
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(4, 24, size=56)]
    for _ in range(8):
        docs.append(rng.choice(vocab, size=SLOT_TILE + 200,
                               replace=False).astype(np.int32))
    idx = build_scored_index(docs, vocab_size=vocab)
    eng, jeng = both("ShardedSparseEngine", idx, 1, 8, hot_tokens=0,
                     max_buckets=2)
    widths = [b["tokT"].shape[0] for b in eng.buckets if "tokT" in b]
    assert max(widths) > SLOT_TILE, f"bucket widths {widths} all single-tile"
    queries = rng.integers(-1, vocab, size=(16, 6), dtype=np.int32)
    check(eng.search(queries, top_k=11), jeng.search(queries, top_k=11),
          ReferenceEngine.from_scored_index(idx).search(queries, top_k=11))


def test_bench_step_fn_shares_dispatch_cache(setup):
    """bench_step_fn plans exactly like the dispatch: its chunk is the
    dispatch's first planned chunk, dedup included, and its step returns
    the search's merged result (JAX's test reads the shared compile
    cache)."""
    idx, oracle = setup
    eng = ShardedSparseEngine.from_scored_index(
        idx, mesh=make_mesh(8, devices=[CPU] * 8))
    rng = np.random.default_rng(11)
    queries = rng.integers(-1, idx.vocab_size, size=(16, 6), dtype=np.int32)
    fn, args, n_chunks = eng.bench_step_fn(queries, top_k=9)
    (cq, padded, wpadded), = eng._plan(queries, None, 9)
    assert n_chunks == 1 and wpadded is None
    np.testing.assert_array_equal(args[1].padded, padded)
    (s, d), = fn(*args)
    dd, ds = eng.search(queries, top_k=9)
    np.testing.assert_array_equal(d.numpy()[:cq], dd)
    assert_matches_oracle(dd, ds, *oracle.search(queries, top_k=9))
    local = eng.bench_step_fn(queries, top_k=9, local_only=True)
    (cands,) = local[0](*local[1])
    assert len(cands) == 8 and all(c[0].shape == (16, 9) for c in cands)

    wide = np.repeat(
        rng.integers(0, idx.vocab_size, size=(8, 2), dtype=np.int32),
        eng.dedup_min_width // 2, axis=1,
    )
    fn, args, _ = eng.bench_step_fn(wide, top_k=9)
    (_cq, padded, wpadded), = eng._plan(wide, None, 9)
    np.testing.assert_array_equal(args[1].padded, padded)
    np.testing.assert_array_equal(args[1].wpadded, wpadded)
    assert args[1].padded.shape[1] < wide.shape[1]


def test_sharded_sparse_search_pipelined_matches_search(setup):
    """Double-buffered sharded search: identical results to search()
    across batches, with weights, doc_mask, and ids_only."""
    idx, oracle = setup
    eng = ShardedSparseEngine.from_scored_index(
        idx, mesh=make_mesh(4, devices=[CPU] * 4), hot_tokens=8)
    rng = np.random.default_rng(31)
    queries = rng.integers(-1, idx.vocab_size, size=(40, 6), dtype=np.int32)
    d1, s1 = eng.search(queries, top_k=9)
    d2, s2 = eng.search_pipelined(queries, top_k=9, batch=16)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(s1, s2)
    assert_matches_oracle(d2, s2, *oracle.search(queries, top_k=9))

    w = rng.uniform(0.5, 2.0, size=queries.shape).astype(np.float32)
    d1, s1 = eng.search(queries, top_k=9, weights=w)
    d2, s2 = eng.search_pipelined(queries, top_k=9, batch=16, weights=w)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(s1, s2)

    mask = rng.random(idx.num_docs) < 0.6
    d1, s1 = eng.search(queries, top_k=9, doc_mask=mask)
    d2, s2 = eng.search_pipelined(queries, top_k=9, batch=16, doc_mask=mask)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(s1, s2)

    ids = eng.search_pipelined(queries, top_k=9, batch=16, ids_only=True)
    np.testing.assert_array_equal(ids, eng.search_ids(queries, top_k=9))


@pytest.mark.parametrize("method", ["bm25+", "bm25l"])
def test_bf16_scores_round_before_the_offsets(zipf_corpus_small, method):
    """JAX's sharded rounding order: the merged score rounds to bf16 on
    the device, then the host adds the per-token offsets in f32, bf16(s) +
    qoff; the single-device SparseEngine rounds bf16(s + qoff).  Bit-equal
    to JAX's sharded engine."""
    from bm25_tpu_torch.models.sparse import SparseEngine

    idx = zipf_index(zipf_corpus_small, method=method)
    assert np.any(idx.token_offsets)
    queries = np.random.default_rng(8).integers(
        0, idx.vocab_size, size=(16, 6), dtype=np.int32)
    eng, jeng = both("ShardedSparseEngine", idx, 2, 4, hot_tokens=8,
                     score_dtype="bfloat16")
    dd, ds = eng.search(queries, top_k=10)
    jd, js = jeng.search(queries, top_k=10)
    np.testing.assert_array_equal(dd, np.asarray(jd))
    np.testing.assert_array_equal(ds, np.asarray(js))

    # the device's merged f32 scores, without the offsets, and the
    # offsets as the engine sums them on the host (over the padded ids)
    (_cq, padded, _w), = eng._plan(queries, None, 10)
    step = port_sharded.make_sharded_ell_step(eng.mesh, 10, eng.hot_h,
                                              eng.buckets)
    raw = np.concatenate([s.numpy() for s, _ in step(
        eng.hot_table, port_sharded.put_queries(eng.mesh, padded))])[:16]
    valid = padded[:16] >= 0
    off = eng.offsets.numpy()
    qoff = np.where(valid, off[np.where(valid, padded[:16], 0)], 0.0).sum(1)
    bf16 = torch.from_numpy(raw).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(ds, bf16 + qoff[:, None])
    # the single-device engine rounds after the add: the same ranking,
    # other bits
    single = SparseEngine.from_scored_index(
        idx, session=Session("cpu"), hot_tokens=8, score_dtype="bfloat16")
    sd, ss = single.search(queries, top_k=10)
    np.testing.assert_array_equal(sd, dd)
    np.testing.assert_allclose(ss, ds, rtol=2e-2)
    assert not np.array_equal(ds, ss)
