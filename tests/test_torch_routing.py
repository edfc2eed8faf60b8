"""Cold-width routing, its DP chunk planner and union selection in the
port's sparse engines, against the JAX package's, on the CPU.

The planner's functions (``compact_rows``, ``_routed_q_pad``,
``_chunk_bounds_dp``, ``plan_query_dispatch``) are held equal to JAX's at
JAX's costs, passed explicitly (the port's own costs were fitted on the
card: ``CHUNK_C0_UNITS``, ``CHUNK_FIXED_UNITS``): the same permutation
and the same chunk arrays.  Then the counterparts of
``tests/test_sparse_engine.py``'s routing, dedup-with-routing, union and
DP tests: routed and union results match JAX's engine and
``ReferenceEngine`` (scores within the JAX tests' tolerances, ids equal
at ``strict_positions``), and union selection equals the per-bucket path
bit for bit, its all-tied fallback included.
"""

import numpy as np
import pytest
import torch

from conftest import make_zipf_corpus, strict_positions

import bm25_tpu.models.sparse as jax_sparse
from bm25_tpu.reference import ReferenceEngine
from bm25_tpu.scoring import build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import Session
from bm25_tpu_torch.models import sparse as port_sparse
from bm25_tpu_torch.models.sparse import SparseEngine
from bm25_tpu_torch.parallel.mesh import make_mesh
from bm25_tpu_torch.parallel.sharded_engine import ShardedSparseEngine
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = Session("cpu")
JAX_FIXED_UNITS = 550.0  # _chunk_bounds_dp's default in the JAX package


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the kernels' CPU twins run many
    small ops, which slow down by tens of times when several test
    processes each run a thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(request):
    corpus = request.getfixturevalue("zipf_corpus_small")
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))
    return idx, ReferenceEngine.from_scored_index(idx)


@pytest.fixture(scope="module")
def wide():
    """A corpus wide enough for several buckets of 512-row blocks (union
    selection needs more than one)."""
    corpus = make_zipf_corpus(2500, vocab=400, avg_len=25, seed=9)
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))
    return idx, ReferenceEngine.from_scored_index(idx)


def engines(idx, hot_tokens, **kw):
    """(JAX engine, port engine) at the same explicit layout."""
    return (jax_sparse.SparseEngine.from_scored_index(
                idx, hot_tokens=hot_tokens, **kw),
            SparseEngine.from_scored_index(
                idx, session=CPU, hot_tokens=hot_tokens,
                hot_budget_bytes=1 << 24, **kw))


def check(got, want_jax, want_oracle, tol):
    gd, gs = got
    for wd, ws in (want_jax, want_oracle):
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=tol, atol=tol)
        strict = strict_positions(want_oracle[1])
        np.testing.assert_array_equal(gd[strict], np.asarray(wd)[strict])
    assert_matches_oracle(gd, gs, *want_oracle)


# -- the planner at JAX's costs ----------------------------------------------


def test_compact_rows_and_routed_q_pad_equal_jax():
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 50, (37, 9)).astype(np.int32)
    keep = (ids >= 0) & (rng.random(ids.shape) < 0.5)
    keep[0] = False  # a row with nothing kept keeps a -1 pad
    w = rng.uniform(0.1, 2, ids.shape).astype(np.float32)
    for args in ((ids, keep), (ids, keep, w), (ids, keep, None, 4)):
        got, want = port_sparse.compact_rows(*args), \
            jax_sparse.compact_rows(*args)
        for g, x in zip(got, want):
            if x is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, x)
    assert (port_sparse.compact_rows(ids, keep)[0][0] == -1).all()
    for cq in range(1, 600, 7):
        for max_q, q_align in ((512, 8), (8, 8), (24, 8), (128, 16),
                               (512, 24)):
            assert port_sparse._routed_q_pad(cq, max_q, q_align) == \
                jax_sparse._routed_q_pad(cq, max_q, q_align)
    # the budget test of tests/test_sparse_engine.py
    assert port_sparse._routed_q_pad(5, max_q=512, q_align=8) == 32
    assert port_sparse._routed_q_pad(100, max_q=512, q_align=8) == 128
    assert port_sparse._routed_q_pad(5, max_q=8, q_align=8) == 8
    assert port_sparse._routed_q_pad(20, max_q=24, q_align=8) == 24
    assert port_sparse._routed_q_pad(16, max_q=24, q_align=8) == 16


def test_chunk_bounds_dp_equals_jax():
    """JAX's DP test (every row covered, chunk sizes within max_q) and the
    same cut points as JAX's at its costs; at the card's costs the plan
    is still a cover."""
    rng = np.random.default_rng(0)
    for n, max_q, q_align in [(2048, 512, 8), (100, 512, 8), (7, 512, 8),
                              (513, 128, 16), (2048, 512, 24), (64, 8, 8),
                              (33, 32, 8), (999, 64, 16), (1, 512, 8)]:
        counts = np.sort(rng.integers(0, 65, size=n))
        cls = 1 << np.ceil(np.log2(np.maximum(counts, 2))).astype(np.int64)
        for c0 in (10.0, 20.0, 32.0):
            for fixed in (JAX_FIXED_UNITS, port_sparse.CHUNK_FIXED_UNITS):
                got = port_sparse._chunk_bounds_dp(cls, max_q, q_align, c0,
                                                   fixed)
                assert got == jax_sparse._chunk_bounds_dp(
                    cls, max_q, q_align, c0_units=c0, fixed_units=fixed)
        card = port_sparse._chunk_bounds_dp(
            cls, max_q, q_align, port_sparse.chunk_c0_units(1000),
            port_sparse.CHUNK_FIXED_UNITS)
        for bounds in (got, card):
            assert bounds[0] == 0 and bounds[-1] == n
            sizes = np.diff(bounds)
            assert (sizes > 0).all() and (sizes <= max(max_q, 8)).all()
    c0 = [port_sparse.chunk_c0_units(k) for k in (10, 100, 316, 1000, 5000)]
    assert c0[0] == c0[1] == port_sparse.CHUNK_C0_UNITS[100]
    assert c0[3] == c0[4] == port_sparse.CHUNK_C0_UNITS[1000]
    assert min(c0[1], c0[3]) <= c0[2] <= max(c0[1], c0[3])


PLAN_CASES = [
    dict(route=True, weighted=False, max_q=256, q_align=8, k=1000),
    dict(route=True, weighted=True, max_q=64, q_align=8, k=100),
    dict(route="auto", weighted=False, max_q=512, q_align=16, k=10),
    dict(route="auto", weighted=True, max_q=24, q_align=8, k=None),
    dict(route=False, weighted=False, max_q=128, q_align=8, k=100),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_routed_plan_equals_jax(case):
    """``plan_query_dispatch`` at JAX's costs: JAX's permutation and chunk
    arrays, rows reassembling exactly under the permutation."""
    c = PLAN_CASES[case]
    rng = np.random.default_rng(case)
    qs = rng.integers(-1, 64, size=(700, 6)).astype(np.int32)
    qs[:40] = np.where(qs[:40] < 32, qs[:40], -1)  # all-hot or pad rows
    w = (rng.uniform(0.2, 2, qs.shape).astype(np.float32) if c["weighted"]
         else None)
    hot = np.full(65, -1, np.int32)
    hot[:32] = np.arange(32)
    kw = dict(hot_table_host=hot, hot_h=32, has_scan=True, route=c["route"],
              route_min_queries=32, max_q=c["max_q"], q_align=c["q_align"])
    jperm, jchunks = jax_sparse.plan_query_dispatch(
        qs, w, **kw, c0_units=jax_sparse.chunk_c0_units(c["k"]))
    perm, chunks = port_sparse.plan_query_dispatch(
        qs, w, **kw, c0_units=jax_sparse.chunk_c0_units(c["k"]),
        fixed_units=JAX_FIXED_UNITS)
    if jperm is None:
        assert perm is None
    else:
        np.testing.assert_array_equal(perm, jperm)
    assert len(chunks) == len(jchunks)
    for got, want in zip(chunks, jchunks):
        assert got.cq == want[0]
        for g, x in zip(got[1:], want[1:]):
            if x is None:
                assert g is None
            else:
                assert g.dtype == x.dtype
                np.testing.assert_array_equal(g, x)
    routed = c["route"] is not False
    assert all((ch.cold_padded is not None) == routed for ch in chunks)
    total = np.concatenate([ch.padded[: ch.cq] for ch in chunks])
    np.testing.assert_array_equal(port_sparse.unpermute(perm, total),
                                  np.pad(qs, ((0, 0), (0, 2)),
                                         constant_values=-1))


# -- the engines -------------------------------------------------------------


def test_cold_width_routing_matches_oracle(setup):
    """Forced routing (JAX's test): reorders and strips hot tokens exactly,
    plain and weighted, an all-pad row included; every chunk is routed."""
    idx, oracle = setup
    jeng, eng = engines(idx, 32)
    jeng.route_cold = eng.route_cold = True
    rng = np.random.default_rng(61)
    queries = rng.integers(-1, idx.vocab_size, size=(40, 8), dtype=np.int32)
    queries[0] = -1
    perm, chunks = eng.plan_chunks(queries, k=9)
    assert perm is not None and all(c.cold_padded is not None
                                    for c in chunks)
    check(eng.search(queries, top_k=9), jeng.search(queries, top_k=9),
          oracle.search(queries, top_k=9), 2e-5)
    w = rng.uniform(0.2, 2.0, size=queries.shape).astype(np.float32)
    check(eng.search(queries, top_k=9, weights=w),
          jeng.search(queries, top_k=9, weights=w),
          oracle.search(queries, top_k=9, weights=w), 5e-5)
    # the routed step's bits are the unrouted step's on the CPU
    eng.route_cold = False
    routed = eng.search(queries, top_k=9)
    eng.route_cold = True
    np.testing.assert_array_equal(eng.search(queries, top_k=9)[1],
                                  routed[1])
    np.testing.assert_array_equal(
        eng.search_pipelined(queries, top_k=9, batch=32)[0],
        eng.search(queries, top_k=9)[0])


def test_dedup_plus_cold_routing_matches_oracle(setup):
    """Auto dedup (wide repetitive queries) composed with forced routing
    (JAX's test): the routed chunks carry the count weights."""
    idx, oracle = setup
    jeng, eng = engines(idx, 32)
    jeng.route_cold = eng.route_cold = True
    rng = np.random.default_rng(81)
    base = rng.integers(0, idx.vocab_size, size=(36, 5))
    pick = rng.integers(0, 5, size=(36, 24))
    queries = np.take_along_axis(
        np.broadcast_to(base, (36, 5)).astype(np.int32), pick, axis=1)
    queries[0] = -1
    assert queries.shape[1] >= eng.dedup_min_width
    dd, ds = eng.search(queries, top_k=9)
    check((dd, ds), jeng.search(queries, top_k=9),
          oracle.search(queries, top_k=9), 5e-5)
    np.testing.assert_array_equal(eng.search_ids(queries, top_k=9), dd)


def test_auto_routing_rule_and_fields(setup):
    """``"auto"`` routes batches of ``route_min_queries`` rows or more;
    False, no host table or no hot tier do not; ``chunk_queries`` caps a
    chunk's rows; a routed batch comes back in the caller's order."""
    idx, oracle = setup
    _, eng = engines(idx, 16)
    rng = np.random.default_rng(5)
    q = rng.integers(-1, idx.vocab_size, size=(48, 6), dtype=np.int32)
    assert eng.route_cold == "auto" and eng.route_min_queries == 32
    assert eng.plan_chunks(q[:31])[0] is None
    assert eng.plan_chunks(q)[0] is not None
    eng.route_min_queries = 64
    assert eng.plan_chunks(q)[0] is None
    eng.route_min_queries = 32
    eng.route_cold = False
    unrouted = eng.search(q, top_k=7)
    assert eng.plan_chunks(q)[0] is None
    eng.route_cold = "auto"
    table, eng.hot_table_host = eng.hot_table_host, None
    assert eng.plan_chunks(q)[0] is None
    eng.hot_table_host = table
    np.testing.assert_array_equal(eng.hot_table_host,
                                  eng.hot_table.numpy())
    routed = eng.search(q, top_k=7)
    np.testing.assert_array_equal(routed[0], unrouted[0])
    np.testing.assert_array_equal(routed[1], unrouted[1])
    assert_matches_oracle(*routed, *oracle.search(q, top_k=7))
    eng.chunk_queries = 16
    assert max(c.cq for c in eng.plan_chunks(q, k=7)[1]) <= 16
    np.testing.assert_array_equal(eng.search(q, top_k=7)[0], routed[0])
    _, h0 = engines(idx, 0)
    assert h0.plan_chunks(q)[0] is None


@pytest.mark.parametrize("weighted", [False, True])
def test_union_selection_matches_per_bucket(wide, monkeypatch, weighted):
    """Union group selection (JAX's test, on a corpus of several
    buckets): bit-equal to the per-bucket path, unweighted and weighted,
    and on a degenerate all-tied corpus the flag trips and the fallback
    keeps the doc-id order."""
    idx, oracle = wide
    select, flags = port_sparse.union_group_select, []

    def spy(gmaxes, k):
        gpos, ok = select(gmaxes, k)
        flags.append(bool(ok))
        return gpos, ok

    monkeypatch.setattr(port_sparse, "union_group_select", spy)
    j_u = jax_sparse.SparseEngine.from_scored_index(idx, max_buckets=4)
    rng = np.random.default_rng(21)
    queries = rng.integers(-1, idx.vocab_size, size=(24, 7), dtype=np.int32)
    w = (rng.uniform(0.5, 2.0, queries.shape).astype(np.float32)
         if weighted else None)
    e_u = SparseEngine.from_scored_index(
        idx, session=CPU, max_buckets=4, hot_tokens=j_u.hot_h,
        hot_budget_bytes=1 << 24)
    e_p = SparseEngine.from_scored_index(
        idx, session=CPU, max_buckets=4, hot_tokens=j_u.hot_h,
        hot_budget_bytes=1 << 24)
    assert not e_p.union_select and len(e_u.buckets) > 1
    e_u.union_select = j_u.union_select = True
    for k in (5, 40):
        assert port_sparse.union_applies(True, e_u.buckets, k)
        du, su = e_u.search(queries, top_k=k, weights=w)
        dp, sp = e_p.search(queries, top_k=k, weights=w)
        np.testing.assert_array_equal(du, dp)
        np.testing.assert_array_equal(su, sp)
        jd, js = j_u.search(queries, top_k=k, weights=w)
        np.testing.assert_array_equal(du, np.asarray(jd))
        np.testing.assert_allclose(su, np.asarray(js), rtol=1e-6, atol=1e-6)
        assert_matches_oracle(du, su, *oracle.search(queries, top_k=k,
                                                     weights=w))
    assert flags[0]  # k=5: the union path's own result

    # every doc alike, over two buckets: every group max ties the k-th
    ids = [np.array([0, 1], np.int32)] * 2048
    tied = build_scored_index(ids, vocab_size=4)
    eng = SparseEngine.from_scored_index(tied, session=CPU, max_buckets=2)
    assert len(eng.buckets) == 2
    eng.union_select = True
    d, s = eng.search(np.array([[0, 1]], np.int32), top_k=10)
    assert flags[-1] is False  # the fallback's result
    np.testing.assert_array_equal(d[0], np.arange(10))
    assert np.allclose(s[0], s[0][0])
    # "unsafe" skips the check: on the tied corpus it keeps the won
    # groups' order, which need not be the doc order's first ten
    eng.union_select = "unsafe"
    du, su = eng.search(np.array([[0, 1]], np.int32), top_k=10)
    assert np.allclose(su[0], s[0][0]) and len(set(du[0])) == 10


def test_union_chunk_budget_counts_every_bucket(wide):
    """With union selection on, the chunk budget counts every bucket's
    rows (all bases are live at its selection), as JAX's plan_chunks."""
    idx, _ = wide
    _, eng = engines(idx, 8, max_buckets=3)
    rows = [b["doc_ids"].shape[0] for b in eng.buckets]
    assert len(rows) > 1
    q = np.zeros((40, 4), np.int32)
    eng.route_cold = False
    eng.score_buffer_budget = 4 * sum(rows) * 8
    assert max(c.cq for c in eng.plan_chunks(q)[1]) > 8
    eng.union_select = True
    assert [c.cq for c in eng.plan_chunks(q)[1]] == [8] * 5


def test_sharded_union_matches_per_bucket(wide):
    """``ShardedSparseEngine.union_select`` runs union selection in each
    shard: bit-equal to its per-bucket path (JAX's sharded engine has no
    such option)."""
    idx, oracle = wide
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    kw = dict(mesh=mesh, hot_tokens=8, max_buckets=3,
              hot_budget_bytes=1 << 24)
    e_u = ShardedSparseEngine.from_scored_index(idx, **kw)
    e_p = ShardedSparseEngine.from_scored_index(idx, **kw)
    e_u.union_select = True
    rng = np.random.default_rng(23)
    queries = rng.integers(-1, idx.vocab_size, size=(40, 6), dtype=np.int32)
    for k in (5, 20):
        local = [b["doc_ids"].on(0, 0).shape[0] for b in e_u.buckets]
        assert len(local) > 1 and sum(local) // 8 > k + 1
        du, su = e_u.search(queries, top_k=k)
        dp, sp = e_p.search(queries, top_k=k)
        np.testing.assert_array_equal(du, dp)
        np.testing.assert_array_equal(su, sp)
        assert_matches_oracle(du, su, *oracle.search(queries, top_k=k))
