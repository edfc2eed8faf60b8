"""Port DenseEngine (models/dense.py), create_engine's routing
(models/auto.py) and the entry step (entry.py) against the JAX package
and the host oracle, on the CPU.

The slice as a whole: search results match the JAX DenseEngine and
``ReferenceEngine`` under the campaign comparator, for gather and matmul
scoring, weights, doc masks, offsets and negative IDF.  Where the path is
the gather kernel's with no offsets, the scores are bit-equal to JAX's.
State: the device-side table fill equals the JAX host fill bit for bit,
and ``from_arrays`` carries a JAX engine's table across.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bm25_tpu.models.auto as jax_auto
from bm25_tpu.eval import engine_device_bytes
from bm25_tpu.models.dense import DenseEngine as JaxDenseEngine
from bm25_tpu.models.dense import make_query_step as jax_make_query_step
from bm25_tpu.ops.gather_rows import doc_pad as jax_doc_pad
from bm25_tpu.reference import ReferenceEngine
from bm25_tpu.scoring import BM25Params, build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import DenseEngine, Session, SparseEngine, create_engine
from bm25_tpu_torch.models import dense as port_dense
from bm25_tpu_torch.ops import gather_rows
from bm25_tpu_torch.ops.gather_rows import doc_pad
from bm25_tpu_torch.utils.parity import assert_matches_oracle

from conftest import make_zipf_corpus, strict_positions

CPU = Session("cpu")


def build(seed, method, num_docs=1100, vocab=300):
    corpus = make_zipf_corpus(num_docs, vocab=vocab, avg_len=25, seed=seed)
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    return build_scored_index(out.ids, vocab_size=len(out.vocab),
                              params=BM25Params(method=method))


@pytest.fixture(scope="module")
def lucene():
    idx = build(0, "lucene")
    return (idx, DenseEngine.from_scored_index(idx, session=CPU),
            JaxDenseEngine.from_scored_index(idx),
            ReferenceEngine.from_scored_index(idx))


def queries_for(idx, seed, q=11, t=6):
    rng = np.random.default_rng(seed)
    queries = rng.integers(-1, idx.vocab_size, size=(q, t), dtype=np.int32)
    queries[0] = -1  # fully padded row
    queries[1, :3] = queries[1, 0]  # duplicate tokens
    return queries


def assert_fuzz_protocol(dd, ds, od, os_):
    """tests/test_fuzz.py's engine-vs-oracle check."""
    np.testing.assert_allclose(ds, os_, rtol=2e-5, atol=1e-5)
    strict = strict_positions(os_)
    np.testing.assert_array_equal(dd[strict], od[strict])


def port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype == ml_dtypes.bfloat16 else np.uint32)


# -- search parity -------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 7, 100])
def test_gather_search_bit_equal_to_jax_and_matches_oracle(lucene, k):
    idx, port, jax_engine, oracle = lucene
    queries = queries_for(idx, k)
    dd, ds = port.search(queries, top_k=k)
    jd, js = jax_engine.search(queries, top_k=k)
    assert dd.dtype == np.int32 and ds.dtype == np.float32
    np.testing.assert_array_equal(dd, jd)
    np.testing.assert_array_equal(ds, js)
    assert_matches_oracle(dd, ds, *oracle.search(queries, top_k=k))


def test_weighted_and_masked_search(lucene):
    idx, port, jax_engine, oracle = lucene
    rng = np.random.default_rng(31)
    queries = queries_for(idx, 31)
    weights = rng.uniform(0.1, 3.0, size=queries.shape).astype(np.float32)
    mask = rng.random(idx.num_docs) < 0.5
    for kw in ({"weights": weights}, {"doc_mask": mask},
               {"weights": weights, "doc_mask": mask}):
        dd, ds = port.search(queries, top_k=40, **kw)
        jd, js = jax_engine.search(queries, top_k=40, **kw)
        np.testing.assert_array_equal(dd, jd)
        np.testing.assert_array_equal(ds, js)
        assert_matches_oracle(dd, ds, *oracle.search(queries, top_k=40,
                                                     **kw))
    with pytest.raises(ValueError, match="weights shape"):
        port.search(queries, top_k=3, weights=weights[:, :2])


def test_mask_shortfall_and_device_mask(lucene):
    """Fewer eligible docs than k: doc -1 / score 0, as JAX and the
    oracle; a mask tensor already on the device is used as it is."""
    idx, port, jax_engine, oracle = lucene
    queries = queries_for(idx, 5)
    mask = np.zeros(idx.num_docs, bool)
    mask[[3, 40, 41, 900]] = True
    dd, ds = port.search(queries, top_k=10, doc_mask=torch.from_numpy(mask))
    jd, js = jax_engine.search(queries, top_k=10, doc_mask=mask)
    np.testing.assert_array_equal(dd, jd)
    np.testing.assert_array_equal(ds, js)
    assert (dd[:, 4:] == -1).all() and (ds[:, 4:] == 0).all()
    assert_matches_oracle(dd, ds, *oracle.search(queries, top_k=10,
                                                 doc_mask=mask))
    with pytest.raises(ValueError, match="doc_mask shape"):
        port.search(queries, top_k=3, doc_mask=mask[:-1])


@pytest.mark.parametrize("seed,method", [
    (1, "robertson"),  # negative idf values
    (2, "atire"),
    (3, "bm25l"),  # nonzero token offsets
    (4, "bm25+"),
])
@pytest.mark.parametrize("scoring", ["gather", "matmul"])
def test_methods_match_jax_and_oracle(seed, method, scoring):
    idx = build(seed, method)
    port = DenseEngine.from_scored_index(idx, session=CPU)
    port.scoring = scoring
    jax_engine = JaxDenseEngine.from_scored_index(idx)
    jax_engine.scoring = scoring
    oracle = ReferenceEngine.from_scored_index(idx)
    queries = queries_for(idx, seed + 100)
    w = np.random.default_rng(seed).uniform(0.1, 3.0, queries.shape)
    for kw in ({}, {"weights": w.astype(np.float32)}):
        for k in (1, 10, idx.num_docs + 5):
            dd, ds = port.search(queries, top_k=k, **kw)
            od, os_ = oracle.search(queries, top_k=k, **kw)
            assert_matches_oracle(dd, ds, od, os_)
            # the JAX matmul's bf16 split is ~f32 only: near-ties may swap
            assert_matches_oracle(dd, ds, *jax_engine.search(queries,
                                                             top_k=k, **kw))
            if scoring == "gather":
                assert_fuzz_protocol(dd, ds, od, os_)


def test_matmul_matches_gather(lucene):
    idx, port, _, _ = lucene
    mm = DenseEngine(st=port.st, offsets=port.offsets, num_docs=port.num_docs,
                     vocab_size=port.vocab_size, session=CPU,
                     scoring="matmul")
    queries = queries_for(idx, 13, q=10)
    dg, sg = port.search(queries, top_k=12)
    dm, sm = mm.search(queries, top_k=12)
    np.testing.assert_allclose(sm, sg, rtol=2e-5, atol=1e-5)
    strict = strict_positions(sg)
    np.testing.assert_array_equal(dm[strict], dg[strict])
    assert mm._st_pair is None  # an f32 table needs no f32 copy


def test_bf16_table_equals_jax(lucene):
    idx, _, _, oracle = lucene
    port = DenseEngine.from_scored_index(idx, session=CPU,
                                         dtype=torch.bfloat16)
    jax_engine = JaxDenseEngine.from_scored_index(idx, dtype=jnp.bfloat16)
    assert port.st.dtype == torch.bfloat16
    queries = queries_for(idx, 17)
    w = np.random.default_rng(2).uniform(0.1, 3.0, queries.shape).astype(
        np.float32)
    for kw in ({}, {"weights": w}):
        dd, ds = port.search(queries, top_k=10, **kw)
        jd, js = jax_engine.search(queries, top_k=10, **kw)
        np.testing.assert_array_equal(dd, jd)
        np.testing.assert_array_equal(ds, js)
        od, os_ = oracle.search(queries, top_k=10, **kw)
        np.testing.assert_allclose(ds, os_, rtol=2e-2, atol=1e-2)
    # matmul scoring over an f32 copy of the bf16 table: held to the JAX
    # bf16 engine's matmul and to the oracle at the bf16 tolerance
    port.scoring = jax_engine.scoring = "matmul"
    for kw in ({}, {"weights": w}):
        dm, sm = port.search(queries, top_k=10, **kw)
        assert_matches_oracle(dm, sm, *jax_engine.search(queries, top_k=10,
                                                         **kw))
        od, os_ = oracle.search(queries, top_k=10, **kw)
        np.testing.assert_allclose(sm, os_, rtol=2e-2, atol=1e-2)
    assert port._st_pair[0].dtype == torch.float32
    assert torch.equal(port._st_pair[0], port.st.float())


def test_get_scores_and_pipelined(lucene):
    idx, port, jax_engine, oracle = lucene
    q = np.array([0, 3, 9, -1], dtype=np.int32)
    np.testing.assert_allclose(port.get_scores(q), oracle.get_scores(q),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.get_scores(q), jax_engine.get_scores(q))
    queries = np.random.default_rng(77).integers(-1, idx.vocab_size,
                                                 size=(40, 5), dtype=np.int32)
    d1, s1 = port.search(queries, top_k=9)
    d2, s2 = port.search_pipelined(queries, top_k=9, batch=16)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(s1, s2)
    j2 = jax_engine.search_pipelined(queries, top_k=9, batch=16)
    np.testing.assert_array_equal(d2, j2[0])
    np.testing.assert_array_equal(s2, j2[1])


def test_edge_cases(lucene):
    idx, port, jax_engine, _ = lucene
    docs, scores = port.search(np.zeros((0, 3), np.int32), top_k=5)
    assert docs.shape == scores.shape == (0, 5)
    assert port.search_pipelined(np.zeros((0, 3), np.int32))[0].shape == \
        (0, 100)
    # OOV-only queries: scores 0, docs by id
    docs, scores = port.search(np.full((2, 4), -1, np.int32), top_k=3)
    np.testing.assert_array_equal(scores, 0.0)
    np.testing.assert_array_equal(docs, [[0, 1, 2], [0, 1, 2]])
    # k > num_docs clamps, padded doc columns never appear
    docs, scores = port.search(np.array([[0, 1]], np.int32),
                               top_k=idx.num_docs + 50)
    assert docs.shape == (1, idx.num_docs) and docs.max() < idx.num_docs
    assert sorted(docs[0].tolist()) == list(range(idx.num_docs))
    # T = 0 queries: the empty grid gives zeros
    docs, scores = port.search(np.zeros((2, 0), np.int32), top_k=4)
    jd, js = jax_engine.search(np.zeros((2, 0), np.int32), top_k=4)
    np.testing.assert_array_equal(docs, jd)
    np.testing.assert_array_equal(scores, js)
    with pytest.raises(ValueError, match="out of range"):
        port.search(np.array([[idx.vocab_size]], np.int32), top_k=1)


def test_animal_end_to_end(animal_corpus):
    tok = Tokenizer()
    out = tok.tokenize_corpus(animal_corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab),
                             vocab=out.vocab)
    eng = DenseEngine.from_scored_index(idx, session=CPU)
    q = tok.tokenize_queries(["does the fish purr like a cat?"], out.vocab)
    docs, scores = eng.search(q, top_k=2)
    assert docs[0, 0] == 0
    assert scores[0, 0] == pytest.approx(1.5877, abs=1e-3)
    assert eng.vocab == out.vocab


# -- state ---------------------------------------------------------------------


@pytest.mark.parametrize("method", ["lucene", "bm25+"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_fill_bit_equal_to_jax_host_fill(method, dtype):
    idx = build(6, method, num_docs=700)
    port = DenseEngine.from_scored_index(idx, session=CPU, dtype=dtype)
    jax_engine = JaxDenseEngine.from_scored_index(
        idx, dtype=getattr(jnp, dtype))
    d = idx.num_docs
    st_j = jax_bits(jax_engine.st)
    assert port.st.shape == (st_j.shape[0], doc_pad(d))
    np.testing.assert_array_equal(port_bits(port.st)[:, :d], st_j[:, :d])
    assert not port.st[:, d:].any() and not st_j[:, d:].any()
    np.testing.assert_array_equal(port.offsets.numpy(),
                                  np.asarray(jax_engine.offsets))
    # and to a plain numpy fill of the CSC postings
    csc = idx.to_csc()
    host = np.zeros((st_j.shape[0], doc_pad(d)), np.float32)
    host[np.repeat(np.arange(idx.vocab_size), np.diff(csc.indptr)),
         csc.indices] = csc.data
    np.testing.assert_array_equal(
        port.st.float().numpy(),
        torch.from_numpy(host).to(port.st.dtype).float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_arrays_carries_jax_state(lucene, dtype):
    idx = lucene[0]
    jax_engine = JaxDenseEngine.from_scored_index(idx,
                                                  dtype=getattr(jnp, dtype))
    st, off = np.asarray(jax_engine.st), np.asarray(jax_engine.offsets)
    assert st.shape[1] == jax_doc_pad(idx.num_docs) > doc_pad(idx.num_docs)
    carried = DenseEngine.from_arrays(st, off, num_docs=idx.num_docs,
                                      vocab_size=idx.vocab_size, session=CPU)
    built = DenseEngine.from_scored_index(idx, session=CPU, dtype=dtype)
    np.testing.assert_array_equal(port_bits(carried.st), port_bits(built.st))
    np.testing.assert_array_equal(port_bits(carried.st),
                                  jax_bits(st)[:, : doc_pad(idx.num_docs)])
    queries = queries_for(idx, 8)
    for engine in (carried, built):
        dd, ds = engine.search(queries, top_k=25)
        jd, js = jax_engine.search(queries, top_k=25)
        np.testing.assert_array_equal(dd, jd)
        np.testing.assert_array_equal(ds, js)
    # a table without doc padding widens to the port's doc_pad
    unpadded = DenseEngine.from_arrays(st[:, : idx.num_docs], off,
                                       num_docs=idx.num_docs,
                                       vocab_size=idx.vocab_size, session=CPU)
    np.testing.assert_array_equal(port_bits(unpadded.st), port_bits(built.st))
    with pytest.raises(ValueError, match="st shape"):
        DenseEngine.from_arrays(st[:-1], off, num_docs=idx.num_docs,
                                vocab_size=idx.vocab_size, session=CPU)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        DenseEngine.from_arrays(st.astype(np.float16), off,
                                num_docs=idx.num_docs,
                                vocab_size=idx.vocab_size, session=CPU)


def test_engine_device_bytes_counts_the_port_engine(lucene):
    idx, port, _, _ = lucene
    assert engine_device_bytes(port) == port.st.nbytes + port.offsets.nbytes \
        == port_dense.table_bytes(idx.vocab_size, idx.num_docs) \
        + 4 * port.st.shape[0]
    bf = DenseEngine.from_scored_index(idx, session=CPU, dtype="bfloat16")
    bf.scoring = "matmul"
    bf.search(queries_for(idx, 1), top_k=3)
    # the matmul scoring's f32 copy of the bf16 table counts too
    assert engine_device_bytes(bf) == bf.st.nbytes * 3 + bf.offsets.nbytes


def test_memory_budget_raises(lucene):
    idx = lucene[0]
    need = port_dense.table_bytes(idx.vocab_size, idx.num_docs)
    DenseEngine.from_scored_index(idx, session=CPU, max_bytes=need)
    with pytest.raises(MemoryError, match="SparseEngine"):
        DenseEngine.from_scored_index(idx, session=CPU, max_bytes=need - 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        DenseEngine.from_scored_index(idx, session=CPU, dtype=torch.float16)


# -- routing ---------------------------------------------------------------------


def jax_need(idx, itemsize=4):
    v = -(-(idx.vocab_size + 1) // 8) * 8
    return v * jax_doc_pad(idx.num_docs) * itemsize


@pytest.fixture(scope="module")
def route_index():
    return build(9, "lucene", num_docs=1100, vocab=300)


def kinds(idx, **kw):
    port = create_engine(idx, session=CPU, **kw)
    jax_kw = {k: (getattr(jnp, v) if k == "dtype" else v)
              for k, v in kw.items()}
    jax_engine = jax_auto.create_engine(idx, **jax_kw)
    return type(port).__name__, type(jax_engine).__name__


def test_routing_matches_jax(route_index):
    idx = route_index
    big, tiny = 1 << 40, 1 << 10
    assert kinds(idx, dense_budget_bytes=big) == ("DenseEngine",) * 2
    assert kinds(idx, dense_budget_bytes=tiny) == ("SparseEngine",) * 2
    # max_bytes caps the budget in both
    assert kinds(idx, dense_budget_bytes=big, max_bytes=tiny) == \
        ("SparseEngine",) * 2
    # the dtype's size enters: a budget that fits the bf16 table only
    half = jax_need(idx, 2)
    assert port_dense.table_bytes(idx.vocab_size, idx.num_docs) > half
    assert kinds(idx, dense_budget_bytes=half) == ("SparseEngine",) * 2
    assert kinds(idx, dense_budget_bytes=half, dtype="bfloat16") == \
        ("DenseEngine",) * 2
    # auto drops the options the chosen engine does not take
    assert kinds(idx, dense_budget_bytes=big, hot_tokens=8,
                 max_buckets=2) == ("DenseEngine",) * 2
    assert kinds(idx, dense_budget_bytes=tiny, hot_tokens=8,
                 max_buckets=2) == ("SparseEngine",) * 2


def test_routing_uses_the_ports_real_allocation(route_index):
    idx = route_index
    need = port_dense.table_bytes(idx.vocab_size, idx.num_docs)
    assert need == (-(-(idx.vocab_size + 1) // 8) * 8) * doc_pad(
        idx.num_docs) * 4 < jax_need(idx)
    assert isinstance(create_engine(idx, session=CPU,
                                    dense_budget_bytes=need), DenseEngine)
    assert isinstance(create_engine(idx, session=CPU,
                                    dense_budget_bytes=need - 1),
                      SparseEngine)


def test_routing_forwards_the_budget(route_index, monkeypatch):
    seen = {}
    orig = DenseEngine.from_scored_index.__func__

    def spy(cls, index, session=None, max_bytes=None, dtype=torch.float32):
        seen["max_bytes"] = max_bytes
        return orig(cls, index, session=session, max_bytes=max_bytes,
                    dtype=dtype)

    monkeypatch.setattr(DenseEngine, "from_scored_index", classmethod(spy))
    create_engine(route_index, session=CPU, dense_budget_bytes=1 << 30)
    assert seen["max_bytes"] == 1 << 30
    create_engine(route_index, session=CPU, dense_budget_bytes=1 << 30,
                  max_bytes=1 << 29)
    assert seen["max_bytes"] == 1 << 29


def test_default_budget_is_half_the_device(route_index, monkeypatch):
    import bm25_tpu_torch.models.auto as port_auto

    need = port_dense.table_bytes(route_index.vocab_size,
                                  route_index.num_docs)
    monkeypatch.setattr(port_auto, "device_hbm_bytes", lambda dev: 2 * need)
    assert isinstance(create_engine(route_index, session=CPU), DenseEngine)
    monkeypatch.setattr(port_auto, "device_hbm_bytes",
                        lambda dev: 2 * need - 2)
    assert isinstance(create_engine(route_index, session=CPU), SparseEngine)


def test_explicit_modes_are_strict(route_index):
    with pytest.raises(TypeError):
        create_engine(route_index, mode="dense", session=CPU, hot_tokens=8)
    with pytest.raises(TypeError):
        jax_auto.create_engine(route_index, mode="dense", hot_tokens=8)
    with pytest.raises(TypeError):
        create_engine(route_index, mode="sparse", session=CPU, max_bytes=1)
    assert isinstance(create_engine(route_index, mode="dense", session=CPU),
                      DenseEngine)
    # the sharded modes build the port's sharded engines, as strictly
    for mode, extra in (("sharded", {"hot_tokens": 8}),
                        ("sharded_sparse", {"max_bytes": 1})):
        with pytest.raises(TypeError):
            create_engine(route_index, mode=mode, session=CPU, **extra)
        with pytest.raises(TypeError):
            jax_auto.create_engine(route_index, mode=mode, **extra)
    from bm25_tpu_torch import ShardedEngine, ShardedSparseEngine

    assert isinstance(create_engine(route_index, mode="sharded", session=CPU),
                      ShardedEngine)
    assert isinstance(create_engine(route_index, mode="sharded_sparse",
                                    session=CPU, hot_tokens=8),
                      ShardedSparseEngine)
    with pytest.raises(ValueError, match="unknown engine mode"):
        create_engine(route_index, mode="nope", session=CPU)


# -- the entry step ----------------------------------------------------------------


def test_entry_step_equals_graft_entry():
    import __graft_entry__ as graft
    import jax

    from bm25_tpu_torch.entry import entry

    fn, args = entry(CPU)
    launched = dict(gather_rows.plain_calls)
    scores, docs = fn(*args)
    assert gather_rows.plain_calls["gather_add_rows"] == \
        launched["gather_add_rows"] + 1
    jfn, jargs = graft.entry()
    jscores, jdocs = jax.jit(jfn)(*jargs)
    assert scores.shape == docs.shape == (4, 8)
    np.testing.assert_array_equal(docs.numpy(), np.asarray(jdocs))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    # the step is the engine's, and equals a fresh JAX step over the table
    step = jax_make_query_step(num_docs=64, k=8)
    np.testing.assert_array_equal(
        scores.numpy(), np.asarray(jax.jit(step)(*jargs)[0]))
