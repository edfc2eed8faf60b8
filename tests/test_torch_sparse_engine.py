"""Port SparseEngine (models/sparse.py) against the JAX SparseEngine and
the host oracle, on the CPU.

Layout and state: the port's host builders and device arrays are
bit-equal to the JAX engine's at the same hot_tokens/max_buckets, and
``from_arrays`` carries a JAX engine's arrays over unchanged.  The slice
as a whole: search results match both under the fuzz protocol of
tests/test_fuzz.py.
"""

import numpy as np
import pytest
import torch

from conftest import make_zipf_corpus, strict_positions

import bm25_tpu.models.sparse as jax_sparse
from bm25_tpu.reference import ReferenceEngine
from bm25_tpu.scoring import BM25Params, build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import DenseEngine, Session, create_engine, load_index
from bm25_tpu_torch.models import sparse as port_sparse
from bm25_tpu_torch.models.sparse import SparseEngine
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = Session("cpu")


def build(seed, method, num_docs=1100, vocab=300):
    corpus = make_zipf_corpus(num_docs, vocab=vocab, avg_len=25, seed=seed)
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    return build_scored_index(out.ids, vocab_size=len(out.vocab),
                              params=BM25Params(method=method))


@pytest.fixture(scope="module")
def lucene_index():
    return build(0, "lucene")


TAIL_KEYS = ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
             "tail_gpos")


def jax_state(engine) -> dict:
    """Numpy copies of a JAX SparseEngine's device arrays, keyed as
    ``SparseEngine.from_arrays`` takes them (the tail's by field name)."""
    arrays = {"offsets": np.asarray(engine.offsets),
              "hot_table": np.asarray(engine.hot_table)}
    for i, b in enumerate(engine.buckets):
        for key, arr in b.items():
            arrays[f"buckets.{i}.{key}"] = np.asarray(arr)
    for key in TAIL_KEYS:
        if getattr(engine, key) is not None:
            arrays[key] = np.asarray(getattr(engine, key))
    return arrays


def port_bits(t: torch.Tensor) -> np.ndarray:
    """Host copy of a port tensor, bf16 as its uint16 bit patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def assert_state_equal(port_engine, arrays: dict):
    got = {"offsets": port_engine.offsets, "hot_table": port_engine.hot_table}
    for i, b in enumerate(port_engine.buckets):
        for key, t in b.items():
            got[f"buckets.{i}.{key}"] = t
    for key in TAIL_KEYS:
        if getattr(port_engine, key) is not None:
            got[key] = getattr(port_engine, key)
    assert sorted(got) == sorted(arrays)
    for key, want in arrays.items():
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        np.testing.assert_array_equal(port_bits(got[key]), want, err_msg=key)


def test_host_layout_builders_bit_equal(lucene_index):
    idx = lucene_index
    hot_j = jax_sparse.split_hot_cold_csr(idx, 24)
    hot_p = port_sparse.split_hot_cold_csr(idx, 24)
    np.testing.assert_array_equal(hot_p[0], hot_j[0])
    for a, b in zip(hot_p[1:], hot_j[1:]):
        for attr in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    for mb in (1, 2, 4):
        bj = jax_sparse.build_ell_buckets_from_csr(
            hot_j[1].copy(), idx.num_docs, max_buckets=mb, row_align=512)
        bp = port_sparse.build_ell_buckets_from_csr(
            hot_p[1].copy(), idx.num_docs, max_buckets=mb, row_align=512)
        assert len(bp) == len(bj)
        for x, y in zip(bp, bj):
            for attr in ("tok", "val", "doc_ids"):
                np.testing.assert_array_equal(getattr(x, attr),
                                              getattr(y, attr))
            assert x.num_real == y.num_real
            htj = jax_sparse.hot_ell_for_rows(hot_j[2], y.doc_ids)
            htp = port_sparse.hot_ell_for_rows(hot_p[2], x.doc_ids)
            for u, v in zip(htp, htj):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("hot_tokens,max_buckets,tail_cap", [
    (0, 2, 0), (16, 2, 0), (64, 3, 0),
    (16, 2, 8),  # hot + ELL + tail
    (0, 3, 1 << 30),  # the tail alone: one identity bucket, no ELL
])
def test_device_state_bit_equal_and_from_arrays(lucene_index, hot_tokens,
                                                max_buckets, tail_cap):
    idx = lucene_index
    kw = dict(hot_tokens=hot_tokens, hot_budget_bytes=1 << 22,
              max_buckets=max_buckets, tail_cap=tail_cap)
    jax_engine = jax_sparse.SparseEngine.from_scored_index(idx, **kw)
    port_engine = SparseEngine.from_scored_index(idx, session=CPU, **kw)
    assert port_engine.hot_h == jax_engine.hot_h == hot_tokens
    assert (port_engine.tail_docs is None) == (tail_cap == 0)
    arrays = jax_state(jax_engine)
    assert_state_equal(port_engine, arrays)
    assert port_engine.device_bytes() == jax_engine.device_bytes()

    carried = SparseEngine.from_arrays(
        arrays, num_docs=idx.num_docs, vocab_size=idx.vocab_size,
        hot_h=jax_engine.hot_h, session=CPU, tail_cap=tail_cap)
    assert_state_equal(carried, arrays)
    assert carried.tail_cap == tail_cap
    q = np.random.default_rng(3).integers(-1, idx.vocab_size, (9, 6))
    d1, s1 = carried.search(q, top_k=20)
    d2, s2 = port_engine.search(q, top_k=20)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(s1, s2)


def test_from_arrays_rejects_bad_state(lucene_index):
    arrays = jax_state(jax_sparse.SparseEngine.from_scored_index(
        lucene_index, hot_tokens=8, max_buckets=2))
    kw = dict(num_docs=lucene_index.num_docs,
              vocab_size=lucene_index.vocab_size, session=CPU)
    with pytest.raises(ValueError, match="hot_h"):
        SparseEngine.from_arrays(arrays, hot_h=0, **kw)
    with pytest.raises(ValueError, match="unknown state key"):
        SparseEngine.from_arrays({**arrays, "buckets.0.junk": arrays[
            "offsets"]}, hot_h=8, **kw)
    with pytest.raises(ValueError, match="a tail tier needs all of"):
        SparseEngine.from_arrays({**arrays, "tail_docs": np.zeros(
            (2, 512), np.int32)}, hot_h=8, **kw)


def assert_fuzz_protocol(dd, ds, od, os_):
    """tests/test_fuzz.py's engine-vs-oracle check."""
    np.testing.assert_allclose(ds, os_, rtol=2e-5, atol=1e-5)
    strict = strict_positions(os_)
    np.testing.assert_array_equal(dd[strict], od[strict])


@pytest.mark.parametrize("seed,method,hot_tokens", [
    (0, "lucene", 0),
    (0, "lucene", 32),
    (1, "robertson", 16),  # negative idf values
    (2, "bm25+", 24),  # nonzero token offsets
])
def test_slice_matches_jax_engine_and_oracle(seed, method, hot_tokens):
    idx = build(seed, method)
    kw = dict(hot_tokens=hot_tokens, hot_budget_bytes=1 << 22, max_buckets=2)
    port_engine = create_engine(idx, mode="sparse", session=CPU, **kw)
    jax_engine = jax_sparse.SparseEngine.from_scored_index(idx, **kw)
    oracle = ReferenceEngine.from_scored_index(idx)
    rng = np.random.default_rng(seed + 100)
    queries = rng.integers(-1, idx.vocab_size, size=(11, 5), dtype=np.int32)
    queries[0] = -1  # fully padded row
    queries[1, :3] = queries[1, 0]  # duplicate tokens
    for k in (1, 7, 100, idx.num_docs + 5):
        dd, ds = port_engine.search(queries, top_k=k)
        od, os_ = oracle.search(queries, top_k=k)
        assert dd.dtype == np.int32 and ds.dtype == np.float32
        assert_fuzz_protocol(dd, ds, od, os_)
        assert_matches_oracle(dd, ds, od, os_)
        if k in (7, 100):
            jd, js = jax_engine.search(queries, top_k=k)
            assert_fuzz_protocol(dd, ds, jd, js)
    np.testing.assert_array_equal(
        port_engine.search_ids(queries, top_k=7),
        port_engine.search(queries, top_k=7)[0])


@pytest.mark.parametrize("seed,method,hot_tokens,width", [
    (0, "lucene", 0, 5),
    (0, "lucene", 32, 5),
    (1, "robertson", 16, 6),  # negative idf values
    (2, "bm25+", 24, 5),  # nonzero token offsets: the weighted qoff
    (3, "lucene", 24, 300),  # wider than 256 ids: split hot counts
])
def test_weighted_search_matches_jax_engine_and_oracle(seed, method,
                                                       hot_tokens, width):
    """search(weights=...) against the JAX engine (through from_arrays too,
    on the JAX engine's own arrays) and the oracle, under the fuzz
    protocol; the weighted hot counts are split into a bf16 pair."""
    idx = build(seed, method)
    kw = dict(hot_tokens=hot_tokens, hot_budget_bytes=1 << 22, max_buckets=2)
    port_engine = create_engine(idx, mode="sparse", session=CPU, **kw)
    jax_engine = jax_sparse.SparseEngine.from_scored_index(idx, **kw)
    carried = SparseEngine.from_arrays(
        jax_state(jax_engine), num_docs=idx.num_docs,
        vocab_size=idx.vocab_size, hot_h=jax_engine.hot_h, session=CPU)
    oracle = ReferenceEngine.from_scored_index(idx)
    rng = np.random.default_rng(seed + 200)
    queries = rng.integers(-1, idx.vocab_size, size=(9, width),
                           dtype=np.int32)
    queries[0] = -1
    queries[1, :3] = queries[1, 0]  # duplicates, each with its own weight
    weights = rng.uniform(0.1, 3.0, queries.shape).astype(np.float32)
    weights[2, :2] = [-1.5, 0.0]  # negative and zero weights
    for k in (1, 10, 100):
        dd, ds = port_engine.search(queries, top_k=k, weights=weights)
        od, os_ = oracle.search(queries, top_k=k, weights=weights)
        assert_fuzz_protocol(dd, ds, od, os_)
        assert_matches_oracle(dd, ds, od, os_)
        jd, js = jax_engine.search(queries, top_k=k, weights=weights)
        assert_fuzz_protocol(dd, ds, jd, js)
        cd, cs = carried.search(queries, top_k=k, weights=weights)
        np.testing.assert_array_equal(cd, dd)
        np.testing.assert_array_equal(cs, ds)
    np.testing.assert_array_equal(
        port_engine.search_ids(queries, top_k=7, weights=weights),
        port_engine.search(queries, top_k=7, weights=weights)[0])
    # unit weights are the unweighted search
    ones = np.ones(queries.shape, np.float32)
    ud, us = port_engine.search(queries, top_k=10, weights=ones)
    vd, vs = port_engine.search(queries, top_k=10)
    np.testing.assert_array_equal(ud, vd)
    np.testing.assert_allclose(us, vs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hot_tokens", [0, 24])
def test_get_scores_matches_jax_and_oracle(lucene_index, hot_tokens):
    kw = dict(hot_tokens=hot_tokens, hot_budget_bytes=1 << 22, max_buckets=2)
    eng = SparseEngine.from_scored_index(lucene_index, session=CPU, **kw)
    jax_engine = jax_sparse.SparseEngine.from_scored_index(lucene_index, **kw)
    oracle = ReferenceEngine.from_scored_index(lucene_index)
    rng = np.random.default_rng(7)
    for q in ([3, 17, 3, -1], rng.integers(0, lucene_index.vocab_size, 6),
              [-1, -1]):
        got = eng.get_scores(q)
        assert got.shape == (lucene_index.num_docs,)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, jax_engine.get_scores(q), rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, oracle.get_scores(np.asarray(q)),
                                   rtol=2e-5, atol=1e-5)


def test_empty_batch_and_chunking(lucene_index):
    eng = SparseEngine.from_scored_index(lucene_index, session=CPU,
                                         hot_tokens=8)
    docs, scores = eng.search(np.zeros((0, 5), np.int32), top_k=9)
    assert docs.shape == scores.shape == (0, 9)
    assert eng.search_ids(np.zeros((0, 5), np.int32), top_k=9).shape == (0, 9)
    q = np.random.default_rng(4).integers(-1, lucene_index.vocab_size,
                                          (37, 6))
    whole = eng.search(q, top_k=12)
    # a budget that fits 8 queries per chunk: five chunks, same answers
    rows = max(b["doc_ids"].shape[0] for b in eng.buckets)
    eng.score_buffer_budget = 4 * rows * 8
    assert len(eng.plan_chunks(q)[1]) == 5
    chunked = eng.search(q, top_k=12)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])


def test_all_hot_vocab_has_no_cold_bucket():
    """Every token hot: one identity bucket without ELL slots."""
    idx = build(5, "lucene", num_docs=600, vocab=40)
    eng = create_engine(idx, mode="sparse", session=CPU,
                        hot_tokens=idx.vocab_size, hot_budget_bytes=1 << 24)
    assert eng.hot_h == idx.vocab_size
    assert [sorted(b) for b in eng.buckets] == [["doc_ids", "hotLo", "hotT"]]
    q = np.random.default_rng(5).integers(-1, idx.vocab_size, (8, 4))
    assert_matches_oracle(*eng.search(q, top_k=30),
                          *ReferenceEngine.from_scored_index(idx).search(
                              q, top_k=30))


def test_hot_tokens_capped_by_memory_budget(lucene_index):
    """Without hot_budget_bytes the cap is the raw CSC bytes, as in JAX."""
    idx = lucene_index
    eng = SparseEngine.from_scored_index(idx, session=CPU, hot_tokens=200)
    csc = idx.data.nbytes + idx.indices.nbytes + idx.indptr.nbytes
    assert eng.hot_h == min(200, csc // (idx.num_docs * 4)) < 200


def test_unported_options_raise(lucene_index):
    eng = SparseEngine.from_scored_index(lucene_index, session=CPU,
                                         hot_tokens=4)
    q = np.zeros((2, 3), np.int32)
    # the doc mask is ported: a masked search, not a raise
    mask = np.arange(lucene_index.num_docs) % 3 == 0
    assert_matches_oracle(
        *eng.search(q, doc_mask=mask),
        *ReferenceEngine.from_scored_index(lucene_index).search(
            q, top_k=100, doc_mask=mask))
    with pytest.raises(ValueError, match="weights"):
        eng.search(q, weights=np.ones((2, 4), np.float32))
    # the layout cost model is ported: "auto" builds (the default), any
    # other string raises
    auto = SparseEngine.from_scored_index(lucene_index, session=CPU,
                                          hot_tokens="auto",
                                          hot_budget_bytes=1 << 22)
    assert 0 <= auto.hot_h <= lucene_index.vocab_size
    with pytest.raises(ValueError, match="hot_tokens must be"):
        SparseEngine.from_scored_index(lucene_index, session=CPU,
                                       hot_tokens="many")
    with pytest.raises(ValueError, match="out of range"):
        eng.search(np.array([[lucene_index.vocab_size]]))
    # the sharded modes are ported: the port's sharded engines, on a
    # one-shard mesh of the session's device
    for mode in ("sharded", "sharded_sparse"):
        sharded = create_engine(lucene_index, mode=mode, session=CPU)
        assert type(sharded).__name__ == {
            "sharded": "ShardedEngine",
            "sharded_sparse": "ShardedSparseEngine"}[mode]
        assert sharded.mesh.shape == {"data": 1, "docs": 1}
    with pytest.raises(ValueError, match="unknown engine mode"):
        create_engine(lucene_index, mode="nope", session=CPU)
    # auto routes by the dense table's size: sparse past the budget, dense
    # within it (the sparse-only hot_tokens is dropped there)
    assert isinstance(create_engine(lucene_index, session=CPU,
                                    dense_budget_bytes=1 << 10,
                                    hot_tokens=4), SparseEngine)
    assert isinstance(create_engine(lucene_index, session=CPU,
                                    dense_budget_bytes=1 << 40,
                                    hot_tokens=4), DenseEngine)
    assert isinstance(create_engine(lucene_index, mode="dense", session=CPU),
                      DenseEngine)


def test_animal_corpus_end_to_end(animal_corpus):
    tok = Tokenizer()
    out = tok.tokenize_corpus(animal_corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab),
                             vocab=out.vocab)
    eng = create_engine(idx, mode="sparse", session=CPU, hot_tokens=3)
    q = tok.tokenize_queries(["does the fish purr like a cat?"], out.vocab)
    docs, scores = eng.search(q, top_k=2)
    assert docs[0, 0] == 0
    assert scores[0, 0] == pytest.approx(1.5877, abs=1e-3)


def test_reference_index_end_to_end(reference_index_dir):
    idx = load_index(reference_index_dir)
    eng = create_engine(idx, mode="sparse", session=CPU, hot_tokens=4)
    q = Tokenizer().tokenize_queries(["does the fish purr like a cat?"],
                                     idx.vocab)
    docs, scores = eng.search(q, top_k=2)
    assert docs[0, 0] == 0
    assert scores[0, 0] == pytest.approx(1.5877, abs=1e-3)


def bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) -> f32, as numpy."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("hot_tokens", [0, 24])
def test_score_dtype_bfloat16_matches_jax(lucene_index, hot_tokens):
    """score_dtype="bfloat16": the JAX engine's docs and its bf16-rounded
    scores, bit for bit, returned as f32; the f32 search's docs and its
    scores rounded on the host; get_scores follows."""
    kw = dict(hot_tokens=hot_tokens, hot_budget_bytes=1 << 22, max_buckets=2,
              score_dtype="bfloat16")
    port_engine = SparseEngine.from_scored_index(lucene_index, session=CPU,
                                                 **kw)
    jax_engine = jax_sparse.SparseEngine.from_scored_index(lucene_index, **kw)
    f32 = SparseEngine.from_scored_index(
        lucene_index, session=CPU, **{**kw, "score_dtype": "float32"})
    assert port_engine.score_dtype == "bfloat16"
    rng = np.random.default_rng(hot_tokens + 11)
    queries = rng.integers(-1, lucene_index.vocab_size, (13, 5),
                           dtype=np.int32)
    queries[0] = -1
    weights = rng.uniform(0.1, 3.0, queries.shape).astype(np.float32)
    for k, w in ((1, None), (10, None), (100, None), (10, weights)):
        dd, ds = port_engine.search(queries, top_k=k, weights=w)
        jd, js = jax_engine.search(queries, top_k=k, weights=w)
        assert ds.dtype == js.dtype == np.float32
        np.testing.assert_array_equal(dd, jd)
        np.testing.assert_array_equal(ds.view(np.uint32), js.view(np.uint32))
        fd, fs = f32.search(queries, top_k=k, weights=w)
        np.testing.assert_array_equal(dd, fd)
        np.testing.assert_array_equal(ds.view(np.uint32),
                                      bf16_round(fs).view(np.uint32))
    q = queries[3]
    np.testing.assert_array_equal(port_engine.get_scores(q),
                                  bf16_round(f32.get_scores(q)))


def test_score_dtype_rejects_other_types(lucene_index):
    for bad in ("float16", "bf16", None):
        with pytest.raises(ValueError, match="score_dtype must be") as pe:
            SparseEngine.from_scored_index(lucene_index, session=CPU,
                                           score_dtype=bad)
        with pytest.raises(ValueError, match="score_dtype must be") as je:
            jax_sparse.SparseEngine.from_scored_index(lucene_index,
                                                      score_dtype=bad)
        assert str(pe.value) == str(je.value)


def test_auto_passes_score_dtype_to_the_sparse_engine_only(lucene_index):
    """create_engine(mode="auto") hands score_dtype to the sparse engine
    and drops it for the dense one, as JAX's does."""
    q = np.random.default_rng(12).integers(-1, lucene_index.vocab_size,
                                           (9, 4))
    sparse = create_engine(lucene_index, session=CPU, dense_budget_bytes=0,
                           score_dtype="bfloat16")
    assert isinstance(sparse, SparseEngine)
    assert sparse.score_dtype == "bfloat16"
    ref_d, ref_s = create_engine(lucene_index, mode="sparse",
                                 session=CPU).search(q, top_k=20)
    sd, ss = sparse.search(q, top_k=20)
    np.testing.assert_array_equal(sd, ref_d)
    np.testing.assert_array_equal(ss, bf16_round(ref_s))
    dense = create_engine(lucene_index, session=CPU, dense_budget_bytes=1 << 40,
                          score_dtype="bfloat16")
    assert isinstance(dense, DenseEngine)
    dd, ds = dense.search(q, top_k=20)
    assert ds.dtype == np.float32
    np.testing.assert_array_equal(
        ds, create_engine(lucene_index, mode="dense",
                          session=CPU).search(q, top_k=20)[1])
    assert not np.array_equal(ds, bf16_round(ds))  # f32, not rounded
    with pytest.raises(TypeError):
        create_engine(lucene_index, mode="dense", session=CPU,
                      score_dtype="bfloat16")
