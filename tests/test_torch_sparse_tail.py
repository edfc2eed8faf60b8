"""The port's tail tier (models/sparse.py: ``build_token_tail``, the
engine's ``tail_*`` fields and the step's tail candidates and merge)
against the JAX engine and the host oracle, on the CPU.

The tail's host arrays and the engine's device state are bit-equal to
JAX's; searches match both under the fuzz protocol of tests/test_fuzz.py
(scores within rtol 2e-5 / atol 1e-5, ids at strict positions) and the
campaign comparator of ``utils/parity.py``, at the fuzz campaign's
``sparse_tail`` and ``sparse_3tier`` configurations and the cases of
tests/test_sparse_engine.py that build a tail.
"""

import numpy as np
import pytest
import torch

from conftest import make_zipf_corpus, strict_positions

import bm25_tpu.models.sparse as jax_sparse
from bm25_tpu.reference import ReferenceEngine
from bm25_tpu.scoring import BM25Params, build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import Session
from bm25_tpu_torch.models import sparse as port_sparse
from bm25_tpu_torch.models.sparse import SparseEngine
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = Session("cpu")


def build(seed, method, num_docs=150, vocab=300):
    """tests/test_fuzz.py's corpus."""
    corpus = make_zipf_corpus(num_docs, vocab=vocab, avg_len=25, seed=seed)
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    return build_scored_index(out.ids, vocab_size=len(out.vocab),
                              params=BM25Params(method=method))


@pytest.fixture(scope="module")
def setup():
    """tests/test_sparse_engine.py's corpus (zipf_corpus_small)."""
    corpus = make_zipf_corpus(300, vocab=500, avg_len=30, seed=7)
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))
    return idx, ReferenceEngine.from_scored_index(idx)


def engines(idx, **kw):
    """The port's engine and JAX's at the same explicit layout."""
    return (SparseEngine.from_scored_index(idx, session=CPU, **kw),
            jax_sparse.SparseEngine.from_scored_index(idx, **kw))


def assert_fuzz_protocol(dd, ds, od, os_):
    np.testing.assert_allclose(ds, os_, rtol=2e-5, atol=1e-5)
    strict = strict_positions(os_)
    np.testing.assert_array_equal(dd[strict], od[strict])


def check_all(port, jax_engine, oracle, queries, k, **kw):
    """The port against the oracle and the JAX engine, both contracts."""
    dd, ds = port.search(queries, top_k=k, **kw)
    od, os_ = oracle.search(queries, top_k=k, **kw)
    jd, js = jax_engine.search(queries, top_k=k, **kw)
    assert dd.dtype == np.int32 and ds.dtype == np.float32
    assert_fuzz_protocol(dd, ds, od, os_)
    assert_matches_oracle(dd, ds, od, os_)
    assert_fuzz_protocol(dd, ds, jd, js)
    assert_matches_oracle(dd, ds, jd, js)
    return dd, ds


# -- host layout ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["lucene", "robertson", "atire", "bm25+"])
@pytest.mark.parametrize("tail_cap,exclude,width", [
    (1, 0, 512), (8, 4, 512), (8, 0, 16), (1 << 30, 6, 64), (0, 0, 512),
])
def test_build_token_tail_bit_equal(method, tail_cap, exclude, width):
    """Arrays and the tail mask equal JAX's, negative-IDF tokens (robertson
    and atire at DF > N/2) excluded in both."""
    idx = build(1, method)
    hot = np.argsort(-idx.df(), kind="stable")[:exclude].astype(np.int32)
    got, got_mask = port_sparse.build_token_tail(idx, hot, tail_cap, width)
    want, want_mask = jax_sparse.build_token_tail(idx, hot, tail_cap, width)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert (got is None) == (want is None)
    if want is not None:
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert not got_mask[hot].any()


def test_tail_excludes_negative_value_tokens():
    """JAX's test_tail_excludes_negative_value_tokens: robertson IDF makes
    a token of DF > N/2 negative; it stays out of the tail, and the
    engine still matches the oracle."""
    rng = np.random.default_rng(11)
    ids = [rng.integers(0, 12, size=6).astype(np.int32) for _ in range(30)]
    for a in ids[:28]:
        a[0] = 0
    idx = build_scored_index(ids, vocab_size=12,
                             params=BM25Params(method="robertson"))
    tail, is_tail = port_sparse.build_token_tail(
        idx, np.zeros(0, np.int32), tail_cap=1 << 30)
    df = idx.df()
    neg = [v for v in range(12)
           if df[v] and idx.data[idx.indptr[v]:idx.indptr[v + 1]].min() < 0]
    assert neg and not is_tail[neg].any()
    port, jax_engine = engines(idx, hot_tokens=0, tail_cap=1 << 30)
    assert port.tail_docs is not None
    q = rng.integers(-1, 12, size=(8, 4), dtype=np.int32)
    dd, ds = port.search(q, top_k=6)
    od, os_ = ReferenceEngine.from_scored_index(idx).search(q, top_k=6)
    np.testing.assert_allclose(ds, os_, rtol=2e-4, atol=1e-5)
    assert_matches_oracle(dd, ds, od, os_)


# -- device state ----------------------------------------------------------------


@pytest.mark.parametrize("hot_tokens,tail_cap,max_buckets", [
    (4, 8, 2), (6, 1 << 30, 4), (0, 3, 3),
])
def test_device_bytes_equal_jax(hot_tokens, tail_cap, max_buckets):
    idx = build(0, "lucene")
    port, jax_engine = engines(idx, hot_tokens=hot_tokens,
                               tail_cap=tail_cap, max_buckets=max_buckets)
    assert port.tail_cap == jax_engine.tail_cap == tail_cap
    assert port.device_bytes() == jax_engine.device_bytes()
    tail = sum(getattr(port, key).nbytes for key in (
        "tail_docs", "tail_vals", "tail_toks", "tail_rows", "tail_gpos"))
    rest = sum(t.nbytes for b in port.buckets for t in b.values())
    assert port.device_bytes() == (tail + rest + port.offsets.nbytes
                                   + port.hot_table.nbytes)


def test_plan_chunks_counts_the_tail_transients(setup):
    """The chunk plan budgets the tail's (Q, T*C*P) gathers beside the
    base tile, as JAX's plan_chunks does."""
    idx, _ = setup
    port = SparseEngine.from_scored_index(idx, session=CPU, hot_tokens=4,
                                          tail_cap=64)
    c, p = port.tail_rows.shape[1], port.tail_docs.shape[1]
    rows = max(b["doc_ids"].shape[0] for b in port.buckets)
    per_q = 4 * rows + 8 * 8 * c * p * 4
    port.score_buffer_budget = per_q * 16
    q = np.zeros((40, 6), np.int32)
    assert [c[0] for c in port.plan_chunks(q)] == [16, 16, 8]


# -- search --------------------------------------------------------------------

TAIL_ENGINES = {
    "sparse_tail": dict(hot_tokens=6, tail_cap=1 << 30),
    "sparse_3tier": dict(hot_tokens=4, tail_cap=8),
}


@pytest.mark.parametrize("engine_name", list(TAIL_ENGINES))
@pytest.mark.parametrize("seed,method,k", [
    (0, "lucene", 7),
    (1, "robertson", 3),
    (2, "bm25+", 11),
])
def test_fuzz_tail_engines_match_jax_and_oracle(engine_name, seed, method,
                                                k):
    """tests/test_fuzz.py::test_engine_matches_oracle_fuzz's tail
    configurations, plus ids only and a larger k."""
    idx = build(seed, method)
    port, jax_engine = engines(idx, **TAIL_ENGINES[engine_name])
    oracle = ReferenceEngine.from_scored_index(idx)
    rng = np.random.default_rng(seed + 100)
    queries = rng.integers(-1, idx.vocab_size, size=(11, 5), dtype=np.int32)
    queries[0] = -1
    queries[1, :3] = queries[1, 0]
    for kk in (k, 40):
        dd, _ = check_all(port, jax_engine, oracle, queries, kk)
        np.testing.assert_array_equal(port.search_ids(queries, top_k=kk),
                                      dd)


@pytest.mark.parametrize("engine_name", list(TAIL_ENGINES))
@pytest.mark.parametrize("seed,method", [(3, "lucene"), (4, "bm25+")])
def test_weighted_fuzz_tail_engines_match_jax_and_oracle(engine_name, seed,
                                                         method):
    """tests/test_fuzz.py::test_weighted_engine_matches_oracle_fuzz's
    tail configurations."""
    idx = build(seed, method)
    port, jax_engine = engines(idx, **TAIL_ENGINES[engine_name])
    oracle = ReferenceEngine.from_scored_index(idx)
    rng = np.random.default_rng(seed + 200)
    queries = rng.integers(-1, idx.vocab_size, size=(9, 5), dtype=np.int32)
    queries[0] = -1
    weights = rng.uniform(0.0, 3.0, size=queries.shape).astype(np.float32)
    check_all(port, jax_engine, oracle, queries, 6, weights=weights)


def test_three_tier_matches_oracle(setup):
    """JAX's test_three_tier_matches_oracle: a tail_cap at the median DF
    leaves hot, ELL and tail all active."""
    idx, oracle = setup
    df = idx.df()
    cap = int(np.median(df[df > 0]))
    port, jax_engine = engines(idx, hot_tokens=4, tail_cap=cap)
    assert port.hot_h == 4 and port.tail_docs is not None
    assert any("tokT" in b for b in port.buckets)
    rng = np.random.default_rng(7)
    queries = rng.integers(-1, idx.vocab_size, size=(16, 7), dtype=np.int32)
    for k in (3, 25):
        check_all(port, jax_engine, oracle, queries, k)


def test_tail_only_no_mid_ell(setup):
    """JAX's test_tail_only_no_mid_ell: a large tail_cap leaves no ELL,
    one identity bucket in doc order."""
    idx, oracle = setup
    port, jax_engine = engines(idx, hot_tokens=8, tail_cap=1 << 30)
    assert all("tokT" not in b for b in port.buckets)
    assert len(port.buckets) == 1
    did = port.buckets[0]["doc_ids"].numpy()
    np.testing.assert_array_equal(did[: idx.num_docs],
                                  np.arange(idx.num_docs))
    np.testing.assert_array_equal(port.tail_gpos.numpy(),
                                  np.arange(idx.num_docs))
    rng = np.random.default_rng(8)
    queries = rng.integers(-1, idx.vocab_size, size=(12, 6), dtype=np.int32)
    check_all(port, jax_engine, oracle, queries, 20)


def test_tail_disabled_matches_oracle(setup):
    idx, oracle = setup
    port, jax_engine = engines(idx, hot_tokens=8, tail_cap=0)
    assert port.tail_docs is None and port._tail is None
    rng = np.random.default_rng(9)
    queries = rng.integers(-1, idx.vocab_size, size=(8, 6), dtype=np.int32)
    check_all(port, jax_engine, oracle, queries, 10)


@pytest.mark.parametrize("kwargs", [
    {"tail_cap": 4096, "hot_tokens": 0},
    {"tail_cap": 0, "hot_tokens": 0},
    {"tail_cap": 1, "hot_tokens": 1, "max_buckets": 3},
])
def test_tail_tie_contract_smallest_doc_id(kwargs):
    """JAX's test_sparse_tie_contract_smallest_doc_id: equal scores go to
    ascending doc ids through the tail merge too."""
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(
        ["identical words here"] * 37)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))
    eng = SparseEngine.from_scored_index(idx, session=CPU, **kwargs)
    dd, ds = eng.search(np.array([[0, 1]], dtype=np.int32), top_k=9)
    assert len(set(ds[0].tolist())) == 1
    np.testing.assert_array_equal(dd[0], np.arange(9))


def test_weighted_search_with_tail_tier(setup):
    """JAX's test_weighted_search_with_tail_tier, negative weights
    refused."""
    idx, oracle = setup
    port, jax_engine = engines(idx, hot_tokens=8, tail_cap=3)
    assert port.tail_docs is not None
    rng = np.random.default_rng(22)
    queries = rng.integers(-1, idx.vocab_size, size=(6, 5), dtype=np.int32)
    weights = rng.uniform(0.0, 2.0, size=queries.shape).astype(np.float32)
    dd, ds = port.search(queries, top_k=6, weights=weights)
    od, os_ = oracle.search(queries, top_k=6, weights=weights)
    np.testing.assert_allclose(ds, os_, rtol=2e-5, atol=2e-5)
    assert_matches_oracle(dd, ds, od, os_)
    jd, js = jax_engine.search(queries, top_k=6, weights=weights)
    assert_matches_oracle(dd, ds, jd, js)
    with pytest.raises(ValueError, match="negative query weights"):
        port.search(queries, top_k=3, weights=-weights)


@pytest.mark.parametrize("density", [0.4, 0.02, 0.0])
def test_doc_mask_with_hot_tier_and_tail(setup, density):
    """JAX's test_sparse_doc_mask_with_hot_tier_and_tail: ineligible docs
    never become tail candidates; a shortfall reads doc -1 / score 0."""
    idx, oracle = setup
    port, jax_engine = engines(idx, hot_tokens=8, tail_cap=2)
    rng = np.random.default_rng(7)
    queries = rng.integers(-1, idx.vocab_size, size=(12, 6), dtype=np.int32)
    mask = rng.random(idx.num_docs) < density
    for w in (None, rng.uniform(0.2, 3.0, queries.shape).astype(np.float32)):
        dd, ds = port.search(queries, top_k=10, weights=w, doc_mask=mask)
        od, os_ = oracle.search(queries, top_k=10, weights=w, doc_mask=mask)
        np.testing.assert_allclose(ds, os_, rtol=2e-5, atol=2e-5)
        assert_matches_oracle(dd, ds, od, os_)
        jd, js = jax_engine.search(queries, top_k=10, weights=w,
                                   doc_mask=mask)
        assert_matches_oracle(dd, ds, jd, js)
        real = dd >= 0
        assert mask[dd[real]].all()
        assert (ds[~real] == 0.0).all()


def test_tail_pipelined_and_bf16_scores(setup):
    """search_pipelined equals search batch by batch with a tail, and
    bf16 scores are the f32 search's rounded."""
    idx, _ = setup
    port = SparseEngine.from_scored_index(idx, session=CPU, hot_tokens=4,
                                          tail_cap=8)
    rng = np.random.default_rng(31)
    queries = rng.integers(-1, idx.vocab_size, size=(70, 6), dtype=np.int32)
    d1, s1 = port.search(queries, top_k=11)
    d2, s2 = port.search_pipelined(queries, top_k=11, batch=32)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(s1, s2)
    port.score_dtype = "bfloat16"
    d3, s3 = port.search(queries, top_k=11)
    np.testing.assert_array_equal(d3, d1)
    np.testing.assert_array_equal(
        s3, torch.from_numpy(s1).bfloat16().float().numpy())


def test_tail_candidates_sum_each_doc_once():
    """The step's tail candidates on a hand-made tail: a doc's postings
    from two query tokens (one of them twice) sum to one candidate, in
    query-token order; weights scale each token's own slots."""
    tail = {
        # token 1 owns docs 0, 2; token 2 owns docs 2, 3 (row 0); row 1 is
        # the all-pad row
        "docs": torch.tensor([[0, 2, 2, 3], [-1, -1, -1, -1]],
                             dtype=torch.int32),
        "vals": torch.tensor([[1.0, 2.0, 4.0, 8.0], [0.0] * 4]),
        "toks": torch.tensor([[1, 1, 2, 2], [-1] * 4], dtype=torch.int32),
        "rows": torch.tensor([[-1], [0], [0], [-1]], dtype=torch.int32),
        "gpos": torch.tensor([3, 2, 1, 0], dtype=torch.int32),
    }
    ids = torch.tensor([[1, 2, 1, -1]], dtype=torch.int32)
    is_cand, docs, tot, gpos = port_sparse.tail_candidates(tail, ids, None,
                                                           None)
    got = {int(d): (float(s), int(g)) for d, s, g, c in
           zip(docs[0], tot[0], gpos[0], is_cand[0]) if c}
    assert got == {0: (2.0, 3), 2: (8.0, 1), 3: (8.0, 0)}
    w = torch.tensor([[0.5, 2.0, 1.0, 7.0]])
    is_cand, docs, tot, _ = port_sparse.tail_candidates(tail, ids, w, None)
    got = {int(d): float(s) for d, s, c in zip(docs[0], tot[0], is_cand[0])
           if c}
    assert got == {0: 1.5, 2: 11.0, 3: 16.0}
