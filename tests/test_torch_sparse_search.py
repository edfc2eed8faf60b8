"""The port SparseEngine's search surface on the CPU: doc masks, query
dedup, ids-only search and pipelined search, against the JAX
``SparseEngine`` (its Pallas kernel in interpret mode, as
tests/test_sparse_engine.py runs it) and ``ReferenceEngine``, under the
fuzz campaign's comparator (``utils/parity.py``); masked shortfall slots
must be doc -1 / score 0 exactly.  Also the B1 byte count against a count
by hand, and ``Retriever.retrieve(doc_mask=...)`` on a sparse index.
"""

import numpy as np
import pytest
import torch

from conftest import make_zipf_corpus

import bm25_tpu.models.sparse as jax_sparse
from bm25_tpu.scoring import BM25Params, build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import ReferenceEngine, Retriever, Session
from bm25_tpu_torch import Tokenizer as PortTokenizer
from bm25_tpu_torch.models import sparse as port_sparse
from bm25_tpu_torch.models.sparse import SparseEngine
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = Session("cpu")
NUM_DOCS = 1100


def build(seed, method="lucene", num_docs=NUM_DOCS, vocab=300):
    corpus = make_zipf_corpus(num_docs, vocab=vocab, avg_len=25, seed=seed)
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    return build_scored_index(out.ids, vocab_size=len(out.vocab),
                              params=BM25Params(method=method))


@pytest.fixture(scope="module")
def index():
    return build(0)


@pytest.fixture(scope="module")
def oracle(index):
    return ReferenceEngine.from_scored_index(index)


def engines(index, hot_tokens):
    kw = dict(hot_tokens=hot_tokens, hot_budget_bytes=1 << 22, max_buckets=2)
    return (SparseEngine.from_scored_index(index, session=CPU, **kw),
            jax_sparse.SparseEngine.from_scored_index(index, **kw))


def queries_for(seed, q, t, vocab, dup=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, vocab, size=(q, t), dtype=np.int32)
    ids[0] = -1  # a fully padded row
    if dup:
        # each row repeats a handful of distinct tokens: dedup shrinks it
        pool = rng.integers(0, vocab, size=(q, 6), dtype=np.int32)
        ids = np.take_along_axis(pool, rng.integers(0, 6, (q, t)), axis=1)
        ids[:, -3:] = -1
    return ids


def masks(num_docs, k):
    rng = np.random.default_rng(11)
    few = np.zeros(num_docs, bool)
    few[rng.choice(num_docs, k // 2, replace=False)] = True
    return {
        "random": rng.random(num_docs) < 0.4,
        "fewer_than_k": few,
        "all_false": np.zeros(num_docs, bool),
    }


def assert_same(got, want):
    """The campaign comparator, and shortfall sentinels equal exactly."""
    gd, gs = got
    wd, ws = want
    assert gd.dtype == np.int32 and gs.dtype == np.float32
    assert_matches_oracle(gd, gs, wd, ws)
    short = wd < 0
    np.testing.assert_array_equal(gd[short], -1)
    np.testing.assert_array_equal(gs[short], 0.0)


@pytest.mark.parametrize("hot_tokens", [0, 24])
@pytest.mark.parametrize("which", ["random", "fewer_than_k", "all_false"])
def test_masked_search_matches_jax_and_oracle(index, oracle, hot_tokens,
                                              which):
    k = 40
    mask = masks(index.num_docs, k)[which]
    port, jax_engine = engines(index, hot_tokens)
    q = queries_for(1, 13, 5, index.vocab_size)
    want = oracle.search(q, top_k=k, doc_mask=mask)
    got = port.search(q, top_k=k, doc_mask=mask)
    assert_same(got, want)
    assert_same(got, jax_engine.search(q, top_k=k, doc_mask=mask))
    if which != "random":
        assert (got[0] < 0).any()  # the shortfall slots are there
    # the same mask as a tensor on the session's device
    assert_same(port.search(q, top_k=k, doc_mask=torch.from_numpy(mask)),
                want)
    np.testing.assert_array_equal(
        port.search_ids(q, top_k=k, doc_mask=mask), got[0])
    np.testing.assert_array_equal(
        port.search_pipelined(q, top_k=k, batch=4, doc_mask=mask,
                              ids_only=True), got[0])
    pd, ps = port.search_pipelined(q, top_k=k, batch=4, doc_mask=mask)
    np.testing.assert_array_equal(pd, got[0])
    np.testing.assert_array_equal(ps, got[1])


@pytest.mark.parametrize("hot_tokens", [0, 24])
def test_weighted_masked_search_matches_jax_and_oracle(index, oracle,
                                                       hot_tokens):
    k = 30
    mask = masks(index.num_docs, k)["random"]
    port, jax_engine = engines(index, hot_tokens)
    q = queries_for(2, 9, 6, index.vocab_size)
    w = np.random.default_rng(3).uniform(0.1, 3.0, q.shape).astype(
        np.float32)
    w[2, :2] = [-1.5, 0.0]
    want = oracle.search(q, top_k=k, weights=w, doc_mask=mask)
    got = port.search(q, top_k=k, weights=w, doc_mask=mask)
    assert_same(got, want)
    assert_same(got, jax_engine.search(q, top_k=k, weights=w, doc_mask=mask))
    pd, ps = port.search_pipelined(q, top_k=k, batch=4, weights=w,
                                   doc_mask=mask)
    np.testing.assert_array_equal(pd, got[0])
    np.testing.assert_array_equal(ps, got[1])


@pytest.mark.parametrize("width", [24, 64])
@pytest.mark.parametrize("mode", [True, False, "auto"])
def test_maybe_dedup_bit_equal_to_jax(width, mode):
    q = queries_for(4, 17, width, 300, dup=True)
    for got, want in zip(port_sparse.dedup_query_rows(q),
                         jax_sparse.dedup_query_rows(q)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    gq, gw = port_sparse.maybe_dedup(q, None, mode, 16)
    wq, ww = jax_sparse.maybe_dedup(q, None, mode, 16)
    np.testing.assert_array_equal(gq, wq)
    assert (gw is None) == (ww is None)
    if gw is not None:
        np.testing.assert_array_equal(gw, ww)
    # dedup engages here unless it is off; given weights, never
    assert (gw is not None) == (mode is not False)
    w = np.ones(q.shape, np.float32)
    assert port_sparse.maybe_dedup(q, w, mode, 16)[1] is w


@pytest.mark.parametrize("hot_tokens", [0, 24])
@pytest.mark.parametrize("width", [24, 64])
@pytest.mark.parametrize("mode", [True, False, "auto"])
def test_dedup_search_matches_jax_and_oracle(index, oracle, hot_tokens,
                                             width, mode):
    k = 25
    port, jax_engine = engines(index, hot_tokens)
    port.dedup_queries = jax_engine.dedup_queries = mode
    q = queries_for(5, 11, width, index.vocab_size, dup=True)
    got = port.search(q, top_k=k)
    assert_same(got, oracle.search(q, top_k=k))
    assert_same(got, jax_engine.search(q, top_k=k))
    np.testing.assert_array_equal(port.search_ids(q, top_k=k), got[0])


@pytest.mark.parametrize("hot_tokens", [0, 24])
def test_pipelined_and_ids_only_match_search(index, oracle, hot_tokens):
    """A batch that does not divide evenly; ids only through the pipeline;
    JAX's pipelined search gives the same."""
    port, jax_engine = engines(index, hot_tokens)
    q = queries_for(6, 23, 5, index.vocab_size)
    k = 17
    d, s = port.search(q, top_k=k)
    assert_same((d, s), oracle.search(q, top_k=k))
    for batch in (5, 8, 64):
        pd, ps = port.search_pipelined(q, top_k=k, batch=batch)
        np.testing.assert_array_equal(pd, d)
        np.testing.assert_array_equal(ps, s)
        ids = port.search_pipelined(q, top_k=k, batch=batch, ids_only=True)
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, d)
    assert_same((d, s), jax_engine.search_pipelined(q, top_k=k, batch=8))
    np.testing.assert_array_equal(
        jax_engine.search_pipelined(q, top_k=k, batch=8, ids_only=True),
        port.search_pipelined(q, top_k=k, batch=8, ids_only=True))
    # bf16-rounded scores through the pipeline, the same ids
    port.score_dtype = "bfloat16"
    bd, bs = port.search_pipelined(q, top_k=k, batch=8)
    np.testing.assert_array_equal(bd, d)
    np.testing.assert_array_equal(
        bs, torch.from_numpy(s).bfloat16().float().numpy())
    # empty batches and an empty engine keep their shapes
    assert port.search_pipelined(q[:0], top_k=k)[0].shape == (0, k)
    assert port.search_pipelined(q[:0], top_k=k, ids_only=True).shape == \
        (0, k)
    assert port.search_ids(q[:0], top_k=k).shape == (0, k)


def test_vocab_field_and_chunked_mask(index):
    port, _ = engines(index, 8)
    assert port.vocab is index.vocab
    q = queries_for(7, 37, 6, index.vocab_size)
    mask = masks(index.num_docs, 20)["random"]
    whole = port.search(q, top_k=12, doc_mask=mask)
    rows = max(b["doc_ids"].shape[0] for b in port.buckets)
    port.score_buffer_budget = 4 * rows * 8  # five chunks of 8 queries
    assert len(port.plan_chunks(q)) == 5
    chunked = port.search(q, top_k=12, doc_mask=mask)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])
    with pytest.raises(ValueError, match="doc_mask shape"):
        port.search(q, doc_mask=mask[:-1])


def test_b1_bytes_by_hand(index):
    """The bytes B1 moves, on a two-bucket toy engine, against a count
    written out by hand."""
    eng = SparseEngine.from_scored_index(index, session=CPU, hot_tokens=3,
                                         hot_budget_bytes=1 << 20,
                                         max_buckets=2)
    assert len(eng.buckets) == 2 and eng.hot_h == 3
    hot_of = eng.hot_table.numpy()
    ids = np.array([[0, 1, -1, 5, 5, -1, -1, -1],
                    [7, -1, -1, -1, -1, -1, -1, -1]], np.int32)
    got = port_sparse.b1_bytes(eng, torch.from_numpy(ids))
    valid = ids[ids >= 0]
    cold = {int(t) for t in valid if hot_of[t] < 0}
    used = len({int(t) for t in valid if hot_of[t] >= 0})
    kp = 64  # the plan's counts: H rounded up to the hot kernel's K step
    for b, g in zip(eng.buckets, got):
        tok = b["tokT"].numpy()
        rows = tok.shape[1]
        matched = sum(int(t) in cold for t in tok.ravel().tolist())
        assert g.matched == matched
        # ids 2 x 8 int32, the slots' tokens, a value a matched slot, the
        # (2, rows) f32 base written once
        assert g.scan == 2 * 8 * 4 + tok.size * 4 + 4 * matched + 2 * rows * 4
        # the used hot rows hi + lo in bf16, the (2, rows / 8) maxima,
        # the (2, kp) bf16 counts, doc_ids
        assert g.epilogue == (2 * used * rows * 2 + 2 * (rows // 8) * 4
                              + 2 * kp * 2 + rows * 4)


def test_retriever_doc_mask_on_sparse_index():
    corpus = make_zipf_corpus(120, vocab=60, avg_len=12, seed=9)
    r = Retriever.fit(corpus, tokenizer=PortTokenizer(stemmer=None),
                      engine_mode="sparse", session=CPU)
    assert isinstance(r.engine, SparseEngine)
    mask = np.zeros(r.index.num_docs, bool)
    mask[::7] = True
    queries = [corpus[3].split()[0], {corpus[10].split()[1]: 2.0}]
    docs, scores, texts = r.retrieve(queries, k=25, doc_mask=mask,
                                     return_text=True)
    assert ((docs < 0) | mask[np.maximum(docs, 0)]).all()
    assert (docs < 0).any()  # 18 eligible docs < k
    assert all(t == "" for row, trow in zip(docs, texts)
               for d, t in zip(row, trow) if d < 0)
    np.testing.assert_array_equal(scores[docs < 0], 0.0)
