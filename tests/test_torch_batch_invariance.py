"""A query's results do not depend on the queries searched with it.

JAX's ``SparseEngine`` gives a query bit-equal ids and scores whether it
is searched alone or inside a batch, with a hot tier, unweighted and
weighted; the port's does too on the CPU (its plain twins sum over all H
in a fixed order), routed or not, and matches JAX's under the fuzz
campaign's comparator.  tests/test_torch_cuda.py holds the card's kernels
to the same property.
"""

import numpy as np
import pytest

from conftest import make_zipf_corpus

import bm25_tpu.models.sparse as jax_sparse
from bm25_tpu.scoring import build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import Session
from bm25_tpu_torch.models.sparse import SparseEngine
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = Session("cpu")
LAYOUT = dict(hot_tokens=64, hot_budget_bytes=1 << 22, max_buckets=2)
ALONE = (0, 1, 2, 17, 31, 32, 50, 63)  # rows searched on their own


@pytest.fixture(scope="module")
def engines():
    corpus = make_zipf_corpus(1500, vocab=400, avg_len=25, seed=5)
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))
    port = SparseEngine.from_scored_index(idx, session=CPU, **LAYOUT)
    jax_engine = jax_sparse.SparseEngine.from_scored_index(idx, **LAYOUT)
    assert port.hot_h == jax_engine.hot_h == 64
    rng = np.random.default_rng(9)
    # Zipf-ish ids: the hot tier's frequent tokens, duplicates, pads
    q = np.minimum(rng.zipf(1.3, (64, 8)) - 1, idx.vocab_size - 1)
    q = q.astype(np.int32)
    q[rng.random(q.shape) < 0.1] = -1
    q[0] = -1
    q[1, :3] = q[1, 0]
    w = rng.uniform(0.1, 3.0, q.shape).astype(np.float32)
    w[2, :2] = [-1.5, 0.0]
    return port, jax_engine, q, w


def alone_equals_batch(engine, q, kw, k):
    """Each row of ``ALONE`` searched by itself: bit-equal ids and
    scores to its row of the batch.  Returns the batch."""
    batch = engine.search(q, top_k=k, **kw)
    for i in ALONE:
        one = engine.search(q[i : i + 1], top_k=k,
                            **{n: v[i : i + 1] for n, v in kw.items()})
        np.testing.assert_array_equal(one[0][0], batch[0][i])
        np.testing.assert_array_equal(one[1][0], batch[1][i])
    return batch


@pytest.mark.parametrize("weighted", [False, True])
def test_alone_and_in_batch_bit_equal_in_jax_and_the_port(engines, weighted):
    port, jax_engine, q, w = engines
    kw = {"weights": w} if weighted else {}
    for k in (10, 100):
        want = alone_equals_batch(jax_engine, q, kw, k)
        got = alone_equals_batch(port, q, kw, k)
        assert_matches_oracle(*got, *want)
        # routed ("auto" engages at 64 queries with a hot tier) and not
        assert port.plan_chunks(q, k=k)[0] is not None
        port.route_cold = False
        try:
            unrouted = port.search(q, top_k=k, **kw)
        finally:
            port.route_cold = "auto"
        np.testing.assert_array_equal(unrouted[0], got[0])
        np.testing.assert_array_equal(unrouted[1], got[1])
