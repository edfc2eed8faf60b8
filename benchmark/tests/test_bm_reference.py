"""The reference against a brute-force BM25 and against the program's
CPU path."""

import math

import numpy as np
import pytest
import torch

from benchmark import check, gen
from benchmark.reference import Bm25Reference
from conftest import SEED, tiny_cell


def brute_force(doc_lengths, flat, query, k1=1.5, b=0.75):
    """BM25 (lucene) of every doc for one query, in float64 loops."""
    n = len(doc_lengths)
    starts = np.concatenate([[0], np.cumsum(doc_lengths)])
    docs = [list(flat[starts[d]:starts[d + 1]]) for d in range(n)]
    avgdl = sum(doc_lengths) / n
    out = np.zeros(n)
    for t in query:
        if t < 0:
            continue
        df = sum(1 for d in docs if t in d)
        idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
        for d in range(n):
            tf = docs[d].count(t)
            if tf:
                norm = 1 - b + b * doc_lengths[d] / avgdl
                out[d] += idf * tf / (tf + k1 * norm)
    return out


def test_reference_matches_brute_force():
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 12, 60).astype(np.int32)
    flat = rng.integers(0, 25, int(lengths.sum())).astype(np.int32)
    ref = Bm25Reference(lengths, flat, 25)
    for query in ([0, 1, 2], [5, 5, 7, -1], [24], [3, 9, 14, 20, 1, 1]):
        want = brute_force(lengths, flat, query)
        got = ref.scores(np.array(query)).numpy().astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
        docs, scores = ref.top_k(np.array(query), 10)
        np.testing.assert_allclose(np.sort(want)[::-1][:10], scores,
                                   rtol=2e-6, atol=1e-7)


def test_reference_postings_bit_equal_the_program_build():
    """Per posting, the reference's float32 score is bit for bit the
    program's index build (bm25s's roundings)."""
    from bm25_tpu_torch.scoring import build_scored_index_flat

    cfg = tiny_cell("quora-k100-b512")["config"]
    lengths, flat, _ = gen.make_inputs(cfg, SEED, "cpu")
    ref = Bm25Reference(lengths, flat, cfg["vocab_size"])
    index = build_scored_index_flat(flat, lengths,
                                    vocab_size=cfg["vocab_size"])
    np.testing.assert_array_equal(ref.indptr.numpy(), index.indptr)
    np.testing.assert_array_equal(ref.post_doc.numpy(), index.indices)
    np.testing.assert_array_equal(ref.post_score.numpy(), index.data)


@pytest.mark.parametrize("name", ["quora-k100-b512", "msmarco-k1000-b512"])
def test_reference_agrees_with_the_program_cpu_path(name, sparse_on_cpu):
    from benchmark import harness

    cell = tiny_cell(name)
    cfg, k = cell["config"], cell["traffic"]["top_k"]
    lengths, flat, queries = gen.make_inputs(cfg, SEED, "cpu")
    engine, _ = harness.build_program(lengths, flat, cfg, sparse_on_cpu)
    docs, scores = engine.search(queries, top_k=k)
    ref = Bm25Reference(lengths, flat, cfg["vocab_size"])
    numbers = check.judge(list(zip(queries, docs, scores)), ref, k)
    assert numbers["bad_rows"] == 0
    assert numbers["score_gap"] < 1e-6 and numbers["rank_gap"] < 1e-6


def test_bfloat16_reference_is_another_precision():
    lengths, flat = np.array([3, 2, 4], np.int32), np.array(
        [0, 1, 1, 2, 0, 0, 1, 2, 2], np.int32)
    ref = Bm25Reference(lengths, flat, 3)
    low = Bm25Reference(lengths, flat, 3, dtype=torch.bfloat16)
    assert low.post_score.dtype == torch.bfloat16
    np.testing.assert_allclose(low.post_score.float().numpy(),
                               ref.post_score.numpy(), rtol=1e-2)
