"""The generator: deterministic under one seed, different under two, the
same sizes for every seed."""

import numpy as np

from benchmark import gen
from conftest import SEED, tiny_cell


def _inputs(seed):
    cfg = tiny_cell("msmarco-k1000-b512")["config"]
    return (cfg, *gen.make_inputs(cfg, seed, "cpu"))


def test_one_seed_gives_the_same_inputs():
    _, l1, f1, q1 = _inputs(SEED)
    _, l2, f2, q2 = _inputs(SEED)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(q1, q2)


def test_two_seeds_give_another_order_and_the_same_sizes():
    cfg, l1, f1, q1 = _inputs(SEED)
    _, l2, f2, q2 = _inputs(SEED + 1)
    assert not np.array_equal(l1, l2) or not np.array_equal(f1, f2)
    assert not np.array_equal(q1, q2)
    # the same multiset of sizes, in the seed's order
    np.testing.assert_array_equal(np.sort(l1), np.sort(l2))
    np.testing.assert_array_equal(np.sort(gen.query_lengths(q1)),
                                  np.sort(gen.query_lengths(q2)))
    assert q1.shape == q2.shape


def test_shapes_and_ranges():
    cfg, lengths, flat, queries = _inputs(SEED)
    assert lengths.dtype == np.int32 and len(lengths) == cfg["num_docs"]
    assert lengths.min() >= cfg["doc_len_min"]
    assert flat.dtype == np.int32 and len(flat) == lengths.sum()
    assert 0 <= flat.min() and flat.max() < cfg["vocab_size"]
    n = gen.query_lengths(queries)
    assert queries.shape[0] == cfg["num_queries"]
    assert n.min() >= 1 and n.max() <= cfg["query_len_max"]
    # pads only after each query's tokens
    for row, m in zip(queries, n):
        assert (row[:m] >= 0).all() and (row[m:] == -1).all()
    # Zipf(1): the most frequent token takes about 1 / H(V) of the draws
    v = cfg["vocab_size"]
    share = np.bincount(flat).max() / len(flat)
    assert 0.7 < share * np.sum(1.0 / np.arange(1, v + 1)) < 1.3
    # ids by first occurrence in the configuration's own order of the
    # documents, which the seed's permutation hides: put them back
    order = gen._permutation(len(lengths), SEED, "cpu").numpy()
    starts = np.concatenate([[0], np.cumsum(lengths)])
    docs = [None] * len(lengths)
    for j, d in enumerate(order):
        docs[d] = flat[starts[j]:starts[j + 1]]
    base = np.concatenate(docs)
    first = np.full(v, len(base))
    np.minimum.at(first, base, np.arange(len(base)))
    seen = first[first < len(base)]
    assert (np.diff(seen) > 0).all() and len(seen) == base.max() + 1


def test_every_seed_serves_the_same_work():
    """Documents, token ids and queries are the configuration's; the seed
    only orders the documents and the queries: each doc's tokens, each
    token's document frequency and the queries are the same for every
    seed."""
    def docs(lengths, flat):
        starts = np.concatenate([[0], np.cumsum(lengths)])
        return sorted(tuple(sorted(flat[a:b].tolist()))
                      for a, b in zip(starts[:-1], starts[1:]))

    cfg, l1, f1, q1 = _inputs(SEED)
    _, l2, f2, q2 = _inputs(SEED + 7)
    assert not np.array_equal(f1, f2)
    assert docs(l1, f1) == docs(l2, f2)
    v = cfg["vocab_size"]
    np.testing.assert_array_equal(np.bincount(f1, minlength=v),
                                  np.bincount(f2, minlength=v))
    assert sorted(map(tuple, q1.tolist())) == sorted(map(tuple, q2.tolist()))


def test_trim_cuts_columns_that_are_pad_everywhere():
    q = np.array([[3, -1, -1, -1], [4, 5, -1, -1]], np.int32)
    np.testing.assert_array_equal(gen.trim(q), q[:, :2])
