"""Port counts (utils/counts.py and the step's hot counts) against JAX."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bm25_tpu.utils import counts as jax_counts
from bm25_tpu_torch.models.sparse import hot_counts_for
from bm25_tpu_torch.utils import counts as port


def bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_split_bf16_bit_equal_with_nonzero_residual():
    rng = np.random.default_rng(0)
    cf = (rng.standard_normal((17, 300)) * 10).astype(np.float32)
    cf[0, :4] = [0.0, 1.0, 3.0, 1e-3]
    hi_j, lo_j = jax.jit(jax_counts.split_bf16)(jnp.asarray(cf))
    hi_t, lo_t = port.split_bf16(torch.from_numpy(cf))
    np.testing.assert_array_equal(bits(hi_t), np.asarray(hi_j).view(np.uint16))
    np.testing.assert_array_equal(bits(lo_t), np.asarray(lo_j).view(np.uint16))
    # the residual carries what bf16 drops: nonzero, and hi + lo is closer
    # to cf than hi alone
    assert (lo_t != 0).float().mean() > 0.9
    err_hi = (hi_t.float() - torch.from_numpy(cf)).abs().max()
    err_pair = (hi_t.float() + lo_t.float() - torch.from_numpy(cf)).abs().max()
    assert err_pair < err_hi / 100


def test_weighted_counts_match_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 12, (9, 6)).astype(np.int32)
    ids[0] = -1
    ids[1, :4] = 3
    w = rng.uniform(0.0, 3.0, ids.shape).astype(np.float32)
    got = port.weighted_counts(torch.from_numpy(ids), torch.from_numpy(w), 12)
    want = jax_counts.weighted_counts(jnp.asarray(ids), jnp.asarray(w), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hot_counts_equal_one_hot_sum():
    """The step's hot counts: token -> hot rank through the table, then
    per-query multiplicities, exactly the JAX step's bf16 one-hot sum."""
    rng = np.random.default_rng(2)
    vocab, h = 40, 10
    table = np.full(vocab + 1, -1, np.int32)
    table[rng.choice(vocab, h, replace=False)] = np.arange(h)
    ids = rng.integers(-1, vocab, (13, 8)).astype(np.int32)
    ids[0] = -1
    ids[2] = np.flatnonzero(table >= 0)[0]  # one hot token 8 times
    got, lo = hot_counts_for(torch.from_numpy(ids), torch.from_numpy(table),
                             h)
    assert got.dtype == torch.bfloat16 and lo is None
    valid = ids >= 0
    hot_ids = np.where(valid, table[np.where(valid, ids, 0)], -1)
    want = jax.nn.one_hot(jnp.asarray(hot_ids), h, dtype=jnp.bfloat16).sum(1)
    np.testing.assert_array_equal(bits(got), np.asarray(want).view(np.uint16))
    oracle = np.zeros((13, h), np.float32)
    for q, row in enumerate(hot_ids):
        for r in row[row >= 0]:
            oracle[q, r] += 1
    np.testing.assert_array_equal(got.float().numpy(), oracle)
    assert got.float()[2].max() == 8


def test_weighted_and_wide_hot_counts_are_jax_split_pairs():
    """Weighted queries, and unweighted ones wider than 256 ids, take the
    exact scatter-add counts split into a bf16 high + residual pair, as the
    JAX step does (a count of 257 would round in bf16)."""
    rng = np.random.default_rng(3)
    vocab, h = 40, 10
    table = np.full(vocab + 1, -1, np.int32)
    table[rng.choice(vocab, h, replace=False)] = np.arange(h)
    hot0 = int(np.flatnonzero(table >= 0)[0])
    for t, weighted in ((8, True), (300, False), (300, True)):
        ids = rng.integers(-1, vocab, (5, t)).astype(np.int32)
        ids[1] = hot0  # one hot token t times: a count of 300 when wide
        w = rng.uniform(0.1, 3.0, ids.shape).astype(np.float32)
        valid = ids >= 0
        hot_ids = np.where(valid, table[np.where(valid, ids, 0)], -1)
        wj = np.where(valid, w, 0.0) if weighted else valid.astype(np.float32)
        hi_j, lo_j = jax_counts.split_bf16(jax_counts.weighted_counts(
            jnp.asarray(hot_ids), jnp.asarray(wj), h))
        hi, lo = hot_counts_for(torch.from_numpy(ids), torch.from_numpy(table),
                                h, torch.from_numpy(w) if weighted else None)
        np.testing.assert_array_equal(bits(hi), np.asarray(hi_j).view(np.uint16))
        np.testing.assert_array_equal(bits(lo), np.asarray(lo_j).view(np.uint16))
        if not weighted:
            assert hi.float()[1].max() + lo.float()[1].max() == t
