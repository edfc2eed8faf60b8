"""Port gather/scatter op family (ops/gather_scatter.py) against the JAX
one, on the CPU: the same seeded numpy inputs through both, bit-equal
(NaN where JAX reads its fill value).

Indices run past both ends of the axis, so the cases pin JAX's indexing
modes: ``take``'s fill value for the gathers, ``data[idx]``'s clamp for
``gather_nd`` and ``mode="drop"`` for the scatters, each after the op's
own negative-index normalisation.  Duplicate indices run under every
reduction, ``"none"`` included (the last write wins).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm25_tpu.ops import gather_scatter as jgs
from bm25_tpu_torch import custom
from bm25_tpu_torch.ops import gather_scatter as pgs


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert str(got.numpy().dtype) == str(np.asarray(want).dtype)


def data_of(rng, shape, dtype):
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(-50, 50, shape).astype(dtype)


def wild_indices(rng, shape, size):
    """Indices across [-2 size - 1, 2 size]: in range, negative, and out of
    range on both sides (past one normalisation, and past two)."""
    return rng.integers(-2 * size - 1, 2 * size + 1, shape)


# -- gathers ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gather_matches_jax(axis, dtype):
    rng = np.random.default_rng(10 + axis)
    data = data_of(rng, (5, 6, 3), dtype)
    idx = wild_indices(rng, (4, 2), data.shape[axis])
    same(pgs.gather(torch.from_numpy(data), torch.from_numpy(idx), axis=axis),
         jgs.gather(jnp.asarray(data), jnp.asarray(idx), axis=axis))


@pytest.mark.parametrize("other", [None, 1])  # the other dim, or broadcast
@pytest.mark.parametrize("axis", [0, 1])
def test_gather_elements_matches_jax(axis, other):
    rng = np.random.default_rng(20 + axis)
    data = data_of(rng, (5, 6), np.float32)
    idx_shape = [4, 4]
    idx_shape[1 - axis] = other or data.shape[1 - axis]
    idx = wild_indices(rng, tuple(idx_shape), data.shape[axis])
    same(pgs.gather_elements(torch.from_numpy(data), torch.from_numpy(idx),
                             axis=axis),
         jgs.gather_elements(jnp.asarray(data), jnp.asarray(idx), axis=axis))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("reduce_fn", ["sum", "max", "min", "prod", "mean"])
def test_gather_reduce_named_matches_jax(reduce_fn, dtype):
    """Pads (negative ids) contribute the identity; duplicates repeat a
    row; "mean" counts only the non-pad ids."""
    rng = np.random.default_rng(30)
    data = data_of(rng, (9, 4, 3), dtype)
    if reduce_fn == "prod":
        data = (data % 3 + 1).astype(dtype) if dtype == np.int32 else \
            rng.uniform(0.5, 1.5, data.shape).astype(dtype)
    idx = rng.integers(-3, 9, (2, 3, 13))
    idx[0, 0] = -1  # a bag of pads only
    idx[0, 1, :4] = 2  # duplicates
    same(pgs.gather_reduce(torch.from_numpy(data), torch.from_numpy(idx),
                           reduce_fn),
         jgs.gather_reduce(jnp.asarray(data), jnp.asarray(idx), reduce_fn))


def test_gather_reduce_out_of_range_reads_fill():
    rng = np.random.default_rng(31)
    data = data_of(rng, (6, 5), np.float32)
    idx = np.array([[0, 7, -1], [2, 3, 5], [-1, -1, -1]])
    for fn in ("sum", "max", "mean"):
        same(pgs.gather_reduce(torch.from_numpy(data), torch.from_numpy(idx),
                               fn),
             jgs.gather_reduce(jnp.asarray(data), jnp.asarray(idx), fn))


def test_gather_reduce_callable_and_init():
    rng = np.random.default_rng(32)
    data = data_of(rng, (7, 4), np.float32)
    idx = rng.integers(-2, 7, (5, 6))
    got = pgs.gather_reduce(torch.from_numpy(data), torch.from_numpy(idx),
                            lambda x, dim: torch.amax(x, dim=dim),
                            reduce_init=-100.0)
    want = jgs.gather_reduce(jnp.asarray(data), jnp.asarray(idx), jnp.max,
                             reduce_init=-100.0)
    same(got, want)
    got = pgs.gather_reduce(torch.from_numpy(data), torch.from_numpy(idx),
                            "sum", reduce_init=10.0)
    same(got, jgs.gather_reduce(jnp.asarray(data), jnp.asarray(idx), "sum",
                                reduce_init=10.0))


@pytest.mark.parametrize("batch_dims,data_shape,idx_shape", [
    (0, (6, 5, 4), (3, 2)),
    (0, (6, 5, 4), (2, 3, 3)),
    (0, (6, 5), (7, 1)),
    (1, (3, 6, 5, 2), (3, 4, 2)),
    (1, (3, 6, 5), (3, 2, 2, 1)),
    (2, (2, 3, 6, 5), (2, 3, 4, 2)),
    (2, (2, 3, 6, 5), (2, 3, 1)),
])
def test_gather_nd_matches_jax(batch_dims, data_shape, idx_shape):
    rng = np.random.default_rng(40 + batch_dims)
    data = data_of(rng, data_shape, np.float32)
    r = idx_shape[-1]
    idx = np.stack([wild_indices(rng, idx_shape[:-1],
                                 data_shape[batch_dims + j])
                    for j in range(r)], axis=-1)
    got = pgs.gather_nd(torch.from_numpy(data), torch.from_numpy(idx),
                        batch_dims=batch_dims)
    same(got, jgs.gather_nd(jnp.asarray(data), jnp.asarray(idx),
                            batch_dims=batch_dims))
    assert tuple(got.shape) == pgs.gather_nd_shape(data_shape, idx_shape,
                                                   batch_dims)


# -- scatters -----------------------------------------------------------------

REDUCTIONS = ["none", "add", "mul", "max", "min"]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("axis", [0, 1])
def test_scatter_elements_matches_jax(axis, reduction, dtype):
    """Duplicates under every reduction; negative and out-of-range
    indices dropped as JAX drops them."""
    rng = np.random.default_rng(50 + axis)
    data = data_of(rng, (4, 6), dtype)
    idx_shape = (6, 5) if axis == 0 else (4, 9)
    idx = wild_indices(rng, idx_shape, data.shape[axis])
    idx[0] = 1  # duplicates along the axis
    upd = data_of(rng, idx_shape, dtype)
    if reduction == "mul" and dtype == np.float32:
        upd = rng.uniform(0.5, 1.5, idx_shape).astype(dtype)
    got = pgs.scatter_elements(torch.from_numpy(data), torch.from_numpy(idx),
                               torch.from_numpy(upd), axis=axis,
                               reduction=reduction)
    want = jgs.scatter_elements(jnp.asarray(data), jnp.asarray(idx),
                                jnp.asarray(upd), axis=axis,
                                reduction=reduction)
    same(got, want)


def test_scatter_elements_last_write_wins():
    data = torch.zeros(5)
    idx = torch.tensor([3, 1, 3, 3, -2, 9])
    upd = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    got = pgs.scatter_elements(data, idx, upd)
    assert got.tolist() == [0.0, 2.0, 0.0, 5.0, 0.0]
    same(got, jgs.scatter_elements(jnp.zeros(5), jnp.asarray(idx.numpy()),
                                   jnp.asarray(upd.numpy())))


@pytest.mark.parametrize("reduction", ["max", "min"])
def test_scatter_max_min_signed_zeros_and_nan_match_jax(reduction):
    """Duplicates of -0 and +0 (either order, in data or updates) and
    NaNs (in data or updates, either sign): JAX puts -0 below +0 and lets
    a NaN win, whatever the order."""
    nan = np.float32("nan")
    data = np.array([0.0, -0.0, 0.0, -0.0, 1.0, nan, 2.0, 3.0], np.float32)
    idx = np.array([0, 0, 1, 2, 3, 3, 4, 4, 6, 6, 7], np.int64)
    upd = np.array([-0.0, 0.0, 0.0, -0.0, 0.0, -0.0, nan, 5.0, 7.0, -nan,
                    -1.0], np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got = pgs.scatter_elements(torch.from_numpy(data).to(dtype),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(upd).to(dtype),
                                   reduction=reduction)
        jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        want = np.asarray(jgs.scatter_elements(
            jnp.asarray(data, jd), jnp.asarray(idx), jnp.asarray(upd, jd),
            reduction=reduction), np.float32)
        got = got.float().numpy()
        np.testing.assert_array_equal(got, want)
        zero = want == 0
        assert zero.sum() == 4
        np.testing.assert_array_equal(np.signbit(got[zero]),
                                      np.signbit(want[zero]))


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype,reduction", [
    (np.float32, "none"), (np.float32, "max"), (np.float32, "min"),
    (np.int32, "add"), (np.int32, "mul")])
def test_scatter_duplicates_cost_no_more_ops(dtype, reduction):
    """Many updates to one target (a histogram) are one scatter, not one
    step per duplicate: the op count is the same for 3 and 300 duplicates
    of one index, and the result is still JAX's."""
    rng = np.random.default_rng(90)
    counts = []
    for dups in (3, 300):
        data = data_of(rng, (5, 2), dtype)
        idx = np.full((dups, 2), 1, np.int64)
        idx[-1] = [4, 7]  # one in range elsewhere, one dropped
        upd = data_of(rng, (dups, 2), dtype)
        if reduction == "mul":
            upd = rng.integers(-3, 4, (dups, 2)).astype(dtype)
        with _CountOps() as ops:
            got = pgs.scatter_elements(torch.from_numpy(data),
                                       torch.from_numpy(idx),
                                       torch.from_numpy(upd),
                                       reduction=reduction)
        counts.append(ops.n)
        same(got, jgs.scatter_elements(jnp.asarray(data), jnp.asarray(idx),
                                       jnp.asarray(upd),
                                       reduction=reduction))
    assert counts[0] == counts[1] < 100, counts


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("data_shape,idx_shape", [
    ((8, 3), (10, 1)),
    ((6, 5, 2), (3, 4, 2)),
    ((6, 5), (7, 2)),
    ((0, 3), (4, 1)),  # empty data: nothing lands
])
def test_scatter_nd_matches_jax(data_shape, idx_shape, reduction):
    rng = np.random.default_rng(60 + len(idx_shape))
    data = data_of(rng, data_shape, np.float32)
    r = idx_shape[-1]
    idx = np.stack([wild_indices(rng, idx_shape[:-1], data_shape[j])
                    for j in range(r)], axis=-1)
    idx.reshape(-1, r)[:3] = idx.reshape(-1, r)[0]  # duplicates
    upd_shape = pgs.scatter_nd_shape(data_shape, idx_shape,
                                     idx_shape[:-1] + data_shape[r:])
    assert upd_shape == data_shape
    upd = rng.uniform(0.5, 1.5, idx_shape[:-1] + data_shape[r:]).astype(
        np.float32)
    got = pgs.scatter_nd(torch.from_numpy(data), torch.from_numpy(idx),
                         torch.from_numpy(upd), reduction=reduction)
    same(got, jgs.scatter_nd(jnp.asarray(data), jnp.asarray(idx),
                             jnp.asarray(upd), reduction=reduction))


def test_scatter_nd_update_fn():
    rng = np.random.default_rng(70)
    data = data_of(rng, (6, 3), np.float32)
    idx = np.array([[1], [4], [-1], [7], [1]])
    upd = rng.standard_normal((5, 3)).astype(np.float32)
    got = pgs.scatter_nd(torch.from_numpy(data), torch.from_numpy(idx),
                         torch.from_numpy(upd),
                         update_fn=lambda old, new: old * 2 + new)
    want = jgs.scatter_nd(jnp.asarray(data), jnp.asarray(idx),
                          jnp.asarray(upd),
                          update_fn=lambda old, new: old * 2 + new)
    same(got, want)


# -- shape inference, errors, registry --------------------------------------------


@pytest.mark.parametrize("data_shape", [(5,), (4, 6), (2, 3, 4)])
@pytest.mark.parametrize("idx_shape", [(), (3,), (2, 5)])
def test_shape_functions_match_jax(data_shape, idx_shape):
    for axis in range(-len(data_shape), len(data_shape)):
        assert pgs.gather_shape(data_shape, idx_shape, axis) == \
            jgs.gather_shape(data_shape, idx_shape, axis)
    for r in range(1, len(data_shape) + 1):
        nd_idx = idx_shape + (r,)
        assert pgs.gather_nd_shape(data_shape, nd_idx) == \
            jgs.gather_nd_shape(data_shape, nd_idx)
        upd = idx_shape + data_shape[r:]
        assert pgs.scatter_nd_shape(data_shape, nd_idx, upd) == \
            jgs.scatter_nd_shape(data_shape, nd_idx, upd)
        for bad in (upd + (2,), (7,) + upd):
            with pytest.raises(ValueError):
                jgs.scatter_nd_shape(data_shape, nd_idx, bad)
            with pytest.raises(ValueError):
                pgs.scatter_nd_shape(data_shape, nd_idx, bad)


def test_errors_match_jax():
    d = np.zeros((4, 3), np.float32)
    i = np.zeros((2, 2), np.int64)
    u = np.ones((2, 2), np.float32)
    calls = [
        lambda m, x, ix, up: m.scatter_elements(x, ix, up, reduction="avg"),
        lambda m, x, ix, up: m.scatter_nd(x, ix[:, :1], up, reduction="avg"),
        lambda m, x, ix, up: m.gather_reduce(x, ix, "median"),
        lambda m, x, ix, up: m.gather_reduce(x, ix, lambda y, **kw: y),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(jgs, jnp.asarray(d), jnp.asarray(i), jnp.asarray(u))
        with pytest.raises(ValueError) as got:
            call(pgs, torch.from_numpy(d), torch.from_numpy(i),
                 torch.from_numpy(u))
        assert str(got.value) == str(want.value)


def test_ops_through_custom():
    rng = np.random.default_rng(80)
    data = torch.from_numpy(data_of(rng, (6, 4), np.float32))
    idx = torch.tensor([[0, 5], [-1, 2]])
    assert torch.equal(custom("gather", data, idx, axis=0),
                       pgs.gather(data, idx))
    assert torch.equal(custom("gather_reduce", data, idx),
                       pgs.gather_reduce(data, idx))
    col = torch.tensor([[3], [-1], [0], [2], [1], [9]])
    same(custom("gather_elements", data, col, axis=1),
         pgs.gather_elements(data, col, axis=1))
    assert torch.equal(custom("gather_nd", data, idx),
                       pgs.gather_nd(data, idx))
    assert torch.equal(
        custom("scatter_elements", data, idx, torch.ones(2, 2)),
        pgs.scatter_elements(data, idx, torch.ones(2, 2)))
    assert torch.equal(
        custom("scatter_nd", data, idx[:, :1], torch.ones(2, 4),
               reduction="add"),
        pgs.scatter_nd(data, idx[:, :1], torch.ones(2, 4), reduction="add"))
