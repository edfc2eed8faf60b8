"""Port gather-accumulate (ops/gather_rows.py, kernel B3's plain twin)
against the JAX ``gather_add_rows``, on the CPU.

Both JAX paths are run as the JAX package's own tests run them: the
``lax`` scan and the Pallas kernel in interpret mode.  The twin must be
bit-equal to both.  Rounding rule (found by comparing the JAX output with
numpy on the CPU, and pinned in the CUDA kernel): an f32 table adds each
row with one rounding; weighted, ``acc + w * row`` rounds once (a fused
multiply-add); a bf16 table rounds every operation to bf16.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bm25_tpu.ops.gather_rows import gather_add_rows as jax_gather
from bm25_tpu_torch.ops import custom
from bm25_tpu_torch.ops import gather_rows as port

IMPLS = ["lax", "pallas"]


def make(seed, v, d, q, t, bf16=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    if bf16:
        table = table.astype(ml_dtypes.bfloat16)
    ids = rng.integers(0, v, (q, t)).astype(np.int32)
    if q > 1 and t > 2:
        ids[1, :3] = ids[1, 0]  # duplicate ids
    w = rng.uniform(-2.0, 3.0, (q, t)).astype(np.float32)
    return table, ids, w


def to_torch(table):
    if table.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(table.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(table)


def bits(x) -> np.ndarray:
    """Bit patterns, so that the comparison is exact (-0 == +0 aside)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return x.view(np.uint16)
    return x.view(np.uint32)


def assert_bit_equal(got, want):
    g, w = bits(got), bits(want)
    # +0 and -0 may differ where a Pallas block starts from w * row
    zero = (g & ~np.array(0x8000_0000 if g.dtype == np.uint32 else 0x8000,
                          g.dtype)) == 0
    np.testing.assert_array_equal(np.where(zero, 0, g), np.where(zero, 0, w))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("v,d,q,t", [(40, 1024, 9, 6), (25, 333, 5, 3),
                                     (60, 2048, 16, 8)])
def test_f32_bit_equal_to_jax(impl, weighted, v, d, q, t):
    table, ids, w = make(v + d, v, d, q, t)
    want = jax_gather(jnp.asarray(table), jnp.asarray(ids), impl,
                      weights=jnp.asarray(w) if weighted else None)
    got = port.gather_add_rows(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(w) if weighted else None)
    assert got.dtype == torch.float32 and got.shape == (q, d)
    assert_bit_equal(got, want)


def test_weighted_rounds_once():
    """The weighted f32 sum is one rounding per token, not two: the twin
    equals numpy's f64 multiply-add rounded to f32, and differs from the
    twice-rounded sum somewhere."""
    table, ids, w = make(7, 50, 4096, 16, 6)
    got = port.gather_add_rows_plain(torch.from_numpy(table),
                                     torch.from_numpy(ids),
                                     torch.from_numpy(w)).numpy()
    once = np.zeros(got.shape, np.float32)
    twice = np.zeros(got.shape, np.float32)
    for ti in range(ids.shape[1]):
        rows = table[ids[:, ti]]
        wt = w[:, ti : ti + 1]
        once = (once.astype(np.float64)
                + wt.astype(np.float64) * rows).astype(np.float32)
        twice = twice + wt * rows
    np.testing.assert_array_equal(got, once)
    assert (got != twice).any()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_table_bit_equal_to_jax(impl, weighted):
    table, ids, w = make(3, 30, 2048, 9, 8, bf16=True)
    want = jax_gather(jnp.asarray(table), jnp.asarray(ids), impl,
                      weights=jnp.asarray(w) if weighted else None)
    got = port.gather_add_rows(to_torch(table), torch.from_numpy(ids),
                               torch.from_numpy(w) if weighted else None)
    assert got.dtype == torch.bfloat16
    assert_bit_equal(got, want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("q,t", [(0, 4), (5, 0), (0, 0)])
def test_empty_grid_gives_zeros(impl, q, t):
    table, ids, w = make(1, 10, 512, q, t)
    want = np.asarray(jax_gather(jnp.asarray(table), jnp.asarray(ids), impl))
    got = port.gather_add_rows(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.shape == want.shape == (q, 512)
    assert not got.any() and not want.any()


def test_cpu_tensors_run_the_twin_and_count():
    table, ids, _ = make(2, 12, 64, 3, 2)
    launched, plain = dict(port.launches), dict(port.plain_calls)
    via_registry = custom("gather_add_rows", torch.from_numpy(table),
                          torch.from_numpy(ids))
    direct = port.gather_add_rows(torch.from_numpy(table),
                                  torch.from_numpy(ids))
    assert torch.equal(via_registry, direct)
    assert port.launches == launched
    assert port.plain_calls["gather_add_rows"] == \
        plain["gather_add_rows"] + 2


@pytest.mark.parametrize("d,want", [(0, 4), (1, 4), (4, 4), (1001, 1004),
                                    (131072, 131072)])
def test_doc_pad_is_the_vector_quantum(d, want):
    assert port.doc_pad(d) == want


def test_non_cuda_device_raises():
    table = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.gather_add_rows(table, torch.zeros((1, 1), dtype=torch.int32,
                                                device="meta"))
