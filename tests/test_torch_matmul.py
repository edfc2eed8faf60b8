"""Port matmul (ops/matmul.py, kernel B6) against the JAX one, on the CPU.

On CPU tensors ``"naive"`` and ``"optimized"`` run the plain twin, the
kernels' bit-exact reference (f32 fused multiply-adds over k in ascending
order, one rounding to bf16 at the end); ``"xla"`` is ``torch.matmul`` in
full f32.  JAX's Pallas schedules run in interpret mode, as the JAX
package's own tests run them, at shapes that take each of them: resident
C (67, 130, 200), the no-scratch tiled path (1500, 70, 1500) and the
f32-scratch path for bf16 (64, 700, 96).

Tolerance: the two sums differ only in order, and each lies within
``K 2^-24 (|A| @ |B|)`` of the exact product, so they agree elementwise
within ``2 K 2^-24 (|A| @ |B|)``; for bf16 outputs each side rounds its
f32 sum once more, so one bf16 ulp of the result is added.  The analytic
corner case has integer sums below 2^24 and is exact.
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm25_tpu.ops.matmul import matmul as jax_matmul
from bm25_tpu_torch import custom
from bm25_tpu_torch.bench import matmul_bench

# bm25_tpu_torch.ops re-exports the function under the module's name
pm = importlib.import_module("bm25_tpu_torch.ops.matmul")

ALGOS = ("xla", "naive", "optimized")


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8-bit significand) at each |x|."""
    mag = np.maximum(np.abs(x.astype(np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_within_order_bound(got: np.ndarray, want: np.ndarray, a32, b32,
                              bf16: bool):
    k = a32.shape[1]
    bound = 2 * k * 2.0**-24 * (np.abs(a32.astype(np.float64))
                                @ np.abs(b32.astype(np.float64)))
    if bf16:
        bound = bound + bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff <= bound).all(), float((diff - bound).max())


def operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def run_both(a32, b32, dtype, port_algo, jax_algo):
    """(port result, JAX result, the f32 values of the operands as the
    two saw them), both as f32 numpy."""
    ta = torch.from_numpy(a32).to(dtype)
    tb = torch.from_numpy(b32).to(dtype)
    got = pm.matmul(ta, tb, algorithm=port_algo)
    assert got.dtype == dtype and got.shape == (a32.shape[0], b32.shape[1])
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_matmul(jnp.asarray(a32, jd), jnp.asarray(b32, jd),
                      algorithm=jax_algo)
    assert want.dtype == jd
    return (got.float().numpy(), np.asarray(want, np.float32),
            ta.float().numpy(), tb.float().numpy())


# m, k, n, dtype: each of JAX's three Pallas schedules
SCHEDULES = {
    "resident_c": (67, 130, 200, torch.float32),
    "tiled_noacc": (1500, 70, 1500, torch.float32),
    "bf16_scratch": (64, 700, 96, torch.bfloat16),
}


@pytest.mark.parametrize("jax_algo", ALGOS)
@pytest.mark.parametrize("shape", list(SCHEDULES))
def test_twin_matches_jax_within_order_bound(shape, jax_algo):
    m, k, n, dtype = SCHEDULES[shape]
    a32, b32 = operands(len(shape) + k, m, k, n)
    before = pm.plain_calls["matmul"]
    got, want, a, b = run_both(a32, b32, dtype, "optimized", jax_algo)
    assert pm.plain_calls["matmul"] == before + 1
    assert_within_order_bound(got, want, a, b, dtype == torch.bfloat16)


@pytest.mark.parametrize("algo", ("xla", "naive"))
def test_port_algorithms_match_jax(algo):
    for m, k, n, dtype in ((67, 130, 200, torch.float32),
                           (64, 700, 96, torch.bfloat16)):
        a32, b32 = operands(m + n, m, k, n)
        got, want, a, b = run_both(a32, b32, dtype, algo, algo)
        assert_within_order_bound(got, want, a, b, dtype == torch.bfloat16)


def test_kernel_algorithms_give_the_twin_bits():
    a32, b32 = operands(3, 33, 17, 45)
    for dtype in pm.DTYPES:
        ta = torch.from_numpy(a32).to(dtype)
        tb = torch.from_numpy(b32).to(dtype)
        want = pm.matmul_plain(ta, tb)
        for algo in ("naive", "optimized"):
            assert torch.equal(pm.matmul(ta, tb, algorithm=algo), want)


def test_twin_is_fma_chain_from_zero():
    """Tiny cases where the order and the single rounding show: the twin
    sums left to right in f32 with one rounding per product."""
    a = torch.tensor([[1.0, 2.0**-24, 2.0**-24]])
    b = torch.tensor([[1.0], [1.0], [1.0]])
    # 1 + 2^-24 rounds to 1 (ties to even), twice
    assert pm.matmul_plain(a, b).item() == 1.0
    # a product that needs 25 bits is not rounded before it is added
    x = 1.0 + 2.0**-12
    a = torch.tensor([[-1.0, x]])
    b = torch.tensor([[1.0 + 2.0**-11], [x]])
    assert pm.matmul_plain(a, b).item() == 2.0**-24
    # -0 products sum to +0, as __fmaf_rn from +0 gives
    z = pm.matmul_plain(torch.tensor([[-0.0]]), torch.tensor([[1.0]]))
    assert z.item() == 0.0 and not torch.signbit(z).item()


def test_analytic_corner_case_is_exact():
    n = 32
    r = np.arange(n, dtype=np.float32)
    a = r[:, None] - r[None, :]
    b = r[:, None] + r[None, :]
    exact = a.astype(np.float64) @ b.astype(np.float64)
    want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b),
                                 algorithm="optimized"))
    np.testing.assert_array_equal(want, exact)
    for algo in ALGOS:
        got = pm.matmul(torch.from_numpy(a), torch.from_numpy(b),
                        algorithm=algo)
        np.testing.assert_array_equal(got.numpy(), exact)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(0, 5, 3), (4, 5, 0), (3, 0, 4)])
def test_empty_shapes(m, k, n):
    a, b = torch.ones(m, k), torch.ones(k, n)
    for algo in ALGOS:
        got = pm.matmul(a, b, algorithm=algo)
        assert got.shape == (m, n) and not got.any()


def test_shape_algorithm_and_operand_errors():
    with pytest.raises(ValueError, match="incompatible"):
        pm.matmul(torch.zeros(2, 3), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="incompatible"):
        pm.matmul(torch.zeros(2, 3, 1), torch.zeros(3, 5))
    with pytest.raises(ValueError, match="incompatible"):
        jax_matmul(jnp.zeros((2, 3)), jnp.zeros((4, 5)))
    with pytest.raises(ValueError, match="unknown algorithm"):
        pm.matmul(torch.zeros(2, 3), torch.zeros(3, 5), algorithm="fast")
    with pytest.raises(ValueError, match="unknown algorithm"):
        jax_matmul(jnp.zeros((2, 3)), jnp.zeros((3, 5)), algorithm="fast")
    f32, bf = torch.zeros(2, 3), torch.zeros(3, 4, dtype=torch.bfloat16)
    for algo in ("naive", "optimized"):
        with pytest.raises(TypeError, match="float32 or two bfloat16"):
            pm.matmul(f32, bf, algorithm=algo)
        with pytest.raises(TypeError, match="float32 or two bfloat16"):
            pm.matmul(f32.double(), f32.double().T, algorithm=algo)
        with pytest.raises(ValueError, match="contiguous"):
            pm.matmul(torch.zeros(3, 2).T, torch.zeros(3, 4), algorithm=algo)
        with pytest.raises(ValueError, match="is on"):
            pm.matmul(f32, torch.zeros(3, 4, device="meta"), algorithm=algo)


def test_tile_rule():
    f32, bf = torch.float32, torch.bfloat16
    # by block count: the 128 x 128 tile fills the card only from 132 blocks
    assert pm.pick_tile(1028, 1028, f32) == pm.Tile(64, 64, 16)
    assert pm.pick_tile(4096, 4096, f32) == pm.Tile(128, 128, 16)
    assert pm.pick_tile(1028, 1028, f32, sms=64) == pm.Tile(128, 128, 16)
    assert pm.pick_tile(100, 100, f32) == pm.Tile(64, 64, 16)  # most blocks
    # the K step is the dtype's: 16 for f32, 8 for bf16
    assert pm.pick_tile(1028, 1028, bf) == pm.Tile(64, 64, 8)
    assert pm.pick_tile(4096, 4096, bf) == pm.Tile(128, 128, 8)
    # overrides choose among the dtype's instantiated tiles
    assert pm.pick_tile(1028, 1028, f32, tile_k=16) == pm.Tile(64, 64, 16)
    assert pm.pick_tile(1028, 1028, f32, tile_m=128) == pm.Tile(128, 128, 16)
    assert pm.pick_tile(9, 9, bf, tile_m=128, tile_k=8) == \
        pm.Tile(128, 128, 8)
    for dtype, bad in ((f32, {"tile_m": 256}), (f32, {"tile_n": 32}),
                       (f32, {"tile_k": 8}), (bf, {"tile_k": 16}),
                       (f32, {"tile_m": 64, "tile_n": 128})):
        with pytest.raises(ValueError, match=r"\(128, 128, %d\)" %
                           pm.TILES[dtype][0].k):
            pm.pick_tile(100, 100, dtype, **bad)
    for dtype in pm.DTYPES:
        a = torch.ones(5, 7, dtype=dtype)
        b = torch.ones(7, 3, dtype=dtype)
        for tile in pm.TILES[dtype]:
            assert torch.equal(pm.matmul(a, b, tile_m=tile.m, tile_n=tile.n,
                                         tile_k=tile.k), a @ b)
    with pytest.raises(ValueError, match="instantiation"):
        pm.matmul(a, b, tile_m=512)
    # naive: a fixed 32 x 32 thread block, no tile argument at all
    for kw in ({"tile_m": 32}, {"tile_n": 32}, {"tile_k": 8},
               {"tile_m": 256, "tile_n": 256}):
        with pytest.raises(ValueError, match="takes no tile"):
            pm.matmul(a, b, "naive", **kw)


def test_through_custom():
    a32, b32 = operands(5, 9, 11, 13)
    a, b = torch.from_numpy(a32), torch.from_numpy(b32)
    for algo in ALGOS:
        assert torch.equal(
            custom("matrix_multiplication", a, b, algorithm=algo),
            pm.matmul(a, b, algorithm=algo))


def test_bench_matmul_keys_at_small_size():
    logged = []
    res = matmul_bench.bench_matmul(16, 24, 8, iters=2, device="cpu",
                                    log=logged.append)
    assert [r["algorithm"] for r in res] == list(ALGOS)
    for r in res:
        assert set(r) == {"algorithm", "seconds", "gflops",
                          "melements_per_sec"}
        assert r["seconds"] > 0
        assert r["gflops"] == pytest.approx(16 * 8 * 47 / r["seconds"] / 1e9)
        assert r["melements_per_sec"] == pytest.approx(
            16 * 8 / r["seconds"] / 1e6)
    assert len(logged) == 3
    with pytest.raises(ValueError, match="iters"):
        matmul_bench.bench_matmul(4, 4, 4, iters=0, device="cpu")


def test_bench_matmul_main_prints_json(capsys):
    assert matmul_bench.main(["--m", "8", "--k", "8", "--n", "8",
                              "--iters", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["algorithm"] for r in out] == list(ALGOS)
