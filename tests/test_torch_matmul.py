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
    # by balance: 128 x 128 leaves 1028^3's busiest SM twice an even share
    # (81 tiles, 132 SMs), 64 x 128 within BALANCE of it
    assert pm.pick_tile(1028, 1028, f32) == pm.Tile(64, 128, 32)
    assert pm.pick_tile(4096, 4096, f32) == pm.Tile(128, 128, 64)
    assert pm.pick_tile(1028, 1028, f32, sms=64) == pm.Tile(128, 128, 64)
    # neither balances: the least work on the busiest SM
    assert pm.pick_tile(100, 100, f32) == pm.Tile(64, 128, 32)
    # the K step is the dtype's: 64 f32 or 32 bf16 values at 128 x 128
    assert pm.pick_tile(1028, 1028, bf) == pm.Tile(64, 128, 32)
    assert pm.pick_tile(4096, 4096, bf) == pm.Tile(128, 128, 32)
    # overrides choose among the dtype's instantiated tiles
    assert pm.pick_tile(1028, 1028, f32, tile_k=32) == pm.Tile(64, 128, 32)
    assert pm.pick_tile(1028, 1028, f32, tile_m=128) == pm.Tile(128, 128, 64)
    assert pm.pick_tile(9, 9, bf, tile_m=128, tile_k=32) == \
        pm.Tile(128, 128, 32)
    for dtype, bad in ((f32, {"tile_m": 256}), (f32, {"tile_n": 64}),
                       (f32, {"tile_k": 16}), (bf, {"tile_k": 64}),
                       (f32, {"tile_m": 64, "tile_k": 64}),
                       (f32, {"tile_m": 64, "tile_n": 256})):
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


# ragged and square (m, n): thin edges on one side, both, or none, and C
# smaller than one tile
PLAN_SHAPES = [(1028, 1028), (4096, 4096), (67, 200), (1, 1), (64, 128),
               (129, 300), (700, 131), (2048, 1030)]


@pytest.mark.parametrize("m,n", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", pm.DTYPES)
def test_b6_walk_writes_every_c_element_once(m, n, dtype):
    # what the kernel walks: block b takes tiles b, b + grid, ... of
    # tile_order; every C element lies in exactly one tile of one block
    for tile in pm.TILES[dtype]:
        for sms in (pm.H100_SMS, 7):
            grid = pm.grid_size(m, n, tile, sms)
            order = pm.tile_order(m, n, tile)
            assert grid == min(len(order), sms * pm.blocks_per_sm(tile))
            assert len(set(order)) == len(order) == (
                -(-m // tile.m)) * (-(-n // tile.n))
            hits = np.zeros((m, n), np.int64)
            for b in range(grid):
                for tm, tn in order[b::grid]:
                    hits[tm * tile.m:(tm + 1) * tile.m,
                         tn * tile.n:(tn + 1) * tile.n] += 1
            assert (hits == 1).all(), (tile, sms)
            assert sum(pm.sm_fmas(m, n, 3, tile, sms)) == m * n * 3
    plan = pm.b6_plan(m, n, dtype)
    assert plan.tile in pm.TILES[dtype]
    assert plan.grid == pm.grid_size(m, n, plan.tile, pm.H100_SMS)


@pytest.mark.parametrize("s", [1028, 2048, 4096])
@pytest.mark.parametrize("dtype", pm.DTYPES)
def test_b6_busiest_sm_within_balance(s, dtype):
    # the design rule: on an H100's 132 SMs the busiest SM's FMAs stay
    # within 1.15 x an even share of s^3
    plan = pm.b6_plan(s, s, dtype)
    busiest = max(pm.sm_fmas(s, s, s, plan.tile, pm.H100_SMS))
    assert busiest <= pm.BALANCE * s**3 / pm.H100_SMS, (plan, busiest)
    assert pm.BALANCE == 1.15
    # the full tiles come first, so at 1028^3 each SM takes one full 64 x
    # 128 tile, and at most one thin edge tile beside it
    if s == 1028:
        assert plan.tile.m == 64 and plan.grid == 153
        assert busiest == (64 * 128 + 4 * 128) * s


@pytest.mark.parametrize("dtype", pm.DTYPES)
def test_b6_ring_fits_shared_memory(dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    for tile in pm.TILES[dtype]:
        # A's rows padded by 16 bytes (so a warp's four rows lie on four
        # banks), then B's box
        stage = (tile.m * (tile.k + 16 // esize) + tile.k * tile.n) * esize
        assert stage % pm.RING_ALIGN == 0  # every stage starts TMA-aligned
        assert tile.m * (tile.k + 16 // esize) * esize % pm.RING_ALIGN == 0
        for stages in range(2, pm.RING_MAX_STAGES + 1):
            got = pm.ring_smem_bytes(tile, stages, esize, padded=True)
            assert got == (pm.RING_ALIGN + stages * stage
                           + 2 * pm.RING_MAX_STAGES * 8)
        # the plan's ring fits blocks_per_sm times in an SM's 228 KB, 1 KB
        # kept for each block
        plan = pm.b6_plan(4096, 4096, dtype, tile.m, tile.n, tile.k)
        got = pm.ring_smem_bytes(tile, plan.stages, esize, padded=True)
        assert got <= pm.H100_SMEM_OPTIN
        assert pm.blocks_per_sm(tile) * (got + 1024) <= \
            pm.H100_SMEM_OPTIN + 1024
        deeper = pm.ring_smem_bytes(tile, plan.stages + 1, esize, True)
        assert (plan.stages == pm.RING_MAX_STAGES or pm.blocks_per_sm(tile)
                * (deeper + 1024) > pm.H100_SMEM_OPTIN + 1024)
        # a smaller card's limit takes a shallower ring, and one that holds
        # not even two stages raises
        two = pm.ring_smem_bytes(tile, 2, esize, padded=True)
        assert pm.ring_stages(tile, esize, two, padded=True) == 2
        with pytest.raises(ValueError, match="two stages"):
            pm.ring_stages(tile, esize, two - 1, padded=True)
    # 64 x 128: two blocks an SM, four stages each; f32 128 x 128 x 64:
    # three stages of 67.6 KB
    assert pm.b6_plan(1028, 1028, dtype).stages == pm.RING_MAX_STAGES
    if dtype == torch.float32:
        assert pm.b6_plan(4096, 4096, dtype).stages == 3


def test_bulk_operand_pads_rows_to_16_bytes():
    bf = torch.bfloat16
    # bf16 rows of whole 16-byte units (8 values), aligned: read as they lie
    x = torch.arange(48, dtype=bf).view(3, 16)
    assert pm._bulk_operand(x) is x
    assert pm._bulk_operand(x.float()[:, :12].contiguous()).shape == (3, 12)
    # bf16 K = 1028 (2,056-byte rows), K = 12 (f32 would read it as it
    # lies), a view 2 bytes off alignment: padded to 8 values
    for y in (torch.ones(3, 1028, dtype=bf), torch.ones(3, 12, dtype=bf),
              torch.arange(49, dtype=bf)[1:].view(3, 16)):
        got = pm._bulk_operand(y)
        assert got is not y and got.dtype == bf
        assert got.shape == (3, -(-y.shape[1] // 8) * 8)
        assert got.data_ptr() % 16 == 0 and got.stride(0) * 2 % 16 == 0
        assert torch.equal(got[:, :y.shape[1]], y)
    f = torch.ones(3, 12)
    assert pm._bulk_operand(f) is f


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


def test_b6_times_needs_a_card(capsys):
    # the timing script measures only on a CUDA device; elsewhere it exits
    # 2 and prints no result
    from bm25_tpu_torch.bench import b6_times

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert b6_times.main([]) == 2
    assert capsys.readouterr().out == ""


def test_optimized_checks_the_given_c():
    # the kernel writes into a given C only if it is the product's
    # contiguous (M, N) tensor of A's dtype on A's device
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    plan = pm.b6_plan(3, 5, torch.float32)
    for bad in (torch.zeros(5, 3), torch.zeros(3, 5, dtype=torch.bfloat16),
                torch.zeros(5, 3).T, torch.zeros(3, 5, device="meta")):
        with pytest.raises(ValueError, match="out must be"):
            pm._optimized(a, b, plan, out=bad)
