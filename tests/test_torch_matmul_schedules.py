"""Port matmul schedules (ops/matmul_schedules.py, kernels E1-E4) against
the TPU scripts' Pallas kernel bodies, on the CPU.

Each script is loaded by path (``scripts/`` is not a package) and its
kernel body (``_noacc_kernel``, ``_strip_kernel``, ``_dma_kernel``,
``_tiled_kernel``) runs through a ``pl.pallas_call(..., interpret=True)``
built here at a small shape, (40, 300) @ (300, 136) padded with the
scripts' ``_pad2``: the scripts' own jitted wrappers pass no
``interpret=`` and refuse the CPU.  On CPU tensors the port's wrappers run
their plain twins.

Tolerances:

* E1-E3 twins (``matmul_plain``: f32 FMAs, k ascending) against the script
  body: two f32 sums of the same products in two orders agree within
  ``2 K 2^-24 (|A| @ |B|)``; JAX's order differs, so bits are not pinned.
* ``bf16in``: the twin on the bf16-rounded inputs against JAX's ``bf16in``
  (the kernel casts to bf16 itself), the same order bound on the rounded
  inputs (bf16 x bf16 products are exact in f32).
* ``default``: on the card this is TF32, on the CPU JAX computes DEFAULT
  in full f32, so the twin is held to the float64 product of the
  TF32-rounded inputs within the order bound, and to JAX's CPU ``default``
  within ``(2 2^-11 + 2^-22 + 2 K 2^-24) (|A| @ |B|)``: each TF32 input is
  within a relative 2^-11 of its f32 value, so each product within
  ``2 2^-11 + 2^-22``, plus the two sums' order bound.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bm25_tpu_torch.bench import matmul_schedules as bench
from bm25_tpu_torch.ops import matmul_schedules as ms
from bm25_tpu_torch.ops.matmul import matmul_plain, plain_calls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, K, N = 40, 300, 136


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {n: load_script(f"exp_r4_matmul_{n}")
            for n in ("tiles3", "tiles4", "dma", "precision")}


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((M, K), dtype=np.float32),
            rng.standard_normal((K, N), dtype=np.float32))


def order_bound(a, b) -> np.ndarray:
    return 2 * a.shape[1] * 2.0**-24 * (np.abs(a.astype(np.float64))
                                        @ np.abs(b.astype(np.float64)))


def assert_within(got, want, bound):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff <= bound).all(), float((diff - bound).max())


def noacc(mod, a, b, tm=8, tn=128, tk=128):
    """E1's body over a (tm, tn, tk) grid, as mm_noacc lays it out."""
    ap, bp = mod._pad2(jnp.asarray(a), tm, tk), mod._pad2(jnp.asarray(b), tk,
                                                          tn)
    k_steps = ap.shape[1] // tk
    out = pl.pallas_call(
        functools.partial(mod._noacc_kernel, k_steps=k_steps),
        grid=(ap.shape[0] // tm, bp.shape[1] // tn, k_steps),
        in_specs=[pl.BlockSpec((tm, tk), lambda i, j, kk: (i, kk)),
                  pl.BlockSpec((tk, tn), lambda i, j, kk: (kk, j))],
        out_specs=pl.BlockSpec((tm, tn), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((ap.shape[0], bp.shape[1]),
                                       jnp.float32),
        interpret=True,
    )(ap, bp)
    return np.asarray(out)[: a.shape[0], : b.shape[1]]


def strip(mod, a, b, tm=8):
    """E2's body, one (tm, K) strip of A per grid cell and B whole."""
    ap, bp = mod._pad2(jnp.asarray(a), tm, 128), mod._pad2(jnp.asarray(b),
                                                           128, 128)
    kp, np_ = bp.shape
    out = pl.pallas_call(
        mod._strip_kernel,
        grid=(ap.shape[0] // tm,),
        in_specs=[pl.BlockSpec((tm, kp), lambda i: (i, 0)),
                  pl.BlockSpec((kp, np_), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((tm, np_), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((ap.shape[0], np_), jnp.float32),
        interpret=True,
    )(ap, bp)
    return np.asarray(out)[: a.shape[0], : b.shape[1]]


def dma(mod, a, b, tm=8):
    """E3's body: A strips copied by hand into a 2-slot buffer."""
    ap, bp = mod._pad2(jnp.asarray(a), tm, 128), mod._pad2(jnp.asarray(b),
                                                           128, 128)
    n_strips = ap.shape[0] // tm
    out = pl.pallas_call(
        functools.partial(mod._dma_kernel, tm=tm, n_strips=n_strips),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((ap.shape[0], bp.shape[1]),
                                       jnp.float32),
        interpret=True,
    )(ap, bp)
    return np.asarray(out)[: a.shape[0], : b.shape[1]]


def tiled(mod, a, b, mode, tm=8, tn=128, tk=128):
    """E4's body in one of its modes, with its f32 scratch accumulator."""
    ap, bp = mod._pad2(jnp.asarray(a), tm, tk), mod._pad2(jnp.asarray(b), tk,
                                                          tn)
    k_steps = ap.shape[1] // tk
    out = pl.pallas_call(
        functools.partial(mod._tiled_kernel, k_steps=k_steps, mode=mode),
        grid=(ap.shape[0] // tm, bp.shape[1] // tn, k_steps),
        in_specs=[pl.BlockSpec((tm, tk), lambda i, j, kk: (i, kk)),
                  pl.BlockSpec((tk, tn), lambda i, j, kk: (kk, j))],
        out_specs=pl.BlockSpec((tm, tn), lambda i, j, kk: (i, j)),
        out_shape=jax.ShapeDtypeStruct((ap.shape[0], bp.shape[1]),
                                       jnp.float32),
        scratch_shapes=[pltpu.VMEM((tm, tn), jnp.float32)],
        interpret=True,
    )(ap, bp)
    return np.asarray(out)[: a.shape[0], : b.shape[1]]


def port(fn, a, b, *args):
    before = plain_calls["matmul"]
    got = fn(torch.from_numpy(a), torch.from_numpy(b), *args)
    assert plain_calls["matmul"] == before + 1  # the twin ran
    assert got.dtype == torch.float32 and got.shape == (a.shape[0],
                                                        b.shape[1])
    return got.numpy()


@pytest.mark.parametrize("tile", [ms.SWEEP_TILES[0], ms.SWEEP_TILES[-1]])
def test_sweep_twin_matches_noacc_body(scripts, operands, tile):
    a, b = operands
    want = noacc(scripts["tiles3"], a, b)
    assert_within(port(ms.matmul_sweep, a, b, tile), want, order_bound(a, b))
    # the one-grid-cell resident layout of mm_resident: tm, tn over all C
    resident = noacc(scripts["tiles3"], a, b, tm=40, tn=256, tk=128)
    assert_within(port(ms.matmul_sweep, a, b, ms.resident_tile(M, N)),
                  resident, order_bound(a, b))


@pytest.mark.parametrize("strip_m,blocks", [(8, None), (32, 1)])
def test_row_strip_twin_matches_strip_body(scripts, operands, strip_m,
                                           blocks):
    a, b = operands
    want = strip(scripts["tiles4"], a, b)
    assert_within(port(ms.matmul_row_strip, a, b, strip_m, blocks), want,
                  order_bound(a, b))
    # mm_single_dot: one cell for the whole product
    whole = strip(scripts["tiles4"], a, b, tm=M)
    assert_within(port(ms.matmul_row_strip, a, b, strip_m, 1), whole,
                  order_bound(a, b))


@pytest.mark.parametrize("stages", ms.STAGES)
def test_pipelined_twin_matches_dma_body(scripts, operands, stages):
    a, b = operands
    want = dma(scripts["dma"], a, b)
    assert_within(port(ms.matmul_pipelined, a, b, ms.PIPELINED_TILES[1],
                       stages), want, order_bound(a, b))


def test_mma_f32_is_b6_twin(scripts, operands):
    a, b = operands
    want = tiled(scripts["precision"], a, b, "f32")
    got = port(ms.matmul_mma, a, b, "f32")
    assert_within(got, want, order_bound(a, b))
    assert np.array_equal(got, matmul_plain(torch.from_numpy(a),
                                            torch.from_numpy(b)).numpy())


def test_mma_bf16in_twin_matches_jax_bf16in(scripts, operands):
    a, b = operands
    want = tiled(scripts["precision"], a, b, "bf16in")
    ar = ms.round_bf16(torch.from_numpy(a)).numpy()
    br = ms.round_bf16(torch.from_numpy(b)).numpy()
    got = port(ms.matmul_mma, a, b, "bf16in")
    assert_within(got, want, order_bound(ar, br))
    assert_within(got, ar.astype(np.float64) @ br, order_bound(ar, br))


def test_mma_default_twin_is_tf32_and_near_jax_cpu_default(scripts,
                                                          operands):
    a, b = operands
    ar = ms.round_tf32(torch.from_numpy(a)).numpy()
    br = ms.round_tf32(torch.from_numpy(b)).numpy()
    got = port(ms.matmul_mma, a, b, "default")
    assert_within(got, ar.astype(np.float64) @ br, order_bound(ar, br))
    # JAX on the CPU computes DEFAULT in full f32 (a TPU ran one bf16 pass)
    want = tiled(scripts["precision"], a, b, "default")
    mag = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
    rel = 2 * 2.0**-11 + 2.0**-22 + 2 * K * 2.0**-24
    assert_within(got, want, rel * mag)
    assert not np.array_equal(got, want)  # TF32 is not f32


def long_k_operands(k=1028):
    rng = np.random.default_rng(2)
    return (torch.from_numpy(rng.standard_normal((8, k), dtype=np.float32)),
            torch.from_numpy(rng.standard_normal((k, 16), dtype=np.float32)))


def test_mma_check_catches_unrounded_inputs_the_bound_misses():
    # at K ~ 1000 a TF32 product of unrounded inputs stays inside
    # K 2^-22 (|A^| @ |B^|); the unrounded-share limit refuses it, and a
    # product with one operand left unrounded
    a, b = long_k_operands()
    twin = ms.matmul_mma_plain(a, b, "default")
    ar, br = ms.round_tf32(a), ms.round_tf32(b)
    bnd = a.shape[1] * 2.0**-22 * (ar.double().abs() @ br.double().abs())
    skipped = matmul_plain(a, b)
    assert bench.within(skipped, twin, bnd, "unrounded")[1] < 1
    for got in (skipped, matmul_plain(ar, b), matmul_plain(a, br)):
        with pytest.raises(RuntimeError, match="rounded to tf32"):
            bench.mma_readings(got, twin, a, b, "default", "skipped")


@pytest.mark.parametrize("mode", list(ms.ROUNDING))
def test_mma_check_passes_the_rounded_inputs_in_another_order(mode):
    a, b = long_k_operands()
    twin = ms.matmul_mma_plain(a, b, mode)
    rnd = ms.ROUNDING[mode]
    reverse = matmul_plain(rnd(a).flip(1).contiguous(),
                           rnd(b).flip(0).contiguous())  # k descending
    assert not torch.equal(reverse, twin)
    err, ratio, unrounded = bench.mma_readings(reverse, twin, a, b, mode,
                                               "k descending")
    assert 0 < ratio <= bench.UNROUNDED_SHARE * unrounded
    assert bench.mma_readings(twin, twin, a, b, mode, "twin")[:2] == (0, 0)


def test_round_tf32_is_nearest_ties_away():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(10000)
         * 10.0 ** rng.integers(-20, 20, 10000)).astype(np.float32)
    bits = x.view(np.int32)
    ties = bits.copy()
    ties[:100] = (bits[:100] & -0x2000) | 0x1000  # exactly half way
    x = ties.view(np.float32)
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    want = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2**11 + 0.5) / 2**11, e)
    got = ms.round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (got.view(np.int32) & 0x1FFF == 0).all()
    assert (np.abs(got[:100]) > np.abs(x[:100])).all()  # ties away from 0
    np.testing.assert_array_equal(
        ms.round_bf16(torch.from_numpy(x)).numpy(),
        torch.from_numpy(x).bfloat16().float().numpy())


def test_wrapper_checks():
    a, b = torch.ones(16, 4096), torch.ones(4096, 8)
    assert torch.equal(ms.matmul_row_strip(a, b, 8), a @ b)  # 8 x 4096 fits
    with pytest.raises(ValueError, match="shared memory"):
        ms.matmul_row_strip(a, b, 16)
    assert ms.row_strip_smem_bytes(4096, 16) > ms.H100_SMEM_OPTIN
    a, b = torch.ones(5, 7), torch.ones(7, 8)
    with pytest.raises(ValueError, match="strip_m"):
        ms.matmul_row_strip(a, b, 4)
    with pytest.raises(ValueError, match="blocks"):
        ms.matmul_row_strip(a, b, 8, blocks=0)
    with pytest.raises(ValueError, match="multiples of 4"):
        ms.matmul_pipelined(a, b)  # K = 7
    shifted = torch.zeros(8 * 8 + 1)[1:].view(8, 8)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        ms.matmul_pipelined(shifted, torch.ones(8, 8))
    with pytest.raises(ValueError, match="stages"):
        ms.matmul_pipelined(torch.ones(4, 8), torch.ones(8, 4), stages=5)
    with pytest.raises(ValueError, match="no tile"):
        ms.matmul_sweep(a, b, (32, 32, 8))
    with pytest.raises(ValueError, match="no tile"):
        ms.matmul_pipelined(torch.ones(4, 8), torch.ones(8, 4), (64, 64, 8))
    with pytest.raises(ValueError, match="unknown mode"):
        ms.matmul_mma(a, b, "tf32")
    with pytest.raises(TypeError, match="float32"):
        ms.matmul_sweep(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        ms.matmul_sweep(torch.ones(7, 5).T, b)
    with pytest.raises(ValueError, match="incompatible"):
        ms.matmul_mma(a, a)
    assert ms.matmul_sweep(a[:0], b).shape == (0, 8)


def test_resident_tile_is_the_one_wave_tile():
    assert ms.resident_tile(1028, 1028) == ms.Tile(128, 128, 16)  # 81 blocks
    assert ms.resident_tile(1028, 1028, bk=32) == ms.Tile(128, 128, 32)
    assert ms.resident_tile(2048, 2048) == ms.Tile(256, 128, 16)  # 128
    # 3 blocks each: the larger tile on a tie
    assert ms.resident_tile(40, 136, bk=8) == ms.Tile(128, 64, 8)
    with pytest.raises(ValueError, match="one wave"):
        ms.resident_tile(4096, 4096)


def test_bench_schedules_rows_at_small_size(capsys):
    rows = bench.bench_schedules([64], iters=1, device="cpu", log=len)
    experiments = [r["experiment"] for r in rows]
    # 12 sweep + 3 resident, 3 strips + one block, 2 x 3 pipelined, 3 modes
    assert experiments.count("E1") == 15 and experiments.count("E2") == 4
    assert experiments.count("E3") == 6 and experiments.count("E4") == 3
    for r in rows:
        assert r["clock"] == "host" and r["device"] == "cpu" and r["ms"] > 0
        assert r["tflops"] == pytest.approx(64 * 64 * 127 / r["ms"] / 1e9)
        assert r["bound_by"] == "bytes" and r["bound_ms"] > 0
        assert r["library_ms"] > 0 and r["err_over_bound"] <= 1
        if r["experiment"] == "E4" and r["mode"] != "f32":
            assert r["err_over_bound"] <= (bench.UNROUNDED_SHARE
                                           * r["unrounded_over_bound"])
        else:
            assert r["unrounded_over_bound"] is None
    assert {r["library"] for r in rows if r.get("mode") == "bf16in"} == {
        "torch.matmul(bf16) (bf16 out: no aten::mm.dtype here)"}
    assert bench.main(["--sizes", "8", "--iters", "1", "--device", "cpu"]) \
        == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {r["experiment"] for r in out} == {"E1", "E2", "E3", "E4"}
    assert not any(ms.launches.values())
