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


# (size, strip): every strip height that fits beside the ring at the
# scripts' sizes
FITTING = [(1028, 8), (1028, 16), (1028, 32), (2048, 8), (2048, 16),
           (4096, 8)]


@pytest.mark.parametrize("size,h", FITTING)
def test_row_strip_plan_fills_the_card(size, h):
    assert [x for x in ms.STRIP_HEIGHTS if ms.row_strip_smem_bytes(
        size, x) <= ms.H100_SMEM_OPTIN] == [x for s, x in FITTING if s == size]
    p = ms.row_strip_plan(size, size, size, h, sms=ms.H100_SMS)
    assert p.grid == p.strips * p.groups >= ms.H100_SMS
    assert p.strips == -(-size // h)
    assert p.smem_bytes == ms.row_strip_smem_bytes(size, h, p.stages)
    assert p.smem_bytes <= ms.H100_SMEM_OPTIN
    # the ring takes what the strip leaves: another slot would not fit
    assert ms.STRIP_MIN_STAGES <= p.stages <= ms.STRIP_MAX_STAGES
    assert p.stages == ms.STRIP_MAX_STAGES or ms.row_strip_smem_bytes(
        size, h, p.stages + 1) > ms.H100_SMEM_OPTIN
    assert p.group_w % 4 == 0
    assert (p.groups - 1) * p.group_w < size <= p.groups * p.group_w
    # the fewest groups that reach the SM count
    assert p.groups == 1 or (p.groups - 1) * p.strips < ms.H100_SMS
    assert (p.bn, p.bk) == (ms.STRIP_BN[h], ms.STRIP_BK[h])
    assert p.bn * p.bk == 4096 and p.bn * h == 8 * 1024
    # strip 8 at K = 4096 fits beside the ring, strip 16 does not
    assert ms.row_strip_smem_bytes(4096, 8) <= ms.H100_SMEM_OPTIN
    assert ms.row_strip_smem_bytes(4096, 16) > ms.H100_SMEM_OPTIN


@pytest.mark.parametrize("k,h", [(1028, 32), (1428, 32), (1429, 16),
                                 (2048, 16), (2860, 16), (2861, 8),
                                 (4096, 8), (5720, 8)])
def test_default_strip_is_the_tallest_that_fits(k, h):
    assert ms.default_strip(k) == h
    assert ms.row_strip_smem_bytes(k, h) <= ms.H100_SMEM_OPTIN
    taller = [x for x in ms.STRIP_HEIGHTS if x > h]
    assert all(ms.row_strip_smem_bytes(k, x) > ms.H100_SMEM_OPTIN
               for x in taller)
    # the wrapper's default takes it: no call at a K that strip 8 fits
    # raises for want of shared memory
    a = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (3, k), dtype=np.float32))
    b = torch.from_numpy(np.random.default_rng(h).standard_normal(
        (k, 5), dtype=np.float32))
    assert torch.equal(ms.matmul_row_strip(a, b), matmul_plain(a, b))


def test_default_strip_where_none_fits_raises():
    assert ms.default_strip(5721) == 8
    assert ms.row_strip_smem_bytes(5721, 8) > ms.H100_SMEM_OPTIN
    with pytest.raises(ValueError, match="shared memory"):
        ms.matmul_row_strip(torch.ones(2, 5721), torch.ones(5721, 3))
    # a smaller card's limit picks a shorter strip
    assert ms.default_strip(1028, 100 * 1024) == 8


def covered(m, n, p):
    """How many times E2's blocks, walking the plan as the kernel does,
    write each element of an (m, n) C."""
    hits = np.zeros((m, n), np.int64)
    for blk in range(p.grid):
        for it in range(blk, p.strips * p.groups, p.grid):
            g, s = divmod(it, p.strips)
            c_hi = min((g + 1) * p.group_w, n)
            for c0 in range(g * p.group_w, c_hi, p.bn):
                w = min(p.bn, c_hi - c0)
                hits[s * p.strip_m:(s + 1) * p.strip_m, c0:c0 + w] += 1
    return hits


@pytest.mark.parametrize("m,k,n", [(67, 130, 200), (1, 1, 1), (33, 13, 70),
                                   (130, 24, 129), (257, 1028, 260),
                                   (300, 64, 1030)])
def test_row_strip_plan_writes_every_element_once(m, k, n):
    for h in ms.STRIP_HEIGHTS:
        p = ms.row_strip_plan(m, n, k, h)
        assert (covered(m, n, p) == 1).all(), h
        for blocks in (1, 3, 1000):
            p = ms.row_strip_plan(m, n, k, h, blocks)
            assert p.groups == 1 and p.group_w >= n and p.grid == blocks
            assert (covered(m, n, p) == 1).all(), (h, blocks)


def panels_of(n, p):
    """(first column, width) of each panel E2's blocks stream, as the
    kernel walks them: each column group in panels of ``p.bn`` columns."""
    return [(c0, min(p.bn, hi - c0))
            for g in range(p.groups)
            for hi in [min((g + 1) * p.group_w, n)]
            for c0 in range(g * p.group_w, hi, p.bn)]


@pytest.mark.parametrize("k,n", [(13, 70), (130, 200), (1, 1), (64, 1030),
                                 (24, 129), (1028, 1028)])
def test_row_strip_packs_each_panel_contiguous(k, n):
    # the layout the kernel's one-copy tiles read: the panel of width w at
    # column c0 is a (K, w rounded up to 4) block at offset K c0
    b = torch.from_numpy(np.random.default_rng(k + n).standard_normal(
        (k, n), dtype=np.float32))
    # the same values in a view that starts 3 floats into its storage
    shifted = torch.zeros(k * n + 3)[3:].view(k, n)
    shifted.copy_(b)
    for h in ms.STRIP_HEIGHTS:
        for m, blocks in ((300, None), (40, None), (2000, None), (300, 3)):
            p = ms.row_strip_plan(m, n, k, h, blocks)
            panels = panels_of(n, p)
            assert [c0 for c0, _ in panels] == sorted(c0 for c0, _ in panels)
            assert sum(w for _, w in panels) == n
            for src in (b, shifted):
                packed = ms.pack_panels(src, p)
                assert packed.shape == (k * (-(-n // 4) * 4),)
                for c0, w in panels:
                    assert w <= p.bn and c0 % 4 == 0
                    wr = -(-w // 4) * 4
                    got = packed[k * c0:k * (c0 + wr)].view(k, wr)[:, :w]
                    assert torch.equal(got, b[:, c0:c0 + w]), (h, m, c0)


def test_row_strip_checks_and_bulk_staging():
    a, b = torch.ones(5, 7), torch.ones(7, 8)
    for bad in (0, -1, 2.0, "2"):
        with pytest.raises(ValueError, match="blocks"):
            ms.matmul_row_strip(a, b, 8, blocks=bad)
    for bad in (0, 4, 64, "8"):
        with pytest.raises(ValueError, match="strip_m"):
            ms.matmul_row_strip(a, b, bad)
    assert torch.equal(ms.matmul_row_strip(a, b, 8, blocks=3), a @ b)
    # the copies the bulk copies need: rows of whole 16-byte units from a
    # 16-byte aligned start; the real values lead each padded row
    x = torch.arange(60, dtype=torch.float32).view(5, 12)
    assert ms._bulk_operand(x) is x
    for y in (x[:, :7].contiguous(),  # K = 7
              torch.arange(41, dtype=torch.float32)[1:].view(5, 8)):  # +4 B
        got = ms._bulk_operand(y)
        assert got.shape == (5, -(-y.shape[1] // 4) * 4)
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got[:, :y.shape[1]], y)


# E1 and E3's ring body: the stage counts and the consumer warps' layout
# the card will launch (csrc/matmul_schedules.cu, RingShape)
RING_CASES = ([("E1", t, None) for t in ms.SWEEP_TILES]
              + [("E3", t, st) for t in ms.PIPELINED_TILES
                 for st in ms.STAGES])


@pytest.mark.parametrize("kernel,tile,stages", RING_CASES)
def test_ring_depth_fits_shared_memory(kernel, tile, stages):
    if kernel == "E1":
        stages = ms.sweep_stages(tile)
        # the deepest up to the cap: every sweep tile's 4 stages fit an
        # H100 (a 256 x 128 x 32 stage is 48 KB)
        assert stages == ms.RING_MAX_STAGES == 4
    else:
        assert tile in ms.SWEEP_TILES  # E3 runs E1's instantiations
    assert 2 <= stages <= ms.RING_MAX_STAGES
    stage = (tile.m * tile.k + tile.k * tile.n) * 4
    assert stage % ms.RING_ALIGN == 0  # every stage starts TMA-aligned
    assert ms.ring_smem_bytes(tile, stages) == (
        ms.RING_ALIGN + stages * stage + 2 * ms.RING_MAX_STAGES * 8)
    assert ms.ring_smem_bytes(tile, stages) <= ms.H100_SMEM_OPTIN
    # a smaller card's limit takes a shallower ring, and one that holds
    # not even two stages raises
    two = ms.ring_smem_bytes(tile, 2)
    assert ms.sweep_stages(tile, two) == 2
    assert ms.sweep_stages(tile, ms.ring_smem_bytes(tile, 3) - 1) == 2
    with pytest.raises(ValueError, match="two stages"):
        ms.sweep_stages(tile, two - 1)


@pytest.mark.parametrize("tile", ms.SWEEP_TILES)
def test_ring_layout_covers_each_c_tile_once(tile):
    lay = ms.ring_layout(tile)
    assert lay.rows in (16, 32) and lay.cols in (2, 4)
    assert lay.rows * lay.cols <= 128  # accumulators a thread
    assert 32 * (lay.warps + 1) <= 1024  # one producer warp more
    hits = np.zeros((tile.m, tile.n), np.int64)
    for w in range(lay.warps):
        for lane in range(32):  # every lane on the warp's rows
            hits[w * lay.rows:(w + 1) * lay.rows,
                 lane * lay.cols:(lane + 1) * lay.cols] += 1
    assert (hits == 1).all()
    # a warp's B reads are 16 (or 8) bytes a lane, neighbours adjacent:
    # one 512 (256) byte run a row, conflict-free
    assert lay.cols * 4 * 32 == tile.n * 4


# (rows, cols, view offset in floats): K or N off a multiple of 4, views
# 4 and 12 bytes off 16-byte alignment, and operands TMA reads as they lie
STAGING = [(7, 13, 0), (13, 8, 0), (9, 12, 1), (9, 12, 3), (5, 16, 0),
           (3, 1, 2)]


@pytest.mark.parametrize("rows,cols,off", STAGING)
def test_sweep_stages_operands_tma_cannot_read(rows, cols, off):
    rng = np.random.default_rng(rows * cols + off)
    x = torch.zeros(rows * cols + off)[off:].view(rows, cols)
    x.copy_(torch.from_numpy(rng.standard_normal((rows, cols),
                                                 dtype=np.float32)))
    y = torch.from_numpy(rng.standard_normal((cols, 6), dtype=np.float32))
    # the operands E1's ring launches on (ops/matmul_schedules.py::_ring)
    a_op, b_op = ms._bulk_operand(x), ms._bulk_operand(y)
    as_is = cols % 4 == 0 and off % 4 == 0
    assert (a_op is x) == as_is
    assert a_op.shape == (rows, -(-cols // 4) * 4)
    assert a_op.data_ptr() % 16 == 0
    assert torch.equal(a_op[:, :cols], x)
    assert b_op.shape == (cols, 8) and torch.equal(b_op[:, :6], y)
    # what the kernel reads, the real (M, K) and (K, N) parts of the staged
    # operands, gives the twin's product; the wrapper on CPU tensors is the
    # twin, at every tile
    want = matmul_plain(x, y)
    assert torch.equal(matmul_plain(a_op[:, :cols].contiguous(),
                                    b_op[:, :6].contiguous()), want)
    for t in ms.SWEEP_TILES:
        assert torch.equal(ms.matmul_sweep(x, y, t), want)
    assert not any(ms.launches.values())


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
        if r["experiment"] == "E2":  # B once per strip, A once per group
            p = ms.row_strip_plan(64, 64, 64, r["strip_m"], r.get("blocks"))
            assert r["b_l2_bytes"] == -(-64 // r["strip_m"]) * 64 * 64 * 4
            assert r["a_l2_bytes"] == p.groups * 64 * 64 * 4
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


# E4's pack (mma_pack_plain) and launch plan (mma_plan): what the card's
# pack kernel must equal bit for bit, and what its product kernel launches
PACK_SHAPES = [(1, 1, 1), (33, 13, 70), (5, 0, 3), (7, 1029, 9), (3, 6, 2),
               (130, 24, 129)]


@pytest.mark.parametrize("mode", list(ms.ROUNDING))
@pytest.mark.parametrize("m,k,n", PACK_SHAPES)
def test_mma_pack_twin_rounds_transposes_and_zero_pads(m, k, n, mode):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    ap, bt = ms.mma_pack_plain(a, b, mode)
    kp = ms.mma_plan(m, n, k, mode).kp
    assert ap.shape == (m, kp) and bt.shape == (n, kp)
    assert ap.dtype == bt.dtype == ms.MMA_PACKED_DTYPE[mode]
    rnd = ms.ROUNDING[mode]
    assert torch.equal(ap[:, :k].float(), rnd(a))
    assert torch.equal(bt[:, :k].float(), rnd(b).t())
    for pad in (ap[:, k:], bt[:, k:]):  # +0, sign bit clear
        assert (pad.float().view(torch.int32) == 0).all()
    # the wrapper on CPU tensors is the twin
    got = ms.mma_pack(a, b, mode)
    assert torch.equal(got[0], ap) and torch.equal(got[1], bt)


@pytest.mark.parametrize("mode", list(ms.ROUNDING))
@pytest.mark.parametrize("m,k,n", PACK_SHAPES)
def test_mma_pack_twin_unpadded_product_is_the_twin(m, k, n, mode):
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    ap, bt = ms.mma_pack_plain(a, b, mode)
    got = matmul_plain(ap[:, :k].float().contiguous(),
                       bt[:, :k].float().t().contiguous())
    assert torch.equal(got, ms.matmul_mma_plain(a, b, mode))


def covered_once(m: int, n: int, plan) -> bool:
    """Every C element lies in exactly one of the plan's 128 x bn tiles."""
    hits = np.zeros((plan.grid_m * ms.MMA_TILE, plan.grid_n * plan.bn), int)
    for tm in range(plan.grid_m):
        for tn in range(plan.grid_n):
            hits[tm * ms.MMA_TILE:(tm + 1) * ms.MMA_TILE,
                 tn * plan.bn:(tn + 1) * plan.bn] += 1
    c = hits[:m, :n]
    # and no tile lies wholly past C
    return bool((c == 1).all()) and (plan.grid_m - 1) * ms.MMA_TILE < m \
        and (plan.grid_n - 1) * plan.bn < n


@pytest.mark.parametrize("mode", list(ms.ROUNDING))
def test_mma_plan_rows_of_whole_16_byte_units(mode):
    e = ms.MMA_ELEM_BYTES[mode]
    for k in list(range(0, 70)) + [1028, 1029, 2048, 4095, 4096]:
        p = ms.mma_plan(8, 8, k, mode)
        assert p.kp * e % 16 == 0 and max(k, 1) <= p.kp < max(k, 1) + 16 // e
        assert p.bk * e == ms.MMA_ROW_BYTES  # a stage is 128 bytes of K
        assert (p.k_steps - 1) * p.bk < p.kp <= p.k_steps * p.bk
    assert ms.mma_plan(1028, 1028, 1028, "bf16in").kp == 1032  # 2,064 bytes
    assert ms.mma_plan(1028, 1028, 1028, "default").kp == 1028  # 4,112 bytes


@pytest.mark.parametrize("m,n", [(1, 1), (33, 70), (129, 257), (1028, 1028),
                                 (1100, 2100), (2048, 2048), (300, 4100)])
def test_mma_plan_grid_covers_c(m, n):
    for mode in ms.ROUNDING:
        p = ms.mma_plan(m, n, 64, mode)
        assert covered_once(m, n, p), (m, n, p)
        narrow = ms.cdiv(m, ms.MMA_TILE) * ms.cdiv(n, ms.MMA_TILE)
        # 128 x 256 only where 128 x 128 tiles take more than one wave
        assert p.bn == (128 if narrow <= ms.H100_SMS else 256)
        assert ms.mma_plan(m, n, 64, mode) is p  # cached
    assert ms.mma_plan(1028, 1028, 1028, "bf16in").bn == 128  # 81 blocks
    assert ms.mma_plan(4096, 4096, 4096, "default").bn == 256  # 512 blocks
    assert ms.mma_plan(1028, 1028, 1028, "bf16in", sms=64).bn == 256


def test_mma_pack_checks():
    a, b = torch.ones(4, 5), torch.ones(5, 6)
    for bad in ("f32", "tf32"):
        with pytest.raises(ValueError, match="unknown mode"):
            ms.mma_pack(a, b, bad)
    with pytest.raises(TypeError, match="float32"):
        ms.mma_pack(a.double(), b.double())
    with pytest.raises(ValueError, match="incompatible"):
        ms.mma_pack(a, a)
