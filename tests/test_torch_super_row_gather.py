"""The winning-group gather (E5-E7) of the port against the TPU experiments
on the CPU: the plain twin against each script's own numpy check and
against its Pallas kernel body run in interpret mode, the consumer's lane
select and two-key sort against the script's JAX, the wrappers' checks and
``gather_bench`` at a small size.  The CUDA kernels are held against the
twin in ``test_torch_cuda.py``."""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from bm25_tpu_torch.bench import gather_bench as gb
from bm25_tpu_torch.ops import super_row_gather as srg

# the scripts' structure at a small size: R = N / 128 super-rows
Q, N, K, KP = 4, 8192, 100, 128
R = N // srg.ROW
PER = srg.ROW // gb.GROUP


def inputs(experiment):
    x3, rowof, tg = gb.make_inputs(experiment, Q, N, K, KP)
    return x3, rowof, tg


def twin(x3, rowof):
    return srg.super_row_gather_plain(torch.from_numpy(x3),
                                      torch.from_numpy(rowof)).numpy()


@pytest.mark.parametrize("experiment", ["pallas_gather", "window_gather"])
def test_twin_equals_the_scripts_numpy_check(experiment):
    # exp_r4_pallas_gather.py:110-112, exp_r4_window_gather.py:135
    x3, rowof, tg = inputs(experiment)
    ref = x3.reshape(Q, N).reshape(Q, R, 128)[np.arange(Q)[:, None], rowof]
    assert np.array_equal(twin(x3, rowof), ref)
    assert np.array_equal(rowof[:, :K], tg // PER)
    if experiment == "window_gather":  # distinct sorted groups, padded
        assert all(len(set(row)) == K for row in tg.tolist())
        assert (rowof[:, K:] == rowof[:, K - 1 : K]).all()
    else:
        assert (rowof[:, K:] == 0).all()


@pytest.mark.parametrize("h", gb.HEIGHTS)
def test_twin_equals_dyngather_numpy_check(h):
    # exp_r4_dyngather.py:115, the tables drawn in the script's order
    rng = np.random.default_rng(0)
    for height in gb.HEIGHTS[: gb.HEIGHTS.index(h)]:
        gb.make_table_inputs(height, Q, KP, rng)
    x3, rowof = gb.make_table_inputs(h, Q, KP, rng)
    assert x3.shape == (Q, h, 128) and rowof.shape == (Q, KP)
    assert np.array_equal(twin(x3, rowof),
                          x3[np.arange(Q)[:, None], rowof])


def pallas_e5(x3, rowof, unroll):
    """exp_r4_pallas_gather.py's kernel (:48-75) at this shape, run in
    interpret mode."""
    q, r, _ = x3.shape
    kp = rowof.shape[1]

    def kernel(rows_ref, x_ref, out_ref):
        def body(jj, _):
            for u in range(unroll):
                j = jj * unroll + u
                row = rows_ref[0, j // 128, j % 128]
                out_ref[0, j, :] = x_ref[0, row, :]
            return 0

        lax.fori_loop(0, kp // unroll, body, 0, unroll=False)

    return pl.pallas_call(
        kernel,
        grid=(q,),
        in_specs=[
            pl.BlockSpec((1, kp // 128, 128), lambda qi: (qi, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, r, 128), lambda qi: (qi, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, kp, 128), lambda qi: (qi, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((q, kp, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(rowof).reshape(q, kp // 128, 128), jnp.asarray(x3))


def pallas_e6(x3, rowof, w):
    """exp_r4_window_gather.py's kernel (:59-99), the winners laid out as
    [q, s, t] = rowof[q, 8t + s], run in interpret mode."""
    q, r, _ = x3.shape
    kp = rowof.shape[1]
    nt = kp // 8
    rows_v = jnp.asarray(rowof.reshape(q, nt, 8).transpose(0, 2, 1).copy())

    def kernel(rv_smem, rv_vmem, x_ref, out_ref):
        val = rv_vmem[0]
        for t in range(nt):
            w0 = rv_smem[0, 0, t]
            w7 = rv_smem[0, 7, t]
            w0a = jnp.minimum((w0 // 8) * 8, r - w)
            win = x_ref[0, pl.ds(w0a, w), :]
            relb = jnp.broadcast_to(val[:, t : t + 1] - w0a, (8, 128))
            out_t = None
            for i in range(w // 8):
                idx = jnp.clip(relb - 8 * i, 0, 7)
                g = jnp.take_along_axis(win[8 * i : 8 * i + 8], idx, axis=0)
                out_t = g if out_t is None else jnp.where(relb // 8 == i, g,
                                                          out_t)
            out_ref[0, 8 * t : 8 * t + 8, :] = out_t

            @pl.when(w7 - w0a >= w)
            def _(t=t):
                for s in range(8):
                    out_ref[0, 8 * t + s, :] = x_ref[0, rv_smem[0, s, t], :]

    return pl.pallas_call(
        kernel,
        grid=(q,),
        in_specs=[
            pl.BlockSpec((1, 8, nt), lambda qi: (qi, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, 8, nt), lambda qi: (qi, 0, 0)),
            pl.BlockSpec((1, r, 128), lambda qi: (qi, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, kp, 128), lambda qi: (qi, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((q, kp, 128), jnp.float32),
        interpret=True,
    )(rows_v, rows_v, jnp.asarray(x3))


def pallas_e7(x3, rowof):
    """exp_r4_dyngather.py's kernel (:75-110) at this shape, run in
    interpret mode."""
    q, h, _ = x3.shape
    kp = rowof.shape[1]

    def kernel(rows_ref, x_ref, out_ref):
        x = x_ref[0]
        rw = rows_ref[0]
        if h >= kp:
            idx = jnp.pad(jnp.broadcast_to(jnp.transpose(rw), (kp, 128)),
                          ((0, h - kp), (0, 0)))
            out_ref[0] = jnp.take_along_axis(x, idx, axis=0)[:kp]
        else:
            for b in range(kp // h):
                blk = jnp.broadcast_to(
                    jnp.transpose(rw[:, b * h:(b + 1) * h]), (h, 128))
                out_ref[0, b * h:(b + 1) * h] = jnp.take_along_axis(
                    x, blk, axis=0)

    return pl.pallas_call(
        kernel,
        grid=(q,),
        in_specs=[pl.BlockSpec((1, 1, kp), lambda qi: (qi, 0, 0)),
                  pl.BlockSpec((1, h, 128), lambda qi: (qi, 0, 0))],
        out_specs=pl.BlockSpec((1, kp, 128), lambda qi: (qi, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((q, kp, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(rowof)[:, None, :], jnp.asarray(x3))


@pytest.mark.parametrize("h", [8, 256])
def test_twin_equals_pallas_e7_interpreted(h):
    x3, rowof = gb.make_table_inputs(h, Q, KP)
    assert np.array_equal(twin(x3, rowof), np.asarray(pallas_e7(x3, rowof)))


@pytest.mark.parametrize("unroll", [1, 8])
def test_twin_equals_pallas_e5_interpreted(unroll):
    x3, rowof, _ = inputs("pallas_gather")
    got = np.asarray(pallas_e5(x3, rowof, unroll))
    assert np.array_equal(twin(x3, rowof), got)


@pytest.mark.parametrize("w", gb.WINDOWS)
def test_twin_equals_pallas_e6_interpreted(w):
    x3, rowof, _ = inputs("window_gather")
    got = np.asarray(pallas_e6(x3, rowof, w))
    assert np.array_equal(twin(x3, rowof), got)


def window_fallbacks_numpy(rowof, r, w):
    """exp_r4_window_gather.py:63-79's fallback test, tile by tile."""
    n = 0
    for row in rowof:
        for t in range(len(row) // 8):
            w0, w7 = int(row[8 * t]), int(row[8 * t + 7])
            n += w7 - min((w0 // 8) * 8, r - w) >= w
    return n


@pytest.mark.parametrize("w", [8, 32, 48])
@pytest.mark.parametrize("experiment", ["pallas_gather", "window_gather"])
def test_fallback_tiles_follow_the_script(experiment, w):
    _, rowof, _ = inputs(experiment)
    rowof = np.sort(rowof, axis=1)
    rowof[-1, -9:] = R - 1  # a tile at the last row: the window clamps
    want = window_fallbacks_numpy(rowof, R, w)
    t = torch.from_numpy(rowof)
    assert int(srg.window_fallback_tiles(t, R, w)) == want
    fb = torch.zeros(1, dtype=torch.int32)
    x3 = torch.zeros((Q, R, 128))
    srg.super_row_gather_window(x3, t, w, fallbacks=fb)
    srg.super_row_gather_window(x3, t, w, fallbacks=fb)
    assert int(fb) == 2 * want
    if w == 8:
        assert want > 0


def test_consumer_equals_the_scripts_jax():
    # exp_r4_pallas_gather.py:130-143: gather, lane select, 2-key sort
    x3, rowof, tg = inputs("pallas_gather")
    rows = jnp.asarray(x3)[jnp.arange(Q)[:, None], jnp.asarray(rowof)][:, :K]
    rows4 = rows.reshape(Q, K, PER, 8)
    sel = jnp.asarray(tg % PER)
    oh = lax.broadcasted_iota(jnp.int32, (Q, K, PER), 2) == sel[:, :, None]
    cand = jnp.max(jnp.where(oh[:, :, :, None], rows4, -jnp.inf),
                   axis=2).reshape(Q, K * 8)
    cand_idx = (jnp.asarray(tg)[:, :, None] * 8
                + jnp.arange(8)[None, None, :]).reshape(Q, K * 8)
    nv, ni = lax.sort((-cand, cand_idx), num_keys=2, is_stable=False)
    vals, idx = gb.select_and_sort(
        srg.super_row_gather_plain(torch.from_numpy(x3),
                                   torch.from_numpy(rowof)),
        torch.from_numpy(tg))
    assert np.array_equal((-vals).numpy(), np.asarray(nv))
    assert np.array_equal(idx.numpy(), np.asarray(ni))


def test_wrappers_on_the_cpu_run_the_twin():
    x3, rowof, _ = inputs("window_gather")
    x3, rowof = torch.from_numpy(x3), torch.from_numpy(rowof)
    before = dict(srg.plain_calls)
    want = x3[torch.arange(Q)[:, None], rowof.long()]
    for got in (srg.super_row_gather(x3, rowof, 4),
                srg.super_row_gather_window(x3, rowof, 32),
                srg.super_row_gather_resident(x3, rowof)):
        assert torch.equal(got, want)
    assert srg.plain_calls["super_row_gather"] == \
        before["super_row_gather"] + 3
    assert not any(srg.launches.values())


@pytest.mark.parametrize("r,kp,w,match", [
    (16, 8, 32, "R >= 32"),  # R < W
    (64, 12, 32, "multiple of 8"),  # KP off the tile
    (64, 16, 20, "positive multiple of 8"),  # W off the tile
    (64, 16, 0, "positive multiple of 8"),
])
def test_window_raises(r, kp, w, match):
    x3 = torch.zeros((2, r, 128))
    rowof = torch.zeros((2, kp), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        srg.super_row_gather_window(x3, rowof, w)


def test_direct_rejects_rows_per_warp_and_bad_counter():
    x3 = torch.zeros((2, 64, 128))
    rowof = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="rows_per_warp"):
        srg.super_row_gather(x3, rowof, 3)
    with pytest.raises(ValueError, match="fallbacks"):
        srg.super_row_gather_window(
            x3, rowof, 32, fallbacks=torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("experiment", gb.EXPERIMENTS)
def test_gather_bench_on_the_cpu(experiment):
    rows = gb.bench_gather(experiment, "cpu", q=2, n=8192, k=50, kp=64,
                           iters=1, log=lambda *_: None)
    assert rows and all(r["clock"] == "host" and r["ms"] > 0 for r in rows)
    variants = {r["variant"] for r in rows}
    assert {"torch.gather", "plain"} <= variants
    if experiment == "dyngather":
        assert {r["h"] for r in rows} == set(gb.HEIGHTS)
        assert "resident" in variants
    elif experiment == "window_gather":
        assert {r["window"] for r in rows if "window" in r} == set(gb.WINDOWS)
    else:
        assert {r["rows_per_warp"] for r in rows if "rows_per_warp" in r} \
            == set(srg.ROWS_PER_WARP)


def test_gather_bytes_counts_distinct_rows():
    rowof = torch.tensor([[0, 0, 3, 3], [1, 2, 2, 2]], dtype=torch.int32)
    # ids, 4 distinct (query, row) pairs read, 8 rows written
    assert gb.gather_bytes(rowof) == 8 * 4 + (4 + 8) * 512
