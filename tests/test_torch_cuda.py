"""Card-only tests: the CUDA kernels against their plain twins, and the
port engine on the GPU against the host oracle.

Every test here needs a CUDA device and skips elsewhere.  The file
imports no JAX, so it also runs on a machine without it:
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from bm25_tpu_torch import (DenseEngine, ReferenceEngine, Session,
                            create_engine)
from bm25_tpu_torch.bench import BenchConfig, make_synthetic_index
from bm25_tpu_torch.ops import gather_rows as gr
from bm25_tpu_torch.ops import super_row_gather as srg
from bm25_tpu_torch.ops import topk as tk
from bm25_tpu_torch.utils.counts import split_bf16
from bm25_tpu_torch.utils.parity import assert_matches_oracle

# bm25_tpu_torch.ops re-exports a function of each module's name
port = importlib.import_module("bm25_tpu_torch.ops.ell_score")
pm = importlib.import_module("bm25_tpu_torch.ops.matmul")

# q, t, rows, l_pad, vocab, h, pad_rows, weighted
CASES = {
    "no_hot": (12, 5, 512, 16, 60, 0, 0, False),
    "hot": (12, 5, 1024, 16, 60, 16, 0, False),
    "pad_rows_oov_ragged_q_hot": (13, 8, 512, 24, 80, 24, 9, False),
    "wide_slot_tiled": (9, 3, 512, 1208, 4000, 0, 5, False),
    "wide_slot_tiled_hot": (9, 3, 512, 1208, 4000, 8, 5, False),
    "hot_only": (7, 8, 1024, 0, 50, 32, 100, False),
    "weighted": (13, 8, 512, 24, 80, 0, 9, True),
    "weighted_hot_split_counts": (13, 8, 512, 24, 80, 24, 9, True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_case(seed, q, t, rows, l_pad, vocab, h, pad_rows, weighted, dev):
    rng = np.random.default_rng(seed)
    fill = rng.integers(0, l_pad + 1, rows)
    tokT = np.full((l_pad, rows), -1, np.int32)
    valT = np.zeros((l_pad, rows), np.float32)
    for r in range(rows):
        tokT[: fill[r], r] = rng.choice(vocab, fill[r], replace=False)
        valT[: fill[r], r] = rng.standard_normal(fill[r]).astype(np.float32)
    ids = rng.integers(-1, vocab + 20, (q, t)).astype(np.int32)
    ids[0] = -1
    ids[1, :3] = ids[1, 0]
    did = np.arange(rows, dtype=np.int32)
    if pad_rows:
        did[-pad_rows:] = -1
    w = rng.uniform(0.0, 3.0, (q, t)).astype(np.float32)

    def put(a):
        return torch.from_numpy(a).to(dev)

    args = [put(ids), put(tokT) if l_pad else None,
            put(valT) if l_pad else None, put(did)]
    kw = {"weights": put(w)} if weighted else {}
    if h:
        hc = np.zeros((q, h), np.float32)
        for qq in range(q):
            np.add.at(hc[qq], rng.integers(0, h, t), w[qq] if weighted else 1)
        hc_hi, hc_lo = split_bf16(put(hc))
        dense = put(rng.standard_normal((h, rows)).astype(np.float32))
        args += [hc_hi, *split_bf16(dense)]
        if weighted:
            kw["hot_counts_lo"] = hc_lo
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernels_match_plain_twins(cuda_device, name):
    q, t, rows, l_pad, vocab, h, pad_rows, weighted = CASES[name]
    args, kw = make_case(4, *CASES[name], cuda_device)
    launched = dict(port.launches)
    base_k, gmax_k = port.ell_score_fused(*args, **kw)
    assert port.launches["ell_score_fused"] == \
        launched["ell_score_fused"] + 1
    base_p, gmax_p = port.ell_score_fused_plain(*args, **kw)
    if not h:
        assert torch.equal(base_k, base_p) and torch.equal(gmax_k, gmax_p)
    else:
        torch.testing.assert_close(base_k, base_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gmax_k, gmax_p, rtol=1e-5, atol=1e-5)
    if l_pad:
        assert torch.equal(port.ell_score(*args[:3]),
                           port.ell_score_plain(*args[:3]))
        assert port.launches["ell_score"] == launched["ell_score"] + 1


@pytest.mark.cuda
def test_cuda_launch_errors_raise(cuda_device):
    ids = torch.zeros((4, 3), dtype=torch.int64, device=cuda_device)
    tok = torch.zeros((8, 512), dtype=torch.int32, device=cuda_device)
    val = torch.zeros((8, 512), dtype=torch.float32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        port.ell_score(ids, tok, val)
    with pytest.raises(ValueError, match="expected"):
        port.ell_score(ids.int(), tok.cpu(), val)


@pytest.mark.cuda
def test_cuda_engine_matches_oracle(cuda_device):
    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    engine = create_engine(index, mode="sparse", session=Session("cuda"),
                           hot_tokens=64, hot_budget_bytes=1 << 24,
                           max_buckets=2)
    q = np.random.default_rng(0).integers(-1, 2000, (40, 8))
    q[0] = -1
    ref = ReferenceEngine.from_scored_index(index)
    launched, plain = dict(port.launches), dict(port.plain_calls)
    for k in (1, 10, 1000):
        assert_matches_oracle(*engine.search(q, top_k=k),
                              *ref.search(q, top_k=k))
    assert port.launches["ell_score_fused"] > launched["ell_score_fused"]
    assert port.plain_calls == plain  # the GPU path ran no plain twin


# -- B3 gather-accumulate -----------------------------------------------------

# v, d, q, t, dtype, weighted
GATHER_CASES = {
    "f32": (50, 1024, 13, 8, torch.float32, False),
    "f32_weighted": (50, 1024, 13, 8, torch.float32, True),
    "f32_ragged_d": (50, 1001, 7, 5, torch.float32, False),
    "f32_ragged_d_weighted": (50, 1001, 7, 5, torch.float32, True),
    "bf16": (50, 2048, 9, 8, torch.bfloat16, False),
    "bf16_weighted": (50, 2048, 9, 8, torch.bfloat16, True),
    "bf16_ragged_d": (30, 333, 4, 3, torch.bfloat16, False),
    "empty_t": (10, 512, 5, 0, torch.float32, False),
}


def gather_case(v, d, q, t, dtype, weighted, dev, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(
        rng.standard_normal((v, d)).astype(np.float32)).to(dtype).to(dev)
    ids = rng.integers(0, v, (q, t)).astype(np.int32)
    if q > 1 and t > 2:
        ids[1, :3] = ids[1, 0]  # duplicate ids
    w = rng.uniform(-2.0, 3.0, (q, t)).astype(np.float32)
    return (table, torch.from_numpy(ids).to(dev),
            torch.from_numpy(w).to(dev) if weighted else None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GATHER_CASES))
def test_cuda_gather_add_rows_bit_equal_to_twin(cuda_device, name):
    table, ids, w = gather_case(*GATHER_CASES[name], cuda_device)
    before = gr.launches["gather_add_rows"]
    got = gr.gather_add_rows(table, ids, w)
    assert gr.launches["gather_add_rows"] == before + 1
    want = gr.gather_add_rows_plain(table, ids, w)
    assert got.dtype == table.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    if ids.shape[1] == 0:
        assert not got.any()


@pytest.mark.cuda
def test_cuda_gather_add_rows_empty_batch_and_checks(cuda_device):
    table, ids, _ = gather_case(8, 64, 0, 3, torch.float32, False, cuda_device)
    assert gr.gather_add_rows(table, ids).shape == (0, 64)
    with pytest.raises(TypeError, match="int32"):
        gr.gather_add_rows(table, ids.long())
    with pytest.raises(TypeError):
        gr.gather_add_rows(table.double(), ids)


# -- B4 two-stage top-k ---------------------------------------------------------


def topk_input(b, n, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 6, (b, n)).astype(np.float32)  # heavy ties
    x[0] = -np.inf  # exhausted row
    if b > 1:
        x[1, ::3] = -np.inf
    if b > 2:
        x[2, : n // 2] = -np.inf
    return torch.from_numpy(x).to(dev)


# b, n, k: one block, several blocks, tail chunks, k == n, a merge in
# two passes (8 x 7,300 candidates exceed one block)
TOPK_CASES = [(5, 100, 7), (4, 16384, 100), (4, 16385, 64), (3, 40000, 16),
              (6, 131072, 1000), (3, 300, 300), (2, 50000, 1),
              (3, 131072, 7300)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k", TOPK_CASES)
def test_cuda_topk_two_stage_matches_twin_and_tree(cuda_device, b, n, k):
    x = topk_input(b, n, n + k, cuda_device)
    before = tk.launches["top_k_two_stage"]
    v, i = tk.top_k_two_stage(x, k)
    assert tk.launches["top_k_two_stage"] == before + 1
    pv, pi = tk.topk_two_stage_plain(x, k)
    tv, ti = tk.top_k_tree(x, k)
    for got in ((pv, pi), (tv, ti)):
        assert torch.equal(v, got[0]) and torch.equal(i, got[1])
    for row in i.cpu().numpy():
        assert len(set(row.tolist())) == k


@pytest.mark.cuda
def test_cuda_topk_largest_false_and_k_beyond_one_block(cuda_device):
    x = topk_input(3, 40000, 1, cuda_device)
    v, i = tk.top_k(x, 50, largest=False, implementation="pallas")
    tv, ti = tk.top_k(x, 50, largest=False, implementation="tree")
    assert torch.equal(v, tv) and torch.equal(i, ti)
    # k wider than a stage-1 chunk (13,334 of 40,000): the tree, counted
    assert tk.two_stage_plan(40000, 14000) is None
    before = dict(tk.tree_calls)
    v, i = tk.top_k(x, 14000, implementation="pallas")
    assert tk.tree_calls["top_k_two_stage"] == \
        before["top_k_two_stage"] + 1
    tv, ti = tk.top_k_tree(x, 14000)
    assert torch.equal(v, tv) and torch.equal(i, ti)


# -- B5 Gumbel-max choice ----------------------------------------------------------


def assert_choices_agree(logits, seed, got, want):
    """Equal choices, except where the twin's top two z are within float
    noise (logf on the card vs torch.log may differ by an ulp)."""
    if torch.equal(got, want):
        return
    z = logits + tk.gumbel_noise_plain(seed, *logits.shape, logits.device)
    zg = z.gather(1, got[:, None])[:, 0]
    zw = z.gather(1, want[:, None])[:, 0]
    diff = (zg - zw).abs()
    assert bool((diff <= 1e-5 * zw.abs().clamp_min(1.0)).all())


@pytest.mark.cuda
def test_cuda_gumbel_choice_matches_twin(cuda_device):
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(
        rng.standard_normal((300, 100)).astype(np.float32)).to(cuda_device)
    logits[0, 50:] = float("-inf")
    before = tk.launches["gumbel_choice"]
    for seed in (0, 1, 2**32 - 1):
        got = tk.gumbel_choice(logits, seed)
        assert torch.equal(got, tk.gumbel_choice(logits, seed))
        assert_choices_agree(logits, seed, got,
                             tk.gumbel_choice_plain(logits, seed))
        assert int(got[0]) < 50
    assert tk.launches["gumbel_choice"] == before + 6


@pytest.mark.cuda
def test_cuda_fused_sampling_member_and_greedy(cuda_device):
    x = torch.from_numpy(np.random.default_rng(1).random(
        (16, 500), np.float32)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    vals, s = tk.top_k_fused_sampling(x, 8, implementation="pallas",
                                      generator=g)
    _, ti = tk.top_k_tree(x, 8)
    assert bool((s == ti).any(dim=1).all())
    _, greedy = tk.top_k_fused_sampling(x, 8, temperature=0.0,
                                        implementation="pallas", generator=g)
    assert torch.equal(greedy[:, 0], ti[:, 0])


# -- the dense engine on the card --------------------------------------------------


@pytest.mark.cuda
def test_cuda_dense_engine_matches_oracle(cuda_device):
    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    engine = create_engine(index, session=Session("cuda"))
    assert isinstance(engine, DenseEngine)
    q = np.random.default_rng(0).integers(-1, 2000, (40, 8))
    q[0] = -1
    ref = ReferenceEngine.from_scored_index(index)
    launched = gr.launches["gather_add_rows"]
    plain = dict(gr.plain_calls)
    w = np.random.default_rng(1).uniform(0.1, 3.0, q.shape).astype(np.float32)
    mask = np.random.default_rng(2).random(index.num_docs) < 0.5
    for k in (1, 10, 1000):
        assert_matches_oracle(*engine.search(q, top_k=k),
                              *ref.search(q, top_k=k))
    assert_matches_oracle(*engine.search(q, top_k=100, weights=w),
                          *ref.search(q, top_k=100, weights=w))
    assert_matches_oracle(*engine.search(q, top_k=100, doc_mask=mask),
                          *ref.search(q, top_k=100, doc_mask=mask))
    assert gr.launches["gather_add_rows"] == launched + 5
    assert gr.plain_calls == plain


@pytest.mark.cuda
def test_cuda_matmul_scoring_is_full_f32_with_tf32_allowed(cuda_device):
    """TF32 allowed process-wide: matmul scoring still holds to the
    oracle's f32 tolerance (a 10-bit mantissa would not), and the
    caller's setting is left as it was."""
    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    engine = create_engine(index, mode="dense", session=Session("cuda"))
    engine.scoring = "matmul"
    q = np.random.default_rng(3).integers(-1, 2000, (40, 8))
    w = np.random.default_rng(4).uniform(0.1, 3.0, q.shape).astype(np.float32)
    ref = ReferenceEngine.from_scored_index(index)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        for kw in ({}, {"weights": w}):
            assert_matches_oracle(*engine.search(q, top_k=100, **kw),
                                  *ref.search(q, top_k=100, **kw))
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved


# -- B6 matmul ---------------------------------------------------------------------

# m, k, n: the JAX test's ragged shape, 1 x 1 x 1, K off the K-steps and M,
# N off the tiles (scalar loads), aligned (16-byte loads), K = 1028
MATMUL_SHAPES = [(67, 130, 200), (1, 1, 1), (33, 13, 70), (128, 64, 128),
                 (300, 1028, 260), (3, 0, 4)]


def matmul_tiles(dtype):
    """(algorithm, tile arguments): each kernel's default and every tile
    of ``dtype``."""
    return [("naive", {}), ("optimized", {}),
            *[("optimized", {"tile_m": t.m, "tile_n": t.n, "tile_k": t.k})
              for t in pm.TILES[dtype]]]


def matmul_operands(m, k, n, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return (torch.from_numpy(a).to(dtype).to(dev),
            torch.from_numpy(b).to(dtype).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", pm.DTYPES)
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_cuda_matmul_kernels_bit_equal_to_twin(cuda_device, m, k, n, dtype):
    a, b = matmul_operands(m, k, n, dtype, cuda_device)
    want = pm.matmul_plain(a, b)
    plain = dict(pm.plain_calls)
    for algo, tiles in matmul_tiles(dtype):
        name = "matmul_naive" if algo == "naive" else "matmul_tiled"
        before = pm.launches[name]
        got = pm.matmul(a, b, algorithm=algo, **tiles)
        assert pm.launches[name] == before + 1, (algo, tiles)
        assert got.dtype == dtype and torch.equal(got, want), (algo, tiles)
    assert pm.plain_calls == plain  # CUDA tensors never reach the twin


@pytest.mark.cuda
def test_cuda_matmul_scalar_path_on_misaligned_pointers(cuda_device):
    """K and N allow 16-byte loads, the pointers do not: the scalar
    instantiation runs, with the same bits."""
    for dtype in pm.DTYPES:
        a, b = matmul_operands(96, 64, 80, dtype, cuda_device, seed=1)
        flat = torch.empty(a.numel() + 1, dtype=dtype, device=cuda_device)
        a_off = flat[1:].view(a.shape)
        a_off.copy_(a)
        assert a_off.is_contiguous() and a_off.data_ptr() % 16
        assert torch.equal(pm.matmul(a_off, b), pm.matmul_plain(a, b))


@pytest.mark.cuda
def test_cuda_matmul_empty_and_checks(cuda_device):
    for m, n in ((0, 5), (5, 0)):
        a, b = matmul_operands(m, 7, n, torch.float32, cuda_device)
        before = dict(pm.launches)
        assert pm.matmul(a, b).shape == (m, n)
        assert pm.launches == before  # nothing to launch
    a, b = matmul_operands(4, 6, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="is on"):
        pm.matmul(a, b.cpu())
    with pytest.raises(TypeError):
        pm.matmul(a.half(), b.half())
    with pytest.raises(ValueError, match="contiguous"):
        pm.matmul(a, b.T.contiguous().T)
    with pytest.raises(ValueError, match="instantiation"):
        pm.matmul(a, b, tile_k=32)


@pytest.mark.cuda
def test_cuda_matmul_xla_is_full_f32_with_tf32_allowed(cuda_device):
    a, b = matmul_operands(256, 512, 192, torch.float32, cuda_device)
    want = pm.matmul_plain(a, b)
    bound = 2 * 512 * 2.0**-24 * (a.abs().double() @ b.abs().double())
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        got = pm.matmul(a, b, algorithm="xla")
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved
    assert bool(((got.double() - want.double()).abs() <= bound).all())


# -- the named ops on CUDA tensors -----------------------------------------------------


@pytest.mark.cuda
def test_cuda_named_ops_equal_cpu(cuda_device):
    from bm25_tpu_torch import custom

    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-13, 13, (4, 3)))
    col = torch.from_numpy(rng.integers(-11, 11, (6, 1)))
    nd = torch.from_numpy(rng.integers(-13, 13, (7, 1)))
    upd = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    nd_upd = torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32))
    calls = [
        ("gather", (data, idx), {"axis": 1}),
        ("gather_reduce", (data, idx), {"reduce_fn": "mean"}),
        ("gather_elements", (data, col), {"axis": 1}),
        ("gather_nd", (data, nd), {}),
        ("scatter_elements", (data, idx, upd), {"reduction": "add"}),
        ("scatter_elements", (data, idx, upd), {}),
        ("scatter_nd", (data, nd, nd_upd), {"reduction": "max"}),
        ("scatter_nd", (data, nd, nd_upd), {}),
        ("reshape", (data, (-1, 3)), {}),
    ]
    for name, args, kw in calls:
        on_card = custom(name, *[a.to(cuda_device)
                                 if isinstance(a, torch.Tensor) else a
                                 for a in args], **kw)
        assert on_card.device.type == "cuda", name
        # bit-equal, NaN (an out-of-range gather's fill) included
        torch.testing.assert_close(on_card.cpu(), custom(name, *args, **kw),
                                   rtol=0, atol=0, equal_nan=True)
    got = custom("arange", 0.0, 3.0, 0.1, dtype=torch.float32,
                 device=cuda_device)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), custom("arange", 0.0, 3.0, 0.1,
                                         dtype=torch.float32, device="cpu"))


def super_row_case(q, r, kp, seed, dev, sort=False):
    rng = np.random.default_rng(seed)
    x3 = torch.from_numpy(rng.random((q, r, srg.ROW), np.float32)).to(dev)
    rowof = rng.integers(0, r, (q, kp)).astype(np.int32)
    rowof[0, :3] = [0, r - 1, r - 1]  # the first and last row, duplicated
    if sort:
        rowof.sort(axis=1)
    return x3, torch.from_numpy(rowof).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_warp", srg.ROWS_PER_WARP)
@pytest.mark.parametrize("q,r,kp", [(3, 64, 40), (5, 300, 1024), (1, 1, 7)])
def test_cuda_super_row_gather_bit_equal(cuda_device, q, r, kp, rows_per_warp):
    x3, rowof = super_row_case(q, r, kp, q + r + kp, cuda_device)
    got = srg.super_row_gather(x3, rowof, rows_per_warp)
    torch.cuda.synchronize()
    assert torch.equal(got, srg.super_row_gather_plain(x3, rowof))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [32, 48])
@pytest.mark.parametrize("q,r,kp", [(3, 64, 40), (4, 2048, 1024), (2, 48, 8)])
def test_cuda_super_row_gather_window_bit_equal(cuda_device, q, r, kp,
                                                window):
    if r < window:
        pytest.skip("R < W raises (test below)")
    x3, rowof = super_row_case(q, r, kp, q + r + kp, cuda_device, sort=True)
    rowof[-1] = r - 1  # a tile at the end: the window clamps to R - W
    rowof[-1, : kp // 2 + 1] = 0  # a tile spanning more than W: fallback
    rowof = rowof.sort(dim=1).values.contiguous()
    fb = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = srg.super_row_gather_window(x3, rowof, window, fallbacks=fb)
    torch.cuda.synchronize()
    assert torch.equal(got, srg.super_row_gather_plain(x3, rowof))
    want = int(srg.window_fallback_tiles(rowof, r, window))
    assert int(fb.item()) == want and (want > 0 or r == window)
    unsorted = rowof.flip(1).contiguous()  # out-of-window rows load directly
    assert torch.equal(srg.super_row_gather_window(x3, unsorted, window),
                       srg.super_row_gather_plain(x3, unsorted))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [8, 32, 100, 256])
def test_cuda_super_row_gather_resident_bit_equal(cuda_device, h):
    x3, rowof = super_row_case(6, h, 1000, h, cuda_device)
    got = srg.super_row_gather_resident(x3, rowof)
    torch.cuda.synchronize()
    assert torch.equal(got, srg.super_row_gather_plain(x3, rowof))


@pytest.mark.cuda
def test_cuda_super_row_gather_raises(cuda_device):
    x3, rowof = super_row_case(2, 16, 8, 0, cuda_device, sort=True)
    with pytest.raises(ValueError, match="R >= 32"):
        srg.super_row_gather_window(x3, rowof, 32)
    x3, rowof = super_row_case(2, 64, 12, 0, cuda_device, sort=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        srg.super_row_gather_window(x3, rowof, 32)
    big, rows = super_row_case(1, 2048, 16, 0, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        srg.super_row_gather_resident(big, rows)
    with pytest.raises(TypeError):
        srg.super_row_gather(x3, rowof.long())
    empty = srg.super_row_gather(x3, rowof[:, :0].contiguous())
    assert empty.shape == (2, 0, srg.ROW)


# E1-E4 (ops/matmul_schedules.py): shapes with ragged M, N and K, K off
# every K step, 1 x 1 x 1; E3 takes only K and N multiples of 4
SCHEDULE_SHAPES = [(67, 130, 200), (1, 1, 1), (33, 13, 70), (100, 64, 136),
                   (130, 24, 129), (37, 36, 44), (257, 1028, 260)]
ms = importlib.import_module("bm25_tpu_torch.ops.matmul_schedules")
bs = importlib.import_module("bm25_tpu_torch.bench.matmul_schedules")


def analytic_operands(dev, n=32):
    r = torch.arange(n, dtype=torch.float32, device=dev)
    return r[:, None] - r[None, :], r[:, None] + r[None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SCHEDULE_SHAPES)
def test_cuda_matmul_sweep_and_row_strip_bit_equal(cuda_device, m, k, n):
    a, b = matmul_operands(m, k, n, torch.float32, cuda_device, seed=m + k)
    want = pm.matmul_plain(a, b)
    for tile in ms.SWEEP_TILES:
        assert torch.equal(ms.matmul_sweep(a, b, tile), want), tile
    for h in ms.STRIP_HEIGHTS:
        for blocks in (None, 1, 3):
            assert torch.equal(ms.matmul_row_strip(a, b, h, blocks), want), (
                h, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [s for s in SCHEDULE_SHAPES
                                   if s[1] % 4 == 0 and s[2] % 4 == 0])
def test_cuda_matmul_pipelined_bit_equal(cuda_device, m, k, n):
    a, b = matmul_operands(m, k, n, torch.float32, cuda_device, seed=m + n)
    want = pm.matmul_plain(a, b)
    for tile in ms.PIPELINED_TILES:
        for stages in ms.STAGES:
            got = ms.matmul_pipelined(a, b, tile, stages)
            assert torch.equal(got, want), (tile, stages)


@pytest.mark.cuda
def test_cuda_matmul_schedules_analytic_corner_case(cuda_device):
    a, b = analytic_operands(cuda_device)
    exact = a.double() @ b.double()
    outs = [ms.matmul_sweep(a, b, t) for t in ms.SWEEP_TILES]
    outs += [ms.matmul_row_strip(a, b, h) for h in ms.STRIP_HEIGHTS]
    outs += [ms.matmul_pipelined(a, b, t, s) for t in ms.PIPELINED_TILES
             for s in ms.STAGES]
    for got in outs:
        assert torch.equal(got.double(), exact)


def assert_mma_within_bound(got, a, b, mode):
    """E4 against its twin within K 2^-22 (|A^| @ |B^|) and within a
    quarter of the unrounded inputs' reading of it (raises past either);
    returns the largest |diff| / bound."""
    return bs.mma_readings(got, ms.matmul_mma_plain(a, b, mode), a, b, mode,
                           f"E4 {mode} {tuple(a.shape)} @ {tuple(b.shape)}")[1]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "bf16in"])
@pytest.mark.parametrize("m,k,n", SCHEDULE_SHAPES)
def test_cuda_matmul_mma_within_bound(cuda_device, m, k, n, mode):
    a, b = matmul_operands(m, k, n, torch.float32, cuda_device, seed=k)
    before = ms.launches["matmul_mma"]
    assert_mma_within_bound(ms.matmul_mma(a, b, mode), a, b, mode)
    assert ms.launches["matmul_mma"] == before + 1
    # "f32" is B6's tiled kernel, counted as its launch
    tiled = pm.launches["matmul_tiled"]
    assert torch.equal(ms.matmul_mma(a, b, "f32"), pm.matmul_plain(a, b))
    assert pm.launches["matmul_tiled"] == tiled + 1


@pytest.mark.cuda
def test_cuda_matmul_schedules_raise(cuda_device):
    dev = cuda_device
    assert ms.smem_optin_bytes(dev) >= 48 * 1024
    a, b = matmul_operands(16, 4096, 8, torch.float32, dev)
    ms.matmul_row_strip(a, b, 8)  # 8 x 4096 f32 fits
    with pytest.raises(ValueError, match="shared memory"):
        ms.matmul_row_strip(a, b, 16)
    a, b = matmul_operands(8, 30, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        ms.matmul_pipelined(a, b)
    a, b = matmul_operands(8, 32, 8, torch.float32, dev)
    shifted = torch.zeros(8 * 32 + 1, device=dev)[1:].view(8, 32)  # +4 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        ms.matmul_pipelined(shifted, b)
    with pytest.raises(ValueError, match="no tile"):
        ms.matmul_sweep(a, b, (32, 32, 8))
    with pytest.raises(TypeError, match="float32"):
        ms.matmul_mma(a.bfloat16(), b.bfloat16())
    empty = ms.matmul_sweep(a[:0], b)
    assert empty.shape == (0, 8)
