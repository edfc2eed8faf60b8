"""Card-only tests: the CUDA kernels against their plain twins, and the
port engine on the GPU against the host oracle.

Every test here needs a CUDA device and skips elsewhere.  The file
imports no JAX, so it also runs on a machine without it:
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from bm25_tpu_torch import (DenseEngine, ReferenceEngine, Session,
                            create_engine)
from bm25_tpu_torch.bench import BenchConfig, make_synthetic_index
from bm25_tpu_torch.ops import ell_score as port
from bm25_tpu_torch.ops import gather_rows as gr
from bm25_tpu_torch.ops import topk as tk
from bm25_tpu_torch.utils.counts import split_bf16
from bm25_tpu_torch.utils.parity import assert_matches_oracle

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
