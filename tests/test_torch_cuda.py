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

# q, t, rows, l_pad, vocab, h, pad_rows, weighted[, kind] (kind: see
# make_case)
CASES = {
    "no_hot": (12, 5, 512, 16, 60, 0, 0, False),
    "hot": (12, 5, 1024, 16, 60, 16, 0, False),
    "pad_rows_oov_ragged_q_hot": (13, 8, 512, 24, 80, 24, 9, False),
    "wide_slot_tiled": (9, 3, 512, 1208, 4000, 0, 5, False),
    "wide_slot_tiled_hot": (9, 3, 512, 1208, 4000, 8, 5, False),
    "hot_only": (7, 8, 1024, 0, 50, 32, 100, False),
    "weighted": (13, 8, 512, 24, 80, 0, 9, True),
    "weighted_hot_split_counts": (13, 8, 512, 24, 80, 24, 9, True),
    # the lookup tables' cases: B2's shape over three tables; wide queries
    # (32 and 4 queries a table); a token in every query; ids past 16
    # bits; negative values; zero weights; ragged last doc tile (1,000
    # rows) and query table (300 = 2 x 128 + 44); 1,208 / 1,536 slots
    "one_token_distinct_ids": (300, 1, 512, 24, 400, 0, 0, False,
                               "distinct"),
    "wide_queries_t64": (40, 64, 512, 24, 300, 0, 5, False, "hits"),
    "wide_queries_t300_weighted": (12, 300, 512, 24, 2000, 0, 5, True,
                                   "hits"),
    "fan_out_shared_token": (140, 8, 512, 24, 300, 0, 5, False, "shared"),
    "fan_out_shared_token_weighted": (140, 8, 512, 24, 300, 0, 5, True,
                                      "shared"),
    "ids_above_65535": (13, 8, 512, 24, 100000, 0, 9, False, "hits"),
    "negative_values": (13, 8, 512, 24, 80, 0, 9, False, "negative"),
    "zero_weights": (13, 8, 512, 24, 80, 0, 9, True, "zero_weights"),
    "ragged_tiles": (300, 8, 1000, 24, 300, 0, 5, False, "hits"),
    "ragged_tiles_weighted_hot": (300, 8, 1000, 24, 300, 40, 5, True,
                                  "hits"),
    "slot_tiled_1208_hits": (140, 4, 1024, 1208, 6000, 0, 5, False, "hits"),
    "slot_tiled_1536_hits_weighted": (40, 4, 512, 1536, 6000, 0, 5, True,
                                      "hits"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_ids(rng, q, t, vocab, tokT, kind):
    """Query ids (pad, OOV and duplicate ids) for a bucket; kind:
    "distinct" one distinct id a query (B2's build); "hits" half the ids
    drawn from the bucket's tokens; "shared" a token in every query (put
    in half the rows of slot 0 by make_case)."""
    ids = rng.integers(-1, vocab + 20, (q, t)).astype(np.int32)
    if kind == "distinct":
        return rng.permutation(vocab)[:q].reshape(q, 1).astype(np.int32)
    if kind == "hits":
        present = tokT[tokT >= 0]
        pick = rng.random((q, t)) < 0.5
        ids[pick] = rng.choice(present, int(pick.sum()))
    elif kind == "shared":
        ids[:, 2] = vocab + 7
    ids[0] = -1
    if t >= 3:
        ids[1, :3] = ids[1, 0]
    return ids


def make_case(seed, q, t, rows, l_pad, vocab, h, pad_rows, weighted, dev,
              kind=None):
    rng = np.random.default_rng(seed)
    fill = rng.integers(0, l_pad + 1, rows)
    tokT = np.full((l_pad, rows), -1, np.int32)
    valT = np.zeros((l_pad, rows), np.float32)
    for r in range(rows):
        tokT[: fill[r], r] = rng.choice(vocab, fill[r], replace=False)
        valT[: fill[r], r] = rng.standard_normal(fill[r]).astype(np.float32)
    if kind == "shared":
        tokT[0, ::2] = vocab + 7
        valT[0, ::2] = rng.standard_normal(len(valT[0, ::2]))
    elif kind == "negative":
        valT = -np.abs(valT)
    ids = make_ids(rng, q, t, vocab, tokT, kind)
    did = np.arange(rows, dtype=np.int32)
    if pad_rows:
        did[-pad_rows:] = -1
    w = rng.uniform(0.0, 3.0, (q, t)).astype(np.float32)
    if kind == "zero_weights":
        w[:, ::2] = 0.0
        w[2] = 0.0

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


def case_args(seed, name, dev):
    q, t, rows, l_pad, vocab, h, pad_rows, weighted, *kind = CASES[name]
    return make_case(seed, q, t, rows, l_pad, vocab, h, pad_rows, weighted,
                     dev, *kind)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernels_match_plain_twins(cuda_device, name):
    q, t, rows, l_pad, vocab, h, pad_rows, weighted, *_ = CASES[name]
    args, kw = case_args(4, name, cuda_device)
    launched = dict(port.launches)
    base_k, gmax_k = port.ell_score_fused(*args, **kw)
    # the scan runs unless a hot tier scores a bucket with no slots
    scans = int(bool(l_pad or not h))
    assert port.launches["ell_score_fused"] == \
        launched["ell_score_fused"] + 1
    assert port.launches["ell_score_scan"] == \
        launched["ell_score_scan"] + scans
    assert port.launches["ell_score_hot"] == \
        launched["ell_score_hot"] + int(bool(h))
    assert port.launches["ell_table"] == launched["ell_table"] + scans
    base_p, gmax_p = port.ell_score_fused_plain(*args, **kw)
    if not h:
        assert torch.equal(base_k, base_p) and torch.equal(gmax_k, gmax_p)
    else:
        torch.testing.assert_close(base_k, base_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gmax_k, gmax_p, rtol=1e-5, atol=1e-5)
        # the ELL-only base stays bit-equal
        no_hot = {k: v for k, v in kw.items() if k == "weights"}
        assert torch.equal(port.ell_score_fused(*args[:4], **no_hot)[0],
                           port.ell_score_fused_plain(*args[:4],
                                                      **no_hot)[0])
    if l_pad:
        assert torch.equal(port.ell_score(*args[:3]),
                           port.ell_score_plain(*args[:3]))
        assert port.launches["ell_score"] == launched["ell_score"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][3]])
def test_cuda_scan_table_holds_table_pairs(cuda_device, name):
    """The table kernel's tables hold what table_pairs defines (the slot a
    colliding key takes may differ from the twin's), every key reachable by
    linear probing; a table made once serves B1 and B2 alike."""
    args, kw = case_args(7, name, cuda_device)
    ids, w = args[0], kw.get("weights")
    launched = dict(port.launches)
    table = port.scan_table(ids, w)
    assert port.launches["ell_table"] == launched["ell_table"] + 1
    plain = port.scan_table_plain(ids.cpu(), None if w is None else w.cpu())
    assert (table.qp, table.cap_log2, table.weighted) == (
        plain.qp, plain.cap_log2, plain.weighted)
    assert table.words.shape == plain.words.shape
    assert port.table_contents(table) == port.table_contents(plain)
    base, gmax = port.ell_score_fused(*args[:4], weights=w, table=table)
    assert port.launches["ell_table"] == launched["ell_table"] + 1
    want = port.ell_score_fused_plain(*args[:4], weights=w)
    assert torch.equal(base, want[0]) and torch.equal(gmax, want[1])
    if w is None:
        assert torch.equal(port.ell_score(*args[:3], table=table),
                           port.ell_score_plain(*args[:3]))
    else:
        with pytest.raises(ValueError, match="weights"):
            port.ell_score(*args[:3], table=table)


@pytest.mark.cuda
@pytest.mark.parametrize("qp", [port.MAX_TABLE_QUERIES, 32, 4])
@pytest.mark.parametrize("name", ["wide_slot_tiled", "ragged_tiles",
                                  "fan_out_shared_token_weighted",
                                  "wide_queries_t64",
                                  "one_token_distinct_ids"])
def test_cuda_scan_bit_equal_at_every_table_size(cuda_device, name, qp):
    """Both compiled scans (one-token queries and the rest), on tables of
    at most qp queries (more tables a block, ragged last ones), give the
    twin's bits, B1 (mask and maxima) and B2 alike."""
    args, kw = case_args(8, name, cuda_device)
    w = kw.get("weights")
    table = port.scan_table(args[0], w, qp)
    assert table.qp <= qp
    got = port.ell_score_fused(*args[:4], weights=w, table=table)
    want = port.ell_score_fused_plain(*args[:4], weights=w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if w is None:
        assert torch.equal(port.ell_score(*args[:3], table=table),
                           port.ell_score_plain(*args[:3]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1001, 1003, 130, 4097])
def test_cuda_b2_rows_off_a_multiple_of_4(cuda_device, rows):
    """B2 takes any row count: off a multiple of 4 the scan writes a row a
    thread (no 16-byte units)."""
    rng = np.random.default_rng(rows)
    tokT = np.full((12, rows), -1, np.int32)
    valT = np.zeros((12, rows), np.float32)
    for r in range(rows):
        f = rng.integers(0, 13)
        tokT[:f, r] = rng.choice(200, f, replace=False)
        valT[:f, r] = rng.standard_normal(f)
    ids = rng.permutation(200)[:150].reshape(150, 1).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda_device) for x in (ids, tokT, valT)]
    assert torch.equal(port.ell_score(*args), port.ell_score_plain(*args))


# B1's hot epilogue (wgmma over the tokens hot_plan lists): q, t, rows,
# l_pad, h, pad_rows, weighted, which queries count hot tokens
HOT_CASES = {
    "q8_h_off_the_k_step": (8, 8, 1024, 24, 100, 9, False, "random"),
    "q24": (24, 8, 1024, 24, 70, 9, False, "random"),
    "two_query_blocks_every_token": (200, 8, 1024, 16, 130, 0, False,
                                     "every"),
    "queries_with_no_hot_token": (37, 8, 512, 16, 64, 5, False, "half"),
    "no_hot_token_at_all": (20, 8, 512, 16, 64, 5, False, "none"),
    "split_weighted": (40, 8, 1024, 24, 100, 9, True, "random"),
    "hot_only_q8": (8, 8, 1024, 0, 64, 100, False, "random"),
    "ragged_doc_tile": (130, 8, 1000, 24, 40, 3, True, "random"),
    # one accumulator takes the base and every pass: 64 weighted hot
    # tokens a query, split counts, on a block of 256 queries
    "many_hot_tokens_a_query": (300, 64, 512, 16, 256, 3, True, "random"),
    # 16 queries (a block of 16) over a wide tier: many groups unused,
    # the last one partial (ranks past H listed as -1, zero-filled)
    "q16_sparse_groups_h_off_the_group": (16, 2, 1024, 24, 1000, 9, True,
                                          "random"),
}


def within_row_scale(got, want):
    """-inf where the twin has it; elsewhere within 2e-5 x the row's
    largest |value| (at least 1)."""
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.equal(got[~fin], want[~fin])
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(got))
    scale = torch.where(fin, want.abs(), torch.zeros_like(want))
    scale = scale.amax(dim=-1, keepdim=True).clamp_min(1.0)
    assert bool((diff <= 2e-5 * scale).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HOT_CASES))
def test_cuda_hot_epilogue_within_bound(cuda_device, name):
    q, t, rows, l_pad, h, pad_rows, weighted, which = HOT_CASES[name]
    args, kw = make_case(5, q, t, rows, l_pad, 300, h, pad_rows, weighted,
                         cuda_device)
    hc = args[4].float()
    if which == "every":
        tok = torch.arange(h, device=cuda_device)
        hc[:] = 0
        hc[tok % q, tok] = 2.0
    elif which == "half":
        hc[::2] = 0
    elif which == "none":
        hc[:] = 0
    args[4] = hc.bfloat16()
    if "hot_counts_lo" in kw and which == "none":
        kw["hot_counts_lo"] = torch.zeros_like(kw["hot_counts_lo"])
    plan = port.hot_plan(args[4], kw.get("hot_counts_lo"))
    used = (hc != 0).any(0)
    if "hot_counts_lo" in kw:
        used |= (kw["hot_counts_lo"] != 0).any(0)
    # whole groups of 16 ranks: every group holding a used token
    g = port.HOT_GROUP
    groups = torch.nn.functional.pad(used, (0, -h % g)).reshape(-1, g)
    assert int(plan.n_used.item()) == g * int(groups.any(1).sum())
    launched = dict(port.launches)
    base_k, gmax_k = port.ell_score_fused(*args, **kw, plan=plan)
    torch.cuda.synchronize()
    assert port.launches["ell_score_hot"] == launched["ell_score_hot"] + 1
    base_p, gmax_p = port.ell_score_fused_plain(*args, **kw)
    within_row_scale(base_k, base_p)
    within_row_scale(gmax_k, gmax_p)
    # the plan made inside the wrapper gives the same bits
    again, _ = port.ell_score_fused(*args, **kw)
    assert torch.equal(again, base_k)
    # the ELL-only base stays bit-equal
    no_hot = {k: v for k, v in kw.items() if k == "weights"}
    assert torch.equal(port.ell_score_fused(*args[:4], **no_hot)[0],
                       port.ell_score_fused_plain(*args[:4], **no_hot)[0])


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


# (l_pad, h, weighted): B1 with doc ids -1 where a doc mask folds in
MASKED_B1 = {
    "ell_only": (24, 0, False),
    "hot": (24, 40, False),
    "hot_weighted": (24, 40, True),
    "slot_tiled_hot": (1208, 8, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MASKED_B1))
def test_cuda_masked_b1_matches_twin(cuda_device, name):
    """Rows a doc mask drops (doc id -1: a whole group of 8, and scattered
    rows) come out -inf after the scan and the hot epilogue, not -inf + x;
    a group whose 8 rows are all dropped has a -inf maximum."""
    l_pad, h, weighted = MASKED_B1[name]
    args, kw = make_case(6, 37, 6, 1024, l_pad, 4000 if l_pad > 512 else
                         300, h, 0, weighted, cuda_device)
    did = args[3].clone()
    did[8:16] = -1
    did[torch.arange(1024, device=cuda_device) % 7 == 3] = -1
    args[3] = did
    base, gmax = port.ell_score_fused(*args, **kw)
    want_b, want_g = port.ell_score_fused_plain(*args, **kw)
    dropped = did < 0
    assert bool(torch.isneginf(base[:, dropped]).all())
    assert bool(torch.isneginf(gmax[:, 1]).all())
    assert bool(torch.isfinite(base[:, ~dropped]).all())
    if h:
        within_row_scale(base, want_b)
        within_row_scale(gmax, want_g)
    else:
        assert torch.equal(base, want_b) and torch.equal(gmax, want_g)


def sparse_engine_on_card():
    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    engine = create_engine(index, mode="sparse", session=Session("cuda"),
                           hot_tokens=64, hot_budget_bytes=1 << 24,
                           max_buckets=2)
    return index, engine


@pytest.mark.cuda
def test_cuda_masked_search_matches_oracle(cuda_device):
    """A random mask, one that leaves fewer than k docs eligible (doc -1 /
    score 0 exactly in the shortfall), and a mask tensor on the card."""
    index, engine = sparse_engine_on_card()
    ref = ReferenceEngine.from_scored_index(index)
    rng = np.random.default_rng(1)
    q = rng.integers(-1, 2000, (40, 8))
    few = np.zeros(index.num_docs, bool)
    few[rng.choice(index.num_docs, 300, replace=False)] = True
    few[:8] = True  # a whole group of 8 eligible, the next dropped
    for mask in (rng.random(index.num_docs) < 0.3, few):
        for k in (10, 1000):
            got = engine.search(q, top_k=k, doc_mask=mask)
            want = ref.search(q, top_k=k, doc_mask=mask)
            assert_matches_oracle(*got, *want)
            short = want[0] < 0
            assert np.array_equal(got[0][short], want[0][short])
            assert (got[1][short] == 0).all()
            dev_mask = torch.from_numpy(mask).to(cuda_device)
            again = engine.search(q, top_k=k, doc_mask=dev_mask)
            assert np.array_equal(again[0], got[0])
            assert np.array_equal(again[1], got[1])
    assert (engine.search(q, top_k=1000, doc_mask=few)[0] < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["auto", False])
def test_cuda_search_pipelined_syncs_only_on_its_events(cuda_device, route):
    """One pipelined call (weights, a mask on the card, ids only too) runs
    under set_sync_debug_mode("error"): nothing on the step's path syncs
    the host, with cold-width routing (the default, which routes these
    128-query batches) and without; it equals the serial search of each
    batch, ids and scores (a chunk's hot plan lists the hot tokens its
    own queries use, so the hot products' order, and the last bits,
    follow the chunking)."""
    index, engine = sparse_engine_on_card()
    engine.route_cold = route
    rng = np.random.default_rng(2)
    q = rng.integers(-1, 2000, (300, 8))
    w = rng.uniform(0.1, 3.0, q.shape).astype(np.float32)
    mask = torch.from_numpy(rng.random(index.num_docs) < 0.5).to(
        cuda_device)

    def serial(**kw):
        parts = [engine.search(q[i : i + 128], top_k=100,
                               **{n: (v[i : i + 128] if n == "weights"
                                      else v) for n, v in kw.items()})
                 for i in range(0, len(q), 128)]
        return tuple(np.concatenate(x) for x in zip(*parts))

    want = serial()
    want_m = serial(weights=w, doc_mask=mask)
    assert (engine.plan_chunks(q[:128])[0] is not None) == (route == "auto")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = engine.search_pipelined(q, top_k=100, batch=128)
        got_m = engine.search_pipelined(q, top_k=100, batch=128, weights=w,
                                        doc_mask=mask)
        ids = engine.search_pipelined(q, top_k=100, batch=128, ids_only=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, x in ((got, want), (got_m, want_m)):
        assert np.array_equal(g[0], x[0]) and np.array_equal(g[1], x[1])
    assert np.array_equal(ids, want[0])
    assert np.array_equal(engine.search_ids(q[:128], top_k=100),
                          want[0][:128])


@pytest.mark.cuda
def test_cuda_dedup_search_matches_oracle(cuda_device):
    """64-token queries with duplicates, dedup on, off and "auto"."""
    index, engine = sparse_engine_on_card()
    ref = ReferenceEngine.from_scored_index(index)
    rng = np.random.default_rng(3)
    pool = rng.integers(0, 2000, (24, 10))
    q = np.take_along_axis(pool, rng.integers(0, 10, (24, 64)), axis=1)
    want = ref.search(q, top_k=100)
    for mode in (True, False, "auto"):
        engine.dedup_queries = mode
        assert_matches_oracle(*engine.search(q, top_k=100), *want)


def alone_and_in_chunks(engine, q, k, kw, rows=(0, 1, 7, 200, 511)):
    """Each of ``rows`` searched alone (a chunk of 8: 16 queries a hot
    block), and the 16-query runs holding them searched as chunks of 16:
    ids and scores bit-equal to their rows of the whole batch."""
    batch = engine.search(q, top_k=k, **kw)
    for i in rows:
        one = engine.search(q[i : i + 1], top_k=k, **{
            n: v[i : i + 1] for n, v in kw.items()})
        assert np.array_equal(one[0][0], batch[0][i])
        assert np.array_equal(one[1][0], batch[1][i])
        s = i // 16 * 16
        run = engine.search(q[s : s + 16], top_k=k, **{
            n: v[s : s + 16] for n, v in kw.items()})
        assert np.array_equal(run[0], batch[0][s : s + 16])
        assert np.array_equal(run[1], batch[1][s : s + 16])
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_hot_kernel_rows_do_not_depend_on_chunk_mates(cuda_device,
                                                          weighted):
    """B1 with a 1,024-rank hot tier over Zipf hot ids: each query's base
    and maxima alone (a block of 16), in runs of 16 and of 8, and in the
    300-query chunk (blocks of 128) are bit-equal, each chunk with its
    own plan and tables."""
    from bm25_tpu_torch.models.sparse import hot_counts_for

    args, kw = make_case(8, 300, 8, 1024, 24, 300, 1024, 9, weighted,
                         cuda_device)
    rng = np.random.default_rng(8)
    hot_ids = np.minimum(rng.zipf(1.2, (300, 8)) - 1, 1023).astype(np.int32)
    hot_ids[rng.random(hot_ids.shape) < 0.2] = -1
    w = kw.get("weights")
    hc, hlo = hot_counts_for(torch.from_numpy(hot_ids).to(cuda_device),
                             torch.arange(1024, dtype=torch.int32,
                                          device=cuda_device), 1024, w)
    args[4] = hc
    if weighted:
        kw["hot_counts_lo"] = hlo

    def rows(a, b):
        sub = [x[a:b].contiguous() for x in args[:1]] + args[1:4] + \
            [args[4][a:b].contiguous()] + args[5:]
        return port.ell_score_fused(*sub, **{
            n: v[a:b].contiguous() for n, v in kw.items()})

    base, gmax = rows(0, 300)
    assert torch.isfinite(base[:, :-9]).all()
    for a, b in [(i, i + 1) for i in (0, 5, 137, 299)] + [
            (0, 16), (16, 32), (280, 296), (8, 16), (292, 300)]:
        got = rows(a, b)
        assert torch.equal(got[0], base[a:b]) and torch.equal(got[1],
                                                              gmax[a:b])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 100, 1000])
def test_cuda_hot_sums_do_not_depend_on_chunk_mates(cuda_device, k):
    """A query alone, in a chunk of 16 and inside a 512-query batch
    (routed: "auto" engages): bit-equal ids and scores, unweighted and
    weighted.  The hot plan lists whole aligned groups of 16 ranks, so a
    query's hot products meet the same lanes of the same k16 steps of
    the hot kernel whatever its chunk-mates, and the query-block width
    (16 or 128) changes no bit."""
    index, engine = sparse_engine_on_card()
    rng = np.random.default_rng(4)
    q = rng.integers(-1, 2000, (512, 8))
    w = rng.uniform(0.1, 3.0, q.shape).astype(np.float32)
    assert engine.plan_chunks(q, k=k)[0] is not None
    for kw in ({}, {"weights": w}):
        alone_and_in_chunks(engine, q, k, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 1000])
def test_cuda_sharded_hot_sums_do_not_depend_on_chunk_mates(cuda_device,
                                                            k):
    """The same on a (1, 4) ShardedSparseEngine over the one card at
    h=64: each shard plans its own hot groups a chunk."""
    from bm25_tpu_torch import ShardedSparseEngine
    from bm25_tpu_torch.parallel import make_mesh

    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    engine = ShardedSparseEngine.from_scored_index(
        index, mesh=mesh, hot_tokens=64, hot_budget_bytes=1 << 30,
        max_buckets=2)
    rng = np.random.default_rng(5)
    q = rng.integers(-1, 2000, (512, 8))
    w = rng.uniform(0.1, 3.0, q.shape).astype(np.float32)
    for kw in ({}, {"weights": w}):
        alone_and_in_chunks(engine, q, k, kw, rows=(0, 3, 300, 511))


@pytest.mark.cuda
def test_cuda_weighted_counts_add_in_t_order(cuda_device):
    """weighted_counts on the card: the CPU's bits (an id's weights added
    from +0 in t order, as JAX's scatter-add), run after run, on weights
    whose sum depends on that order (1e8 + 1 - 1e8), in rows alone and
    in a batch."""
    from bm25_tpu_torch.utils.counts import weighted_counts

    rng = np.random.default_rng(6)
    ids = rng.integers(-1, 6, (4096, 16)).astype(np.int32)
    w = rng.choice(np.array([1e8, 1.0, -1e8, 0.5, 3.0], np.float32),
                   ids.shape)
    want = weighted_counts(torch.from_numpy(ids), torch.from_numpy(w), 6)
    ids_c, w_c = torch.from_numpy(ids).to(cuda_device), \
        torch.from_numpy(w).to(cuda_device)
    for _ in range(3):
        got = weighted_counts(ids_c, w_c, 6).cpu()
        assert torch.equal(got, want)
    for i in (0, 1, 4095):
        one = weighted_counts(ids_c[i : i + 1], w_c[i : i + 1], 6).cpu()
        assert torch.equal(one[0], want[i])


# -- cold-width routing and union selection ---------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("t_c", [2, 4, 64])
def test_cuda_routed_b1_matches_twin(cuda_device, t_c):
    """B1 on a routed chunk: the scan reads (Q, T_c) cold ids (2 and 4
    take the 128-query tables of the (128, 8, 4) build), the hot epilogue
    the counts of the full ids; a row with no cold id is all -1 pads.
    The ELL-only base bit-equal to the twin, the fused base and maxima
    within 2e-5 x the row's largest |score|."""
    from bm25_tpu_torch.bench.layout_sweep import routed_rows
    from bm25_tpu_torch.models.sparse import hot_counts_for
    from bm25_tpu_torch.utils.padding import next_pow2_at_least

    index, engine = sparse_engine_on_card()
    full, cold = routed_rows(index, engine.hot_table_host, 200, t_c,
                             seed=t_c)
    cold[0] = -1
    width = next_pow2_at_least(max(full.shape[1], 8))
    full = np.pad(full, ((0, 0), (0, width - full.shape[1])),
                  constant_values=-1)
    ids, cids = engine.session.put(full), engine.session.put(cold)
    hc, hlo = hot_counts_for(ids, engine.hot_table, engine.hot_h)
    plan, table = port.hot_plan(hc, hlo), port.scan_table(cids)
    assert table.qp == (128 if t_c <= 4 else table.qp)
    for b in engine.buckets:
        args = (cids, b["tokT"], b["valT"], b["doc_ids"])
        assert torch.equal(port.ell_score_fused(*args, table=table)[0],
                           port.ell_score_fused_plain(*args)[0])
        hot = (hc, b["hotT"], b["hotLo"])
        got = port.ell_score_fused(*args, *hot, hot_counts_lo=hlo,
                                   plan=plan, table=table)
        want = port.ell_score_fused_plain(*args, *hot, hot_counts_lo=hlo)
        within_row_scale(got[0], want[0])
        within_row_scale(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 1000])
def test_cuda_routed_matches_unrouted(cuda_device, k):
    """A 512-query batch routed ("auto" engages) and not: both the
    oracle's under the comparator, and bit-equal to each other (a query's
    hot sums do not depend on its chunk-mates); plain and weighted."""
    index, engine = sparse_engine_on_card()
    ref = ReferenceEngine.from_scored_index(index)
    rng = np.random.default_rng(11)
    q = rng.integers(-1, 2000, (512, 8))
    q[0] = -1
    w = rng.uniform(0.1, 3.0, q.shape).astype(np.float32)
    assert engine.plan_chunks(q, k=k)[0] is not None
    for kw in ({}, {"weights": w}):
        routed = engine.search(q, top_k=k, **kw)
        engine.route_cold = False
        unrouted = engine.search(q, top_k=k, **kw)
        engine.route_cold = "auto"
        assert_matches_oracle(*routed, *ref.search(q, top_k=k, **kw))
        assert np.array_equal(routed[0], unrouted[0])
        assert np.array_equal(routed[1], unrouted[1])


@pytest.mark.cuda
def test_cuda_union_selection_bit_equal_and_tied_fallback(cuda_device):
    """Union selection on the card: bit-equal to the per-bucket path over
    four buckets at k=10 and 1000, through search and through the step
    itself; on an all-tied corpus over two buckets the flag trips and the
    fallback returns doc ids 0..9."""
    from bm25_tpu_torch.models.sparse import (SparseEngine,
                                              make_sparse_query_step)
    from bm25_tpu_torch.scoring import build_scored_index

    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    engine = create_engine(index, mode="sparse", session=Session("cuda"),
                           hot_tokens=64, hot_budget_bytes=1 << 24,
                           max_buckets=4)
    assert len(engine.buckets) == 4
    q = np.random.default_rng(12).integers(-1, 2000, (64, 8))
    for k in (10, 1000):
        per = engine.search(q, top_k=k)
        engine.union_select = True
        uni = engine.search(q, top_k=k)
        engine.union_select = False
        np.testing.assert_array_equal(uni[0], per[0])
        np.testing.assert_array_equal(uni[1], per[1])
        ids = engine.session.put(engine.plan_chunks(q)[1][0].padded)
        args = (ids, engine.buckets, engine.offsets, engine.hot_table)
        a = make_sparse_query_step(k, engine.hot_h)(*args)
        b = make_sparse_query_step(k, engine.hot_h,
                                   union_select=True)(*args)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    tied = build_scored_index([np.array([0, 1], np.int32)] * 2048,
                              vocab_size=4)
    te = SparseEngine.from_scored_index(tied, session=Session("cuda"),
                                        max_buckets=2)
    assert len(te.buckets) == 2
    te.union_select = True
    d, s = te.search(np.array([[0, 1]], np.int32), top_k=10)
    np.testing.assert_array_equal(d[0], np.arange(10))
    assert len(set(s[0].tolist())) == 1


def three_tier_index():
    """The card tests' corpus and a tail_cap at its median nonzero DF:
    hot, ELL and tail all hold postings."""
    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    df = index.df()
    return index, int(np.median(df[df > 0]))


@pytest.mark.cuda
def test_cuda_three_tier_engine_matches_cpu_and_oracle(cuda_device):
    """Hot + ELL + tail on the card against the same engine on the CPU
    (the kernels' twins, the same tail ops) and the oracle: plain,
    weighted and masked, at k = 10 and 1000; the tail arrays equal."""
    index, cap = three_tier_index()
    kw = dict(mode="sparse", hot_tokens=16, hot_budget_bytes=1 << 24,
              max_buckets=2, tail_cap=cap)
    card = create_engine(index, session=Session("cuda"), **kw)
    cpu = create_engine(index, session=Session("cpu"), **kw)
    assert card.tail_docs is not None and card.hot_h == 16
    assert any("tokT" in b for b in card.buckets)
    for key in ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
                "tail_gpos"):
        assert torch.equal(getattr(card, key).cpu(), getattr(cpu, key))
    ref = ReferenceEngine.from_scored_index(index)
    rng = np.random.default_rng(6)
    q = rng.integers(-1, 2000, (64, 8))
    q[0] = -1
    q[1, :3] = q[1, 0]
    w = rng.uniform(0.1, 3.0, q.shape).astype(np.float32)
    mask = rng.random(index.num_docs) < 0.3
    launched = dict(port.launches)
    for extra in ({}, {"weights": w}, {"doc_mask": mask}):
        for k in (10, 1000):
            got = card.search(q, top_k=k, **extra)
            assert_matches_oracle(*got, *cpu.search(q, top_k=k, **extra))
            assert_matches_oracle(*got, *ref.search(q, top_k=k, **extra))
    assert port.launches["ell_score_fused"] > launched["ell_score_fused"]


@pytest.mark.cuda
def test_cuda_auto_layout_matches_oracle(cuda_device):
    """The default build (hot_tokens="auto" at the chosen bucket count)
    on the card against the oracle."""
    from bm25_tpu_torch.models.sparse import choose_layout

    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    session = Session("cuda")
    layout = choose_layout(index, k=100, device=session.device)
    engine = create_engine(index, mode="sparse", session=session,
                           max_buckets=layout["max_buckets"])
    assert engine.hot_h == layout["hot_tokens"]
    ref = ReferenceEngine.from_scored_index(index)
    q = np.random.default_rng(8).integers(-1, 2000, (40, 8))
    for k in (10, 100):
        assert_matches_oracle(*engine.search(q, top_k=k),
                              *ref.search(q, top_k=k))


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


# -- B4 top-k (radix select) ----------------------------------------------------


def topk_input(b, n, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 6, (b, n)).astype(np.float32)  # heavy ties
    x[0] = -np.inf  # exhausted row
    if b > 1:
        x[1, ::3] = -np.inf
    if b > 2:
        x[2, : n // 2] = -np.inf
    return torch.from_numpy(x).to(dev)


# b, n, k: one block, ragged rows, k == n, k = 1, a wide shared-memory
# sort, rows split over blocks, k beyond the shared-memory sort
TOPK_CASES = [(5, 100, 7), (4, 16384, 100), (4, 16385, 64), (3, 40000, 16),
              (6, 131072, 1000), (3, 300, 300), (2, 50000, 1),
              (3, 131072, 7300), (8, 524288, 100), (2, 524288, 20000)]


def assert_same_bits(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


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
@pytest.mark.parametrize("side_max", [None, 0, 64])
def test_cuda_topk_split_rows_and_side_buffer(cuda_device, side_max,
                                              monkeypatch):
    """Few rows, each split over several blocks, with the side buffer at
    its default, off, and too small for any row."""
    if side_max is not None:
        monkeypatch.setattr(tk, "SIDE_MAX", side_max)
    x = topk_input(8, 524288, 3, cuda_device)
    x[3] = torch.rand(524288, device=cuda_device)
    x[4] = 1 + 0.25 * torch.rand(524288, device=cuda_device)  # one digit
    assert tk.radix_slices(8, 524288, 132)[0] > 1
    for k in (1, 100, 5000):
        got = tk.top_k_two_stage(x, k)
        assert_same_bits(got, tk.topk_two_stage_plain(x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [tk.SORT_SMEM_KEYS + 1, 32768])
def test_cuda_topk_global_sort_beyond_shared_memory(cuda_device, k):
    x = topk_input(3, 524288, k, cuda_device)
    x[1] = torch.rand(524288, device=cuda_device)
    v, i = tk.top_k_two_stage(x, k)
    assert_same_bits((v, i), tk.topk_two_stage_plain(x, k))
    assert torch.equal(i, tk.top_k_tree(x, k)[1])


@pytest.mark.cuda
def test_cuda_topk_equal_rows_and_special_values(cuda_device):
    """All-equal rows (every key is T), and +-0 / NaN / +-inf: -0 stays -0
    and NaN ranks largest, as in the twin."""
    x = torch.full((3, 70001), 2.5, device=cuda_device)
    for k in (1, 777, 70001 // 16):
        assert_same_bits(tk.top_k_two_stage(x, k),
                         tk.topk_two_stage_plain(x, k))
    vals = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                         float("-inf"), 1.0, -1.0], device=cuda_device)
    x = vals[torch.from_numpy(np.random.default_rng(5).integers(
        0, 7, (4, 3001))).to(cuda_device)]
    for k in (1, 50, 3001):
        assert_same_bits(tk.top_k_two_stage(x, k),
                         tk.topk_two_stage_plain(x, k))


@pytest.mark.cuda
def test_cuda_topk_rows_beyond_one_launch(cuda_device):
    """More rows than one launch takes (ROW_CHUNK): the rest go in a second
    launch at their row offset, with one count for the call."""
    x = topk_input(tk.ROW_CHUNK + 3, 700, 9, cuda_device)
    x[-1] = torch.rand(700, device=cuda_device)
    before = tk.launches["top_k_two_stage"]
    got = tk.top_k_two_stage(x, 50)
    assert tk.launches["top_k_two_stage"] == before + 1
    assert_same_bits(got, tk.topk_two_stage_plain(x, 50))


@pytest.mark.cuda
def test_cuda_topk_largest_false_and_k_beyond_one_block(cuda_device):
    x = topk_input(3, 40000, 1, cuda_device)
    v, i = tk.top_k(x, 50, largest=False, implementation="pallas")
    tv, ti = tk.top_k(x, 50, largest=False, implementation="tree")
    assert torch.equal(v, tv) and torch.equal(i, ti)
    # k wider than JAX's chunk (13,440 of 40,000): the tree, counted
    assert not tk.kernel_serves(40000, 14000)
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


# the three layouts at each shape: the wrapper's pick, and each forced
LAYOUTS = {"warp": tk.WARP_PLAN,
           "block": tk.ChoicePlan("block", 1024, 1),
           "cluster": tk.ChoicePlan("cluster", 1024, 8),
           "cluster2": tk.ChoicePlan("cluster", 1024, 2)}
B5_SHAPES = [(512, 100), (512, 1000), (64, 32768), (8, 131072), (13, 50001)]


def nan_rows(device):
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (6, 37)).astype(np.float32))
    x[0] = float("nan")
    x[1, [7, 20]] = float("nan")
    x[2, -1] = float("nan")
    x[3] = float("-inf")
    x[4, :30] = float("-inf")
    x[4, [31, 33]] = float("nan")
    x[5, 0] = float("nan")
    return x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [None, *LAYOUTS])
def test_cuda_gumbel_choice_nan_rows(cuda_device, layout):
    """NaN ranks above every number, the first NaN column wins, and no
    column >= k is written, in every layout."""
    x = nan_rows(cuda_device)
    for seed in (0, 1, 2**32 - 1):
        got = tk._gumbel_launch(x, seed, plan=LAYOUTS.get(layout))
        assert got.tolist() == [0, 7, 36, 0, 31, 0]
        assert torch.equal(got, tk.gumbel_choice_plain(x, seed))
    wide = torch.full((3, 50001), float("nan"), device=cuda_device)
    wide[1, 40000] = 1.0
    wide[2] = float("-inf")
    wide[2, 49999] = float("nan")
    got = tk._gumbel_launch(wide, 5, plan=LAYOUTS.get(layout))
    assert got.tolist() == [0, 0, 49999]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [None, *LAYOUTS])
@pytest.mark.parametrize("b,k", B5_SHAPES)
def test_cuda_gumbel_choice_layouts_match_twin(cuda_device, b, k, layout):
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, k)).astype(np.float32)).to(cuda_device)
    logits[0, k // 2:] = float("-inf")
    plan = LAYOUTS.get(layout)
    before = tk.launches["gumbel_choice"]
    for seed in (0, 1, 2**32 - 1):
        got = tk._gumbel_launch(logits, seed, plan=plan)
        assert torch.equal(got, tk._gumbel_launch(logits, seed, plan=plan))
        assert_choices_agree(logits, seed, got,
                             tk.gumbel_choice_plain(logits, seed))
        assert int(got[0]) < k // 2
    assert tk.launches["gumbel_choice"] == before + 6


def edge_columns(k):
    """Columns at the edges of what a lane, a warp, a block or a cluster's
    block reads in any layout: the row's ends, a lane's 4-column runs, the
    strides of 32-1,024 lanes, and the slices of clusters of 2-8."""
    cols = {0, 1, 2, 3, 4, 5, 31, 32, 33, k - 5, k - 4, k - 3, k - 2, k - 1}
    for lanes in (32, 64, 128, 256, 1024):
        cols |= {4 * lanes - 1, 4 * lanes, 4 * lanes + 1}
    for c in (2, 4, 8):
        s = -(-k // (4 * c)) * 4
        for p in range(1, c):
            cols |= {p * s - 1, p * s, p * s + 1}
    return sorted(c for c in cols if 0 <= c < k)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [None, *LAYOUTS])
@pytest.mark.parametrize("k", [37, 100, 4099, 50001, 131072])
def test_cuda_gumbel_choice_reads_every_edge_column(cuda_device, k, layout):
    """A row of -inf with one 0 must pick that column, whatever the noise:
    exact in every layout, with the 0 at each edge of a run, a lane's
    stride or a cluster's slice."""
    cols = edge_columns(k)
    x = torch.full((len(cols), k), float("-inf"), device=cuda_device)
    x[torch.arange(len(cols)), torch.tensor(cols)] = 0.0
    for seed in (0, 2**32 - 1):
        got = tk._gumbel_launch(x, seed, plan=LAYOUTS.get(layout))
        assert got.tolist() == cols


@pytest.mark.cuda
def test_cuda_gumbel_choice_reads_a_device_seed(cuda_device):
    logits = torch.randn((64, 32768), device=cuda_device)
    for seed in (0, 77, 2**32 - 1, 2**32 + 5):
        want = tk.gumbel_choice(logits, seed)
        t = torch.tensor([seed], dtype=torch.int64, device=cuda_device)
        assert torch.equal(tk.gumbel_choice(logits, t), want)
        assert torch.equal(tk.gumbel_choice(logits, t.cpu()), want)


def sampled_choice(idxs, sampled):
    """The column of each row's sampled id (top-k ids are distinct)."""
    return (idxs == sampled).float().argmax(dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [None, *LAYOUTS])
def test_cuda_fused_sampling_matches_twin(cuda_device, dtype, layout):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((64, 40000)).astype(
        np.float32) * 3).to(cuda_device, dtype)
    x[5] = float("-inf")
    vals, idxs = tk.top_k(x, 1000, implementation="pallas")
    before = tk.launches["gumbel_choice"]
    for temperature in (1.0, 0.25, 0.0):
        logits = tk._sample_logits(vals, temperature).float()
        for seed in (0, 1, 2**32 - 1):
            if layout is None:
                got = tk.gumbel_sample(vals, idxs, seed, temperature)
            else:
                got = tk._gumbel_launch(logits, seed, idxs,
                                        plan=LAYOUTS[layout])[:, None]
            want = tk.gumbel_sample_plain(vals, idxs, seed, temperature)
            assert int(got[5, 0]) == int(idxs[5, 0])
            assert_choices_agree(logits, seed, sampled_choice(idxs, got),
                                 sampled_choice(idxs, want))
    assert tk.launches["gumbel_choice"] == before + 9


@pytest.mark.cuda
def test_cuda_fused_sampling_per_generator_state_and_no_sync(cuda_device):
    """The sampling call (the tree's top k, as JAX's default, then one B5
    launch) draws, for a generator state, the twin's choices for the seed
    that state gives; a CUDA generator costs no host sync; a fully -inf
    row samples its first top-k id."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (512, 131072)).astype(np.float32)).to(cuda_device)
    x[7] = float("-inf")
    gen = torch.Generator(device=cuda_device)
    for k in (100, 1000):
        gen.manual_seed(k)
        before = dict(tk.launches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            vals, s = tk.top_k_fused_sampling(x, k, temperature=0.7,
                                              implementation="pallas",
                                              generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert tk.launches["gumbel_choice"] == before["gumbel_choice"] + 1
        gen.manual_seed(k)
        seed = int(torch.randint(0, 2**32, (1,), generator=gen,
                                 device=cuda_device).item())
        _, idxs = tk.top_k(x, k)
        want = tk.gumbel_sample_plain(vals, idxs, seed, 0.7)
        assert_choices_agree(tk._sample_logits(vals, 0.7), seed,
                             sampled_choice(idxs, s),
                             sampled_choice(idxs, want))
        assert int(s[7, 0]) == 0


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
    """K and N are whole 16-byte units, A's pointer is not 16-byte
    aligned: the optimized kernel's TMA reads a padded copy, with the same
    bits."""
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
        pm.matmul(a, b, tile_k=16)


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


# B6 optimized, the ring (csrc/matmul_ring.cuh) on a balanced walk:
# (m, k, n) per dtype's K step bk: K = 0, K below the K step, K = 37 bk +
# 3 (the phase bits wrap), M and N below a tile, K and N at 8 j + 4 (bf16
# operands staged), N = 1028 (thin right-edge tiles)
def b6_edge_shapes(bk):
    return [(9, 0, 36), (70, 5, 132), (70, 37 * bk + 3, 132), (3, 40, 8),
            (129, 3, 65), (37, 44, 76), (100, 36, 1028)]


def b6_bits_equal(got, want):
    """Equal bits, NaN only where the twin has NaN (any payload)."""
    nan = torch.isnan(want)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return got.dtype == want.dtype and torch.equal(torch.isnan(got), nan) \
        and torch.equal(got.masked_fill(nan, 0).view(bits),
                        want.masked_fill(nan, 0).view(bits))


def b6_every_plan(a, b, want):
    """B6's ring at every tile of the dtype and every ring depth up to the
    plan's, on the planned grid and on 3 blocks (many tiles a block): the
    twin's bits, one launch each."""
    (m, k), n = a.shape, b.shape[1]
    for tile in pm.TILES[a.dtype]:
        plan = pm.b6_plan(m, n, a.dtype, *tile, pm.sm_count(a.device))
        for stages in range(2, plan.stages + 1):
            for grid in {plan.grid, min(3, plan.grid)}:
                before = pm.launches["matmul_tiled"]
                got = pm._optimized(a, b, plan._replace(stages=stages,
                                                        grid=grid))
                assert pm.launches["matmul_tiled"] == before + 1
                assert b6_bits_equal(got, want), (tile, stages, grid)
                if k == 0:  # +0, not -0
                    assert not got.view(torch.int16 if got.element_size()
                                        == 2 else torch.int32).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", pm.DTYPES)
@pytest.mark.parametrize("case", range(7))
def test_cuda_b6_ring_edges(cuda_device, dtype, case):
    m, k, n = b6_edge_shapes(pm.TILES[dtype][0].k)[case]
    a, b = matmul_operands(m, k, n, dtype, cuda_device, seed=m + k)
    b6_every_plan(a, b, pm.matmul_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", pm.DTYPES)
def test_cuda_b6_ring_views_off_alignment(cuda_device, dtype):
    # views 4 bytes off 16-byte alignment go through a padded copy
    dev, esize = cuda_device, torch.empty((), dtype=dtype).element_size()
    off = 4 // esize
    for m, k, n in ((37, 64, 132), (20, 30, 9)):
        a, b = matmul_operands(m, k, n, dtype, dev, seed=k)
        x = torch.zeros(a.numel() + off, dtype=dtype, device=dev)[off:]
        y = torch.zeros(b.numel() + off, dtype=dtype, device=dev)[off:]
        x, y = x.view(m, k), y.view(k, n)
        x.copy_(a)
        y.copy_(b)
        assert x.data_ptr() % 16 and y.data_ptr() % 16
        b6_every_plan(x, y, pm.matmul_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", pm.DTYPES)
def test_cuda_b6_ring_special_values(cuda_device, dtype):
    a, b = matmul_operands(40, 36, 72, dtype, cuda_device, seed=5)
    a[0], a[1, ::2], a[2, 3] = -0.0, 0.0, float("inf")
    a[3, 7], a[4, :] = float("nan"), -0.0
    b[5, :8], b[6, 9], b[7, 10] = float("-inf"), float("nan"), float("inf")
    b[:, 11] = -0.0
    want = pm.matmul_plain(a, b)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    b6_every_plan(a, b, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", pm.DTYPES)
@pytest.mark.parametrize("m,k,n", [(1028, 64, 1028), (300, 70, 1030),
                                   (1028, 1028, 1028)])
def test_cuda_b6_writes_every_element(cuda_device, dtype, m, k, n):
    # C prefilled with NaN: the walk overwrites every element,
    # with the twin's bits
    a, b = matmul_operands(m, k, n, dtype, cuda_device, seed=n)
    plan = pm.b6_plan(m, n, dtype, sms=pm.sm_count(cuda_device))
    c = torch.full((m, n), float("nan"), dtype=dtype, device=cuda_device)
    assert pm._optimized(a, b, plan, out=c) is c
    assert torch.equal(c, pm.matmul_plain(a, b))


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
    unsorted = rowof.flip(1).contiguous()  # every id gives the gather
    assert torch.equal(srg.super_row_gather_window(x3, unsorted, window),
                       srg.super_row_gather_plain(x3, unsorted))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [32, 48])
@pytest.mark.parametrize("ids", ["same", "distinct", "unsorted", "runs"])
def test_cuda_super_row_gather_window_ring(cuda_device, ids, window):
    """The ring at its edges: KP = 264 and 8 (off a multiple of the block's
    run of 256 slots), one row for every slot, a new row at every slot
    (more than the ring holds), unsorted ids, runs of repeats."""
    r = 600
    for kp in (264, 8):
        x3, rowof = super_row_case(3, r, kp, kp, cuda_device)
        if ids == "same":
            rowof[:] = r - 1
        elif ids == "distinct":
            rowof = torch.arange(kp, device=cuda_device).repeat(3, 1)
        elif ids == "runs":
            rowof = (rowof.sort(dim=1).values // 7 * 7).contiguous()
        rowof = rowof.int().contiguous()
        fb = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        got = srg.super_row_gather_window(x3, rowof, window, fallbacks=fb)
        torch.cuda.synchronize()
        assert torch.equal(got, srg.super_row_gather_plain(x3, rowof))
        assert int(fb.item()) == int(srg.window_fallback_tiles(rowof, r,
                                                               window))


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
    assert torch.equal(ms.matmul_row_strip(a, b), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(5, 100, 300), (1, 1028, 9),
                                   (40, 33, 1030)])
def test_cuda_row_strip_m_below_strip(cuda_device, m, k, n):
    # M below the strip: the warps past M hold no rows but take part in
    # every barrier
    a, b = matmul_operands(m, k, n, torch.float32, cuda_device, seed=n)
    want = pm.matmul_plain(a, b)
    for h in ms.STRIP_HEIGHTS:
        for blocks in (None, 1, 3):
            got = ms.matmul_row_strip(a, b, h, blocks)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (h, blocks)


@pytest.mark.cuda
def test_cuda_row_strip_stages_misaligned_operands(cuda_device):
    # a view 4 bytes off 16-byte alignment, and K or N off a multiple of 4,
    # go through a padded copy: one launch a call, bits unchanged
    dev = cuda_device
    a, b = matmul_operands(37, 64, 132, torch.float32, dev, seed=3)
    shifted_a = torch.zeros(37 * 64 + 1, device=dev)[1:].view(37, 64)
    shifted_a.copy_(a)
    shifted_b = torch.zeros(64 * 132 + 3, device=dev)[3:].view(64, 132)
    shifted_b.copy_(b)
    assert shifted_a.data_ptr() % 16 and shifted_b.data_ptr() % 16
    want = pm.matmul_plain(a, b)
    for x, y in ((shifted_a, b), (a, shifted_b), (shifted_a, shifted_b)):
        for h in ms.STRIP_HEIGHTS:
            before = ms.launches["matmul_row_strip"]
            assert torch.equal(ms.matmul_row_strip(x, y, h), want)
            assert ms.launches["matmul_row_strip"] == before + 1
    a, b = matmul_operands(37, 61, 130, torch.float32, dev, seed=4)
    before = ms.launches["matmul_row_strip"]
    assert torch.equal(ms.matmul_row_strip(a, b), pm.matmul_plain(a, b))
    assert ms.launches["matmul_row_strip"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1028, 2048, 4096])
def test_cuda_row_strip_bit_equal_at_script_sizes(cuda_device, s):
    a, b = matmul_operands(s, s, s, torch.float32, cuda_device, seed=s)
    want = pm.matmul_plain(a, b)
    smem = ms.smem_optin_bytes(cuda_device)
    fitting = [h for h in ms.STRIP_HEIGHTS
               if ms.row_strip_smem_bytes(s, h) <= smem]
    for h in fitting:
        before = ms.launches["matmul_row_strip"]
        got = ms.matmul_row_strip(a, b, h)
        assert ms.launches["matmul_row_strip"] == before + 1
        assert torch.equal(got, want), (s, h)
        if s <= 2048:  # three blocks over 512 strips would take minutes
            assert torch.equal(ms.matmul_row_strip(a, b, h, blocks=3), want)
    # the default: the tallest strip that fits (32, 16, 8)
    assert ms.default_strip(s, smem) == fitting[-1]
    assert torch.equal(ms.matmul_row_strip(a, b), want)


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


def ring_calls():
    """(what, fn(a, b)) for E1 at every sweep tile and E3 at every (tile,
    stages): one ring body, two entry points."""
    calls = [(f"E1 {tuple(t)}", lambda a, b, t=t: ms.matmul_sweep(a, b, t))
             for t in ms.SWEEP_TILES]
    calls += [(f"E3 {tuple(t)} stages {st}",
               lambda a, b, t=t, st=st: ms.matmul_pipelined(a, b, t, st))
              for t in ms.PIPELINED_TILES for st in ms.STAGES]
    return calls


def same_bits(got, want):
    """Equal bits, NaN only where the twin has NaN (any payload)."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got.masked_fill(nan, 0).view(torch.int32),
        want.masked_fill(nan, 0).view(torch.int32))


@pytest.mark.cuda
def test_cuda_matmul_sweep_stages_operands_tma_cannot_read(cuda_device):
    # K or N off a multiple of 4 and views 4 or 12 bytes off alignment go
    # through a padded copy: one launch a call, the twin's bits
    dev = cuda_device
    for m, k, n, off_a, off_b in ((37, 61, 130, 0, 0), (37, 64, 132, 1, 0),
                                  (37, 64, 132, 0, 3), (20, 30, 9, 1, 1)):
        a, b = matmul_operands(m, k, n, torch.float32, dev, seed=k + off_a)
        x = torch.zeros(a.numel() + off_a, device=dev)[off_a:].view(m, k)
        y = torch.zeros(b.numel() + off_b, device=dev)[off_b:].view(k, n)
        x.copy_(a)
        y.copy_(b)
        want = pm.matmul_plain(a, b)
        for t in ms.SWEEP_TILES:
            before = ms.launches["matmul_sweep"]
            got = ms.matmul_sweep(x, y, t)
            assert ms.launches["matmul_sweep"] == before + 1
            assert torch.equal(got, want), (m, k, n, off_a, off_b, t)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(70, 5, 132), (9, 0, 36), (3, 40, 8),
                                   (1, 12, 4), (129, 3, 65), (5, 0, 7)])
def test_cuda_matmul_ring_edges(cuda_device, m, k, n):
    # K below every K step, K = 0 (C is +0), M and N below the tile
    a, b = matmul_operands(m, k, n, torch.float32, cuda_device, seed=m + n)
    want = pm.matmul_plain(a, b)
    for what, fn in ring_calls():
        if what.startswith("E3") and (k % 4 or n % 4):
            continue  # E3 raises there (test_cuda_matmul_schedules_raise)
        got = fn(a, b)
        assert torch.equal(got, want), what
        if k == 0:
            assert (got.view(torch.int32) == 0).all(), what  # +0, not -0


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [8, 16, 32])
def test_cuda_matmul_ring_wraps_its_phase_bits(cuda_device, bk):
    # K = 37 BK + 3: 38 stages, the ring's phase bits wrap many times at
    # every depth, and the last stage is a tail
    k = 37 * bk + 3
    a, b = matmul_operands(70, k, 132, torch.float32, cuda_device, seed=bk)
    want = pm.matmul_plain(a, b)
    for t in (t for t in ms.SWEEP_TILES if t.k == bk):
        assert torch.equal(ms.matmul_sweep(a, b, t), want), t
        for stages in range(2, ms.RING_MAX_STAGES + 1):
            before = ms.launches["matmul_sweep"]
            got = ms._ring("matmul_sweep", a, b, t, stages)
            assert ms.launches["matmul_sweep"] == before + 1
            assert torch.equal(got, want), (t, stages)
    if bk == 16:  # E3 at each of its stage counts, K a multiple of 4
        a, b = matmul_operands(70, k + 1, 132, torch.float32, cuda_device)
        want = pm.matmul_plain(a, b)
        for t in ms.PIPELINED_TILES:
            for stages in ms.STAGES:
                got = ms.matmul_pipelined(a, b, t, stages)
                assert torch.equal(got, want), (t, stages)


@pytest.mark.cuda
def test_cuda_matmul_ring_special_values(cuda_device):
    # +-0, +-inf and NaN in both operands: the twin's bits, NaN where the
    # twin has NaN
    dev = cuda_device
    a, b = matmul_operands(40, 36, 72, torch.float32, dev, seed=5)
    a[0], a[1, ::2], a[2, 3] = -0.0, 0.0, float("inf")
    a[3, 7], a[4, :] = float("nan"), -0.0
    b[5, :8], b[6, 9], b[7, 10] = float("-inf"), float("nan"), float("inf")
    b[:, 11] = -0.0
    want = pm.matmul_plain(a, b)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    for what, fn in ring_calls():
        assert same_bits(fn(a, b), want), what


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
    # "f32" is B6's optimized kernel (the ring), counted as its launch
    tiled = pm.launches["matmul_tiled"]
    assert torch.equal(ms.matmul_mma(a, b, "f32"), pm.matmul_plain(a, b))
    assert pm.launches["matmul_tiled"] == tiled + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "bf16in"])
@pytest.mark.parametrize("m,k,n", SCHEDULE_SHAPES)
def test_cuda_mma_pack_bit_equal(cuda_device, m, k, n, mode):
    a, b = matmul_operands(m, k, n, torch.float32, cuda_device, seed=m)
    before = ms.launches["matmul_mma_pack"]
    ap, bt = ms.mma_pack(a, b, mode)
    torch.cuda.synchronize()
    assert ms.launches["matmul_mma_pack"] == before + 1
    want_a, want_b = ms.mma_pack_plain(a, b, mode)
    assert torch.equal(ap, want_a) and torch.equal(bt, want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "bf16in"])
def test_cuda_matmul_mma_counts_pack_and_product(cuda_device, mode):
    a, b = matmul_operands(67, 130, 200, torch.float32, cuda_device)
    before = dict(ms.launches)
    ms.matmul_mma(a, b, mode)
    assert ms.launches["matmul_mma"] == before["matmul_mma"] + 1
    assert ms.launches["matmul_mma_pack"] == before["matmul_mma_pack"] + 1
    ms.matmul_mma(a[:0], b, mode)  # empty C: nothing launched
    assert ms.launches["matmul_mma"] == before["matmul_mma"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "bf16in"])
def test_cuda_matmul_mma_operands_4_bytes_off(cuda_device, mode):
    # the pack reads any 4-byte aligned operand
    dev = cuda_device
    a, b = matmul_operands(37, 64, 132, torch.float32, dev, seed=3)
    shifted_a = torch.zeros(37 * 64 + 1, device=dev)[1:].view(37, 64)
    shifted_a.copy_(a)
    shifted_b = torch.zeros(64 * 132 + 1, device=dev)[1:].view(64, 132)
    shifted_b.copy_(b)
    assert shifted_a.data_ptr() % 16 and shifted_b.data_ptr() % 16
    want_a, want_b = ms.mma_pack_plain(a, b, mode)
    for x, y in ((shifted_a, b), (a, shifted_b), (shifted_a, shifted_b)):
        ap, bt = ms.mma_pack(x, y, mode)
        assert torch.equal(ap, want_a) and torch.equal(bt, want_b)
        assert_mma_within_bound(ms.matmul_mma(x, y, mode), a, b, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "bf16in"])
@pytest.mark.parametrize("m,k,n", [(1100, 13, 2100), (600, 200, 4100)])
def test_cuda_matmul_mma_wide_tile_edges(cuda_device, m, k, n, mode):
    # more 128 x 128 tiles than SMs: the plan takes 128 x 256, ragged here
    plan = ms.mma_plan(m, n, k, mode, ms.sm_count(cuda_device))
    assert plan.bn == 256 and n % 256
    a, b = matmul_operands(m, k, n, torch.float32, cuda_device, seed=n)
    assert_mma_within_bound(ms.matmul_mma(a, b, mode), a, b, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "bf16in"])
@pytest.mark.parametrize("s", [1028, 4096])
def test_cuda_matmul_mma_at_script_sizes(cuda_device, s, mode):
    a, b = matmul_operands(s, s, s, torch.float32, cuda_device, seed=s)
    ap, bt = ms.mma_pack(a, b, mode)
    want_a, want_b = ms.mma_pack_plain(a, b, mode)
    assert torch.equal(ap, want_a) and torch.equal(bt, want_b)
    del ap, bt, want_a, want_b
    # the twin is a loop over K: the float64 product of the rounded inputs
    # stands for it at these sizes
    rnd = ms.ROUNDING[mode]
    want = rnd(a).double() @ rnd(b).double()
    bs.mma_readings(ms.matmul_mma(a, b, mode), want, a, b, mode,
                    f"E4 {mode} at {s}^3")


@pytest.mark.cuda
def test_cuda_matmul_schedules_raise(cuda_device):
    dev = cuda_device
    assert ms.smem_optin_bytes(dev) >= 48 * 1024
    a, b = matmul_operands(16, 4096, 8, torch.float32, dev)
    ms.matmul_row_strip(a, b, 8)  # 8 x 4096 f32 fits
    with pytest.raises(ValueError, match="shared memory"):
        ms.matmul_row_strip(a, b, 16)
    with pytest.raises(ValueError, match="shared memory"):
        ms.matmul_row_strip(*matmul_operands(8, 5721, 8, torch.float32, dev))
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


# -- serving on the card (serve.py, index/updates.py, runtime/health.py) ----


def _http(srv, path, payload=None):
    import json
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _rows(results):
    docs = np.array([[it["doc"] for it in r] for r in results], np.int32)
    scores = np.array([[it["score"] for it in r] for r in results],
                      np.float32)
    return docs, scores


@pytest.fixture
def served_index(tmp_path):
    """A 20,000-doc Zipf index saved with the vocabulary w<i> and the
    default tokenizer's config (its native Snowball stemmer needs no
    nltk)."""
    import dataclasses

    from bm25_tpu_torch import Tokenizer
    from bm25_tpu_torch.index.io import save_index, save_tokenizer_config

    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    index = dataclasses.replace(
        index, vocab={f"w{i}": i for i in range(index.vocab_size)})
    save_index(str(tmp_path / "idx"), index)
    save_tokenizer_config(str(tmp_path / "idx"), Tokenizer())
    return str(tmp_path / "idx"), index


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_cuda_server_concurrent_search_matches_oracle(cuda_device,
                                                      served_index, mode):
    import threading

    from bm25_tpu_torch.serve import Server

    d, index = served_index
    srv = Server(d, port=0, engine_mode=mode, batch_window_ms=2.0,
                 warmup_top_k=10,
                 engine_kwargs={"session": Session(cuda_device)})
    srv.start_background()
    try:
        rt = srv._handler.runtime
        assert rt.engine.session.device.type == "cuda"
        rng = np.random.default_rng(0)
        ids = rng.integers(-1, index.vocab_size, (32, 6)).astype(np.int32)
        w = rng.uniform(0.2, 3.0, ids.shape).astype(np.float32)
        out = [None] * len(ids)

        def client(i):
            terms = [f"w{t}" for t in ids[i] if t >= 0] or ["zzz"]
            q = (" ".join(terms) if i % 2 else
                 {f"w{t}": float(x) for t, x in zip(ids[i], w[i]) if t >= 0})
            out[i] = (q, _http(srv, "/search", {"queries": [q],
                                                 "top_k": 25}))

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(ids))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
        ref = ReferenceEngine.from_scored_index(index)
        for q, (code, body) in out:
            assert code == 200
            if isinstance(q, dict):
                qi, qw = rt.tokenizer.tokenize_weighted_queries([q], rt.vocab)
            else:
                qi, qw = rt.tokenizer.tokenize_queries([q], rt.vocab), None
            assert_matches_oracle(*_rows(body["results"]),
                                  *ref.search(qi, top_k=25, weights=qw))
        assert srv.batcher.batches_run < srv.batcher.rows_run
    finally:
        srv.shutdown()


@pytest.mark.cuda
def test_cuda_healthz_deep_probes_the_card(cuda_device, served_index):
    from bm25_tpu_torch.runtime.health import device_probe
    from bm25_tpu_torch.serve import Server

    assert device_probe().ok and device_probe(cuda_device).ok
    srv = Server(served_index[0], port=0,
                 engine_kwargs={"session": Session(cuda_device)})
    srv.start_background()
    try:
        code, h = _http(srv, "/healthz?deep=1")
        assert code == 200 and h["status"] == "ok"
        assert h["device_probe"]["ok"] and h["engine_probe"]["ok"]
    finally:
        srv.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_cuda_updatable_cycle_against_the_oracle(cuda_device, tmp_path,
                                                 mode):
    """add / delete / compact on an updatable server on the card, held to
    an UpdatableEngine over ReferenceEngine fed the same ops, then (after
    the compaction) to ReferenceEngine over a fresh build."""
    from bm25_tpu_torch import Tokenizer, build_index
    from bm25_tpu_torch.index.updates import UpdatableEngine
    from bm25_tpu_torch.serve import Server

    rng = np.random.default_rng(1)
    texts = [" ".join(f"w{t}" for t in rng.integers(0, 300, rng.integers(
        3, 20))) for _ in range(3000)]
    tok = Tokenizer()
    d = str(tmp_path / "idx")
    index, _ = build_index(texts, tokenizer=tok, save_to=d)
    srv = Server(d, port=0, engine_mode=mode, updatable=True,
                 batch_window_ms=2.0,
                 engine_kwargs={"session": Session(cuda_device)})
    srv.start_background()
    oracle = UpdatableEngine(ReferenceEngine.from_scored_index(index), index)
    vocab = dict(index.vocab)
    queries = ["w1 w2 w3", "w250 zzq1", "zzq2 w7", "w0"]

    def check(ref_engine, ref_vocab):
        code, body = _http(srv, "/search", {"queries": queries, "top_k": 20})
        assert code == 200
        qi = tok.tokenize_queries(queries, ref_vocab)
        assert_matches_oracle(*_rows(body["results"]),
                              *ref_engine.search(qi, top_k=20))

    try:
        added = [f"zzq{i % 3} w{i} w{2 * i} fresh doc" for i in range(40)]
        code, out = _http(srv, "/add", {"docs": added})
        assert code == 200
        tc = tok.tokenize_corpus(added, vocab=vocab)
        np.testing.assert_array_equal(out["doc_ids"], oracle.add(tc.ids))
        victims = [int(v) for v in rng.choice(3040, 60, replace=False)]
        assert _http(srv, "/delete", {"doc_ids": victims})[0] == 200
        oracle.delete(victims)
        check(oracle, vocab)
        code, out = _http(srv, "/compact", {})
        assert code == 200 and out["live_docs"] == 3040 - 60
        live = [t for i, t in enumerate(texts + added) if i not in victims]
        fresh, _ = build_index(live, tokenizer=tok)
        check(ReferenceEngine.from_scored_index(fresh), fresh.vocab)
    finally:
        srv.shutdown()


@pytest.mark.cuda
def test_cuda_drop_reload_returns_device_memory(cuda_device, served_index):
    """The live tensor bytes after a drop-mode /reload are back within 2%
    of one engine's device bytes of their value before it, and the old
    engine is freed before the new one builds (the peak stays below two
    engines).  Live bytes are the allocator's requested bytes:
    ``memory_allocated`` counts whole cached blocks, which the caching
    allocator leaves unsplit when less than 1 MiB would remain, so at
    this engine's size (7.6 MB) it moved by 1 MB with nothing leaked."""
    import gc
    import time

    from bm25_tpu_torch.eval import engine_device_bytes
    from bm25_tpu_torch.serve import Server

    srv = Server(served_index[0], port=0, engine_mode="sparse",
                 batch_window_ms=2.0, warmup_top_k=10,
                 engine_kwargs={"session": Session(cuda_device)})
    srv.start_background()
    try:
        assert _http(srv, "/search", {"queries": ["w1 w2"],
                                       "top_k": 10})[0] == 200
        one = engine_device_bytes(srv._handler.runtime.engine)

        def settled():
            # earlier tests' servers (reference cycles) may still be
            # freeing their engines: read once nothing else moves
            last = -1
            for _ in range(50):
                gc.collect()
                torch.cuda.synchronize()
                now = (torch.cuda.memory_stats()[
                    "requested_bytes.all.current"],
                    torch.cuda.memory_allocated())
                if now == last:
                    return now
                last = now
                time.sleep(0.1)
            return last

        before = settled()
        torch.cuda.reset_peak_memory_stats()
        code, rl = _http(srv, "/reload", {"mode": "drop"})
        assert code == 200 and rl["mode"] == "drop"
        after = settled()
        assert abs(after[0] - before[0]) <= 0.02 * one, (before, after, one)
        assert torch.cuda.max_memory_allocated() < before[1] + one // 2
        assert _http(srv, "/search", {"queries": ["w1 w2"],
                                       "top_k": 10})[0] == 200
    finally:
        srv.shutdown()


# -- device checkpoints ----------------------------------------------------------


def _leaves(engine) -> dict:
    if isinstance(engine, DenseEngine):
        return {"st": engine.st, "offsets": engine.offsets}
    out = {"offsets": engine.offsets, "hot_table": engine.hot_table}
    for i, b in enumerate(engine.buckets):
        out.update({f"buckets.{i}.{k}": t for k, t in b.items()})
    for key in ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
                "tail_gpos"):
        if getattr(engine, key) is not None:
            out[key] = getattr(engine, key)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["hot", "three_tier", "dense"])
def test_cuda_device_checkpoint_round_trip(cuda_device, layout, tmp_path):
    """Save and load on the card: every tensor bit-equal to the source's
    (the hot pairs rebuilt by B2, two launches a hot bucket and no plain
    twin), results equal to the source's and the oracle's."""
    from bm25_tpu_torch import load_device_checkpoint, save_device_checkpoint

    session = Session("cuda")
    if layout == "three_tier":
        index, cap = three_tier_index()
        kw = dict(mode="sparse", hot_tokens=16, hot_budget_bytes=1 << 24,
                  max_buckets=2, tail_cap=cap)
    else:
        index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
        kw = (dict(mode="dense") if layout == "dense" else
              dict(mode="sparse", hot_tokens=64, hot_budget_bytes=1 << 24,
                   max_buckets=2))
    engine = create_engine(index, session=session, **kw)
    path = str(tmp_path / "ck")
    save_device_checkpoint(path, engine)
    launched, plain = dict(port.launches), dict(port.plain_calls)
    restored = load_device_checkpoint(path, session=session)
    hot = sum("hotT" in b for b in getattr(engine, "buckets", []))
    assert (hot > 0) == (layout != "dense")
    assert port.launches["ell_score"] - launched["ell_score"] == 2 * hot
    assert port.plain_calls == plain
    a, b = _leaves(restored), _leaves(engine)
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].is_cuda and a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key
    ref = ReferenceEngine.from_scored_index(index)
    q = np.random.default_rng(3).integers(-1, index.vocab_size, (40, 8))
    for k in (10, 1000):
        got = restored.search(q, top_k=k)
        want = engine.search(q, top_k=k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert_matches_oracle(*got, *ref.search(q, top_k=k))


@pytest.mark.cuda
def test_cuda_rebuild_hot_pair_bit_identical(cuda_device):
    """B2's rebuild of a hot pair from its sparse form on the card: the
    saved bf16 pair bit for bit, and the CPU twin's."""
    from bm25_tpu_torch.models import sparse as ps

    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    engine = create_engine(index, mode="sparse", session=Session("cuda"),
                           hot_tokens=64, hot_budget_bytes=1 << 24,
                           max_buckets=2)
    for b in engine.buckets:
        sparse = ps.hot_pair_to_sparse(b["hotT"], b["hotLo"])
        assert sparse["hotNzHi"].is_cuda
        rows = b["doc_ids"].shape[0]
        hi, lo = ps.rebuild_hot_pair_from_sparse(
            engine.hot_h, rows, sparse, engine.session.put)
        assert torch.equal(hi.view(torch.int16), b["hotT"].view(torch.int16))
        assert torch.equal(lo.view(torch.int16),
                           b["hotLo"].view(torch.int16))
        cpu = Session("cpu")
        chi, clo = ps.rebuild_hot_pair_from_sparse(
            engine.hot_h, rows, {k: v.cpu() for k, v in sparse.items()},
            cpu.put)
        assert torch.equal(chi, hi.cpu()) and torch.equal(clo, lo.cpu())


# -- the sharded engines on the card -----------------------------------------------


@pytest.mark.cuda
def test_cuda_sharded_checkpoint_round_trip(cuda_device, tmp_path):
    """A (1, 4) ShardedSparseEngine and ShardedEngine on the one card:
    saved, loaded (each shard's hot pair rebuilt by two B2 launches, no
    plain twin) and restored in place, every piece and the results bit-
    equal to the saved engine; a mesh of another doc axis refused."""
    from bm25_tpu_torch import (ShardedEngine, ShardedSparseEngine,
                                load_device_checkpoint,
                                save_device_checkpoint)
    from bm25_tpu_torch.index.device_checkpoint import (
        restore_device_checkpoint)
    from bm25_tpu_torch.parallel import make_mesh

    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    mesh = make_mesh(4, devices=[cuda_device] * 4)
    q = np.random.default_rng(13).integers(-1, 2000, (64, 8))
    plain = dict(port.plain_calls)
    for engine in (ShardedSparseEngine.from_scored_index(
                       index, mesh=mesh, hot_tokens=64,
                       hot_budget_bytes=1 << 30, max_buckets=2),
                   ShardedEngine.from_scored_index(index, mesh=mesh)):
        path = str(tmp_path / type(engine).__name__)
        save_device_checkpoint(path, engine)
        b2 = port.launches["ell_score"]
        loaded = load_device_checkpoint(path, mesh=mesh)
        hot = sum("hotT" in b for b in getattr(engine, "buckets", []))
        assert port.launches["ell_score"] - b2 == 2 * hot * 4
        restore_device_checkpoint(path, loaded)
        if hot:
            pieces = {(i, key): t for i, b in enumerate(engine.buckets)
                      for key, t in b.items()}
            back = {(i, key): t for i, b in enumerate(loaded.buckets)
                    for key, t in b.items()}
            pieces[0, "hot_table"] = engine.hot_table
            back[0, "hot_table"] = loaded.hot_table
            assert np.array_equal(loaded.hot_table_host,
                                  engine.hot_table_host)
        else:
            pieces, back = {"st": engine.st}, {"st": loaded.st}
        assert sorted(back) == sorted(pieces)
        for key, t in pieces.items():
            for j in range(4):
                assert back[key].on(0, j).is_cuda
                assert torch.equal(back[key].on(0, j), t.on(0, j)), key
        for k in (10, 1000):
            got, want = loaded.search(q, top_k=k), engine.search(q, top_k=k)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        with pytest.raises(ValueError, match="restore mesh has 2"):
            load_device_checkpoint(path, mesh=make_mesh(
                2, devices=[cuda_device] * 2))
    assert port.plain_calls == plain


@pytest.mark.cuda
@pytest.mark.parametrize("data,docs", [(1, 2), (2, 2)])
def test_cuda_sharded_engines_match_single_device(cuda_device, data, docs):
    """ShardedSparseEngine and ShardedEngine on meshes over the one card
    against SparseEngine and DenseEngine at the same layout: plain,
    weighted and masked batches at k=10 and 1000, bf16 scores, ids only
    and pipelined; B1 in every shard, B2 once a shard and bucket at build,
    B3 once a shard and chunk, no plain twin."""
    from bm25_tpu_torch import ShardedEngine, ShardedSparseEngine, SparseEngine
    from bm25_tpu_torch.parallel import make_mesh

    index = make_synthetic_index(BenchConfig(num_docs=20000, vocab=2000))
    ref = ReferenceEngine.from_scored_index(index)
    session = Session("cuda")
    mesh = make_mesh(data * docs, data=data,
                     devices=[cuda_device] * (data * docs))
    rng = np.random.default_rng(7)
    q = rng.integers(-1, 2000, (40, 8))
    q[0] = -1
    w = rng.uniform(0.1, 3.0, q.shape).astype(np.float32)
    mask = rng.random(index.num_docs) < 0.5
    layout = dict(hot_tokens=64, hot_budget_bytes=1 << 30, max_buckets=2)
    plain = (dict(port.plain_calls), dict(gr.plain_calls))
    b2 = port.launches["ell_score"]
    sharded = ShardedSparseEngine.from_scored_index(index, mesh=mesh,
                                                    **layout)
    assert port.launches["ell_score"] - b2 == docs * len(sharded.buckets)
    single = SparseEngine.from_scored_index(index, session=session, **layout)
    dense = DenseEngine.from_scored_index(index, session=session)
    sdense = ShardedEngine.from_scored_index(index, mesh=mesh)
    b1 = b3 = 0
    for kw in ({}, {"weights": w}, {"doc_mask": mask}):
        for k in (10, 1000):
            want = ref.search(q, top_k=k, **kw)
            before = port.launches["ell_score_fused"]
            got = sharded.search(q, top_k=k, **kw)
            b1 += port.launches["ell_score_fused"] - before
            assert_matches_oracle(*got, *want)
            # the single-device engine, under the comparator
            assert_matches_oracle(*got, *single.search(q, top_k=k, **kw))
            before = gr.launches["gather_add_rows"]
            got_d = sdense.search(q, top_k=k, **kw)
            b3 += gr.launches["gather_add_rows"] - before
            want_d = dense.search(q, top_k=k, **kw)
            np.testing.assert_array_equal(got_d[0], want_d[0])
            np.testing.assert_array_equal(got_d[1], want_d[1])
            assert_matches_oracle(*got_d, *want)
    # one launch a chunk, data row, shard (and bucket)
    assert b1 == 6 * docs * data * len(sharded.buckets)
    assert b3 == 6 * docs * data
    f32 = sharded.search(q, top_k=100)
    sharded.score_dtype = "bfloat16"
    d16, s16 = sharded.search(q, top_k=100)
    np.testing.assert_array_equal(d16, f32[0])
    # no offsets in this index: the host add leaves bf16(s) as it is
    np.testing.assert_array_equal(
        s16, torch.from_numpy(f32[1]).bfloat16().float().numpy())
    np.testing.assert_array_equal(sharded.search_ids(q, top_k=100), f32[0])
    big = rng.integers(-1, 2000, (300, 8))
    want = sharded.search(big, top_k=100)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sharded.search_pipelined(big, top_k=100, batch=128)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert_matches_oracle(*got, *want)
    assert (dict(port.plain_calls), dict(gr.plain_calls)) == plain
