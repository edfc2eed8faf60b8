"""Port kernels B1/B2 (ops/ell_score.py) against the JAX Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch twins; the JAX
kernels run in interpret mode, as the JAX package's own tests run them.
The ELL-only base must be bit-equal; with the hot tier, the products are
summed in another order (a dense dot on the JAX side), hence rtol = atol =
1e-5.  tests/test_torch_cuda.py holds the CUDA kernels against the twins.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# bm25_tpu.ops and bm25_tpu_torch.ops re-export a function of the
# module's name
port = importlib.import_module("bm25_tpu_torch.ops.ell_score")
jax_ell = importlib.import_module("bm25_tpu.ops.ell_score")

# q, t, rows, l_pad, vocab, h, pad_rows, weighted[, kind]: kind (see
# make_case) shapes the ids, values or weights where the card's lookup
# tables are likeliest to go wrong
CASES = {
    "no_hot": (12, 5, 512, 16, 60, 0, 0, False),
    "hot": (12, 5, 1024, 16, 60, 16, 0, False),
    "pad_rows_oov_ragged_q": (13, 8, 512, 24, 80, 0, 9, False),
    "pad_rows_oov_ragged_q_hot": (13, 8, 512, 24, 80, 24, 9, False),
    "wide_slot_tiled": (9, 3, 512, 1208, 4000, 0, 5, False),
    "wide_slot_tiled_hot": (9, 3, 512, 1208, 4000, 8, 5, False),
    "weighted": (13, 8, 512, 24, 80, 0, 9, True),
    "weighted_hot_split_counts": (13, 8, 512, 24, 80, 24, 9, True),
    "weighted_wide_slot_tiled": (9, 3, 512, 1208, 4000, 0, 5, True),
    # B2's shape: one distinct id a query, the queries over three tables
    "one_token_distinct_ids": (300, 1, 512, 24, 400, 0, 0, False,
                               "distinct"),
    # wide queries: a table holds fewer of them (32 at T = 64, 4 at 300)
    "wide_queries_t64": (40, 64, 512, 24, 300, 0, 5, False, "hits"),
    "wide_queries_t300_weighted": (12, 300, 512, 24, 2000, 0, 5, True,
                                   "hits"),
    # every query holds one cold token: its run fans out to every query
    "fan_out_shared_token": (140, 8, 512, 24, 300, 0, 5, False, "shared"),
    "fan_out_shared_token_weighted": (140, 8, 512, 24, 300, 0, 5, True,
                                      "shared"),
    "ids_above_65535": (13, 8, 512, 24, 100000, 0, 9, False, "hits"),
    "negative_values": (13, 8, 512, 24, 80, 0, 9, False, "negative"),
    "zero_weights": (13, 8, 512, 24, 80, 0, 9, True, "zero_weights"),
}


def make_case(seed, q, t, rows, l_pad, vocab, h, pad_rows, weighted,
              kind=None):
    """Seeded ELL bucket, queries with pad/OOV/duplicate ids, hot tier
    (with weights: float hot counts as a bf16 high + residual pair), and
    the keyword arguments that pass weights and count residuals.  kind:
    "distinct" one distinct id a query (B2's build); "hits" half the ids
    drawn from the bucket's tokens; "shared" a frequent token in every
    query; "negative" every value negative (robertson / atire scores);
    "zero_weights" weights of 0 in every other column and one row."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(0, l_pad + 1, rows)
    tokT = np.full((l_pad, rows), -1, np.int32)
    valT = np.zeros((l_pad, rows), np.float32)
    for r in range(rows):
        tokT[: fill[r], r] = rng.choice(vocab, fill[r], replace=False)
        valT[: fill[r], r] = rng.standard_normal(fill[r]).astype(np.float32)
    ids = rng.integers(-1, vocab + 20, (q, t)).astype(np.int32)  # OOV ids
    if kind == "distinct":
        ids = rng.permutation(vocab)[:q].reshape(q, 1).astype(np.int32)
    elif kind == "hits":
        present = tokT[tokT >= 0]
        pick = rng.random((q, t)) < 0.5
        ids[pick] = rng.choice(present, int(pick.sum()))
    elif kind == "shared":
        tokT[0, ::2] = vocab + 7  # in half the rows, outside the vocabulary
        valT[0, ::2] = rng.standard_normal(len(valT[0, ::2]))
        ids[:, 2] = vocab + 7
    elif kind == "negative":
        valT = -np.abs(valT)
    if kind != "distinct":
        ids[0] = -1
        if t >= 3:
            ids[1, :3] = ids[1, 0]  # a count of 3: cnt * val can round
    did = np.arange(rows, dtype=np.int32)
    if pad_rows:
        did[-pad_rows:] = -1
    w = rng.uniform(0.0, 3.0, (q, t)).astype(np.float32)
    if kind == "zero_weights":
        w[:, ::2] = 0.0
        w[2] = 0.0
    extra = {"weights": w} if weighted else {}
    hot = None
    if h:
        hc = np.zeros((q, h), np.float32)
        for qq in range(q):
            np.add.at(hc[qq], rng.integers(0, h, t), w[qq] if weighted else 1)
        dense = rng.standard_normal((h, rows)).astype(np.float32)
        hi = dense.astype(jnp.bfloat16)
        lo = (dense - hi.astype(np.float32)).astype(jnp.bfloat16)
        hc_hi = hc.astype(jnp.bfloat16)
        hot = (hc_hi, hi, lo)
        if weighted:
            extra["hot_counts_lo"] = (
                hc - hc_hi.astype(np.float32)).astype(jnp.bfloat16)
    return ids, tokT, valT, did, hot, extra


def to_torch(a, device="cpu"):
    """numpy (incl. ml_dtypes bfloat16) -> torch, bit for bit."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@pytest.mark.parametrize("name", list(CASES))
def test_ell_score_fused_plain_matches_jax(name):
    ids, tokT, valT, did, hot, extra = make_case(1, *CASES[name])
    hot_j = () if hot is None else tuple(jnp.asarray(x) for x in hot)
    base_j, gmax_j = jax_ell.ell_score_fused(
        jnp.asarray(ids), jnp.asarray(tokT), jnp.asarray(valT),
        jnp.asarray(did), *hot_j, interpret=True,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    hot_t = () if hot is None else tuple(to_torch(x) for x in hot)
    before = dict(port.plain_calls)
    base_t, gmax_t = port.ell_score_fused(
        to_torch(ids), to_torch(tokT), to_torch(valT), to_torch(did), *hot_t,
        **{k: to_torch(v) for k, v in extra.items()})
    assert port.plain_calls["ell_score_fused"] == before["ell_score_fused"] + 1
    assert base_t.shape == (ids.shape[0], tokT.shape[1])
    assert gmax_t.shape == (ids.shape[0], tokT.shape[1] // port.GROUP)
    if hot is None:
        np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
        np.testing.assert_array_equal(gmax_t.numpy(), np.asarray(gmax_j))
    else:
        np.testing.assert_allclose(base_t.numpy(), np.asarray(base_j),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gmax_t.numpy(), np.asarray(gmax_j),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["no_hot", "pad_rows_oov_ragged_q",
                                  "wide_slot_tiled", "one_token_distinct_ids",
                                  "wide_queries_t64", "ids_above_65535"])
def test_ell_score_plain_matches_jax(name):
    ids, tokT, valT, _, _, _ = make_case(2, *CASES[name])
    out_j = jax_ell.ell_score_pallas(jnp.asarray(ids), jnp.asarray(tokT),
                                     jnp.asarray(valT), interpret=True)
    out_t = port.ell_score(to_torch(ids), to_torch(tokT), to_torch(valT))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_hot_only_bucket_matches_jax_epilogue():
    """A bucket with no cold slots (tokT None): the JAX engine scores it
    with the hot products outside the kernel (bucket_base_scores)."""
    from bm25_tpu.models.sparse import bucket_base_scores

    ids, _, _, did, hot, _ = make_case(3, 7, 8, 1024, 0, 50, 32, 100, False)
    base_j, gmax_j = bucket_base_scores(
        {"doc_ids": jnp.asarray(did), "hotT": jnp.asarray(hot[1]),
         "hotLo": jnp.asarray(hot[2])},
        jnp.asarray(ids), ids.shape[0], hot_counts=jnp.asarray(hot[0]))
    base_t, gmax_t = port.ell_score_fused(
        to_torch(ids), None, None, to_torch(did),
        *(to_torch(x) for x in hot))
    np.testing.assert_allclose(base_t.numpy(), np.asarray(base_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gmax_t.numpy(), np.asarray(gmax_j),
                               rtol=1e-5, atol=1e-5)


def test_slot_tiling_matches_jax():
    for l_pad in (0, 8, 512, 520, 1032, 1208, 1536, 4096, 5000):
        assert port._slot_tiling(l_pad) == jax_ell._slot_tiling(l_pad)


def test_wrapper_refuses_other_devices():
    ids = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    tok = torch.zeros((8, 512), dtype=torch.int32, device="meta")
    val = torch.zeros((8, 512), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port.ell_score(ids, tok, val)


@pytest.mark.parametrize("name", ["hot", "pad_rows_oov_ragged_q_hot",
                                  "weighted_hot_split_counts"])
def test_hot_plan_products_match_jax(name):
    """hot_plan (B1's hot kernel runs over the tokens it lists) lists the
    used hot tokens first, ascending, and the counts' columns in that order
    with zeros after; its products over the first n_used tokens, added to
    the ELL-only base in the kernel's order, match the JAX kernel."""
    ids, tokT, valT, did, hot, extra = make_case(4, *CASES[name])
    hc, hi, lo = (to_torch(x) for x in hot)
    hc_lo = to_torch(extra["hot_counts_lo"]) if "hot_counts_lo" in extra \
        else None
    hc[0] = 0  # a query with no hot token
    plan = port.hot_plan(hc, hc_lo)
    q, h = hc.shape
    used = (hc != 0).any(0) if hc_lo is None else \
        (hc != 0).any(0) | (hc_lo != 0).any(0)
    n = int(plan.n_used)
    assert n == int(used.sum())
    assert plan.counts.shape == (q, -(-h // port.HOT_BK) * port.HOT_BK)
    assert torch.equal(plan.tokens[:n].long(), torch.nonzero(used)[:, 0])
    assert sorted(plan.tokens.tolist()) == list(range(h))
    for c, want in ((plan.counts, hc), (plan.counts_lo, hc_lo)):
        if want is None:
            assert c is None
            continue
        assert torch.equal(c[:, :n], want[:, plan.tokens[:n].long()])
        assert not c[:, n:].any()
    rows_used = plan.tokens[:n].long()
    weights = {k: to_torch(v) for k, v in extra.items() if k == "weights"}
    base = port.ell_score_fused_plain(to_torch(ids), to_torch(tokT),
                                      to_torch(valT), to_torch(did),
                                      **weights)[0]
    hi_u, lo_u = hi[rows_used].float(), lo[rows_used].float()
    got = base + plan.counts[:, :n].float() @ hi_u
    got = got + plan.counts[:, :n].float() @ lo_u
    if hc_lo is not None:
        got = got + plan.counts_lo[:, :n].float() @ hi_u
    got = torch.where(to_torch(did)[None, :] >= 0, got, port.NEG_INF)
    jax_kw = {k: jnp.asarray(v) for k, v in extra.items()}
    if "hot_counts_lo" in jax_kw:
        jax_kw["hot_counts_lo"] = jnp.asarray(
            hc_lo.float().numpy()).astype(jnp.bfloat16)
    base_j, _ = jax_ell.ell_score_fused(
        jnp.asarray(ids), jnp.asarray(tokT), jnp.asarray(valT),
        jnp.asarray(did), jnp.asarray(hc.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(hot[1]), jnp.asarray(hot[2]), interpret=True, **jax_kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(base_j), rtol=1e-5,
                               atol=1e-5)


def scan_with_table(tiles, qp, q, tokT, valT, rows):
    """The scan as the card runs it, driven by ``table_pairs``' tiles: a
    slot whose token is in a tile's table adds c x value to each of the
    token's (query, c) pairs with one fused multiply-add, in slot order
    from +0 (slot tiles summed as base + part); other slots add nothing."""
    base = torch.zeros((q, rows), dtype=torch.float32)
    l_pad = tokT.shape[0]
    l_tile, _ = port._slot_tiling(l_pad)
    for i, tile in enumerate(tiles):
        q0, toks = i * qp, sorted(tile)
        nq = min(qp, q - q0)
        keys = torch.tensor(toks + [-3], dtype=torch.int32)  # -3: no token
        c = torch.zeros((len(keys), nq), dtype=torch.float32)
        has = torch.zeros((len(keys), nq), dtype=torch.bool)
        for k, tok in enumerate(toks):
            for qq, cc in tile[tok]:
                c[k, qq], has[k, qq] = cc, True
        out = torch.zeros((nq, rows), dtype=torch.float32)
        for l0 in range(0, l_pad, max(l_tile, 1)):
            part = torch.zeros_like(out)
            for l in range(l0, min(l0 + l_tile, l_pad)):
                at = torch.searchsorted(keys[:-1], tokT[l]).clamp(
                    max=len(keys) - 1)
                at = torch.where(keys[at] == tokT[l], at, len(keys) - 1)
                part = torch.where(has[at].T,
                                   port._fma_f32(c[at].T, valT[l][None],
                                                 part), part)
            out = part if l0 == 0 else out + part
        base[q0:q0 + nq] = out
    return base


@pytest.mark.parametrize("name", list(CASES))
def test_table_pairs_drive_the_scan_bit_equal(name):
    """table_pairs defines what the card's lookup tables hold; a scan that
    adds only its pairs, on the slots whose token it holds, gives
    _scan_plain's bits, at the wrapper's table size and at 4 queries a
    table (more tables, ragged last one)."""
    ids, tokT, valT, _, _, extra = make_case(5, *CASES[name])
    q, t = ids.shape
    w = extra.get("weights")
    want = port._scan_plain(to_torch(ids), to_torch(tokT), to_torch(valT),
                            tokT.shape[1], None if w is None else to_torch(w))
    for qp in {port.table_geometry(q, t)[0], 4}:
        tiles = port.table_pairs(ids, w, qp)
        assert len(tiles) == -(-q // qp)
        got = scan_with_table(tiles, qp, q, to_torch(tokT), to_torch(valT),
                              tokT.shape[1])
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", ["pad_rows_oov_ragged_q", "weighted",
                                  "one_token_distinct_ids",
                                  "wide_queries_t300_weighted",
                                  "fan_out_shared_token_weighted",
                                  "ids_above_65535", "zero_weights"])
@pytest.mark.parametrize("most", [port.MAX_TABLE_QUERIES, 4])
def test_scan_table_plain_layout(name, most):
    """The table twin lays table_pairs out as the kernel reads it, at
    most ``most`` queries a table: every key reachable by linear probing,
    runs covering the pairs once, at most a half (a quarter, past one id
    a query) of the key slots used; pads and OOV ids (< 0) are no keys."""
    ids, _, _, _, _, extra = make_case(6, *CASES[name])
    q, t = ids.shape
    w = extra.get("weights")
    before = port.plain_calls["ell_table"]
    table = port.scan_table(to_torch(ids), None if w is None else to_torch(w),
                            most)
    assert port.plain_calls["ell_table"] == before + 1
    qp, cap_log2 = port.table_geometry(q, t, most)
    assert qp <= most
    assert (table.qp, table.cap_log2, table.weighted) == (qp, cap_log2,
                                                         w is not None)
    assert table.words.shape == (-(-q // qp),
                                 port.table_words(cap_log2, qp * t))
    assert table.words.shape[1] % 4 == 0
    contents = port.table_contents(table)
    assert contents == port.table_pairs(ids, w, qp)
    for tile in contents:
        assert port.scan_build(t)[2] * len(tile) <= 1 << cap_log2
        assert all(tok >= 0 for tok in tile)
        for pairs in tile.values():
            assert [p[0] for p in pairs] == sorted({p[0] for p in pairs})
    if name == "fan_out_shared_token_weighted":
        shared = contents[0][int(ids[5, 2])]
        # queries 0 (pads) and 1 (its first id thrice) lack it
        assert [p[0] for p in shared] == list(range(2, qp))
        assert shared[1][1] == float(np.float32(extra["weights"][3, 2]))


def test_table_pairs_counts_and_t_ordered_weight_sums():
    ids = np.array([[5, 7, 5, -1, 5], [7, 70000, -2, 7, 9]], np.int32)
    w = np.array([[0.1, 1.0, 1e8, 3.0, -1e8], [2.0, 1.0, 9.0, 0.0, 0.0]],
                 np.float32)
    assert port.table_pairs(ids, None, 2) == [
        {5: [(0, 3.0)], 7: [(0, 1.0), (1, 2.0)], 70000: [(1, 1.0)],
         9: [(1, 1.0)]}]
    s = (np.float32(0.1) + np.float32(1e8)) + np.float32(-1e8)
    tiles = port.table_pairs(ids, w, 1)
    assert tiles[0] == {5: [(0, float(s))], 7: [(0, 1.0)]}
    assert tiles[1] == {7: [(0, 2.0)], 70000: [(0, 1.0)], 9: [(0, 0.0)]}


def test_table_geometry_shrinks_with_wide_queries():
    """A table holds at most MAX_TABLE_QUERIES queries (or the cap given)
    and fewer as T grows, so that two scan blocks fit an SM; one query of
    up to 4,096 ids (more than the compare sweep took) still fits one
    block; beyond that the wrapper raises."""
    g = port.table_geometry
    assert g(512, 8) == (128, 12) and g(8, 8) == (8, 8) and g(1, 1) == (1, 4)
    assert g(1024, 1) == (128, 8) and g(13, 8)[0] == 16
    assert g(512, 64)[0] == 32 and g(512, 300)[0] == 4
    assert g(512, 3632)[0] == 1 and g(512, 4096) == (1, 14)
    assert g(512, 8, 4) == (4, 7) and g(512, 300, 32)[0] == 4
    for q, t in ((512, 8), (1024, 1), (512, 64), (512, 300), (8, 1808)):
        qp, cap_log2 = g(q, t)
        rows, _, sparsity = port.scan_build(t)
        assert 1 << cap_log2 >= sparsity * qp * t
        smem = 4 * (128 // rows) * (qp * rows +
                                    port.table_words(cap_log2, qp * t))
        assert smem <= port.SMEM_TWO_BLOCKS
    with pytest.raises(ValueError, match="4096"):
        g(4, 4097)


def test_table_contents_rejects_a_key_lookups_cannot_reach():
    ids = torch.tensor([[3, 4, 5]], dtype=torch.int32)
    table = port.scan_table(ids)
    cap, head = 1 << table.cap_log2, port.TABLE_HEAD
    keys = table.words[0, head:head + cap]
    h = int(torch.nonzero(keys == 4)[0, 0])
    # the key moved one bucket on, past its own bucket's free slots
    moved = table.words.clone()
    to = (h // 4 * 4 + 4) % cap
    if int(keys[to]) == -1:
        moved[0, head + h] = -1
        moved[0, head + to] = 4
        moved[0, head + cap + to] = table.words[0, head + cap + h]
        with pytest.raises(ValueError, match="free slot"):
            port.table_contents(table._replace(words=moved))
    # a key after a free slot of its bucket
    gap = table.words.clone()
    gap[0, head + h // 4 * 4 + 3] = 4
    gap[0, head + h // 4 * 4 + 2] = -1
    with pytest.raises(ValueError, match="free slot"):
        port.table_contents(table._replace(words=gap))
    blind = table.words.clone()
    blind[0, head + 2 * cap:head + 2 * cap + cap // 4] = 0  # no filter bit
    with pytest.raises(ValueError, match="filter"):
        port.table_contents(table._replace(words=blind))
    lost = table.words.clone()
    lost[0, 0] += 1  # one pair more than the runs cover
    with pytest.raises(ValueError, match="cover"):
        port.table_contents(table._replace(words=lost))


def test_e6_b1_times_needs_a_card(capsys):
    # the timing script measures only on a CUDA device; elsewhere it exits
    # 2 and prints no result
    from bm25_tpu_torch.bench import e6_b1_times

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert e6_b1_times.main([]) == 2
    assert capsys.readouterr().out == ""
