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

# q, t, rows, l_pad, vocab, h, pad_rows, weighted
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
}


def make_case(seed, q, t, rows, l_pad, vocab, h, pad_rows, weighted):
    """Seeded ELL bucket, queries with pad/OOV/duplicate ids, hot tier
    (with weights: float hot counts as a bf16 high + residual pair), and
    the keyword arguments that pass weights and count residuals."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(0, l_pad + 1, rows)
    tokT = np.full((l_pad, rows), -1, np.int32)
    valT = np.zeros((l_pad, rows), np.float32)
    for r in range(rows):
        tokT[: fill[r], r] = rng.choice(vocab, fill[r], replace=False)
        valT[: fill[r], r] = rng.standard_normal(fill[r]).astype(np.float32)
    ids = rng.integers(-1, vocab + 20, (q, t)).astype(np.int32)  # OOV ids
    ids[0] = -1
    ids[1, :3] = ids[1, 0]  # a count of 3: cnt * val can round
    did = np.arange(rows, dtype=np.int32)
    if pad_rows:
        did[-pad_rows:] = -1
    w = rng.uniform(0.0, 3.0, (q, t)).astype(np.float32)
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
                                  "wide_slot_tiled"])
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
