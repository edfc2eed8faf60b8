"""Port top-k op library (ops/topk.py) against the JAX one, on the CPU.

B4's twin (``top_k(implementation="pallas")`` on CPU tensors: the radix
select's passes in torch ops) is held to the JAX Pallas kernel, run in
interpret mode as the JAX package's own tests run it, on the golden cases
of ``tests/test_ops_topk.py``: values and indices equal; to a stable sort
on cases aimed at its digits; and its routing to JAX's chunk rule.  ``top_k`` and ``top_k_blockwise`` are held to JAX
over axis, largest and integer dtypes.  B5's draws cannot match the TPU
PRNG, so its twin is held to membership, determinism per seed, the
sampling distribution (a chi-square test) and greedy choice as the
temperature goes to 0; where the choice does not depend on the noise (rows
of NaN, NaN among numbers, a fully -inf row through the sampling call) it
is held to the JAX kernel exactly.  The fused sampling twin is held to the
steps it replaced, bit for bit, and ``choice_plan`` to its layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from bm25_tpu.ops import topk as jax_topk
from bm25_tpu_torch import custom, top_k
from bm25_tpu_torch.ops import list_ops
from bm25_tpu_torch.ops import topk as port

NINF = float("-inf")


def assert_same(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def both(x, k, impl="pallas", **kw):
    return (top_k(torch.from_numpy(x), k, implementation=impl, **kw),
            jax_topk.top_k(jnp.asarray(x), k, implementation=impl, **kw))


# -- B4's twin vs the JAX Pallas kernel (interpreted) --------------------------


def golden_inputs():
    rng = np.random.default_rng(0)
    ties = rng.integers(0, 6, (4, 40000)).astype(np.float32)
    ties[0] = NINF
    ties[1, ::3] = NINF
    lane = rng.normal(size=(4, 16384 * 3 + 100)).astype(np.float32)
    dup = np.zeros((2, 40000), np.float32)
    dup[:, [5, 20000, 39999]] = 3.0
    return {
        "arange": (np.arange(12, dtype=np.float32), 3),
        "identical_33x33": (np.full((33, 33), 7.0, np.float32), 5),
        "k_equals_axis": (np.array([3.0, 1.0, 2.0], np.float32), 3),
        "rank5": (rng.random((2, 3, 2, 2, 6)).astype(np.float32), 2),
        "two_stage_large_n": (rng.random((4, 40000)).astype(np.float32), 16),
        "duplicates_across_blocks": (dup, 4),
        "exhausted_rows": (np.array([[5.0, NINF, NINF, NINF],
                                     [NINF, 7.0, 3.0, NINF]], np.float32), 3),
        "multiblock_lane_padding": (lane, 16),
        "ties_and_inf_rows": (ties, 40),
        "negative_zero": (np.array([[0.0, -0.0, 1.0, -0.0, 0.0]],
                                   np.float32), 4),
        "nan_ranks_largest": (np.array([[1.0, np.nan, 3.0, np.nan, 2.0]],
                                       np.float32), 4),
    }


GOLDEN = golden_inputs()


@pytest.mark.parametrize("name", list(GOLDEN))
def test_pallas_twin_matches_jax_pallas(name):
    x, k = GOLDEN[name]
    got, want = both(x, k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_pallas_exhausted_rows_distinct_indices():
    _, i = top_k(torch.from_numpy(GOLDEN["exhausted_rows"][0]), 3,
                 implementation="pallas")
    for row in i.numpy():
        assert len(set(row.tolist())) == 3


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("n,k", [(100, 7), (16385, 64), (40000, 16),
                                 (20000, 300)])
def test_pallas_twin_two_stage_vs_jax(n, k, largest):
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((3, n)).astype(np.float32).round(1)  # ties
    x[0, : n // 2] = NINF
    got, want = both(x, k, largest=largest)
    assert_same(got, want)


def jax_kernel_serves(n, k):
    """JAX's routing, re-derived from bm25_tpu/ops/topk.py:251-261: its
    kernel runs unless there are several chunks and k is wider than one."""
    def cdiv(a, b):
        return -(-a // b)

    chunk = min(jax_topk._PALLAS_CHUNK, cdiv(n, 128) * 128)
    nblocks = min(cdiv(n, chunk), jax_topk._PALLAS_MAX_BLOCKS)
    chunk = cdiv(cdiv(n, nblocks), 128) * 128
    nblocks = cdiv(n, chunk)
    return not (nblocks > 1 and k > chunk)


# n, k, whether JAX's kernel (and so B4's) serves it
ROUTES = [(20000, 10001, True), (20000, 10113, False),
          (524288, 20000, True), (524288, 32769, False),
          (16384, 16384, True), (100, 7, True), (40000, 13440, True),
          (40000, 13441, False), (300000, 18816, True),
          (300000, 18817, False)]


@pytest.mark.parametrize("n,k,kernel", ROUTES)
def test_b4_routes_as_jax_kernel(n, k, kernel):
    """The kernel-or-tree decision is JAX's chunk rule; the tree's calls
    are counted, and either way the result is JAX's tree's."""
    assert jax_kernel_serves(n, k) == kernel
    assert port.kernel_serves(n, k) == kernel
    rng = np.random.default_rng(n + k)
    x = rng.integers(0, 40, (2, n)).astype(np.float32)  # ties
    x[1, n // 3:] = NINF  # fewer finite values than k on wide k
    before = (dict(port.launches), dict(port.plain_calls),
              dict(port.tree_calls))
    v, i = top_k(torch.from_numpy(x), k, implementation="pallas")
    assert port.launches == before[0]  # CPU tensors launch nothing
    assert port.plain_calls["top_k_two_stage"] == \
        before[1]["top_k_two_stage"] + kernel
    assert port.tree_calls["top_k_two_stage"] == \
        before[2]["top_k_two_stage"] + (not kernel)
    assert_same((v, i), jax_topk.top_k(jnp.asarray(x), k,
                                       implementation="tree"))
    for row in i.numpy():
        assert len(np.unique(row)) == k


def stable_desc(x, k):
    """Reference: a stable descending sort of each row (NaN largest, -0
    equal to +0), cut to k, by numpy's lexsort."""
    idx = []
    for row in x:
        nan = np.isnan(row)
        val = np.where(nan, 0.0, row) + np.float32(0.0)  # -0 -> +0
        idx.append(np.lexsort((np.arange(len(row)), -val, ~nan))[:k])
    idx = np.array(idx)
    return np.take_along_axis(x, idx, 1), idx


def digit_cases():
    rng = np.random.default_rng(7)
    one = np.float32(1.5).view(np.uint32)
    last = (one + rng.integers(0, 1 << 10, (3, 6000))).astype(np.uint32)
    middle = (one + (rng.integers(0, 1 << 11, (3, 6000)) << 10)).astype(
        np.uint32)
    # the low 19 bits zero: the keys differ in the first digit only
    first = (rng.integers(0, 1 << 13, (3, 6000)) << 19).astype(np.uint32)
    specials = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0,
                                    -1.0], np.float32), (5, 3000))
    mostly_zero = np.zeros((3, 40000), np.float32)
    mostly_zero[:, rng.integers(0, 40000, 500)] = rng.random(500) + 0.5
    mostly_zero[2, 30000:] = NINF
    return {
        "last_digit_only": (last.view(np.float32), 100),
        "middle_digit_only": (middle.view(np.float32), 100),
        "first_digit_only": (first.view(np.float32), 100),
        "all_equal": (np.full((3, 5000), 2.5, np.float32), 7),
        "zeros_nan_inf": (specials, 50),
        "zeros_nan_inf_k_n": (specials, 3000),
        "all_neg_inf": (np.full((3, 20000), NINF, np.float32), 100),
        "k_one": (rng.standard_normal((4, 30000)).astype(np.float32), 1),
        "k_equals_n": (rng.integers(0, 5, (3, 777)).astype(np.float32), 777),
        "threshold_bin_holds_most_of_row": (mostly_zero, 3000),
    }


DIGIT_CASES = digit_cases()


@pytest.mark.parametrize("name", list(DIGIT_CASES))
def test_twin_equals_stable_sort_on_digit_cases(name):
    """B4's twin (histogram passes, threshold, ordered compaction) against
    a stable descending sort, bit for bit, -0 kept as -0."""
    x, k = DIGIT_CASES[name]
    v, i = port.topk_two_stage_plain(torch.from_numpy(x), k)
    want_v, want_i = stable_desc(x, k)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                  want_v.view(np.uint32))


def test_radix_threshold_is_the_kth_key():
    """T is the k-th largest key and ties = k - #keys > T."""
    x, _ = DIGIT_CASES["threshold_bin_holds_most_of_row"]
    keys = port.order_key(torch.from_numpy(x))
    for k in (1, 499, 3000, 40000):
        thr, ties = port.radix_threshold(keys, k)
        kth = torch.sort(keys, dim=1, descending=True).values[:, k - 1]
        assert torch.equal(thr, kth)
        assert torch.equal(ties, k - (keys > thr[:, None]).sum(1))


def test_order_key_is_the_float_order():
    vals = np.array([NINF, -3.5, -1e-40, -0.0, 0.0, 1e-40, 2.0, np.inf,
                     np.nan], np.float32)
    keys = port.order_key(torch.from_numpy(vals)).numpy()
    assert (keys > 0).all()
    assert (np.diff(keys[:3]) > 0).all() and keys[3] == keys[4]
    assert (np.diff(keys[4:]) > 0).all()


def test_pallas_rejects_int_inputs():
    with pytest.raises(TypeError, match="float"):
        top_k(torch.arange(64, dtype=torch.int32)[None, :], 4,
              implementation="pallas")


def test_pallas_bf16_input_is_exact():
    x = np.random.default_rng(2).standard_normal((3, 5000)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    v, i = top_k(xt, 50, implementation="pallas")
    tv, ti = top_k(xt, 50, implementation="tree")
    assert v.dtype == torch.bfloat16
    assert torch.equal(v, tv) and torch.equal(i, ti)


# -- the public dispatcher vs JAX ------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "lax", "tree"])
@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("largest", [True, False])
def test_top_k_matches_jax_over_axis_and_largest(impl, axis, largest):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 9, (7, 30, 11)).astype(np.float32)
    got, want = both(x, 4, impl, axis=axis, largest=largest)
    assert_same(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.uint8, np.int8])
@pytest.mark.parametrize("largest", [True, False])
def test_top_k_int_dtypes_match_jax(dtype, largest):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(6)
    x = rng.integers(info.min, info.max, (3, 5001), dtype=dtype,
                     endpoint=True)
    x[0, :5] = info.min
    x[1, :5] = info.max
    v, i = top_k(torch.from_numpy(x), 7, largest=largest)
    want_v, want_i = jax_topk.top_k(jnp.asarray(x), 7, largest=largest,
                                    implementation="tree")
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    assert v.dtype == torch.from_numpy(x).dtype


def test_top_k_bool_matches_jax():
    x = np.zeros((2, 5001), dtype=bool)
    x[0, [7, 4999]] = True
    x[1, 0] = True
    for largest in (True, False):
        v, i = top_k(torch.from_numpy(x), 3, largest=largest)
        want = jax_topk.top_k(jnp.asarray(x), 3, largest=largest)
        assert v.dtype == torch.bool
        assert_same((v, i), want)


def test_top_k_validates():
    with pytest.raises(ValueError, match="out of range"):
        top_k(torch.zeros(4), 5)
    with pytest.raises(ValueError, match="unknown implementation"):
        top_k(torch.zeros(4), 2, implementation="nope")


@pytest.mark.parametrize("n,k,block", [(50000, 50, 256), (30000, 40, 128),
                                       (1000, 100, 128), (33333, 20, 256),
                                       (20000, 10, None)])
def test_top_k_blockwise_matches_jax(n, k, block):
    rng = np.random.default_rng(n)
    x = rng.choice([0.0, 1.0, 2.0], size=(4, n)).astype(np.float32)
    got = port.top_k_blockwise(torch.from_numpy(x), k, block=block)
    want = jax_topk.top_k_blockwise(jnp.asarray(x), k, block=block)
    assert_same(got, want)


def test_top_k_blockwise_int_matches_jax():
    x = np.random.default_rng(3).integers(-1000, 1000, (3, 20001),
                                          dtype=np.int32)
    got = port.top_k_blockwise(torch.from_numpy(x), 25, block=128)
    want = jax_topk.top_k_blockwise(jnp.asarray(x), 25, block=128)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_registry_resolves_by_device_and_names_targets():
    for name in ("top_k", "top_k_blockwise", "top_k_fused_sampling",
                 "gather_add_rows"):
        assert name in list_ops()
    x = torch.from_numpy(np.random.default_rng(4).random((3, 50),
                                                          np.float32))
    assert_same(custom("top_k", x, 5, implementation="pallas"),
                top_k(x, 5))
    assert_same(custom("top_k", x, 5, target="cuda"), top_k(x, 5))
    with pytest.raises(ValueError, match="target"):
        custom("top_k", [1.0, 2.0], 1)


def test_registry_per_target_implementations():
    from bm25_tpu_torch.ops import get_op, register_op

    @register_op("test_torch_triple", target="cpu")
    def _triple(x):
        return x * 3

    assert custom("test_torch_triple", torch.ones(2)).tolist() == [3.0, 3.0]
    with pytest.raises(KeyError, match="no implementation"):
        get_op("test_torch_triple", "cuda")
    with pytest.raises(KeyError, match="unknown op"):
        get_op("never_registered", "cpu")
    with pytest.raises(ValueError, match="duplicate"):
        register_op("test_torch_triple", target="cpu")(_triple)


# -- B5's twin and fused sampling ---------------------------------------------------


def test_gumbel_noise_hash_matches_integer_reference():
    """The twin's int64 hash equals a plain-Python uint32 hash."""
    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    for seed in (0, 7, 2**32 - 1):
        g = port.gumbel_noise_plain(seed, 3, 5)
        for r in range(3):
            for c in range(5):
                bits = mix(mix(mix(seed) ^ r) ^ c)
                u = np.float32(bits >> 8) * np.float32(2**-24) \
                    + np.float32(1e-12)
                want = -np.log(-np.log(np.float32(u)))
                assert abs(float(g[r, c]) - float(want)) <= 1e-5 * max(
                    1.0, abs(float(want)))


def test_gumbel_choice_deterministic_per_seed_and_seed_sensitive():
    logits = torch.from_numpy(np.random.default_rng(9).random(
        (32, 60), np.float32)) * 5
    a = port.gumbel_choice(logits, 1)
    assert torch.equal(a, port.gumbel_choice(logits, 1))
    assert not torch.equal(a, port.gumbel_choice(logits, 2))
    assert a.dtype == torch.int64 and a.shape == (32,)


@pytest.mark.parametrize("impl", ["torch", "pallas"])
def test_sampling_member_shapes_and_determinism(impl):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((6, 50)).astype(np.float32))
    vals, s1 = port.top_k_fused_sampling(
        x, 5, implementation=impl, generator=torch.Generator().manual_seed(1))
    _, s2 = port.top_k_fused_sampling(
        x, 5, implementation=impl, generator=torch.Generator().manual_seed(1))
    assert torch.equal(s1, s2) and s1.shape == (6, 1)
    jv, _ = jax_topk.top_k_fused_sampling(jax.random.PRNGKey(1),
                                          jnp.asarray(x.numpy()), k=5)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    _, ti = top_k(x, 5)
    assert bool((s1 == ti).any(dim=1).all())
    x3 = torch.from_numpy(rng.random((2, 20, 3)).astype(np.float32))
    v3, s3 = port.top_k_fused_sampling(x3, 4, implementation=impl, axis=1)
    assert v3.shape == (2, 4, 3) and s3.shape == (2, 1, 3)
    _, i3 = top_k(x3, 4, axis=1)
    assert bool((s3 == i3).any(dim=1).all())


@pytest.mark.parametrize("impl", ["torch", "pallas"])
def test_sampling_temperature_zero_is_greedy(impl):
    x = np.random.default_rng(3).random((4, 30)).astype(np.float32)
    _, s = port.top_k_fused_sampling(torch.from_numpy(x), 5, temperature=0.0,
                                     implementation=impl,
                                     generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(s.numpy()[:, 0], np.argmax(x, axis=1))


@pytest.mark.parametrize("impl", ["torch", "pallas"])
def test_sampling_dominant_logit(impl):
    x = np.zeros((8, 30), np.float32)
    x[:, 7] = 50.0
    _, s = port.top_k_fused_sampling(torch.from_numpy(x), 5,
                                     implementation=impl,
                                     generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(s.numpy()[:, 0], 7)


@pytest.mark.parametrize("impl", ["torch", "pallas"])
def test_sampling_distribution_chi_square(impl):
    """20,000 draws over 5 logits follow softmax(logits / T)."""
    logits = np.array([2.0, 1.5, 1.0, 0.0, -1.0], np.float32)
    t = 0.8
    x = torch.from_numpy(np.tile(logits, (20000, 1)))
    _, s = port.top_k_fused_sampling(x, 5, temperature=t,
                                     implementation=impl,
                                     generator=torch.Generator().manual_seed(3))
    counts = np.bincount(s.numpy()[:, 0], minlength=5)
    p = np.exp(logits.astype(np.float64) / t)
    p /= p.sum()
    assert stats.chisquare(counts, p * counts.sum()).pvalue > 1e-3


def test_sampling_rejects_unknown_implementation():
    with pytest.raises(ValueError, match="unknown implementation"):
        port.top_k_fused_sampling(torch.zeros((1, 4)), 2,
                                  implementation="jax")


# -- B5 on NaN rows, the fused step's twin, and the kernel's layouts ----------


def nan_rows():
    """Rows whose choice does not depend on the noise: all NaN (column 0),
    NaN among numbers (the first NaN), all -inf (column 0)."""
    x = np.random.default_rng(4).standard_normal((6, 37)).astype(np.float32)
    x[0] = np.nan
    x[1, [7, 20]] = np.nan
    x[2, -1] = np.nan
    x[3] = NINF
    x[4, :30] = NINF
    x[4, [31, 33]] = np.nan
    x[5, 0] = np.nan
    return x


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_gumbel_twin_matches_jax_pallas_on_nan_rows(seed):
    x = nan_rows()
    want = np.asarray(jax_topk._pallas_gumbel_choice(jnp.asarray(x), seed))
    got = port.gumbel_choice(torch.from_numpy(x), seed)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:6], [0, 7, 36, 0, 31, 0])


def test_sampling_on_an_all_neg_inf_row_matches_jax_pallas():
    """(v - v0) / t is NaN in every column of a fully -inf row: both sample
    the row's first top-k id (column 0)."""
    x = np.random.default_rng(5).random((4, 50)).astype(np.float32)
    x[1] = NINF
    x[3, 10:] = NINF
    _, js = jax_topk.top_k_fused_sampling(jax.random.PRNGKey(0),
                                          jnp.asarray(x), 5,
                                          implementation="pallas")
    _, ps = port.top_k_fused_sampling(
        torch.from_numpy(x), 5, implementation="pallas",
        generator=torch.Generator().manual_seed(0))
    _, ti = top_k(torch.from_numpy(x), 5)
    assert int(ps[1, 0]) == int(np.asarray(js)[1, 0]) == int(ti[1, 0]) == 0


def old_inline_sampling(vals, idxs, seed, temperature):
    """The CPU steps top_k_fused_sampling ran inline before the fused twin
    (axis already moved last)."""
    k = vals.shape[-1]
    t = torch.clamp_min(torch.as_tensor(temperature, dtype=vals.dtype,
                                        device=vals.device), 1e-6)
    logits = (vals - vals[..., :1]) / t
    flat = logits.float().reshape(-1, k).contiguous()
    choice = port.gumbel_choice_plain(flat, seed)
    return logits, torch.gather(idxs, -1,
                                choice.reshape(logits.shape[:-1] + (1,)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("temperature", [1.0, 0.3, 0.0, 7.5])
def test_fused_sampling_twin_equals_old_inline_steps(dtype, temperature):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((40, 300)).astype(
        np.float32) * 4).to(dtype)
    x[3] = NINF
    vals, idxs = top_k(x, 64, implementation="pallas")
    seed = torch.tensor([123456789], dtype=torch.int64)
    logits, want = old_inline_sampling(vals, idxs, 123456789, temperature)
    got_logits = port._sample_logits(vals, temperature)
    assert torch.equal(got_logits.view(torch.int16 if dtype != torch.float32
                                       else torch.int32),
                       logits.view(torch.int16 if dtype != torch.float32
                                   else torch.int32))
    for s in (seed, 123456789):
        assert torch.equal(port.gumbel_sample_plain(vals, idxs, s,
                                                    temperature), want)


def test_fused_sampling_draws_equal_the_seeded_twin():
    """The sampling call draws one seed from the generator, then the fused
    twin: the same generator state gives the twin's draws."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 20, 200)).astype(np.float32))
    _, s = port.top_k_fused_sampling(
        x, 16, temperature=0.6, axis=1, implementation="pallas",
        generator=torch.Generator().manual_seed(11))
    seed = torch.randint(0, 2**32, (1,),
                         generator=torch.Generator().manual_seed(11))
    v, i = top_k(x, 16, axis=1)
    want = port.gumbel_sample_plain(torch.movedim(v, 1, -1),
                                    torch.movedim(i, 1, -1), seed, 0.6)
    assert torch.equal(s, torch.movedim(want, -1, 1))


@pytest.mark.parametrize("b,k,layout,cluster", [
    (512, 100, "warp", 1), (300, 100, "warp", 1), (1, 5, "warp", 1),
    (512, 1000, "block", 1), (4096, 1000, "block", 1),
    (64, 32768, "cluster", 2), (8, 131072, "cluster", 8),
    (31, 131072, "cluster", 8), (33, 131072, "cluster", 8),
    (34, 131072, "cluster", 4), (64, 131072, "cluster", 4),
    (100, 131072, "cluster", 2), (13, 50001, "cluster", 4),
    (4, 1 << 20, "cluster", 8), (15, 1 << 20, "cluster", 8),
    (200, 131072, "block", 1)])
def test_choice_plan_layouts(b, k, layout, cluster):
    """On 132 SMs: a cluster of at most 8 blocks, every row's cluster on
    the card at once (two 1,024-thread blocks an SM)."""
    plan = port.choice_plan(b, k, 132)
    assert (plan.layout, plan.cluster) == (layout, cluster)
    assert plan.threads % 32 == 0 and plan.threads <= port.CHOICE_BLOCK
    assert b * cluster <= 264 or cluster == 1


def test_b5_times_needs_a_card(capsys):
    # the timing script measures only on a CUDA device; elsewhere it exits
    # 2 and prints no result
    from bm25_tpu_torch.bench import b5_times

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert b5_times.main([]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("b,k,ids,want", [
    (512, 100, False, 6.235701492537314e-05),
    (512, 100, True, 6.357970149253731e-05),
    (8, 131072, False, 1.2520501492537313e-03)])
def test_b5_bound_counts_each_byte_once(b, k, ids, want):
    """The logits read once, the int64 result written once (and, with
    ids, one id a row read) over 3.35 TB/s: larger than the operations'
    lower bound at these shapes."""
    from bm25_tpu_torch.bench import b5_times

    assert b5_times.bound_ms(b, k, ids) == (pytest.approx(want, rel=1e-12),
                                            "bytes")
