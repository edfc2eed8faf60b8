"""The port's named-op registry (ops/registry.py, ops/__init__.py) against
the JAX one, on the CPU.

* ``custom(..., device=...)`` places an op that has no tensor argument
  (``arange``): the target comes from the device and the device is passed
  on.  Before the repair the registry only looked for a tensor, and the
  same call raised "no tensor argument".
* The port registers every op name and exports every public name of
  ``bm25_tpu.ops``.
* ``union_group_select`` and ``gather_group_candidates`` equal JAX's on
  seeded inputs, a tie straddling the k boundary (``ok`` false) included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bm25_tpu.ops as jops
import bm25_tpu_torch.ops as pops
from bm25_tpu.ops import topk as jtk
from bm25_tpu_torch import custom
from bm25_tpu_torch.ops import registry
from bm25_tpu_torch.ops import topk as ptk


def test_custom_takes_target_from_device():
    @registry.register_op("test_torch_where_placed", target="cpu")
    def _where_placed(n, *, device):
        return torch.zeros(n, device=device), torch.device(device)

    for dev in ("cpu", torch.device("cpu")):
        x, placed = custom("test_torch_where_placed", 3, device=dev)
        assert placed == torch.device("cpu") and x.shape == (3,)
    got = custom("arange", 5, device="cpu")
    assert got.tolist() == list(range(5)) and got.dtype == torch.int32
    # the device decides the target: no cuda implementation is registered
    with pytest.raises(KeyError, match="no implementation for target 'cuda'"):
        custom("test_torch_where_placed", 3, device="cuda")
    # an explicit target still wins; no tensor and no device still raises
    assert custom("arange", 2, target="cpu", device="cpu").tolist() == [0, 1]
    with pytest.raises(ValueError, match="no tensor argument"):
        custom("test_torch_where_placed", 3)


def jax_builtin_ops() -> list[str]:
    """The JAX package's own op names: other test modules in the same
    process may register test ops in its registry."""
    from bm25_tpu.ops.registry import _REGISTRY
    return [name for name in jops.list_ops()
            if any(fn.__module__.startswith("bm25_tpu.")
                   for fn in _REGISTRY[name].impls.values())]


def test_port_registers_every_jax_op():
    assert "matrix_multiplication" in jax_builtin_ops()
    missing = set(jax_builtin_ops()) - set(pops.list_ops())
    assert not missing, sorted(missing)


def test_port_exports_every_jax_name():
    assert set(jops.__all__) <= set(pops.__all__)
    for name in pops.__all__:
        assert callable(getattr(pops, name)), name


def test_every_exported_op_resolves_on_cpu():
    for name in jax_builtin_ops():
        assert callable(registry.get_op(name, "cpu")), name


# -- union group select / candidate gather -----------------------------------------

BRANCH = 8


def union_case(seed, q, rows, tie_at_k=None):
    """Per bucket (Q, rows_b) f32 scores (pad rows -inf) and doc ids (-1
    pads), and their (Q, rows_b / 8) group maxima."""
    rng = np.random.default_rng(seed)
    bases, dids, gmaxes = [], [], []
    start = 0
    for r in rows:
        base = rng.standard_normal((q, r)).astype(np.float32).round(2)
        did = np.arange(start, start + r, dtype=np.int32)
        did[-3:] = -1
        base[:, -3:] = -np.inf
        start += r
        bases.append(base)
        dids.append(did)
    if tie_at_k is not None:
        # the k-th and (k+1)-th group maxima equal: one in each bucket
        for b, g in ((0, 0), (1, 1)):
            bases[b][:, g * BRANCH] = 50.0
        bases[0][:, 2 * BRANCH + 1] = 60.0
    for base in bases:
        gmaxes.append(base.reshape(q, -1, BRANCH).max(axis=2))
    return bases, dids, gmaxes


@pytest.mark.parametrize("k,tie", [(1, False), (3, False), (5, False),
                                   (2, True)])
def test_union_group_select_and_candidates_match_jax(k, tie):
    bases, dids, gmaxes = union_case(k, 6, (64, 40, 24),
                                     tie_at_k=k if tie else None)
    gpos, ok = ptk.union_group_select([torch.from_numpy(g) for g in gmaxes],
                                      k)
    jpos, jok = jtk.union_group_select([jnp.asarray(g) for g in gmaxes], k)
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(jpos))
    assert ok.dim() == 0 and ok.dtype == torch.bool
    assert bool(ok) == bool(jok) == (not tie)
    v, d = ptk.gather_group_candidates(
        [torch.from_numpy(b) for b in bases],
        [torch.from_numpy(x) for x in dids], gpos, branch=BRANCH)
    jv, jd = jtk.gather_group_candidates(
        [jnp.asarray(b) for b in bases], [jnp.asarray(x) for x in dids],
        jpos, branch=BRANCH)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert v.shape == (6, k * BRANCH) and d.dtype == torch.int32


def test_union_ops_through_custom_and_sentinel_slots():
    bases, dids, gmaxes = union_case(9, 4, (16,))
    gm = [torch.from_numpy(g) for g in gmaxes]
    gpos, ok = custom("union_group_select", gm, 1)
    assert torch.equal(gpos, ptk.union_group_select(gm, 1)[0])
    # a group position past every bucket fills no slot: sentinel, -inf
    far = torch.full((4, 1), 99, dtype=torch.int64)
    v, d = custom("gather_group_candidates",
                  [torch.from_numpy(b) for b in bases],
                  [torch.from_numpy(x) for x in dids], far)
    assert bool((d == ptk.DOC_SENTINEL).all()) and bool(torch.isneginf(v).all())
    jv, jd = jtk.gather_group_candidates(
        [jnp.asarray(b) for b in bases], [jnp.asarray(x) for x in dids],
        jnp.asarray(far.numpy()))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
