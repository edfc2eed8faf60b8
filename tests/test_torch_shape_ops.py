"""Port shape ops (ops/shape_ops.py) against the JAX ones, on the CPU:
``reshape``/``reshape_shape`` and ``arange``/``arange_shape``, bit-equal,
with errors of the same type.

A float ``arange`` computes ``start + i * step`` in its dtype.  JAX on
the CPU rounds the product and the sum separately (no fused
multiply-add): ``step=0.1`` and the other non-representable steps below
pin the port to the same two roundings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bm25_tpu.ops import shape_ops as jso
from bm25_tpu_torch import custom
from bm25_tpu_torch.ops import shape_ops as pso

IN_SHAPES = [(24,), (2, 3, 4), (6, 4), (1, 24, 1), (0, 5)]
TARGETS = [(-1,), (6, -1), (-1, 4), (2, 12), (4, 3, 2), (-1, 2, 3), (5, 5),
           (-1, -1), (0, -1), (7, -1), (24, 1, -1)]


@pytest.mark.parametrize("in_shape", IN_SHAPES)
def test_reshape_shape_matches_jax(in_shape):
    for target in TARGETS:
        try:
            want = jso.reshape_shape(in_shape, target)
        except ValueError:
            with pytest.raises(ValueError):
                pso.reshape_shape(in_shape, target)
            continue
        assert pso.reshape_shape(in_shape, target) == want
        x = np.arange(int(np.prod(in_shape)), dtype=np.float32).reshape(
            in_shape)
        got = pso.reshape(torch.from_numpy(x), target)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jso.reshape(jnp.asarray(x), target)))


INT_ARANGES = [(5,), (1, 10, 3), (10, 0, -2), (-3, 4), (0,), (2, 2)]
FLOAT_ARANGES = [(0.0, 1.0, 0.1), (1.5, -2.0, -0.3), (0.0, 100.0, 0.7),
                 (-1.0, 1.0, 1 / 3)]


@pytest.mark.parametrize("args,dtype", [
    *[(a, d) for a in INT_ARANGES for d in ("int32", "float32")],
    *[(a, "float32") for a in FLOAT_ARANGES]])
def test_arange_matches_jax(args, dtype):
    start, stop, step = (0, *args, 1)[-3:] if len(args) < 3 else args
    assert pso.arange_shape(start, stop, step) == \
        jso.arange_shape(start, stop, step)
    want = np.asarray(jso.arange(*args, dtype=getattr(jnp, dtype)))
    got = pso.arange(*args, dtype=getattr(torch, dtype), device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert str(got.numpy().dtype) == str(want.dtype)


def test_arange_step_tenth_rounds_twice():
    """The case that decides FMA or not: 0 + i * 0.1 in f32."""
    got = pso.arange(0.0, 3.0, 0.1, dtype=torch.float32, device="cpu")
    want = np.asarray(jso.arange(0.0, 3.0, 0.1, dtype=jnp.float32))
    assert got.numpy().view(np.int32).tolist() == want.view(np.int32).tolist()
    i = np.arange(30, dtype=np.float32)
    two_roundings = np.float32(0.0) + i * np.float32(0.1)
    np.testing.assert_array_equal(got.numpy(), two_roundings)


@pytest.mark.parametrize("bad", [(0, 10, 0), (10, 0, 1), (0, -5, 2)])
def test_arange_errors_match_jax(bad):
    for fn in (jso.arange_shape, pso.arange_shape):
        with pytest.raises(ValueError):
            fn(*bad)
    with pytest.raises(ValueError):
        pso.arange(*bad, device="cpu")


def test_through_custom_with_device():
    got = custom("arange", 2, 11, 3, device="cpu")
    assert got.tolist() == [2, 5, 8] and got.dtype == torch.int32
    got = custom("arange", 4, dtype=torch.float32, device=torch.device("cpu"))
    assert got.tolist() == [0.0, 1.0, 2.0, 3.0]
    x = torch.arange(12)
    assert custom("reshape", x, (3, -1)).shape == (3, 4)
    with pytest.raises(TypeError):
        pso.arange(5)  # no device: the port has no default
