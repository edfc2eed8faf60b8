"""Reshape / arange utilities with explicit shape inference.

PyTorch counterpart of ``bm25_tpu/ops/shape_ops.py``: a contiguous
reshape with -1 dimension inference and a validated arange.  Plain
PyTorch, as the JAX module is plain XLA.

``arange`` takes an explicit ``device`` (keyword-only): the port has no
default device, and ``custom("arange", n, device=...)`` places it.  For a
float dtype it computes ``start + iota * step`` in that dtype with two
roundings, as the JAX version does on the CPU (XLA does not fuse that
multiply-add; a test holds the two bit-equal at ``step=0.1``).
"""

from __future__ import annotations

import math

import torch

from bm25_tpu_torch.ops.registry import register_op


def reshape_shape(input_shape: tuple, target: tuple) -> tuple:
    """Resolve a reshape target with at most one -1 dim (reshape.mojo:68-113)."""
    target = tuple(int(t) for t in target)
    if sum(1 for t in target if t == -1) > 1:
        raise ValueError(f"at most one -1 allowed in reshape target {target}")
    total = math.prod(input_shape)
    if -1 in target:
        known = math.prod(t for t in target if t != -1)
        if known == 0 or total % known:
            raise ValueError(f"cannot infer -1 in {target} from {input_shape}")
        target = tuple(total // known if t == -1 else t for t in target)
    if math.prod(target) != total:
        raise ValueError(f"reshape {input_shape} -> {target} changes element count")
    return target


@register_op("reshape")
def reshape(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Contiguous reshape with -1 inference (a view where the strides
    allow, as ``torch.reshape`` gives)."""
    return torch.reshape(x, reshape_shape(tuple(x.shape), shape))


def arange_shape(start, stop, step) -> tuple[int]:
    """Validated output length (arange.mojo:47-59 semantics)."""
    if step == 0:
        raise ValueError("arange step must be nonzero")
    n = math.ceil((stop - start) / step)
    if n < 0:
        raise ValueError(f"arange({start}, {stop}, {step}) is empty/negative")
    return (int(n),)


@register_op("arange")
def arange(start, stop=None, step=1, dtype=torch.int32, *,
           device: torch.device | str) -> torch.Tensor:
    """``start + i * step`` for i in [0, n), n from ``arange_shape``, in
    ``dtype`` on ``device`` (which the JAX version does not take)."""
    if stop is None:
        start, stop = 0, start
    (n,) = arange_shape(start, stop, step)
    base = torch.arange(n, dtype=torch.int32, device=device)
    return (torch.tensor(start, dtype=dtype, device=device)
            + base.to(dtype) * torch.tensor(step, dtype=dtype, device=device))
