"""ONNX/torch-semantics gather & scatter op family + shape inference.

PyTorch counterpart of ``bm25_tpu/ops/gather_scatter.py``.  The JAX
module is XLA gathers and scatters with no Pallas kernel, so this one is
plain PyTorch with no kernel.  It keeps the JAX results bit for bit, on
the CPU and the card alike, including where JAX's indexing modes decide:

* ``gather``, ``gather_elements`` and ``gather_reduce`` read like
  ``jnp.take``: an index below 0 gains the axis size (the op's own ONNX
  normalisation), then, if still below 0, gains it once more (``take``'s
  own); what is then out of range reads the fill value: NaN for floats,
  the least value of a signed integer type, the greatest of an unsigned
  one, True for bool.
* ``gather_nd`` reads like ``data[idx]``: one normalisation, then the
  index is clamped into range.
* The scatters drop what is out of range (JAX's ``mode="drop"``), after
  two normalisations in ``scatter_elements`` and one in ``scatter_nd``.
  ``index_put_`` would raise (or assert on the card) instead, so the
  indices are masked first.  Duplicate indices fold as JAX folds them:
  under ``"none"`` the last write wins, ``"max"``/``"min"`` order -0
  below +0 and let a NaN win, and a float ``"add"``/``"mul"`` folds in
  update order, the order XLA folds on the CPU.

Differences from the JAX signatures: a callable ``reduce_fn`` of
``gather_reduce`` takes ``dim=`` (``axis=`` in JAX), and ``update_fn`` of
``scatter_nd`` takes tensors.  Index tensors may be any integer dtype.
"""

from __future__ import annotations

import torch

from bm25_tpu_torch.ops.registry import register_op


def _fill_value(dtype: torch.dtype):
    """What ``jnp.take`` reads at an out-of-range index."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def _normalize_indices(indices: torch.Tensor, dim_size: int) -> torch.Tensor:
    """ONNX negative-index normalization: i < 0 -> i + dim_size."""
    return torch.where(indices < 0, indices + dim_size, indices)


def _take_index(indices, dim_size: int):
    """(safe index, in-range mask) of an index read as ``jnp.take`` reads
    it after the op's own normalisation."""
    i = _normalize_indices(_normalize_indices(torch.as_tensor(indices).long(),
                                              dim_size), dim_size)
    ok = (i >= 0) & (i < dim_size)
    return torch.where(ok, i, 0), ok


def _expand_mask(mask: torch.Tensor, lead: int, trail: int) -> torch.Tensor:
    return mask.reshape((1,) * lead + tuple(mask.shape) + (1,) * trail)


@register_op("gather")
def gather(data: torch.Tensor, indices, axis: int = 0) -> torch.Tensor:
    """ONNX Gather along ``axis`` with negative-index support."""
    axis = axis % data.dim()
    size = data.shape[axis]
    safe, ok = _take_index(indices, size)
    safe, ok = safe.to(data.device), ok.to(data.device)
    out_shape = data.shape[:axis] + safe.shape + data.shape[axis + 1:]
    if size == 0:
        return torch.full(out_shape, _fill_value(data.dtype),
                          dtype=data.dtype, device=data.device)
    out = data.index_select(axis, safe.reshape(-1)).reshape(out_shape)
    mask = _expand_mask(ok, axis, data.dim() - axis - 1)
    return torch.where(mask, out, _fill_value(data.dtype))


def _lowest(dtype):
    return float("-inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def _highest(dtype):
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def _fold(x: torch.Tensor, dim: int, op) -> torch.Tensor:
    """Reduce ``dim`` left to right: ``op(op(x0, x1), x2) ...``, the order
    XLA's CPU reduction takes over this axis."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


_GATHER_REDUCE_FNS = {
    "sum": (torch.add, lambda dt: 0),
    "max": (torch.maximum, _lowest),
    "min": (torch.minimum, _highest),
    "prod": (torch.mul, lambda dt: 1),
}


@register_op("gather_reduce")
def gather_reduce(data: torch.Tensor, indices, reduce_fn="sum",
                  reduce_init=None) -> torch.Tensor:
    """Fused gather + reduce: for each index row, reduce the gathered rows.

    ``data (N, *F)``, ``indices (*B, M)`` -> ``(*B, *F)`` (EmbeddingBag
    style).  ``reduce_fn`` is one of "sum"/"max"/"min"/"prod"/"mean", or a
    callable ``f(tensor, dim=...)`` (``axis=`` in the JAX version) paired
    with an explicit ``reduce_init`` identity.  Negative indices are
    padding and contribute the identity; "mean" divides by the number of
    non-pad indices (at least 1).  An index >= N reads the fill value.
    """
    indices = torch.as_tensor(indices, device=data.device).long()
    valid = indices >= 0
    safe, in_range = _take_index(torch.where(valid, indices, 0),
                                 data.shape[0])
    g = data[safe]  # (*B, M, *F)
    trail = data.dim() - 1
    g = torch.where(_expand_mask(in_range, 0, trail), g,
                    _fill_value(data.dtype))
    mask = _expand_mask(valid, 0, trail)
    dim = indices.dim() - 1
    if reduce_fn == "mean":
        total = _fold(torch.where(mask, g, 0).to(g.dtype), dim, torch.add)
        count = torch.clamp_min(mask.sum(dim=dim), 1).to(g.dtype)
        return total / count
    if callable(reduce_fn):
        if reduce_init is None:
            raise ValueError("a callable reduce_fn needs an explicit "
                             "reduce_init")
        init = reduce_init
        return reduce_fn(torch.where(mask, g, torch.as_tensor(
            init, dtype=g.dtype, device=g.device)), dim=dim)
    try:
        op, init_fn = _GATHER_REDUCE_FNS[reduce_fn]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown reduce_fn {reduce_fn!r}; expected one of "
            f"{sorted(_GATHER_REDUCE_FNS)} + ['mean'] or a callable"
        ) from None
    init = init_fn(g.dtype) if reduce_init is None else reduce_init
    init = torch.as_tensor(init, device=g.device).to(g.dtype)
    return _fold(torch.where(mask, g, init), dim, op)


@register_op("gather_elements")
def gather_elements(data: torch.Tensor, indices, axis: int = 0
                    ) -> torch.Tensor:
    """torch.gather / ONNX GatherElements; dims other than ``axis``
    broadcast between data and indices, as ``take_along_axis`` does."""
    axis = axis % data.dim()
    safe, ok = _take_index(indices, data.shape[axis])
    safe, ok = safe.to(data.device), ok.to(data.device)
    if safe.dim() != data.dim():
        raise ValueError(f"indices have {safe.dim()} dims, data {data.dim()}")
    d_shape, i_shape = list(data.shape), list(safe.shape)
    d_shape[axis] = i_shape[axis] = 1
    shape = list(torch.broadcast_shapes(d_shape, i_shape))
    d_shape, i_shape = shape.copy(), shape.copy()
    d_shape[axis], i_shape[axis] = data.shape[axis], safe.shape[axis]
    if data.shape[axis] == 0:
        return torch.full(i_shape, _fill_value(data.dtype), dtype=data.dtype,
                          device=data.device)
    out = torch.gather(data.expand(d_shape), axis, safe.expand(i_shape))
    return torch.where(ok.expand(i_shape), out, _fill_value(data.dtype))


@register_op("gather_nd")
def gather_nd(data: torch.Tensor, indices, batch_dims: int = 0
              ) -> torch.Tensor:
    """ONNX GatherND: the last indices dim indexes the dims of data after
    the first ``batch_dims`` (which data and indices share); an index is
    normalised once and clamped into range, as JAX's ``data[idx]`` reads.
    The JAX version maps over the batch dims with ``vmap``; here they are
    leading index arrays."""
    indices = torch.as_tensor(indices, device=data.device).long()
    r = indices.shape[-1]
    lead = indices.shape[:-1]
    idx = []
    for d in range(batch_dims):  # arange over batch dim d, broadcast
        shape = [1] * len(lead)
        shape[d] = data.shape[d]
        idx.append(torch.arange(data.shape[d], device=data.device)
                   .reshape(shape).expand(lead))
    for j in range(r):
        size = data.shape[batch_dims + j]
        i = _normalize_indices(indices[..., j], size)
        idx.append(i.clamp(0, size - 1))
    return data[tuple(idx)]


_INT_OF_WIDTH = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _order_key(x: torch.Tensor, reduction: str) -> torch.Tensor:
    """Integers ordered as XLA's scatter max/min orders ``x``: for floats
    -0 lies below +0 and a NaN wins (it is made the greatest value under
    "max" and the least under "min").  ``_from_key`` inverts it."""
    if not x.dtype.is_floating_point:
        return x
    b = x.view(_INT_OF_WIDTH[x.element_size()])
    info = torch.iinfo(b.dtype)
    key = b ^ ((b >> (8 * x.element_size() - 1)) & info.max)
    return torch.where(torch.isnan(x),
                       info.max if reduction == "max" else info.min, key)


def _from_key(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if not dtype.is_floating_point:
        return key
    bits = 8 * key.element_size() - 1
    return (key ^ ((key >> bits) & torch.iinfo(key.dtype).max)).view(dtype)


def _scatter_rows(data2: torch.Tensor, rows: torch.Tensor,
                  valid: torch.Tensor, upd2: torch.Tensor,
                  reduction: str) -> torch.Tensor:
    """``data2`` (R, S) with each valid update row folded into its target
    row, as JAX folds duplicate indices.

    Only a float (or bool) ``"add"``/``"mul"`` depends on the order of
    duplicates: it applies the updates one rank at a time (the rank of an
    update among those with its target), so each step writes distinct
    rows.  The other reductions are one scatter however many duplicates
    there are: ``"none"`` writes each target's last update, ``"max"`` and
    ``"min"`` reduce the order key, integers add and multiply (wrapping)
    the same in any order.
    """
    if rows.numel() == 0 or data2.shape[0] == 0:  # nothing lands
        return data2.clone()
    dtype = data2.dtype
    safe = torch.where(valid, rows, 0)
    if reduction == "none":
        pos = torch.arange(rows.numel(), device=rows.device)
        last = torch.full((data2.shape[0],), -1, dtype=torch.int64,
                          device=rows.device).scatter_reduce(
            0, safe, torch.where(valid, pos, -1), "amax")
        return torch.where((last >= 0)[:, None], upd2[last.clamp_min(0)],
                           data2)
    index = safe[:, None].expand(upd2.shape)
    ordered = dtype.is_floating_point or dtype.is_complex or dtype == torch.bool
    if reduction in ("max", "min") and dtype != torch.bool:
        key = _order_key(data2, reduction)
        info = torch.iinfo(key.dtype)
        skip = info.min if reduction == "max" else info.max
        src = torch.where(valid[:, None], _order_key(upd2, reduction), skip)
        return _from_key(key.scatter_reduce(0, index, src, "a" + reduction),
                         dtype)
    if not ordered:  # integer add / mul
        src = torch.where(valid[:, None], upd2, int(reduction == "mul"))
        return data2.scatter_reduce(
            0, index, src, "sum" if reduction == "add" else "prod")
    out = data2.clone()
    sel = valid.nonzero().reshape(-1)
    if sel.numel() == 0:
        return out
    rows, upd2 = rows[sel], upd2[sel]
    sorted_rows, perm = torch.sort(rows, stable=True)
    pos = torch.arange(rows.numel(), device=rows.device)
    first = torch.ones_like(sorted_rows, dtype=torch.bool)
    first[1:] = sorted_rows[1:] != sorted_rows[:-1]
    group_start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[perm] = pos - group_start
    op = _REDUCTIONS[reduction]
    for r in range(int(rank.max()) + 1):
        at = rank == r
        target = rows[at]
        out[target] = op(out[target], upd2[at])
    return out


# the fold of each reduction, as the rank-at-a-time path applies it
_REDUCTIONS = {
    "none": lambda old, new: new,
    "add": torch.add,
    "mul": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _ravel(coords, shape, device):
    """(linear index, all-in-range mask) of a list of coordinate tensors."""
    lin = torch.zeros((), dtype=torch.int64, device=device)
    ok = torch.ones((), dtype=torch.bool, device=device)
    for c, size in zip(coords, shape):
        ok = ok & (c >= 0) & (c < size)
        lin = lin * size + c
    return torch.where(ok, lin, 0), ok


@register_op("scatter_elements")
def scatter_elements(data: torch.Tensor, indices, updates, axis: int = 0,
                     reduction: str = "none") -> torch.Tensor:
    """torch.scatter / ONNX ScatterElements (out-of-place)."""
    data = torch.as_tensor(data)
    axis = axis % data.dim()
    if reduction not in _REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}")
    indices = torch.as_tensor(indices, device=data.device).long()
    # the op's normalisation, then the one JAX's ``.at`` indexing makes
    indices = _normalize_indices(_normalize_indices(indices,
                                                    data.shape[axis]),
                                 data.shape[axis])
    coords = list(torch.meshgrid(
        *[torch.arange(s, device=data.device) for s in indices.shape],
        indexing="ij"))
    coords[axis] = indices
    lin, ok = _ravel(coords, data.shape, data.device)
    upd = torch.as_tensor(updates, device=data.device).to(data.dtype)
    upd = torch.broadcast_to(upd, indices.shape).reshape(-1, 1)
    out = _scatter_rows(data.reshape(-1, 1), lin.reshape(-1),
                        ok.reshape(-1), upd, reduction)
    return out.reshape(data.shape)


@register_op("scatter_nd")
def scatter_nd(data: torch.Tensor, indices, updates, reduction: str = "none",
               update_fn=None) -> torch.Tensor:
    """ONNX ScatterND (out-of-place update of data).

    ``update_fn`` optionally replaces the named reduction with an
    arbitrary ``f(old, update) -> new`` on tensors, realised as gather
    (``gather_nd``'s clamped read) -> apply -> set.  Duplicate indices:
    the last write wins.
    """
    data = torch.as_tensor(data)
    indices = torch.as_tensor(indices, device=data.device).long()
    if update_fn is None and reduction not in _REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}")
    r = indices.shape[-1]
    lead = tuple(indices.shape[:-1])
    slice_shape = tuple(data.shape[r:])
    upd = torch.as_tensor(updates, device=data.device)
    if update_fn is not None:
        upd = update_fn(gather_nd(data, indices), upd)
    upd = torch.broadcast_to(upd.to(data.dtype), lead + slice_shape)
    coords = [_normalize_indices(indices[..., j], data.shape[j])
              for j in range(r)]
    lin, ok = _ravel(coords, data.shape[:r], data.device)
    lin, ok = torch.broadcast_to(lin, lead), torch.broadcast_to(ok, lead)
    size = 1
    for s in slice_shape:
        size *= s
    out = _scatter_rows(
        data.reshape(-1, size), lin.reshape(-1), ok.reshape(-1),
        upd.reshape(-1, size), "none" if update_fn is not None else reduction)
    return out.reshape(data.shape)


# ---------------------------------------------------------------------------
# shape inference (host-side, copied from the JAX module)
# ---------------------------------------------------------------------------


def gather_shape(data_shape: tuple, indices_shape: tuple, axis: int = 0) -> tuple:
    axis = axis % len(data_shape)
    return data_shape[:axis] + tuple(indices_shape) + data_shape[axis + 1 :]


def gather_nd_shape(
    data_shape: tuple, indices_shape: tuple, batch_dims: int = 0
) -> tuple:
    r = indices_shape[-1]
    return (
        tuple(indices_shape[:-1])
        + tuple(data_shape[batch_dims + r :])
    )


def scatter_nd_shape(data_shape: tuple, indices_shape: tuple, updates_shape: tuple) -> tuple:
    expected = tuple(indices_shape[:-1]) + tuple(data_shape[indices_shape[-1]:])
    if tuple(updates_shape) != expected:
        raise ValueError(
            f"updates shape {updates_shape} incompatible; expected {expected}"
        )
    return tuple(data_shape)
