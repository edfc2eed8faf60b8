"""Fused gather-accumulate: CUDA kernel B3 and its plain twin.

PyTorch counterpart of ``bm25_tpu/ops/gather_rows.py``, the dense
engine's scoring primitive:

    out[q] = sum_t w[q, t] * table[ids[q, t]]     (w = 1 unweighted)

``gather_add_rows`` (B3, replaces ``_gather_add_rows_pallas``) launches
the hand-written kernel of ``csrc/gather_rows.cu`` (see its header for
the design and what bounds it) on CUDA tensors and raises on anything the
kernel does not take; only a table on the CPU runs the plain PyTorch twin.
Both keep the JAX package's rounding, so the twin is bit-equal to JAX's
``gather_add_rows`` and the kernel to the twin:

* f32, unweighted: ``acc + row`` from +0, t ascending;
* f32, weighted: ``acc + w * row`` rounded once (a fused multiply-add,
  which is what XLA compiles the JAX scan to);
* bf16 table: every operation rounds to bf16 (the JAX accumulator has the
  table's dtype, and the weight is cast to it).

The Pallas kernel's (8, C, 128) tile view and its block-balanced doc
quantum are TPU layout and are not copied: ``doc_pad`` is this kernel's
own padding (a multiple of 4, for its vector loads).  Any D works; a D
that is not a multiple of 4 takes the kernel's scalar path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bm25_tpu_torch.utils.padding import next_multiple
from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.ops.ell_score import _fma_f32
from bm25_tpu_torch.ops.registry import register_op

# columns per vector load of the kernel
VEC = 4

# kernel launches, counted only where a kernel is launched
launches = {"gather_add_rows": 0}
# plain-twin runs (CPU tensors, or a direct call)
plain_calls = {"gather_add_rows": 0}


def doc_pad(d: int) -> int:
    """The doc-column padding of a resident table for d docs: a multiple
    of the kernel's vector width, so every row starts 16-byte aligned."""
    return next_multiple(max(d, 1), VEC)


def gather_add_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of B3: a loop over t in the kernel's order."""
    plain_calls["gather_add_rows"] += 1
    q, t = ids.shape
    acc = torch.zeros((q, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for ti in range(t):
        rows = table[ids[:, ti].long()]
        if weights is None:
            acc = acc + rows
        elif table.dtype == torch.float32:
            acc = _fma_f32(weights[:, ti : ti + 1], rows, acc)
        else:
            acc = acc + weights[:, ti : ti + 1].to(table.dtype) * rows
    return acc


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gather_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bm25_gather_add_rows.argtypes = [p, ctypes.c_longlong, i, p, p, i, i,
                                         i, p, p]
    lib.bm25_gather_add_rows.restype = i
    return lib


def gather_add_rows(table: torch.Tensor, ids: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """B3: sum of gathered rows, (V, D) table x (Q, T) ids -> (Q, D).

    ``ids`` are int32 in [0, V): callers map pad/OOV ids to an all-zero
    row (and zero their weights).  ``weights`` (Q, T) f32 scales each
    gathered row.  The result has the table's dtype (f32 or bf16); Q = 0
    or T = 0 gives zeros.
    """
    if table.device.type == "cpu":
        return gather_add_rows_plain(table, ids, weights)
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"gather_add_rows runs on cuda or cpu, not {device}")
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("table must be a 2-D float32 or bfloat16 tensor, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be (Q, T), got {tuple(ids.shape)}")
    q, t = ids.shape
    for x, name, dtype in ((table, "table", table.dtype),
                           (ids, "ids", torch.int32),
                           (weights, "weights", torch.float32)):
        if x is None:
            continue
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weights is not None and tuple(weights.shape) != (q, t):
        raise ValueError(f"weights shape {tuple(weights.shape)} != {(q, t)}")
    d = table.shape[1]
    out = torch.empty((q, d), dtype=table.dtype, device=device)
    if q == 0 or d == 0:
        return out
    vec = VEC if d % VEC == 0 and table.data_ptr() % 16 == 0 else 1
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bm25_gather_add_rows(
            table.data_ptr(), d, int(table.dtype == torch.bfloat16),
            ids.data_ptr(), None if weights is None else weights.data_ptr(),
            q, t, vec, out.data_ptr(), stream)
    _build.check(lib, err, "bm25_gather_add_rows launch")
    launches["gather_add_rows"] += 1
    return out


register_op("gather_add_rows")(gather_add_rows)
