"""Exact weighted token counts and the bf16 high/residual split.

PyTorch counterpart of ``bm25_tpu/utils/counts.py``.  Eager PyTorch runs
each operation as written, so the XLA rewrites the JAX version guards
against (a one-hot sum turned into a bf16-pass matmul; the ``bf16 -> f32``
round trip simplified away) cannot happen here and no barrier is needed.
"""

from __future__ import annotations

import torch


def weighted_counts(ids: torch.Tensor, w: torch.Tensor,
                    width: int) -> torch.Tensor:
    """Exact f32 (Q, width) weighted counts: cf[q, v] = sum of w[q, t] over
    t with ids[q, t] == v, added from +0 in t order (JAX's scatter-add
    order on the CPU).  Negative ids (pad/OOV/cold) contribute nothing.

    On the CPU ``scatter_add_`` adds in that order; on CUDA it adds by
    atomics, whose order (so the bits of three or more weights of one id)
    varies from run to run, so the card takes ``index_put_(accumulate=
    True)``, which sorts the indices stably and adds each run in order.
    """
    q = ids.shape[0]
    valid = ids >= 0
    safe = torch.where(valid, ids, width).long()  # extra column catches pads
    wm = torch.where(valid, w.float(), torch.zeros((), device=w.device))
    cf = torch.zeros((q, width + 1), dtype=torch.float32, device=ids.device)
    if ids.is_cuda:
        rows = torch.arange(q, device=ids.device)[:, None].expand_as(safe)
        cf.index_put_((rows, safe), wm, accumulate=True)
    else:
        cf.scatter_add_(1, safe, wm)
    return cf[:, :width]


def split_bf16(cf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 (high, residual) pair whose exact sum is ~cf (round to nearest
    even at both casts, as in JAX)."""
    hi = cf.to(torch.bfloat16)
    lo = (cf - hi.float()).to(torch.bfloat16)
    return hi, lo
