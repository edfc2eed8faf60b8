"""ELL membership-count scoring: CUDA kernels B1/B2 and their plain twins.

PyTorch counterpart of ``bm25_tpu/ops/ell_score.py``.  The sparse
engine's hot loop is

    base[q, d] = sum_l valT[l, d] * #{t : ids[q, t] == tokT[l, d]}

over slot-major ELL postings (``tokT``/``valT`` are (L, rows)).

* ``ell_score`` (B2, replaces ``ell_score_pallas``): the plain scan,
  (Q, rows) f32.  The engine build runs it with the H hot token ids as
  one-token queries to lay out the dense hot tier bit for bit.
* ``ell_score_fused`` (B1, replaces ``ell_score_fused``): the scan (each
  match may add a per-token weight instead of 1), then the hot split-bf16
  products ``hc @ hi`` and ``hc @ lo`` (and ``hc_lo @ hi`` for
  non-integer counts), the pad-row mask (``doc_ids < 0`` -> -inf) and the
  maxima of each group of GROUP rows, (Q, rows / GROUP), which the top-k
  tree starts from.  With a hot tier the card runs the scan, then a hot
  kernel on the tensor cores over the tokens ``hot_plan`` lists.

Both wrappers launch the hand-written kernels of ``csrc/ell_score.cu``
(see its header for the design and what bounds it) on CUDA tensors and
raise on anything the kernels do not take; only a tensor on the CPU runs
the plain PyTorch twin, which keeps the kernels' f32 order: the ELL-only
base is bit-equal between the two.  What only Mosaic needed is gone: the
query-count padding, the transposed group maxima and the bf16 ``valT``
upcast (``valT`` is f32 here).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from bm25_tpu_torch.utils.padding import cdiv, next_multiple
from bm25_tpu_torch.ops import _build

# bucket rows are padded to this multiple (the JAX engine's layout, kept
# so both engines build bit-equal arrays)
BLOCK_ROWS = 512
# slot-axis tile width: wider buckets sum balanced slot tiles in order
SLOT_TILE = 512
# rows per group maximum (the top-k tree's branch factor)
GROUP = 8
NEG_INF = float("-inf")
# hot tokens a stage of the hot kernel: the plan pads the counts' columns
# to a multiple of it
HOT_BK = 64

# kernel launches, counted only where a kernel is launched: B1 calls,
# the hot kernels they launch, B2 calls
launches = {"ell_score": 0, "ell_score_fused": 0, "ell_score_hot": 0}
# plain-twin runs (CPU tensors, or a direct call)
plain_calls = {"ell_score": 0, "ell_score_fused": 0}


def _slot_tiling(l_pad: int) -> tuple[int, int]:
    """(l_tile, l_tiles) for a bucket of padded width l_pad.

    Tiles are balanced, not fixed-width (8-aligned, at most SLOT_TILE):
    the tile partials are summed in order, so this fixes the f32 order
    the JAX kernel uses for wide buckets.
    """
    if l_pad <= SLOT_TILE:
        return l_pad, 1
    n = cdiv(l_pad, SLOT_TILE)
    l_tile = next_multiple(cdiv(l_pad, n), 8)
    return l_tile, cdiv(l_pad, l_tile)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """``a * b + c`` rounded once to f32, as a fused multiply-add does.

    The product of two f32 values is exact in f64; the f64 sum is made
    round-to-odd (TwoSum gives its exact error, and an inexact sum moves to
    the neighbour with an odd last bit), and an f64 round-to-odd result
    rounds to f32 exactly as the exact sum would (53 >= 24 + 2 bits).
    """
    x = a.double() * b.double()
    y = c.double()
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _scan_plain(ids, tokT, valT, rows: int, weights=None) -> torch.Tensor:
    """The membership-count scan in the kernels' f32 order: per slot, the
    matches over T reduce to an integer count (or, with weights, the sum
    of the matching weights in t order), then one fused multiply-add."""
    q, t = ids.shape
    ids = torch.where(ids >= 0, ids, -2)  # pads never match pad slots (-1)
    base = torch.zeros((q, rows), dtype=torch.float32, device=ids.device)
    l_pad = 0 if tokT is None else tokT.shape[0]
    l_tile, _ = _slot_tiling(l_pad)
    for l0 in range(0, l_pad, max(l_tile, 1)):
        part = torch.zeros_like(base)
        for l in range(l0, min(l0 + l_tile, l_pad)):
            tok_row = tokT[l][None, :]
            if weights is None:
                acc = torch.zeros((q, rows), dtype=torch.int32,
                                  device=ids.device)
                for ti in range(t):
                    acc += ids[:, ti : ti + 1] == tok_row
                acc = acc.float()
            else:
                acc = torch.zeros_like(base)
                for ti in range(t):
                    acc = acc + torch.where(ids[:, ti : ti + 1] == tok_row,
                                            weights[:, ti : ti + 1], 0.0)
            part = _fma_f32(acc, valT[l][None, :], part)
        base = part if l0 == 0 else base + part
    return base


def ell_score_plain(ids, tokT, valT) -> torch.Tensor:
    """Plain PyTorch twin of B2."""
    plain_calls["ell_score"] += 1
    return _scan_plain(ids, tokT, valT, tokT.shape[1])


def ell_score_fused_plain(ids, tokT, valT, doc_ids, hot_counts=None,
                          hotT=None, hotLo=None, weights=None,
                          hot_counts_lo=None):
    """Plain PyTorch twin of B1."""
    plain_calls["ell_score_fused"] += 1
    rows = doc_ids.shape[0]
    base = _scan_plain(ids, tokT, valT, rows, weights)
    if hot_counts is not None:
        hc = hot_counts.float()
        base = base + hc @ hotT.float()
        base = base + hc @ hotLo.float()
        if hot_counts_lo is not None:
            base = base + hot_counts_lo.float() @ hotT.float()
    base = torch.where(doc_ids[None, :] >= 0, base,
                       torch.full((), NEG_INF, device=base.device))
    gmax = base.reshape(base.shape[0], rows // GROUP, GROUP).amax(-1)
    return base, gmax


class HotPlan(NamedTuple):
    """The hot tokens a chunk uses, as B1's hot kernel takes them."""

    counts: torch.Tensor  # (Q, KP) bf16: hot_counts' columns in tokens order
    counts_lo: torch.Tensor | None  # the same of hot_counts_lo
    tokens: torch.Tensor  # (H,) int32: the used tokens ascending, then the rest
    n_used: torch.Tensor  # (1,) int32: how many are used


def hot_plan(hot_counts: torch.Tensor,
             hot_counts_lo: torch.Tensor | None = None) -> HotPlan:
    """List the hot tokens some query of the chunk counts (nonzero in
    ``hot_counts`` or ``hot_counts_lo``), on the counts' device and with no
    host sync.  ``counts`` holds their columns first, in ``tokens`` order,
    and zeros after, KP = H rounded up to HOT_BK columns; so ``counts[:,
    :n] @ hotT[tokens[:n]]`` is ``hot_counts @ hotT`` for n = n_used."""
    q, h = hot_counts.shape
    used = (hot_counts != 0).any(dim=0)
    if hot_counts_lo is not None:
        used |= (hot_counts_lo != 0).any(dim=0)
    tokens = torch.argsort((~used).to(torch.int32), stable=True)
    kp = next_multiple(max(h, 1), HOT_BK)

    def compact(c):
        if c is None:
            return None
        out = c.new_zeros((q, kp))
        out[:, :h] = c[:, tokens]
        return out

    return HotPlan(compact(hot_counts), compact(hot_counts_lo),
                   tokens.to(torch.int32),
                   used.sum(dtype=torch.int32).reshape(1))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ell_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bm25_ell_score.argtypes = [p, i, i, p, p, i, i, i, p, p]
    lib.bm25_ell_score.restype = i
    lib.bm25_ell_score_fused.argtypes = [
        p, p, i, i, p, p, i, i, i, p, p, p, i, p, p, p, p, i, p, p, p]
    lib.bm25_ell_score_fused.restype = i
    return lib


def _expect(x: torch.Tensor | None, name: str, dtype, shape, device):
    if x is None:
        raise ValueError(f"{name} is required")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _check_slots(ids, tokT, valT, rows, device):
    if ids.dim() != 2:
        raise ValueError(f"ids must be (Q, T), got {tuple(ids.shape)}")
    _expect(ids, "ids", torch.int32, ids.shape, device)
    if tokT is None:
        if valT is not None:
            raise ValueError("valT given without tokT")
        return 0
    _expect(tokT, "tokT", torch.int32, (tokT.shape[0], rows), device)
    _expect(valT, "valT", torch.float32, tokT.shape, device)
    return tokT.shape[0]


def ell_score(ids: torch.Tensor, tokT: torch.Tensor,
              valT: torch.Tensor) -> torch.Tensor:
    """B2: score one ELL bucket, (Q, rows) float32."""
    if ids.device.type == "cpu":
        return ell_score_plain(ids, tokT, valT)
    device = ids.device
    if device.type != "cuda":
        raise ValueError(f"ell_score runs on cuda or cpu, not {device}")
    rows = tokT.shape[1]
    l_pad = _check_slots(ids, tokT, valT, rows, device)
    q, t = ids.shape
    out = torch.empty((q, rows), dtype=torch.float32, device=device)
    if q == 0 or rows == 0:
        return out
    l_tile, _ = _slot_tiling(l_pad)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bm25_ell_score(
            _ptr(ids), q, t, _ptr(tokT), _ptr(valT), l_pad, rows, l_tile,
            _ptr(out), stream)
    _build.check(lib, err, "bm25_ell_score launch")
    launches["ell_score"] += 1
    return out


def ell_score_fused(
    ids: torch.Tensor,  # (Q, T) int32, pads/OOV < 0
    tokT: torch.Tensor | None,  # (L, rows) int32, -1 padded; None: no slots
    valT: torch.Tensor | None,  # (L, rows) float32
    doc_ids: torch.Tensor,  # (rows,) int32, -1 for pad rows
    hot_counts: torch.Tensor | None = None,  # (Q, H) bf16
    hotT: torch.Tensor | None = None,  # (H, rows) bf16 high part
    hotLo: torch.Tensor | None = None,  # (H, rows) bf16 residual
    weights: torch.Tensor | None = None,  # (Q, T) f32 per-token weights
    hot_counts_lo: torch.Tensor | None = None,  # (Q, H) bf16 count residual
    plan: HotPlan | None = None,  # hot_plan(hot_counts, hot_counts_lo)
) -> tuple[torch.Tensor, torch.Tensor]:
    """B1: fused bucket scoring -> (masked base (Q, rows), gmax (Q, rows/8)).

    ``weights`` makes each match add its token's weight instead of 1;
    ``hot_counts_lo`` (non-integer counts) adds the third split product
    ``hot_counts_lo @ hotT``.  ``plan`` is ``hot_plan`` of the counts, made
    once per chunk by a caller that scores several buckets (made here when
    None); the plain twin does not need it.
    """
    if ids.device.type == "cpu":
        return ell_score_fused_plain(ids, tokT, valT, doc_ids, hot_counts,
                                     hotT, hotLo, weights, hot_counts_lo)
    device = ids.device
    if device.type != "cuda":
        raise ValueError(f"ell_score_fused runs on cuda or cpu, not {device}")
    rows = doc_ids.shape[0]
    if doc_ids.dim() != 1 or rows % GROUP:
        raise ValueError(f"doc_ids must be (rows,) with rows % {GROUP} == 0")
    _expect(doc_ids, "doc_ids", torch.int32, (rows,), device)
    l_pad = _check_slots(ids, tokT, valT, rows, device)
    q, t = ids.shape
    if weights is not None:
        _expect(weights, "weights", torch.float32, (q, t), device)
    h = 0
    if hot_counts is not None:
        h = hot_counts.shape[1]
        _expect(hot_counts, "hot_counts", torch.bfloat16, (q, h), device)
        _expect(hotT, "hotT", torch.bfloat16, (h, rows), device)
        _expect(hotLo, "hotLo", torch.bfloat16, (h, rows), device)
        if hotT.data_ptr() % 16 or hotLo.data_ptr() % 16:
            raise ValueError("hotT and hotLo must be 16-byte aligned")
    if hot_counts_lo is not None:
        if hot_counts is None:
            raise ValueError("hot_counts_lo requires hot_counts")
        _expect(hot_counts_lo, "hot_counts_lo", torch.bfloat16, (q, h), device)
    base = torch.empty((q, rows), dtype=torch.float32, device=device)
    gmax = torch.empty((q, rows // GROUP), dtype=torch.float32, device=device)
    if q == 0 or rows == 0:
        return base, gmax
    kp = 0
    if h:
        if plan is None:
            plan = hot_plan(hot_counts, hot_counts_lo)
        kp = next_multiple(h, HOT_BK)
        _expect(plan.counts, "plan.counts", torch.bfloat16, (q, kp), device)
        if (plan.counts_lo is None) != (hot_counts_lo is None):
            raise ValueError("plan.counts_lo must come with hot_counts_lo")
        if plan.counts_lo is not None:
            _expect(plan.counts_lo, "plan.counts_lo", torch.bfloat16,
                    (q, kp), device)
        _expect(plan.tokens, "plan.tokens", torch.int32, (h,), device)
        _expect(plan.n_used, "plan.n_used", torch.int32, (1,), device)
    else:
        plan = HotPlan(None, None, None, None)
    l_tile, _ = _slot_tiling(l_pad)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bm25_ell_score_fused(
            _ptr(ids), _ptr(weights), q, t, _ptr(tokT), _ptr(valT), l_pad,
            rows, l_tile, _ptr(doc_ids), _ptr(plan.counts),
            _ptr(plan.counts_lo), kp, _ptr(plan.tokens), _ptr(plan.n_used),
            _ptr(hotT), _ptr(hotLo), h, _ptr(base), _ptr(gmax), stream)
    _build.check(lib, err, "bm25_ell_score_fused launch")
    launches["ell_score_fused"] += 1
    if h:
        launches["ell_score_hot"] += 1
    return base, gmax
