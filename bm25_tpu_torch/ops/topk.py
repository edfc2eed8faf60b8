"""Top-k op library: exact selection, the radix-select kernel, sampling.

PyTorch counterpart of ``bm25_tpu/ops/topk.py``.  The contract is the
package's: results sorted descending (ascending for ``largest=False``),
ties to the smaller index, distinct indices.  Indices are int64.

* ``top_k_tree`` / ``select_top_k``: the branch-8 tournament tree, whose
  merges are ``torch.sort(..., stable=True)`` over index-ordered
  candidates (plain JAX in the JAX package, so plain PyTorch here).
  ``torch.topk`` is never used: its tie order on CUDA is not specified.
* ``top_k``: the public dispatcher (axis, largest, sorted).
  ``implementation="pallas"`` runs kernel B4; ``"auto"``, ``"lax"`` and
  ``"tree"`` run the tree, an exact stable selection (the JAX package's
  ``_auto_impl`` thresholds are TPU measurements and are not copied).
* ``top_k_two_stage`` (B4, replaces ``_pallas_topk_lastaxis``: an exact
  radix select on this card, routed as JAX routes its kernel) and
  ``gumbel_choice`` (B5, replaces ``_pallas_gumbel_choice``) launch the
  hand-written kernels of ``csrc/topk.cu`` on CUDA tensors; only a tensor
  on the CPU runs their plain twins (``topk_two_stage_plain``,
  ``gumbel_choice_plain``), which follow the kernels step for step.
* ``top_k_blockwise`` and ``top_k_fused_sampling``, whose ``"pallas"``
  step (``gumbel_sample``: the logits, then B5's choice and the sampled
  id in one launch; twin ``gumbel_sample_plain``) reads its seed on the
  card.
* ``union_group_select`` / ``gather_group_candidates``: one group
  tournament across buckets, and the candidates of the won groups (plain
  PyTorch on the tree, as in JAX; not wired into ``SparseEngine`` yet).

NaN: the tree ranks NaN smallest, B4 (like the Pallas kernel) largest;
callers mask non-finite scores first, as every engine does.  B5 ranks a
NaN z largest and takes the first, as ``argmax`` does (a fully -inf row
of top-k values gives NaN logits and samples its first id).
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math
from typing import NamedTuple

import torch

from bm25_tpu_torch.utils.padding import cdiv, next_multiple
from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.ops.registry import register_op

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")
DOC_SENTINEL = 2**31 - 1

# JAX's chunk rule for its kernel (bm25_tpu/ops/topk.py:42-43, 251-261):
# B4 serves exactly the (n, k) that JAX's kernel serves
_PALLAS_CHUNK = 16384
_PALLAS_MAX_BLOCKS = 16
# B4's grid: each block reads at least MIN_SLICE values of its row; a row
# is cut into at most MAX_SLICES slices (csrc/topk.cu), and ROW_CHUNK rows
# go to one launch (the histograms take 32 KB per row and slice)
MIN_SLICE = 32768
MAX_SLICES = 128
ROW_CHUNK = 4096
# the largest k that B4 sorts in shared memory (csrc/topk.cu)
SORT_SMEM_KEYS = 16384
# B4's side buffer: after a digit pass, a row whose keys at or above the
# chosen prefix number at most min(n / SIDE_DIV, SIDE_MAX) has them
# compacted there, and the passes after it read them instead of the row
# (read at each call; SIDE_MAX = 0 turns the buffer off)
SIDE_DIV = 8
SIDE_MAX = 65536
# B4's digits, high first: (shift, bits)
DIGITS = ((19, 13), (8, 11), (0, 8))

# kernel launches, counted only where a kernel is launched (B4 counts one
# per call, all passes)
launches = {"top_k_two_stage": 0, "gumbel_choice": 0}
# plain-twin runs (CPU tensors, or a direct call)
plain_calls = {"top_k_two_stage": 0, "gumbel_choice": 0}
# B4 calls whose (n, k) JAX's kernel does not serve: served by the tree
tree_calls = {"top_k_two_stage": 0}


def _sorted_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """(vals, idx) -> k largest, sorted desc, ties by candidate order.

    A stable ascending sort of the order-reversed values: negation for
    floats, bitwise NOT for integers (exact over the whole range,
    including the minimum that ``_tree_level`` pads with).
    """
    if vals.dtype.is_floating_point:
        nv, perm = torch.sort(-vals, dim=1, stable=True)
        return -nv[:, :k], torch.gather(idx, 1, perm[:, :k])
    nv, perm = torch.sort(~vals, dim=1, stable=True)
    return ~nv[:, :k], torch.gather(idx, 1, perm[:, :k])


def _tree_level(x2: torch.Tensor, k: int, branch: int, base: int,
                maxes: torch.Tensor | None = None):
    """Recursive top-k over the last axis of (B, N) via branch-wide maxima.

    At most k-1 groups can rank strictly above the group of the k-th
    value, so the k groups with the largest maxima hold the top k; the
    recursion selects them on the (B, N/branch) maxima, then one stable
    sort of their k*branch index-ordered members finishes.  ``maxes``,
    when given, is the first level precomputed (the fused kernel's group
    maxima); N must then be a multiple of ``branch``.
    """
    b, n = x2.shape
    if n <= base or n // branch < k:
        iota = torch.arange(n, device=x2.device).expand(b, n)
        return _sorted_topk(x2, iota, k)
    if maxes is None:
        n_pad = next_multiple(n, branch)
        if n_pad != n:
            lowest = (NEG_INF if x2.dtype.is_floating_point
                      else torch.iinfo(x2.dtype).min)
            pad = torch.full((b, n_pad - n), lowest, dtype=x2.dtype,
                             device=x2.device)
            x2 = torch.cat([x2, pad], dim=1)
        groups = x2.reshape(b, n_pad // branch, branch)
        maxes = groups.amax(dim=-1)
    else:
        assert n % branch == 0, (n, branch)
        groups = x2.reshape(b, n // branch, branch)
    _, top_groups = _tree_level(maxes, k, branch, base)
    top_groups = torch.sort(top_groups, dim=1).values  # index order: ties
    cand = torch.gather(
        groups, 1, top_groups[:, :, None].expand(b, k, branch)
    ).reshape(b, k * branch)
    offsets = torch.arange(branch, device=x2.device)
    cand_idx = (top_groups[:, :, None] * branch + offsets).reshape(
        b, k * branch)
    return _sorted_topk(cand, cand_idx, k)


def top_k_tree(x: torch.Tensor, k: int, branch: int = 8,
               base: int | None = None):
    """Exact top-k over the last axis: (values, int64 indices)."""
    orig_shape = x.shape
    n = orig_shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for axis of {n}")
    if base is None:
        base = max(2 * k, 4096)
    b = x.numel() // n if x.dim() > 1 else 1
    vals, idx = _tree_level(x.reshape(b, n), k, branch, base)
    out_shape = orig_shape[:-1] + (k,)
    return vals.reshape(out_shape), idx.reshape(out_shape)


def select_top_k(x: torch.Tensor, k: int):
    """Exact top-k of a (batch, N) score matrix.

    The JAX version dispatches between ``lax.top_k`` and the tree by a
    TPU-measured rule; both give the same answer, and here the tree (which
    is one stable sort when N <= max(2k, 4096)) serves every shape.  NaN
    ranks smallest: callers mask non-finite scores first.
    """
    return top_k_tree(x, k)


def top_k_tree_with_maxes(x2: torch.Tensor, maxes: torch.Tensor, k: int,
                          branch: int = 8, base: int | None = None):
    """``top_k_tree`` whose first level is precomputed:
    ``maxes[b, g] = max(x2[b, g*branch : (g+1)*branch])``."""
    b, n = x2.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for axis of {n}")
    if n % branch or tuple(maxes.shape) != (b, n // branch):
        raise ValueError(
            f"maxes shape {tuple(maxes.shape)} does not match branch-{branch} "
            f"groups of {tuple(x2.shape)}"
        )
    if base is None:
        base = max(2 * k, 4096)
    return _tree_level(x2, k, branch, base, maxes=maxes)


def union_group_select(gmaxes: list[torch.Tensor], k: int):
    """One group tournament over every bucket's (Q, rows_b / branch) group
    maxima, concatenated: ``(gpos, ok)``, the (Q, k) int64 winning group
    positions in concatenated group space and a 0-d bool tensor.

    ``ok`` is true when, for every query, the (k+1)-th group max is
    strictly below the k-th (theta): then no doc outside the k selected
    groups can reach the top k, even by a tie.  A tie straddling the k
    boundary makes it false, and the caller must take the exact
    per-bucket path.  ``ok`` stays on the device (nothing here syncs).
    """
    gm = torch.cat(list(gmaxes), dim=1)
    gv, gpos = top_k_tree(gm, k + 1)
    theta = gv[:, k - 1]
    ok = torch.all(gv[:, k] < theta)
    return gpos[:, :k], ok


def gather_group_candidates(bases: list[torch.Tensor],
                            dids: list[torch.Tensor], gpos: torch.Tensor,
                            branch: int = 8):
    """Flat (Q, k*branch) candidate (f32 values, int32 doc ids) of the won
    groups: per bucket, (Q, rows_b) f32 scores (pads -inf) and (rows_b,)
    int32 doc ids (-1 pads); ``gpos`` (Q, k) in concatenated group space.

    Slots no bucket fills keep ``DOC_SENTINEL``; they and pad rows score
    -inf, so one (score desc, doc asc) sort of the result gives the exact
    top k under the smaller-doc-id tie contract.
    """
    q, k = gpos.shape
    dev = gpos.device
    vals = torch.full((q, k, branch), NEG_INF, dtype=torch.float32,
                      device=dev)
    docs = torch.full((q, k, branch), DOC_SENTINEL, dtype=torch.int32,
                      device=dev)
    off = 0
    for base, did in zip(bases, dids):
        gb = base.shape[1] // branch
        b3 = base.reshape(q, gb, branch)
        dg = did.reshape(gb, branch)
        rel = gpos - off
        in_b = ((rel >= 0) & (rel < gb))[:, :, None]
        relc = rel.clamp(0, gb - 1)
        v = torch.gather(b3, 1, relc[:, :, None].expand(q, k, branch))
        vals = torch.where(in_b, v, vals)
        docs = torch.where(in_b, dg[relc], docs)
        off += gb
    flat_v = vals.reshape(q, k * branch)
    flat_d = docs.reshape(q, k * branch)
    flat_v = torch.where((flat_d < 0) | (flat_d == DOC_SENTINEL), NEG_INF,
                         flat_v)
    return flat_v, flat_d


# ---------------------------------------------------------------------------
# B4: two-stage top-k over the last axis
# ---------------------------------------------------------------------------


def kernel_serves(n: int, k: int) -> bool:
    """Whether B4 runs its kernel for (n, k): where JAX's kernel does
    (``_pallas_topk_lastaxis``: balanced chunks of at most 16 blocks,
    rounded up to 128), i.e. one chunk, or k no wider than a chunk.
    Routing only: the radix select has no chunk of its own."""
    chunk = min(_PALLAS_CHUNK, next_multiple(n, 128))
    nblocks = min(cdiv(n, chunk), _PALLAS_MAX_BLOCKS)
    chunk = next_multiple(cdiv(n, nblocks), 128)
    return cdiv(n, chunk) == 1 or k <= chunk


def order_key(x: torch.Tensor) -> torch.Tensor:
    """B4's order keys of f32 values, as int64 holding a uint32: unsigned
    order is the float order, NaN is largest, -0 equals +0, and every key
    is > 0."""
    b = x.view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(b >= 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    key = torch.where(x == 0, 0x80000000, key)
    return torch.where(torch.isnan(x), 0xFFFFFFFF, key)


def radix_threshold(keys: torch.Tensor, k: int):
    """B4's histogram passes in torch ops on (B, n) order keys: per row the
    key T of the k-th largest and ``ties``, how many keys equal to T the
    top k takes (k minus the keys > T).  Each pass counts one digit of
    the keys that share the prefix chosen so far (``bincount``) and picks
    the digit that holds the k-th key."""
    b, _ = keys.shape
    rows = torch.arange(b, device=keys.device)[:, None]
    prefix = torch.zeros(b, dtype=torch.int64, device=keys.device)
    need = torch.full((b,), k, dtype=torch.int64, device=keys.device)
    for shift, bits in DIGITS:
        hi = shift + bits
        match = (keys >> hi) == (prefix >> hi)[:, None]
        digit = (keys >> shift) & ((1 << bits) - 1)
        flat = (rows * (1 << bits) + digit)[match]
        hist = torch.bincount(flat, minlength=b << bits).reshape(b, 1 << bits)
        at_least = hist.flip(1).cumsum(1).flip(1)  # keys in bins >= d
        # the digit holding the need-th key: the highest d with
        # at_least[d] >= need (at_least falls as d grows)
        d = (at_least >= need[:, None]).sum(1) - 1
        above = (at_least - hist).gather(1, d[:, None])[:, 0]
        need = need - above
        prefix = prefix | (d << shift)
    return prefix, need


def topk_two_stage_plain(x2: torch.Tensor, k: int):
    """Plain PyTorch twin of B4 on (B, n) f32: (values, int64 indices).

    The kernel's steps in torch ops: the histogram passes
    (``radix_threshold``), the ordered compaction of the keys > T and of
    the first ``ties`` keys == T (``cumsum`` ranks), then a stable sort of
    the k candidates by key, descending.
    """
    plain_calls["top_k_two_stage"] += 1
    b, n = x2.shape
    keys = order_key(x2)
    thr, ties = radix_threshold(keys, k)
    gt = keys > thr[:, None]
    eq = keys == thr[:, None]
    gt_rank = gt.cumsum(1) - 1
    eq_rank = eq.cumsum(1) - 1
    n_gt = (k - ties)[:, None]
    # destinations in the candidate row; k is a dump slot for the rest
    dest = torch.where(gt, gt_rank,
                       torch.where(eq & (eq_rank < ties[:, None]),
                                   n_gt + eq_rank, k))
    pos = torch.arange(n, device=x2.device).expand(b, n)
    cand = torch.empty((b, k + 1), dtype=torch.int64, device=x2.device)
    cand.scatter_(1, dest, pos)
    cand = cand[:, :k]
    _, order = torch.sort(keys.gather(1, cand), dim=1, descending=True,
                          stable=True)
    idx = cand.gather(1, order)
    return x2.gather(1, idx), idx


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bm25_topk_select.argtypes = [p, i, i, i, i, i, i] + [p] * 12
    lib.bm25_topk_select.restype = i
    lib.bm25_gumbel_choice.argtypes = [p, i, i, p, ctypes.c_uint32, p, i, i,
                                       i, p, i, p]
    lib.bm25_gumbel_choice.restype = i
    return lib


def _check_cuda_f32(x: torch.Tensor, name: str, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"{name} must be a contiguous 2-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def radix_slices(rows: int, n: int, sms: int) -> tuple[int, int]:
    """B4's cut of each row: (slices, slice length, a multiple of 4).
    Enough (row, slice) blocks for two per SM where the rows are few, each
    slice at least MIN_SLICE values; one slice per row otherwise."""
    want = cdiv(2 * sms, max(rows, 1))
    slices = max(1, min(want, n // MIN_SLICE, MAX_SLICES))
    slice_len = next_multiple(cdiv(n, slices), 4)
    return cdiv(n, slice_len), slice_len


def top_k_two_stage(x2: torch.Tensor, k: int):
    """B4: top-k of each row of a (B, n) f32 tensor -> (values, int64
    indices), sorted descending (NaN largest, -0 equal to +0), ties to the
    smaller index, distinct indices.

    The kernel is an exact radix select (csrc/topk.cu): three histogram
    passes find the k-th key, one pass writes the positions above it and
    the first ties in position order, and a sort orders the k of them.
    Its side buffer holds ``min(n // SIDE_DIV, SIDE_MAX)`` entries per row;
    the result does not depend on its size.
    It serves the (n, k) that JAX's kernel serves (``kernel_serves``);
    the tree serves the rest, as the JAX wrapper hands them to its tree:
    such calls are counted in ``tree_calls`` and logged as warnings.
    """
    b, n = x2.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for axis of {n}")
    if not kernel_serves(n, k):
        tree_calls["top_k_two_stage"] += 1
        logger.warning("top_k_two_stage: k=%d is wider than a chunk of JAX's "
                       "kernel on the (%d-wide) axis; served by the tree",
                       k, n)
        return top_k_tree(x2, k)
    if x2.device.type == "cpu":
        return topk_two_stage_plain(x2, k)
    _check_cuda_f32(x2, "x", "top_k_two_stage")
    dev = x2.device
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int64, device=dev)
    if b == 0:
        return out_v, out_i
    lib = _lib()
    rows = min(b, ROW_CHUNK)  # every launch's rows, the last one's fewer
    slices, slice_len = radix_slices(rows, n, _sm_count(dev.index or 0))
    cap = min(n // SIDE_DIV, SIDE_MAX)
    # hist, state, cnt, side key/pos, candidate key/pos, sort scratch
    sizes = ([rows * slices * 8192, rows * 4, rows * slices * 4]
             + [rows * cap] * 2 + [rows * k] * 2
             + [rows * k] * (2 if k > SORT_SMEM_KEYS else 0))
    ws = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    ptrs, at = [], ws.data_ptr()
    for size in sizes + [0] * (9 - len(sizes)):
        ptrs.append(at if size else None)
        at += 4 * size
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for r0 in range(0, b, ROW_CHUNK):
            r1 = min(b, r0 + ROW_CHUNK)
            err = lib.bm25_topk_select(
                x2.data_ptr() + 4 * r0 * n, r1 - r0, n, k, slices,
                slice_len, cap, *ptrs, out_v.data_ptr() + 4 * r0 * k,
                out_i.data_ptr() + 8 * r0 * k, stream)
            _build.check(lib, err, "bm25_topk_select launch")
    launches["top_k_two_stage"] += 1
    return out_v, out_i


# ---------------------------------------------------------------------------
# public dispatcher
# ---------------------------------------------------------------------------


def _reverse(x: torch.Tensor) -> torch.Tensor:
    """Exact order reversal: negation for floats, bitwise NOT for integers
    (overflow-free, unlike negation at the minimum)."""
    return -x if x.dtype.is_floating_point else ~x


def top_k(x, k: int, axis: int = -1, largest: bool = True,
          sorted: bool = True,  # noqa: A002 - mirrors the reference signature
          implementation: str = "auto"):
    """(values, int64 indices) of the k largest (or smallest) along ``axis``.

    Results are sorted (descending for largest, ascending for smallest);
    ties resolve to the smaller index.  ``sorted=False`` is accepted for
    API parity and returns the sorted order.  ``implementation``:
    ``"pallas"`` runs kernel B4 (float inputs only; the name is kept so
    that JAX callers port unchanged), ``"auto"``, ``"lax"`` and ``"tree"``
    the exact tree.
    """
    x = torch.as_tensor(x)
    if implementation not in ("auto", "lax", "tree", "pallas"):
        raise ValueError(f"unknown implementation {implementation!r}")
    if not 1 <= k <= x.shape[axis]:
        raise ValueError(f"k={k} out of range for axis of {x.shape[axis]}")
    axis = axis % x.dim()
    if axis != x.dim() - 1:
        v, i = top_k(torch.movedim(x, axis, -1), k, -1, largest, sorted,
                     implementation)
        return torch.movedim(v, -1, axis), torch.movedim(i, -1, axis)
    if x.dtype == torch.bool:  # as 0/1 bytes: ~ then reverses the order
        v, i = top_k(x.to(torch.uint8), k, -1, largest, sorted,
                     implementation)
        return v.bool(), i
    xs = x if largest else _reverse(x)
    if implementation == "pallas":
        if not xs.dtype.is_floating_point:
            raise TypeError(
                "implementation='pallas' supports float inputs only; use "
                "'tree' or 'lax' for integer top-k")
        if xs.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise TypeError("implementation='pallas' takes float32, bfloat16 "
                            f"or float16, not {xs.dtype}")
        n = xs.shape[-1]
        # bf16/f16 -> f32 is exact and keeps the order
        v, i = top_k_two_stage(xs.reshape(-1, n).float().contiguous(), k)
        out_shape = xs.shape[:-1] + (k,)
        v, i = v.to(xs.dtype).reshape(out_shape), i.reshape(out_shape)
    else:
        v, i = top_k_tree(xs, k)
    return (v if largest else _reverse(v)), i


def top_k_blockwise(x, k: int, block: int | None = None):
    """Exact top-k over a huge last axis via block-max pre-selection.

    The k blocks with the largest maxima hold the top k (at most k-1
    blocks can have a max above the k-th value's block); their members,
    gathered in index order, go through one stable selection, so ties
    resolve to the smaller index.
    """
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for axis of {n}")
    if block is None:
        # minimise k*block + n/block -> block ~ sqrt(n/k), 128-aligned
        block = max(128, next_multiple(int(math.sqrt(n / k)), 128))
    nb = cdiv(n, block)
    if nb <= k:  # no reduction possible
        return top_k(x, k)
    b = x.numel() // n
    x2 = x.reshape(b, n)
    if nb * block != n:
        lowest = (NEG_INF if x2.dtype.is_floating_point
                  else torch.iinfo(x2.dtype).min)
        x2 = torch.cat([x2, x2.new_full((b, nb * block - n), lowest)], dim=1)
    groups = x2.reshape(b, nb, block)
    iota = torch.arange(nb, device=x2.device).expand(b, nb)
    _, top_blocks = _sorted_topk(groups.amax(dim=-1), iota, k)
    top_blocks = torch.sort(top_blocks, dim=1).values  # index order
    cand = torch.gather(groups, 1, top_blocks[:, :, None].expand(b, k, block))
    cand_idx = (top_blocks[:, :, None] * block
                + torch.arange(block, device=x2.device)).reshape(b, k * block)
    vals, idx = _sorted_topk(cand.reshape(b, k * block), cand_idx, k)
    out_shape = x.shape[:-1] + (k,)
    return vals.reshape(out_shape), idx.reshape(out_shape)


# ---------------------------------------------------------------------------
# B5: Gumbel-max choice, and fused top-k sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
# 1e-12 rounded to f32, the JAX kernel's floor on u
_U_FLOOR = 9.999999960041972e-13


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for uint32 values held in int64, without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's 32-bit integer hash (a bijection of uint32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seed_value(seed) -> int:
    """A seed's low 32 bits: an int, or a one-element integer tensor."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(()).item()
    return int(seed) & _M32


def gumbel_noise_plain(seed, b: int, k: int,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """B5's (B, k) f32 Gumbel noise ``-log(-log u)`` for ``seed``: the hash
    of (seed, row, column), its top 24 bits as u = bits * 2^-24 + 1e-12."""
    s = _mix32(torch.tensor(_seed_value(seed), dtype=torch.int64,
                            device=device))
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    bits = _mix32(_mix32(s ^ rows) ^ cols)
    u = (bits >> 8).float() * 2.0**-24 + torch.tensor(
        _U_FLOOR, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(u))


def gumbel_choice_plain(logits: torch.Tensor, seed) -> torch.Tensor:
    """Plain PyTorch twin of B5: (B,) int64 first argmax of logits + noise
    (NaN ranks largest, ties to the smaller column)."""
    plain_calls["gumbel_choice"] += 1
    b, k = logits.shape
    z = logits + gumbel_noise_plain(seed, b, k, logits.device)
    return z.argmax(dim=1)


# B5's layouts (csrc/topk.cu): a lane takes at least CHOICE_MIN_COLS
# columns (two 16-byte loads), an SM holds CHOICE_FILL threads, a block
# at most CHOICE_BLOCK, a cluster 2-8 blocks (the portable sizes), each of
# CHOICE_BLOCK threads on at least CLUSTER_BLOCK_COLS columns (16 a lane:
# a cluster's block costs more to start and to join than a block a row's)
CHOICE_MIN_COLS = 8
CHOICE_FILL = 2048
CHOICE_BLOCK = 1024
CLUSTER_BLOCK_COLS = 16 * CHOICE_BLOCK
CHOICE_CLUSTERS = (8, 4, 2)


class ChoicePlan(NamedTuple):
    """A B5 launch of ``threads``-thread blocks: a warp a row ("warp"), a
    block a row ("block"), or a cluster of ``cluster`` blocks a row
    ("cluster")."""
    layout: str
    threads: int
    cluster: int


WARP_PLAN = ChoicePlan("warp", 256, 1)
# csrc/topk.cu ChoiceLayout
_LAYOUTS = {"warp": 0, "block": 1, "cluster": 2}


def choice_plan(b: int, k: int, sms: int) -> ChoicePlan:
    """B5's layout for (B, k) logits on a card of ``sms`` SMs.

    Each row gets the lanes that make the rows fill the card (CHOICE_FILL
    threads an SM), but no fewer than CHOICE_MIN_COLS columns a lane: a
    warp a row where 32 lanes do, a block (64-1,024 threads) where one
    block does, else the largest cluster whose blocks each get
    CLUSTER_BLOCK_COLS columns or more (its size rounded up to a power of
    two) and of which every row's fits on the card at once; a
    1,024-thread block where there is none.  (The picks at (512, 100),
    (512, 1,000), (64, 32,768) and (8, 131,072) were the fastest or within
    3% of the fastest layout on an H100: ``bench/b5_times.py``.)
    """
    lanes = min(cdiv(sms * CHOICE_FILL, max(b, 1)), cdiv(k, CHOICE_MIN_COLS))
    if lanes <= 32:
        return WARP_PLAN
    if lanes <= CHOICE_BLOCK:
        return ChoicePlan("block", max(64, 1 << (lanes - 1).bit_length()), 1)
    want = 1 << (cdiv(k, CLUSTER_BLOCK_COLS) - 1).bit_length()
    blocks = sms * CHOICE_FILL // CHOICE_BLOCK
    for c in CHOICE_CLUSTERS:
        if c <= want and b * c <= blocks:
            return ChoicePlan("cluster", CHOICE_BLOCK, c)
    return ChoicePlan("block", CHOICE_BLOCK, 1)


@functools.lru_cache(maxsize=256)
def _device_plan(b: int, k: int, index: int) -> ChoicePlan:
    return choice_plan(b, k, _sm_count(index))


def _gumbel_launch(x: torch.Tensor, seed, idx: torch.Tensor | None = None,
                   plan: ChoicePlan | None = None) -> torch.Tensor:
    """One B5 launch on (B, k) f32 logits ``x`` -> (B,) int64: the chosen
    column of each row, or ``idx[row, column]`` where ``idx`` is given.  A
    ``seed`` tensor on ``x``'s device is read there (no host sync).
    ``plan`` overrides the layout ``choice_plan`` picks (tests force each
    one).  The host work is kept small: the raw stream handle, not a
    ``torch.cuda.Stream``, and no device context (the C entry sets the
    device only where it is not current)."""
    _check_cuda_f32(x, "logits", "gumbel_choice")
    b, k = x.shape
    dev = x.device
    if idx is not None and (idx.dtype != torch.int64 or idx.shape != x.shape
                            or idx.device != dev
                            or not idx.is_contiguous()):
        raise TypeError(f"idx must be a contiguous int64 {(b, k)} tensor on "
                        f"{dev}, got {idx.dtype} {tuple(idx.shape)} on "
                        f"{idx.device}")
    out = torch.empty((b,), dtype=torch.int64, device=dev)
    if b == 0:
        return out
    if plan is None:
        plan = _device_plan(b, k, dev.index)
    seed_ptr = None
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise TypeError("a seed tensor must hold one int64, got "
                            f"{seed.dtype} {tuple(seed.shape)}")
        if seed.device == dev:
            seed_ptr, seed = seed.data_ptr(), 0
    err = _lib().bm25_gumbel_choice(
        x.data_ptr(), b, k, seed_ptr, _seed_value(seed),
        None if idx is None else idx.data_ptr(), _LAYOUTS[plan.layout],
        plan.threads, plan.cluster, out.data_ptr(), dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(_lib(), err, "bm25_gumbel_choice launch")
    launches["gumbel_choice"] += 1
    return out


def gumbel_choice(logits: torch.Tensor, seed) -> torch.Tensor:
    """B5: one column per row of (B, k) f32 temperature-scaled logits,
    drawn by Gumbel-max with a 32-bit seed -> (B,) int64.  ``seed`` is an
    int or a one-element int64 tensor (its low 32 bits; read on the card
    where it lies on the logits' device)."""
    if logits.device.type == "cpu":
        return gumbel_choice_plain(logits, seed)
    return _gumbel_launch(logits, seed)


def _sample_logits(vals: torch.Tensor, temperature) -> torch.Tensor:
    """The sampling step's logits ``(v - v[..., :1]) / t`` in vals' dtype,
    t = max(temperature, 1e-6) as JAX takes it; a number ``t`` reaches
    vals' device by a fill, not a host-to-device copy."""
    t = torch.clamp_min(torch.as_tensor(temperature, dtype=vals.dtype), 1e-6)
    if t.device != vals.device:
        t = torch.full((), float(t), dtype=vals.dtype, device=vals.device)
    return (vals - vals[..., :1]) / t


def gumbel_sample_plain(vals: torch.Tensor, idxs: torch.Tensor, seed,
                        temperature=1.0) -> torch.Tensor:
    """Plain twin of the fused sampling step on (..., k) top-k values and
    ids: the logits, B5's choice (its twin), the sampled id -> (..., 1)."""
    k = vals.shape[-1]
    flat = _sample_logits(vals, temperature).float().reshape(-1, k)
    choice = gumbel_choice_plain(flat, seed)
    return torch.gather(idxs, -1, choice.reshape(vals.shape[:-1] + (1,)))


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """x as contiguous (rows, k), a copy only where it must be."""
    if x.dim() == 2 and x.is_contiguous():
        return x
    return x.reshape(-1, k).contiguous()


def gumbel_sample(vals: torch.Tensor, idxs: torch.Tensor, seed,
                  temperature=1.0) -> torch.Tensor:
    """The fused sampling step on (..., k) top-k values and int64 ids ->
    (..., 1) sampled ids: the logits formed in the values' dtype, as JAX
    forms them, then one B5 launch that writes the sampled id,
    ``idxs[..., choice]``."""
    if vals.device.type == "cpu":
        return gumbel_sample_plain(vals, idxs, seed, temperature)
    k = vals.shape[-1]
    logits = _sample_logits(vals, temperature).float()
    out = _gumbel_launch(_rows(logits, k), seed, _rows(idxs, k))
    return out.reshape(vals.shape[:-1] + (1,))


def top_k_fused_sampling(x, k: int, temperature: float = 1.0, axis: int = -1,
                         implementation: str = "torch",
                         generator: torch.Generator | None = None):
    """Top-k + temperature softmax sampling of one index per row.

    Selects the k largest, then samples one of them from softmax of
    ``(v - max) / max(temperature, 1e-6)``; returns ``(topk_values,
    sampled_index)``, the sampled index with size 1 on ``axis``.
    ``temperature -> 0`` is greedy.

    ``generator`` (a ``torch.Generator``; None: the default generator of
    ``x``'s device) takes the place of the JAX version's PRNG key.
    ``implementation="torch"`` draws Gumbel noise from it with
    ``torch.rand``; ``"pallas"`` draws one 32-bit seed from it, as a
    tensor on the generator's device, and runs the fused step
    (``gumbel_sample``: the logits, then one B5 launch), so equal generator
    states give equal draws and a CUDA generator costs no host sync.
    """
    x = torch.as_tensor(x)
    if implementation not in ("torch", "pallas"):
        raise ValueError(f"unknown implementation {implementation!r}")
    vals, idxs = top_k(x, k, axis=axis, largest=True)
    axis = axis % x.dim()
    vals_last = torch.movedim(vals, axis, -1)
    idxs_last = torch.movedim(idxs, axis, -1)
    gen_device = generator.device if generator is not None else vals.device
    if implementation == "pallas":
        seed = torch.randint(0, 2**32, (1,), generator=generator,
                             device=gen_device)
        sampled = gumbel_sample(vals_last, idxs_last, seed, temperature)
    else:
        flat = _sample_logits(vals_last, temperature).float().reshape(-1, k)
        u = torch.rand(flat.shape, generator=generator, device=gen_device)
        u = u.to(flat.device).clamp_min(torch.finfo(torch.float32).tiny)
        choice = (flat - torch.log(-torch.log(u))).argmax(dim=1)
        sampled = torch.gather(idxs_last, -1,
                               choice.reshape(vals_last.shape[:-1] + (1,)))
    return vals, torch.movedim(sampled, -1, axis)


register_op("top_k")(top_k)
register_op("top_k_tree")(top_k_tree)
register_op("select_top_k")(select_top_k)
register_op("top_k_tree_with_maxes")(top_k_tree_with_maxes)
register_op("union_group_select")(union_group_select)
register_op("gather_group_candidates")(gather_group_candidates)
register_op("top_k_blockwise")(top_k_blockwise)
register_op("top_k_fused_sampling")(top_k_fused_sampling)
