"""Top-k op library: exact selection, the two-stage kernel, sampling.

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
* ``top_k_two_stage`` (B4, replaces ``_pallas_topk_lastaxis``) and
  ``gumbel_choice`` (B5, replaces ``_pallas_gumbel_choice``) launch the
  hand-written kernels of ``csrc/topk.cu`` on CUDA tensors; only a tensor
  on the CPU runs their plain twins (``topk_two_stage_plain``,
  ``gumbel_choice_plain``), which follow the kernels step for step.
* ``top_k_blockwise`` and ``top_k_fused_sampling``.
* ``union_group_select`` / ``gather_group_candidates``: one group
  tournament across buckets, and the candidates of the won groups (plain
  PyTorch on the tree, as in JAX; not wired into ``SparseEngine`` yet).

NaN: the tree ranks NaN smallest, B4 (like the Pallas kernel) largest;
callers mask non-finite scores first, as every engine does.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math

import torch

from bm25_tpu.utils.padding import cdiv, next_multiple
from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.ops.registry import register_op

logger = logging.getLogger(__name__)

NEG_INF = float("-inf")
DOC_SENTINEL = 2**31 - 1

# B4's widest stage-1 chunk (64 KB of order keys: several blocks per SM)
STAGE1_LEN = 16384
# B4's most candidates per merge block (the kernel's MAX_LEN: 224 KB of
# order keys in shared memory)
MERGE_LEN = 57344

# kernel launches, counted only where a kernel is launched (B4 counts one
# per call, all passes)
launches = {"top_k_two_stage": 0, "gumbel_choice": 0}
# plain-twin runs (CPU tensors, or a direct call)
plain_calls = {"top_k_two_stage": 0, "gumbel_choice": 0}
# B4 calls whose k is wider than a stage-1 chunk: served by the tree
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


def two_stage_plan(n: int, k: int) -> list[int] | None:
    """The chunk widths of B4's passes over an axis of n: stage 1's, then
    the merge's, or None where k is wider than a stage-1 chunk (a chunk
    narrower than k cannot supply k distinct candidates; the JAX wrapper
    hands that case to its tree too).

    Each pass cuts its input row into ceil(width / chunk) chunks and keeps
    k candidates of each, in chunk order; the merge repeats while the
    candidates outnumber one block (MERGE_LEN).  Top-k by (value, then
    position) of a row is the top-k of the per-chunk top-k's kept in chunk
    order, so every pass count gives the same answer.  A merge chunk is
    wider than MERGE_LEN / 2 and k is at most STAGE1_LEN, so each pass
    shrinks the row to under 0.58 of its width.
    """
    nblocks = cdiv(n, STAGE1_LEN)
    chunk = cdiv(n, nblocks)
    if nblocks > 1 and k > chunk:
        return None
    passes = [chunk]
    while nblocks > 1:
        m = nblocks * k
        nblocks = cdiv(m, MERGE_LEN)
        passes.append(cdiv(m, nblocks))
    return passes


def order_key(x: torch.Tensor) -> torch.Tensor:
    """B4's order keys of f32 values, as int64 holding a uint32: unsigned
    order is the float order, NaN is largest, -0 equals +0, and every key
    is > 0 (0 marks a taken position)."""
    b = x.view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(b >= 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    key = torch.where(x == 0, 0x80000000, key)
    return torch.where(torch.isnan(x), 0xFFFFFFFF, key)


def _select_rounds_plain(vals: torch.Tensor, cand_idx: torch.Tensor | None,
                         chunk: int, k: int):
    """One stage of B4 in torch ops: per chunk of the (R, n) f32 rows, k
    rounds of (largest key, first position, take); a round on a chunk with
    every position taken emits (-inf, chunk start).  -> (R, nblocks * k)
    values and int64 indices (the candidates' own with ``cand_idx``)."""
    r, n = vals.shape
    nblocks = cdiv(n, chunk)
    pad = nblocks * chunk - n
    keys = order_key(vals)
    if pad:
        keys = torch.cat([keys, keys.new_zeros((r, pad))], dim=1)
        vals = torch.cat([vals, vals.new_full((r, pad), NEG_INF)], dim=1)
        if cand_idx is not None:
            cand_idx = torch.cat([cand_idx, cand_idx.new_zeros((r, pad))], 1)
    keys = keys.reshape(r * nblocks, chunk)
    vals = vals.reshape(r * nblocks, chunk)
    start = (torch.arange(nblocks, device=vals.device) * chunk).repeat(r)
    if cand_idx is not None:
        cand_idx = cand_idx.reshape(r * nblocks, chunk)
    out_v, out_i = [], []
    for _ in range(k):
        pos = keys.argmax(dim=1, keepdim=True)  # first maximum
        taken = keys.gather(1, pos) == 0
        out_v.append(torch.where(taken, NEG_INF, vals.gather(1, pos)))
        out_i.append(cand_idx.gather(1, pos) if cand_idx is not None
                     else start[:, None] + pos)
        keys.scatter_(1, pos, 0)
    return (torch.cat(out_v, 1).reshape(r, nblocks * k),
            torch.cat(out_i, 1).reshape(r, nblocks * k))


def topk_two_stage_plain(x2: torch.Tensor, k: int):
    """Plain PyTorch twin of B4 on (B, n) f32: (values, int64 indices)."""
    plain_calls["top_k_two_stage"] += 1
    plan = two_stage_plan(x2.shape[1], k)
    if plan is None:
        raise ValueError(f"k={k} is wider than a chunk of B4 for n="
                         f"{x2.shape[1]}; top_k_two_stage takes the tree")
    vals, idx = x2, None
    for chunk in plan:
        vals, idx = _select_rounds_plain(vals, idx, chunk, k)
    return vals, idx


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bm25_topk_select.argtypes = [p, p, i, i, i, i, p, p,
                                     ctypes.c_longlong, p]
    lib.bm25_topk_select.restype = i
    lib.bm25_gumbel_choice.argtypes = [p, i, i, ctypes.c_uint32, p, p]
    lib.bm25_gumbel_choice.restype = i
    return lib


def _check_cuda_f32(x: torch.Tensor, name: str, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"{name} must be a contiguous 2-D float32 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")


def top_k_two_stage(x2: torch.Tensor, k: int):
    """B4: top-k of each row of a (B, n) f32 tensor -> (values, int64
    indices), sorted descending, ties to the smaller index, distinct
    indices on rows with fewer than k finite values.

    Stage 1 keeps k candidates per chunk, and the merge passes of
    ``two_stage_plan`` reduce them to k.  Where k is wider than a stage-1
    chunk (the plan is None) the tree serves the call, as the JAX kernel
    hands k > chunk to its tree; such calls are counted in ``tree_calls``
    and logged as warnings.
    """
    b, n = x2.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for axis of {n}")
    plan = two_stage_plan(n, k)
    if plan is None:
        tree_calls["top_k_two_stage"] += 1
        logger.warning("top_k_two_stage: k=%d is wider than a chunk of the "
                       "(%d-wide) axis; served by the tree", k, n)
        return top_k_tree(x2, k)
    if x2.device.type == "cpu":
        return topk_two_stage_plain(x2, k)
    _check_cuda_f32(x2, "x", "top_k_two_stage")
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=x2.device),
                torch.empty((0, k), dtype=torch.int64, device=x2.device))
    lib = _lib()
    vals, idx, width = x2, None, n
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        for chunk in plan:
            m = cdiv(width, chunk) * k
            out_v = torch.empty((b, m), dtype=torch.float32, device=x2.device)
            out_i = torch.empty((b, m), dtype=torch.int64, device=x2.device)
            err = lib.bm25_topk_select(
                vals.data_ptr(), None if idx is None else idx.data_ptr(), b,
                width, chunk, k, out_v.data_ptr(), out_i.data_ptr(), m,
                stream)
            _build.check(lib, err, f"bm25_topk_select launch (chunk {chunk})")
            vals, idx, width = out_v, out_i, m
    launches["top_k_two_stage"] += 1
    return vals, idx


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


def gumbel_noise_plain(seed: int, b: int, k: int,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """B5's (B, k) f32 Gumbel noise ``-log(-log u)`` for ``seed``: the hash
    of (seed, row, column), its top 24 bits as u = bits * 2^-24 + 1e-12."""
    s = _mix32(torch.tensor(int(seed) & _M32, dtype=torch.int64,
                            device=device))
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(k, dtype=torch.int64, device=device)[None, :]
    bits = _mix32(_mix32(s ^ rows) ^ cols)
    u = (bits >> 8).float() * 2.0**-24 + torch.tensor(
        _U_FLOOR, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(u))


def gumbel_choice_plain(logits: torch.Tensor, seed: int) -> torch.Tensor:
    """Plain PyTorch twin of B5: (B,) int64 first argmax of logits + noise."""
    plain_calls["gumbel_choice"] += 1
    b, k = logits.shape
    z = logits + gumbel_noise_plain(seed, b, k, logits.device)
    return z.argmax(dim=1)


def gumbel_choice(logits: torch.Tensor, seed: int) -> torch.Tensor:
    """B5: one column per row of (B, k) f32 temperature-scaled logits,
    drawn by Gumbel-max with the 32-bit ``seed`` -> (B,) int64."""
    if logits.device.type == "cpu":
        return gumbel_choice_plain(logits, seed)
    _check_cuda_f32(logits, "logits", "gumbel_choice")
    b, k = logits.shape
    out = torch.empty((b,), dtype=torch.int64, device=logits.device)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.bm25_gumbel_choice(logits.data_ptr(), b, k,
                                     int(seed) & _M32, out.data_ptr(), stream)
    _build.check(lib, err, "bm25_gumbel_choice launch")
    launches["gumbel_choice"] += 1
    return out


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
    ``torch.rand``; ``"pallas"`` draws one 32-bit seed from it and runs
    kernel B5, so equal generator states give equal draws.
    """
    x = torch.as_tensor(x)
    if implementation not in ("torch", "pallas"):
        raise ValueError(f"unknown implementation {implementation!r}")
    vals, idxs = top_k(x, k, axis=axis, largest=True)
    axis = axis % x.dim()
    vals_last = torch.movedim(vals, axis, -1)
    idxs_last = torch.movedim(idxs, axis, -1)
    t = torch.clamp_min(torch.as_tensor(temperature, dtype=vals_last.dtype,
                                        device=vals_last.device), 1e-6)
    logits = (vals_last - vals_last[..., :1]) / t
    flat = logits.float().reshape(-1, k).contiguous()
    gen_device = generator.device if generator is not None else flat.device
    if implementation == "pallas":
        seed = int(torch.randint(0, 2**32, (1,), generator=generator,
                                 device=gen_device).item())
        choice = gumbel_choice(flat, seed)
    else:
        u = torch.rand(flat.shape, generator=generator, device=gen_device)
        u = u.to(flat.device).clamp_min(torch.finfo(torch.float32).tiny)
        choice = (flat - torch.log(-torch.log(u))).argmax(dim=1)
    sampled = torch.gather(idxs_last, -1,
                           choice.reshape(logits.shape[:-1] + (1,)))
    return vals, torch.movedim(sampled, -1, axis)


register_op("top_k")(top_k)
register_op("top_k_tree")(top_k_tree)
register_op("select_top_k")(select_top_k)
register_op("top_k_tree_with_maxes")(top_k_tree_with_maxes)
register_op("union_group_select")(union_group_select)
register_op("gather_group_candidates")(gather_group_candidates)
register_op("top_k_blockwise")(top_k_blockwise)
register_op("top_k_fused_sampling")(top_k_fused_sampling)
