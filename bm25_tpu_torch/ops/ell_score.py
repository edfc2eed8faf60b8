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
base is bit-equal between the two.  The card's scan looks each slot's
token up in tables of the queries' tokens (``scan_table``, a third
kernel, made once per chunk by the sparse step or inside the wrapper);
``table_pairs`` defines what the tables hold.  What only Mosaic needed is
gone: the query-count padding, the transposed group maxima and the bf16
``valT`` upcast (``valT`` is f32 here).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
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
# the hot kernel's shared memory at 128 queries a block
# (csrc/ell_score.cu, HotShape<128>::smem): an alignment pad, 3 stages of
# 128 x 128 bytes of counts beside 64 staged hot rows of 2 x 128 + 16
# bytes (rounded to 1 KB), the stages' mbarriers, then 4 bytes a hot
# token of the used-token list
HOT_SMEM_FIXED = 1024 + 3 * 33792 + 2 * 3 * 8

# the scan (csrc/ell_score.cu): 128 threads a block, as 128 / rows groups
# of `rows` doc rows, each group against one table of at most
# MAX_TABLE_QUERIES queries with at least `sparsity` key slots an id; a
# thread loads `batch` slots' tokens at once (scan_build picks the two by
# T)
SCAN_THREADS = 128
MAX_TABLE_QUERIES = 128
# a table's words before its keys, its keys a bucket, and the most ids
# (queries x T) it holds
TABLE_HEAD = 4
TABLE_BUCKET = 4
MAX_TABLE_ENTRIES = 4096
# shared memory of a scan block: two an SM on an H100, or one
SMEM_TWO_BLOCKS = 115712
SMEM_ONE_BLOCK = 232448

# kernel launches, counted only where a kernel is launched: B1 calls, the
# scans and the hot kernels B1 launches, B2's scans, the tables
launches = {"ell_score": 0, "ell_score_fused": 0, "ell_score_scan": 0,
            "ell_score_hot": 0, "ell_table": 0}
# plain-twin runs (CPU tensors, or a direct call)
plain_calls = {"ell_score": 0, "ell_score_fused": 0, "ell_table": 0}


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


# ---------------------------------------------------------------------------
# the scan's lookup tables
# ---------------------------------------------------------------------------


class ScanTable(NamedTuple):
    """The scan's lookup tables for one (Q, T) batch of ids, in the layout
    of ``csrc/ell_score.cu``: one table a tile of ``qp`` queries."""

    words: torch.Tensor  # (ceil(Q / qp), table_words) int32
    qp: int  # queries a table
    cap_log2: int  # 2 ** cap_log2 key slots
    weighted: bool  # built with per-token weights


def table_words(cap_log2: int, n: int) -> int:
    """int32 words of one table of 2 ** cap_log2 key slots and room for n
    pairs: the head, keys, runs, filter (8 bits a key slot), then (query,
    c) pairs; a multiple of 4."""
    cap = 1 << cap_log2
    return TABLE_HEAD + 2 * cap + cap // 4 + 2 * (n + (n & 1))


def scan_build(t: int) -> tuple[int, int, int]:
    """(doc rows a block, slots a thread loads at once, key slots an id)
    of the scan for queries of T ids, one of the two compiled builds:
    (64, 16, 2) for one-token queries (B2's build: every slot hits one of
    the Q / qp tables, so a block takes two and reads each token half as
    often, and three such blocks fit an SM only with the smaller tables)
    and (128, 8, 4) otherwise, the fastest on an H100 (PERF.md, §6)."""
    return (64, 16, 2) if t == 1 else (128, 8, 4)


def table_geometry(q: int, t: int, qp: int = MAX_TABLE_QUERIES
                   ) -> tuple[int, int]:
    """(qp, cap_log2) for Q queries of T ids: the most queries a table (a
    power of two, at most ``qp`` and Q rounded up) whose tables and
    accumulators fit two scan blocks of ``scan_build(t)`` an SM (one, at a
    single query), with 2 ** cap_log2 >= sparsity x qp T key slots."""
    rows_tile, _, sparsity = scan_build(t)
    groups = SCAN_THREADS // rows_tile
    qp = min(qp, 1 << max(q - 1, 0).bit_length())
    while True:
        n = qp * t
        cap_log2 = max((sparsity * n - 1).bit_length(), 4)
        smem = 4 * groups * (qp * rows_tile + table_words(cap_log2, n))
        if n <= MAX_TABLE_ENTRIES and (
                smem <= SMEM_TWO_BLOCKS or (qp == 1 and smem <= SMEM_ONE_BLOCK)):
            return qp, cap_log2
        if qp == 1:
            raise ValueError(f"{t} ids a query: a table of the scan holds "
                             f"at most {MAX_TABLE_ENTRIES}")
        qp //= 2


def table_pairs(ids, weights=None, qp: int = MAX_TABLE_QUERIES
                ) -> list[dict[int, list[tuple[int, float]]]]:
    """What the scan's tables hold, one dict a tile of ``qp`` queries: each
    distinct id >= 0 of the tile -> its (query in the tile, c) pairs in
    query order.  c is the id's count in the query, or with weights the
    f32 sum of its weights in t order (the first as it is), which is what
    the plain scan's per-slot reduction over T gives for a matching slot."""
    ids = np.asarray(torch.as_tensor(ids).cpu())
    w = None if weights is None else np.asarray(
        torch.as_tensor(weights).cpu(), dtype=np.float32)
    tiles = []
    for q0 in range(0, ids.shape[0], qp):
        runs: dict[int, dict[int, np.float32]] = {}
        for q in range(q0, min(q0 + qp, ids.shape[0])):
            for t, tok in enumerate(ids[q].tolist()):
                if tok < 0:
                    continue
                run = runs.setdefault(tok, {})
                c = np.float32(1.0) if w is None else w[q, t]
                run[q - q0] = c if q - q0 not in run else run[q - q0] + c
        tiles.append({tok: [(qq, float(c)) for qq, c in sorted(run.items())]
                      for tok, run in runs.items()})
    return tiles


def _table_hash(tok: int, cap_log2: int) -> int:
    """The first bucket (of TABLE_BUCKET key slots) a token may lie in."""
    return ((tok * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - (cap_log2 - 2))


def _filter_bits(keys, cap_log2: int) -> np.ndarray:
    """The filter of a table's keys: bit ((key * 0x85EBCA6B) mod 2^32) >>
    (32 - (cap_log2 + 3)) of 8 cap bits set for each key, as uint32
    words."""
    bits = np.zeros(1 << (cap_log2 - 2), np.uint32)
    for tok in keys:
        f = ((int(tok) * 0x85EBCA6B) & 0xFFFFFFFF) >> (32 - (cap_log2 + 3))
        bits[f >> 5] |= np.uint32(1 << (f & 31))
    return bits


def scan_table_plain(ids, weights=None,
                     qp: int = MAX_TABLE_QUERIES) -> ScanTable:
    """Plain twin of the table kernel: ``table_pairs`` laid out as the
    kernel lays it out, the tokens inserted in ascending order (the kernel
    inserts them in parallel, so a colliding key may take another slot:
    compare tables by ``table_contents``)."""
    plain_calls["ell_table"] += 1
    q, t = ids.shape
    qp, cap_log2 = table_geometry(q, t, qp)
    cap = 1 << cap_log2
    tiles = table_pairs(ids, weights, qp)
    words = np.zeros((len(tiles), table_words(cap_log2, qp * t)), np.int32)
    for row, tile in zip(words, tiles):
        keys, meta = row[TABLE_HEAD:][:cap], row[TABLE_HEAD + cap:][:cap]
        pairs = row[TABLE_HEAD + 2 * cap + cap // 4:]
        row[TABLE_HEAD + 2 * cap:][:cap // 4] = _filter_bits(
            tile, cap_log2).view(np.int32)
        keys[:] = -1
        p = 0
        for tok in sorted(tile):
            h = _table_hash(tok, cap_log2) * TABLE_BUCKET
            while keys[h] != -1:
                h = (h + 1) & (cap - 1)
            keys[h], meta[h] = tok, p | len(tile[tok]) << 16
            for qq, c in tile[tok]:
                pairs[2 * p] = qq
                pairs[2 * p + 1] = np.float32(c).view(np.int32)
                p += 1
        row[0] = p
    return ScanTable(torch.from_numpy(words).to(ids.device), qp, cap_log2,
                     weights is not None)


def table_contents(table: ScanTable) -> list[dict[int, list[tuple[int, float]]]]:
    """Read a table back into ``table_pairs``' form, checking that every
    key is found where a lookup probes for it (every bucket from its hash
    bucket on to its own full, each bucket filled from its first slot),
    that the filter holds its keys' bits and no other, and that the runs
    cover the pairs once each."""
    cap = 1 << table.cap_log2
    out = []
    for row in table.words.cpu().numpy():
        keys, meta = row[TABLE_HEAD:][:cap], row[TABLE_HEAD + cap:][:cap]
        pairs = row[TABLE_HEAD + 2 * cap + cap // 4:]
        cs = pairs.view(np.float32)
        if not np.array_equal(
                row[TABLE_HEAD + 2 * cap:][:cap // 4].view(np.uint32),
                _filter_bits(keys[keys != -1], table.cap_log2)):
            raise ValueError("the filter is not its keys' bits")
        tile, covered = {}, []
        buckets = keys.reshape(-1, TABLE_BUCKET)
        free = buckets == -1
        if (free[:, :-1] & ~free[:, 1:]).any():
            raise ValueError("a bucket has a key after a free slot")
        for h in np.flatnonzero(keys != -1).tolist():
            tok = int(keys[h])
            g = _table_hash(tok, table.cap_log2)
            while g != h // TABLE_BUCKET:
                if free[g].any():
                    raise ValueError(f"key {tok} at {h} lies past bucket "
                                     f"{g}, which has a free slot")
                g = (g + 1) % len(buckets)
            start, count = int(meta[h]) & 0xFFFF, int(meta[h]) >> 16
            covered += range(start, start + count)
            tile[tok] = [(int(pairs[2 * j]), float(cs[2 * j + 1]))
                         for j in range(start, start + count)]
        if sorted(covered) != list(range(int(row[0]))):
            raise ValueError("the runs do not cover the pairs once each")
        out.append(tile)
    return out


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


def max_hot_tokens() -> int:
    """The widest hot tier B1's hot kernel takes: its block keeps the
    chunk's used-token list (4 bytes a hot token, H rounded up to HOT_BK)
    in shared memory beside its ring, within one block's opt-in limit."""
    return (SMEM_ONE_BLOCK - HOT_SMEM_FIXED) // 4 // HOT_BK * HOT_BK


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ell_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bm25_ell_table.argtypes = [p, p, i, i, i, i, p, p]
    lib.bm25_ell_table.restype = i
    lib.bm25_ell_score.argtypes = [p, i, i, i, i, p, p, i, i, i, i, i, p, p]
    lib.bm25_ell_score.restype = i
    lib.bm25_ell_score_fused.argtypes = [
        p, i, i, i, i, p, p, i, i, i, i, i, p, p, p, i, p, p, p, p, i, p, p,
        p]
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


def scan_table(ids: torch.Tensor, weights: torch.Tensor | None = None,
               qp: int = MAX_TABLE_QUERIES) -> ScanTable:
    """The scan's lookup tables for (Q, T) int32 ids (pads/OOV < 0) and
    optional (Q, T) f32 weights, at most ``qp`` queries a table
    (``table_geometry``); made once and passed to every bucket's
    ``ell_score_fused`` (or ``ell_score``) of the same ids."""
    if ids.device.type == "cpu":
        return scan_table_plain(ids, weights, qp)
    device = ids.device
    if device.type != "cuda":
        raise ValueError(f"scan_table runs on cuda or cpu, not {device}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be (Q, T), got {tuple(ids.shape)}")
    _expect(ids, "ids", torch.int32, ids.shape, device)
    q, t = ids.shape
    if weights is not None:
        _expect(weights, "weights", torch.float32, (q, t), device)
    qp, cap_log2 = table_geometry(q, t, qp)
    words = torch.empty((cdiv(q, qp), table_words(cap_log2, qp * t)),
                        dtype=torch.int32, device=device)
    table = ScanTable(words, qp, cap_log2, weights is not None)
    if q == 0:
        return table
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bm25_ell_table(_ptr(ids), _ptr(weights), q, t, qp,
                                 cap_log2, _ptr(words), stream)
    _build.check(lib, err, "bm25_ell_table launch")
    launches["ell_table"] += 1
    return table


def _check_table(table: ScanTable, ids, weighted: bool, device):
    q, t = ids.shape
    if table.weighted != weighted:
        raise ValueError("the table was made with" + ("out" if weighted else "")
                         + " weights")
    _expect(table.words, "table.words", torch.int32,
            (cdiv(q, table.qp), table_words(table.cap_log2, table.qp * t)),
            device)


def ell_score(ids: torch.Tensor, tokT: torch.Tensor, valT: torch.Tensor,
              table: ScanTable | None = None) -> torch.Tensor:
    """B2: score one ELL bucket, (Q, rows) float32.  ``table`` is
    ``scan_table(ids)`` (made here when None); the plain twin needs none."""
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
    if table is None:
        table = scan_table(ids)
    _check_table(table, ids, False, device)
    l_tile, _ = _slot_tiling(l_pad)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bm25_ell_score(
            _ptr(table.words), table.qp, table.cap_log2, q, t, _ptr(tokT),
            _ptr(valT), l_pad, rows, l_tile, *scan_build(t)[:2], _ptr(out),
            stream)
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
    table: ScanTable | None = None,  # scan_table(ids, weights)
) -> tuple[torch.Tensor, torch.Tensor]:
    """B1: fused bucket scoring -> (masked base (Q, rows), gmax (Q, rows/8)).

    ``weights`` makes each match add its token's weight instead of 1;
    ``hot_counts_lo`` (non-integer counts) adds the third split product
    ``hot_counts_lo @ hotT``.  ``plan`` is ``hot_plan`` of the counts, made
    once per chunk by a caller that scores several buckets (made here when
    None), and so is ``table``, ``scan_table(ids, weights)``; the plain
    twin needs neither.  The card runs the scan unless the bucket has no
    slots but a hot tier, then the hot kernel where there is a hot tier.
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
    scan = l_pad > 0 or not h
    if scan:
        if table is None:
            table = scan_table(ids, weights)
        _check_table(table, ids, weights is not None, device)
    else:
        table = ScanTable(None, 1, 1, False)
    l_tile, _ = _slot_tiling(l_pad)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bm25_ell_score_fused(
            _ptr(table.words), table.qp, table.cap_log2, q, t, _ptr(tokT),
            _ptr(valT), l_pad, rows, l_tile, *scan_build(t)[:2],
            _ptr(doc_ids), _ptr(plan.counts), _ptr(plan.counts_lo), kp,
            _ptr(plan.tokens), _ptr(plan.n_used), _ptr(hotT), _ptr(hotLo), h,
            _ptr(base), _ptr(gmax), stream)
    _build.check(lib, err, "bm25_ell_score_fused launch")
    launches["ell_score_fused"] += 1
    if scan:
        launches["ell_score_scan"] += 1
    if h:
        launches["ell_score_hot"] += 1
    return base, gmax
