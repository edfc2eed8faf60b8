"""Schedules of the matrix product: CUDA kernels E1-E4 and their twins.

The four TPU experiments on kernel B6's ``C = A @ B``
(``scripts/exp_r4_matmul_{tiles3,tiles4,dma,precision}.py``), each as a
kernel of ``csrc/matmul_schedules.cu`` (see its header for the designs and
what bounds them).  Operands are row-major float32, any M, K, N unless a
kernel states a limit:

* ``matmul_sweep(a, b, tile)`` (E1, ``mm_noacc``): a (BM, BN, BK) block tile
  of ``SWEEP_TILES`` with the C tile in registers over the whole K loop,
  fed by the ring body: a producer warp copies A's and B's boxes by TMA,
  as they lie in memory, into a ring of ``sweep_stages(tile)`` stages on
  mbarriers (the deepest up to ``RING_MAX_STAGES`` that fits the card's
  shared memory), and consumer warps hold register tiles in which every
  lane of a warp owns the same rows (``ring_layout``), so A is read as
  16-byte warp-wide broadcasts and B as 16 (or 8) bytes a lane.  TMA takes
  rows of whole 16-byte units from a 16-byte aligned base: an operand that
  is not so (K or N off a multiple of 4, a view off alignment) is first
  copied into a padded ``torch.empty`` (``_bulk_operand``, timed with the
  call), and the kernel's loops stop at the real M, N and K.
  ``resident_tile`` picks the one-wave tile that stands for the script's
  ``mm_resident``;
* ``matmul_row_strip(a, b, strip_m=None, blocks=None)`` (E2,
  ``mm_b_resident``): a block holds a ``strip_m``-row strip of A resident
  in shared memory and streams B through a ring of bulk asynchronous copies
  (``cp.async.bulk`` on mbarriers), on a grid of (strip, column group)
  that ``row_strip_plan`` sizes to fill the SMs; ``blocks=n`` walks the
  strips with n blocks, ``blocks=1`` is ``mm_single_dot``'s grid of one.
  A taller strip feeds each B value to more rows, so B crosses the L2
  fewer times: the default strip is the tallest that fits beside the ring
  at the operands' K (``default_strip``: 32 at K = 1028, 16 at 2048, 8 at
  4096).  Fewer, larger copies are faster (one copy per tile row of B was
  markedly slower at strips 16 and 32), so each copy is as large as it
  can be: the wrapper lays B out by panels (``pack_panels``: each
  BN-wide panel's K rows contiguous), so a tile is one copy, and the A
  strip is one copy.  The copies take 16-byte aligned runs of whole
  16-byte units: an A whose row length is not a multiple of 4 floats, or
  whose data is not 16-byte aligned, is first copied into a padded
  ``torch.empty``, as B's packing pads its panels (data preparation in
  the wrapper, timed with the kernel; the kernel's loops stop at the real
  K and N);
* ``matmul_pipelined(a, b, tile, stages=2)`` (E3, ``mm_dma``): E1's ring
  body on one of ``PIPELINED_TILES`` with the caller's ``stages`` (2, 3 or
  4; the script's two DMA slots are 2); it takes only operands TMA reads
  as they are and raises on others;
* ``matmul_mma(a, b, mode)`` (E4, ``pallas_matmul``): ``"default"`` on TF32
  and ``"bf16in"`` on bf16 tensor cores, in two launches: a pack kernel
  rounds both operands once and writes them K-major, B transposed, rows
  zero-padded to ``mma_plan``'s ``kp`` (a multiple of 16 bytes, as TMA
  needs) into scratch from ``torch.empty`` (its twin is
  ``mma_pack_plain``; ``mma_pack`` launches it alone), then the product
  kernel streams both by TMA into a ring of shared-memory stages on
  mbarriers and runs ``wgmma`` on C tiles of 128 x 128, or 128 x 256
  where 128 x 128 tiles would take more than one wave.  ``"f32"``, the
  script's baseline, is B6's ``"optimized"`` (``matmul_tiled``, the same
  ring as E1 on a balanced walk) and counts as its launch.

TF32 is the card's counterpart of XLA's DEFAULT precision, one low-
precision pass: 10 explicit significand bits, rounded to nearest with ties
away from zero.  On the TPU DEFAULT meant one bf16 pass; JAX on the CPU
computes DEFAULT in full f32, so the CPU tests cannot pin what it means on
a chip.

Twins: E1-E3 compute B6's function in B6's order (k ascending from +0, one
rounding per product), so their twin is ``matmul_plain`` and they equal it
bit for bit.  E4's twin rounds the inputs first (``round_tf32``,
``round_bf16``) and calls ``matmul_plain`` on the rounded values: products
of two bf16 or two TF32 values are exact in f32, so the kernel differs from
the twin only in the order of its sums and holds within
``K 2^-22 (|A^| @ |B^|)``.

Each wrapper launches its kernel on CUDA tensors or raises; only tensors on
the CPU run the twin.  The checks that do not depend on the card run on
both devices, so the CPU refuses what the card would; the shared-memory
limit is read from the card there and is an H100's on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.ops.matmul import (  # noqa: F401 (re-exported)
    H100_SMEM_OPTIN, H100_SMS, RING_ALIGN, RING_MAX_STAGES, Tile,
    _bulk_operand, _on_device, matmul, matmul_plain, ring_smem_bytes,
    ring_stages, sm_count, smem_optin_bytes)
from bm25_tpu_torch.utils.padding import cdiv, next_multiple

SWEEP_TILES = tuple(Tile(m, n, k) for m, n in ((64, 64), (128, 64),
                                                (128, 128), (256, 128))
                    for k in (8, 16, 32))
STRIP_HEIGHTS = (8, 16, 32)
# E2's B tile per strip height: 8 consumer warps of 8 rows x 128 columns
# make a BN-wide panel, and a ring slot holds BK x BN = 4096 floats
STRIP_BN = {h: 128 * 8 // (h // 8) for h in STRIP_HEIGHTS}  # 1024, 512, 256
STRIP_BK = {h: 4096 // STRIP_BN[h] for h in STRIP_HEIGHTS}  # 4, 8, 16
# the ring holds as many 16 KB slots as shared memory leaves, 3 to 8
STRIP_MIN_STAGES, STRIP_MAX_STAGES = 3, 8
PIPELINED_TILES = (Tile(64, 64, 16), Tile(128, 128, 16))
STAGES = (2, 3, 4)
MMA_MODES = ("f32", "default", "bf16in")

# E4: C tiles of 128 rows (128 or 256 wide); a ring stage holds 128 bytes
# of K of each operand's rows (64 bf16 or 32 TF32 values); the packed rows
# are whole 16-byte units
MMA_TILE = 128
MMA_ROW_BYTES = 128
MMA_ELEM_BYTES = {"default": 4, "bf16in": 2}
MMA_PACKED_DTYPE = {"default": torch.float32, "bf16in": torch.bfloat16}

# kernel launches, counted only where a kernel is launched (mode="f32" of
# matmul_mma counts under ops.matmul.launches["matmul_tiled"]; a matmul_mma
# call counts its pack under "matmul_mma_pack" too)
launches = {"matmul_sweep": 0, "matmul_row_strip": 0, "matmul_pipelined": 0,
            "matmul_mma": 0, "matmul_mma_pack": 0}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 explicit significand bits), to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32``: add half an
    ulp to the magnitude bits and clear the 13 low bits (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 (to nearest even), back in f32."""
    return x.bfloat16().float()


ROUNDING = {"default": round_tf32, "bf16in": round_bf16}


def matmul_mma_plain(a: torch.Tensor, b: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Plain twin of E4: ``matmul_plain`` of the rounded inputs."""
    rnd = ROUNDING[mode]
    return matmul_plain(rnd(a), rnd(b))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul_schedules")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bm25_matmul_ring.argtypes = [p, p, p, ll, ll, ll, ll, ll, i, i, i,
                                     i, p]
    lib.bm25_matmul_row_strip.argtypes = [p, p, p, ll, ll, ll, ll, i, ll,
                                          ll, ll, i, p]
    lib.bm25_matmul_mma.argtypes = [p, p, p, ll, ll, ll, p, ll, i, ll, ll,
                                     i, p]
    lib.bm25_mma_pack.argtypes = [p, p, p, ll, ll, ll, ll, i, p]
    for fn in (lib.bm25_matmul_ring, lib.bm25_matmul_row_strip,
               lib.bm25_matmul_mma, lib.bm25_mma_pack):
        fn.restype = i
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    """What every schedule takes (on both devices)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: incompatible shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{what}: a is on {a.device}, b on {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} takes contiguous (row-major) tensors")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {a.device}")


def _launch(name: str, fn: str, a: torch.Tensor, b: torch.Tensor,
            *args, mnk: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Launch ``fn`` of the library on (a, b) into a new (M, N) C; counted.
    ``mnk`` gives (M, N, K) where the operands are padded copies."""
    m, n, k = mnk or (a.shape[0], b.shape[1], a.shape[1])
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    err = _on_device(a.device, getattr(lib, fn), a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), m, n, k, *args)
    _build.check(lib, err, f"{fn} launch")
    launches[name] += 1
    return out


def _tile(tile, tiles, what: str) -> Tile:
    t = Tile(*tile)
    if t not in tiles:
        raise ValueError(f"{what} has no tile {tuple(t)}; the tiles "
                         f"(m, n, k) are {[tuple(x) for x in tiles]}")
    return t


def resident_tile(m: int, n: int, bk: int = 16,
                  sms: int = H100_SMS) -> Tile:
    """E1's counterpart of ``mm_resident``: the sweep tile of K step ``bk``
    whose grid over an (m, n) C is one wave (at most ``sms`` blocks) with
    the most blocks, the larger tile on a tie."""
    fits = [t for t in SWEEP_TILES if t.k == bk
            and cdiv(m, t.m) * cdiv(n, t.n) <= sms]
    if not fits:
        raise ValueError(f"no sweep tile with K step {bk} covers a ({m}, {n}) "
                         f"C in one wave of {sms} blocks")
    return max(fits, key=lambda t: (cdiv(m, t.m) * cdiv(n, t.n), t.m * t.n))


@dataclasses.dataclass(frozen=True)
class RingLayout:
    """How the ring body's consumer warps hold a tile's C: ``warps`` warps
    (one more produces); warp w holds rows ``w * rows`` to ``(w + 1) *
    rows - 1``, the same rows on every lane, and lane l holds columns
    ``l * cols`` to ``(l + 1) * cols - 1``."""

    warps: int
    rows: int
    cols: int


def ring_layout(tile) -> RingLayout:
    """The consumer warps' layout at a sweep tile (csrc's ``RingShape``):
    16 rows a warp, 32 at BM = 256, and BN / 32 columns a lane."""
    t = Tile(*tile)
    warps = 8 if t.m >= 128 else t.m // 16
    return RingLayout(warps, t.m // warps, t.n // 32)


@functools.lru_cache(maxsize=64)
def sweep_stages(tile, smem_limit: int = H100_SMEM_OPTIN) -> int:
    """E1's ring depth at ``tile``: the deepest up to ``RING_MAX_STAGES``
    whose ring fits ``smem_limit``; raises where not even two fit.  Cached:
    the wrapper asks it on every call."""
    return ring_stages(tile, 4, smem_limit)


def _ring(name: str, a: torch.Tensor, b: torch.Tensor, t: Tile,
          stages: int) -> torch.Tensor:
    """Launch the ring body on a CUDA (a, b) with ``stages`` stages, each
    operand staged into a padded copy where TMA cannot read it as it lies
    (the kernel reads the real (M, K) and (K, N) parts); counted as
    ``name``."""
    (m, k), n = a.shape, b.shape[1]
    a_op, b_op = _bulk_operand(a), _bulk_operand(b)
    return _launch(name, "bm25_matmul_ring", a_op, b_op, a_op.shape[1],
                   b_op.shape[1], t.m, t.n, t.k, stages, mnk=(m, n, k))


def matmul_sweep(a: torch.Tensor, b: torch.Tensor,
                 tile=Tile(128, 128, 16)) -> torch.Tensor:
    """E1: C = A @ B on the (BM, BN, BK) block tile ``tile`` of
    ``SWEEP_TILES``, the C tile in registers over the whole K loop, fed by
    a TMA ring of ``sweep_stages(tile)`` stages.  Any shape: an operand TMA
    cannot read as it lies is staged into a padded copy first."""
    _check(a, b, "matmul_sweep")
    t = _tile(tile, SWEEP_TILES, "matmul_sweep")
    stages = sweep_stages(t, smem_optin_bytes(a.device))
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    return _ring("matmul_sweep", a, b, t, stages)


def row_strip_smem_bytes(k: int, strip_m: int,
                         stages: int = STRIP_MIN_STAGES) -> int:
    """Shared memory of an E2 block: ``stages`` ring slots of 4096 floats,
    the A strip (K rounded up to 4) and the ring's and the strip's
    mbarriers.  The default, the fewest slots, is what a strip needs."""
    return ((stages * 4096 + strip_m * next_multiple(k, 4)) * 4
            + (2 * STRIP_MAX_STAGES + 2) * 8)


def default_strip(k: int, smem_limit: int = H100_SMEM_OPTIN) -> int:
    """E2's strip height for operands of depth ``k``: the tallest of
    ``STRIP_HEIGHTS`` whose strip fits beside the ring (at each of 1028,
    2048 and 4096 the fastest on an H100, PERF.md), the shortest where
    none fits (the wrapper then raises)."""
    return max((h for h in STRIP_HEIGHTS
                if row_strip_smem_bytes(k, h) <= smem_limit),
               default=STRIP_HEIGHTS[0])


@dataclasses.dataclass(frozen=True)
class RowStripPlan:
    """What E2 launches: ``grid`` blocks walk ``strips`` x ``groups`` work
    items (strip ``i % strips`` of column group ``i // strips``; a group is
    ``group_w`` columns, walked in panels of ``bn``); the ring has
    ``stages`` slots."""

    strip_m: int
    bn: int
    bk: int
    strips: int
    groups: int
    group_w: int
    grid: int
    stages: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def row_strip_plan(m: int, n: int, k: int, strip_m: int,
                   blocks: int | None = None, sms: int = H100_SMS,
                   smem_limit: int = H100_SMEM_OPTIN) -> RowStripPlan:
    """E2's launch for an (m, k) @ (k, n) product.  ``blocks=None``: one
    block per work item, with the fewest column groups (each a multiple of
    4 columns wide) whose items reach ``sms`` blocks; ``blocks=n``: one
    group of all columns and n blocks walking the strips.  The ring takes
    as many slots as ``smem_limit`` leaves beside the strip (3 to 8).
    Cached: the wrapper asks it on every call."""
    strips = cdiv(m, strip_m)
    groups = 1
    if blocks is None:
        groups = max(1, min(cdiv(sms, max(strips, 1)), cdiv(n, 4)))
    group_w = max(4, next_multiple(cdiv(n, groups), 4))
    groups = max(1, cdiv(n, group_w))
    grid = strips * groups if blocks is None else blocks
    spare = smem_limit - row_strip_smem_bytes(k, strip_m, 0)
    stages = min(STRIP_MAX_STAGES, max(STRIP_MIN_STAGES, spare // 16384))
    return RowStripPlan(strip_m, STRIP_BN[strip_m],
                        STRIP_BK[strip_m], strips, groups, group_w, grid,
                        stages, row_strip_smem_bytes(k, strip_m, stages))


def row_strip_l2_bytes(m: int, n: int, k: int, plan: RowStripPlan) -> dict:
    """The bytes E2 reckons to read through the L2: B once per strip,
    ceil(M / strip_m) K N 4, and A once per column group."""
    return {"b_l2_bytes": cdiv(m, plan.strip_m) * k * n * 4,
            "a_l2_bytes": plan.groups * m * k * 4}


def pack_panels(b: torch.Tensor, plan: RowStripPlan) -> torch.Tensor:
    """B laid out for E2's bulk copies: the panel of width w starting at
    column c0 is a contiguous (K, w rounded up to 4) block at offset K c0,
    so each tile of it (rows k0 .. of the panel) is one contiguous copy.
    The padding columns are left unset and never read into a sum.  Panels
    of one width at one spacing move in one strided copy: the full-width
    panels of the groups of full width, their narrow last panels, and the
    same two of the ragged last group, at most four copies."""
    k, n = b.shape
    out = torch.empty(k * next_multiple(n, 4), dtype=b.dtype,
                      device=b.device)
    gw, bn, base = plan.group_w, plan.bn, b.storage_offset()
    whole = n // gw  # groups of full width
    # (first column, groups, group width): the whole groups, then the last
    for c0, reps, w in ((0, whole, gw), (whole * gw, 1, n - whole * gw)):
        full, tail = divmod(w, bn)
        # (offset in the group, panels, panel width)
        for o, panels, pw in ((0, full, bn), (full * bn, 1, tail)):
            if reps and panels and pw:
                size = (reps, panels, k, pw)
                dst = out.as_strided(size, (k * w, k * bn,
                                            next_multiple(pw, 4), 1),
                                     k * (c0 + o))
                dst.copy_(b.as_strided(size, (w, bn, n, 1), base + c0 + o))
    return out


def matmul_row_strip(a: torch.Tensor, b: torch.Tensor,
                     strip_m: int | None = None,
                     blocks: int | None = None) -> torch.Tensor:
    """E2: C = A @ B with each block holding a ``strip_m``-row strip of A
    (8, 16 or 32; None: ``default_strip(K)``) in shared memory and
    streaming B.  ``blocks=None`` runs ``row_strip_plan``'s grid of (strip,
    column group); an int runs that many blocks over the strips
    (``blocks=1``: one block, on one SM).  A strip plus the ring above the
    opt-in limit of shared memory raises ``ValueError``."""
    _check(a, b, "matmul_row_strip")
    m, k = a.shape
    n = b.shape[1]
    limit = smem_optin_bytes(a.device)
    if strip_m is None:
        strip_m = default_strip(k, limit)
    if strip_m not in STRIP_HEIGHTS:
        raise ValueError(f"strip_m={strip_m} not in {STRIP_HEIGHTS}")
    if blocks is not None and (not isinstance(blocks, int) or blocks < 1):
        raise ValueError(f"blocks={blocks!r} must be None or a positive int")
    plan = row_strip_plan(m, n, k, strip_m, blocks, sm_count(a.device),
                          limit)
    if plan.smem_bytes > limit:
        raise ValueError(f"an A strip of {strip_m} x {k} f32 plus the ring "
                         f"needs {plan.smem_bytes} bytes of shared memory, "
                         f"more than the {limit} a block can have")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    a_op = _bulk_operand(a)
    return _launch("matmul_row_strip", "bm25_matmul_row_strip", a_op,
                   pack_panels(b, plan), a_op.shape[1], strip_m, plan.groups,
                   plan.group_w, plan.grid, plan.stages, mnk=(m, n, k))


def matmul_pipelined(a: torch.Tensor, b: torch.Tensor,
                     tile=Tile(128, 128, 16), stages: int = 2
                     ) -> torch.Tensor:
    """E3: C = A @ B on a block tile of ``PIPELINED_TILES``: E1's ring body
    with ``stages`` (2, 3 or 4) TMA stages.  It takes K and N multiples of
    4 and 16-byte aligned operands, which TMA reads as they lie, or raises
    ``ValueError``."""
    _check(a, b, "matmul_pipelined")
    t = _tile(tile, PIPELINED_TILES, "matmul_pipelined")
    if stages not in STAGES:
        raise ValueError(f"stages={stages} not in {STAGES}")
    k, n = b.shape
    if k % 4 or n % 4 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"matmul_pipelined copies 16 bytes at a time: K={k} "
                         f"and N={n} must be multiples of 4 and both operands "
                         "16-byte aligned")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    return _ring("matmul_pipelined", a, b, t, stages)


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    """What E4 launches for an (m, k) @ (k, n) product: the packed
    operands' row length ``kp`` (K rounded up to whole 16-byte units, at
    least one), ``k_steps`` ring stages of ``bk`` values each, and a
    ``grid_m`` x ``grid_n`` grid of 128 x ``bn`` C tiles."""

    kp: int
    bk: int
    k_steps: int
    bn: int
    grid_m: int
    grid_n: int


@functools.lru_cache(maxsize=256)
def mma_plan(m: int, n: int, k: int, mode: str,
             sms: int = H100_SMS) -> MmaPlan:
    """E4's launch for one shape and mode.  The tile is 128 x 128 where
    those tiles fill at most one wave of ``sms`` blocks, else 128 x 256,
    which reads fewer operand bytes through the L2 for the same outputs
    (384 rows a K step for 32,768 outputs; two 128 x 128 tiles read 512).
    Cached: the wrapper asks it on every call."""
    e = MMA_ELEM_BYTES[mode]
    kp = next_multiple(max(k, 1), 16 // e)
    bk = MMA_ROW_BYTES // e
    grid_m = cdiv(m, MMA_TILE)
    bn = MMA_TILE if grid_m * cdiv(n, MMA_TILE) <= sms else 2 * MMA_TILE
    return MmaPlan(kp, bk, cdiv(kp, bk), bn, grid_m, cdiv(n, bn))


def mma_pack_plain(a: torch.Tensor, b: torch.Tensor,
                   mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of E4's pack: A rounded as (M, kp) and B rounded and
    transposed as (N, kp), both zero past K, in ``MMA_PACKED_DTYPE`` (TF32
    values stay in f32)."""
    (m, k), n = a.shape, b.shape[1]
    kp, rnd = mma_plan(m, n, k, mode).kp, ROUNDING[mode]
    dt = MMA_PACKED_DTYPE[mode]
    ap = torch.zeros((m, kp), dtype=dt, device=a.device)
    bt = torch.zeros((n, kp), dtype=dt, device=a.device)
    ap[:, :k] = rnd(a)
    bt[:, :k] = rnd(b).t()
    return ap, bt


def _mma_mode(a: torch.Tensor, b: torch.Tensor, mode: str, modes,
              what: str) -> None:
    if mode not in modes:
        raise ValueError(f"unknown mode {mode!r}; the modes are {modes}")
    _check(a, b, what)


def _packed_scratch(a: torch.Tensor, m: int, n: int, kp: int,
                    mode: str) -> torch.Tensor:
    """One ``torch.empty`` for both packed operands: (M, kp) rows of A,
    then (N, kp) of B; kp values are whole 16-byte units, so B's start is
    aligned too."""
    return torch.empty((m + n, kp), dtype=MMA_PACKED_DTYPE[mode],
                       device=a.device)


def mma_pack(a: torch.Tensor, b: torch.Tensor,
             mode: str = "bf16in") -> tuple[torch.Tensor, torch.Tensor]:
    """E4's pack kernel alone (the twin on CPU tensors): what
    ``matmul_mma`` feeds its product kernel."""
    _mma_mode(a, b, mode, tuple(ROUNDING), "mma_pack")
    if a.device.type == "cpu":
        return mma_pack_plain(a, b, mode)
    (m, k), n = a.shape, b.shape[1]
    kp = mma_plan(m, n, k, mode).kp
    packed = _packed_scratch(a, m, n, kp, mode)
    if m or n:
        lib = _lib()
        err = _on_device(a.device, lib.bm25_mma_pack, a.data_ptr(),
                         b.data_ptr(), packed.data_ptr(), m, n, k, kp,
                         int(mode == "bf16in"))
        _build.check(lib, err, "bm25_mma_pack launch")
        launches["matmul_mma_pack"] += 1
    return packed[:m], packed[m:]


def matmul_mma(a: torch.Tensor, b: torch.Tensor,
               mode: str = "bf16in") -> torch.Tensor:
    """E4: C = A @ B with f32 accumulation in one of the script's input
    precisions: ``"default"`` (TF32 tensor cores), ``"bf16in"`` (inputs
    rounded to bf16, bf16 tensor cores) or ``"f32"`` (B6's
    ``"optimized"``, ``matmul_tiled``).  On the card the pack and the
    ``wgmma`` product, two launches; the packed operands are scratch,
    freed on return."""
    _mma_mode(a, b, mode, MMA_MODES, "matmul_mma")
    if mode == "f32":
        return matmul(a, b, algorithm="optimized")
    if a.device.type == "cpu":
        return matmul_mma_plain(a, b, mode)
    (m, k), n = a.shape, b.shape[1]
    plan = mma_plan(m, n, k, mode, sm_count(a.device))
    packed = _packed_scratch(a, m, n, plan.kp, mode)
    out = _launch("matmul_mma", "bm25_matmul_mma", a, b, packed.data_ptr(),
                  plan.kp, plan.bn, plan.grid_m, plan.grid_n,
                  int(mode == "bf16in"))
    if m and n:  # counted as _launch counts the product
        launches["matmul_mma_pack"] += 1
    return out
