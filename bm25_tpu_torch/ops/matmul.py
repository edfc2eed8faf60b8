"""Matrix product: CUDA kernel B6 (naive and optimized) and its plain twin.

PyTorch counterpart of ``bm25_tpu/ops/matmul.py``, the op library's
``matrix_multiplication``: ``C = A @ B`` for a row-major (M, K) A and
(K, N) B, f32 or bf16, summed in f32, with C in A's dtype.

* ``algorithm="naive"`` launches ``matmul_naive`` of ``csrc/matmul.cu``
  (one thread per output element; replaces the Pallas naive schedule, and
  stays the reference's naive baseline by design);
* ``algorithm="optimized"`` launches ``matmul_tiled``: the TMA ring body
  of ``csrc/matmul_ring.cuh`` (shared with E1 and E3), typed for f32 and
  bf16, on as many blocks as the SMs hold at once, walking a balanced
  order of C tiles (``b6_plan``, ``tile_order``); it replaces the
  resident-C and K-tiled Pallas schedules.  TMA reads rows of whole
  16-byte units from a 16-byte aligned start: an operand that is not so
  (a bf16 row of 1028 values, a view off alignment) is first copied into
  a padded ``torch.empty`` (``_bulk_operand``, timed with the call);
* ``algorithm="xla"`` is ``torch.matmul`` of the f32-widened inputs in
  full f32 (``full_f32_matmul``), rounded once to A's dtype: the plain
  library product, as the JAX package leaves ``"xla"`` to XLA.  It is not
  a port of B6.

On CUDA tensors the two kernel algorithms launch their kernel or raise;
only tensors on the CPU run the plain twin ``matmul_plain``, a loop over k
of f32 fused multiply-adds.  Kernels and twin sum k in ascending order
with one rounding per product, so all three give the same bits (see the
header of ``csrc/matmul.cu``).  JAX's sums run in another order, so the
port and JAX agree within ``2 K 2^-24 (|A| @ |B|)``, not bit for bit.

Tiles: the Pallas VMEM tiling (``_auto_tile``, ``_shrink_naive_tiles``,
the resident-C schedule) has no meaning on the card and is not copied.
``tile_m``/``tile_n``/``tile_k`` of ``"optimized"`` choose among the
ring's instantiated tiles for the dtype, ``TILES[dtype]``; ``"naive"``
runs a fixed 32 x 32 thread block and takes no tile argument.  A tile
that cannot be honoured raises ``ValueError``: none is ignored.

The helpers the E1-E4 wrappers share with B6 live here too (the card's SM
count and shared-memory limit, the ring's shared memory, ``_bulk_operand``,
``_on_device``); ``ops/matmul_schedules.py`` imports them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from bm25_tpu_torch.utils.padding import cdiv, next_multiple
from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.ops.ell_score import _fma_f32
from bm25_tpu_torch.ops.registry import register_op
from bm25_tpu_torch.runtime.session import full_f32_matmul

ALGORITHMS = ("xla", "naive", "optimized")
DTYPES = (torch.float32, torch.bfloat16)
# an H100 SXM's SMs and its opt-in limit of shared memory per block: the
# rules' defaults where no card is asked
H100_SMS = 132
H100_SMEM_OPTIN = 232448
# the TMA ring (csrc/matmul_ring.cuh): at most this many stages, from a
# base aligned to TMA's 128 bytes, then a full and an empty mbarrier for
# each of the most stages
RING_MAX_STAGES = 4
RING_ALIGN = 128
# pick_tile's rule: the busiest SM's FMAs within this factor of an even
# share over the SMs
BALANCE = 1.15

# kernel launches, counted only where a kernel is launched
launches = {"matmul_naive": 0, "matmul_tiled": 0}
# plain-twin runs (CPU tensors, or a direct call)
plain_calls = {"matmul": 0}


class Tile(NamedTuple):
    m: int
    n: int
    k: int


# B6's ring tiles per dtype, in order of preference (the larger tile reads
# fewer operand bytes through the L2).  At 64 x 128 a K step of 32 leaves
# room for four stages for each of two blocks an SM; f32 at 128 x 128
# takes 64, whose kernel fits the registers where 32's spilled (PERF.md
# §6, PR 11).
TILES = {
    torch.float32: (Tile(128, 128, 64), Tile(64, 128, 32)),
    torch.bfloat16: (Tile(128, 128, 32), Tile(64, 128, 32)),
}


def tile_order(m: int, n: int, tile) -> list[tuple[int, int]]:
    """The (tile row, tile column) order the optimized kernel walks
    (``matmul_ring.cuh::tile_at``): the full tiles row-major, then the
    right edge's thin tiles top to bottom, the bottom edge's left to
    right, the corner.  Block b takes tiles b, b + grid, ... of it."""
    t = Tile(*tile)
    fm, fn = m // t.m, n // t.n
    em, en = m % t.m > 0, n % t.n > 0
    order = [(i, j) for i in range(fm) for j in range(fn)]
    if en:
        order += [(i, fn) for i in range(fm)]
    if em:
        order += [(fm, j) for j in range(fn)]
    if em and en:
        order.append((fm, fn))
    return order


def blocks_per_sm(tile) -> int:
    """Blocks of the ring an SM holds at once: two at 64 rows, whose
    threads keep 32 accumulators (the kernel's launch bounds ask for
    two), else one."""
    return 2 if Tile(*tile).m == 64 else 1


def grid_size(m: int, n: int, tile, sms: int) -> int:
    """Blocks launched: ``min(tiles, sms * blocks_per_sm(tile))``; each
    walks ``tile_order`` from its index in steps of the grid."""
    t = Tile(*tile)
    return max(1, min(cdiv(m, t.m) * cdiv(n, t.n), sms * blocks_per_sm(t)))


def sm_fmas(m: int, n: int, k: int, tile, sms: int) -> list[int]:
    """The FMAs (the products of the C elements written) each of ``sms``
    SMs does, with block b on SM ``b % sms``, as the card hands out a
    launch's first blocks."""
    t = Tile(*tile)
    grid = grid_size(m, n, t, sms)
    work = [0] * sms
    for i, (tm, tn) in enumerate(tile_order(m, n, t)):
        work[i % grid % sms] += (min(t.m, m - tm * t.m)
                                 * min(t.n, n - tn * t.n) * k)
    return work


@functools.lru_cache(maxsize=256)
def pick_tile(m: int, n: int, dtype: torch.dtype, tile_m: int | None = None,
              tile_n: int | None = None, tile_k: int | None = None,
              sms: int = H100_SMS) -> Tile:
    """The tile of the optimized kernel for an (m, n) output of ``dtype``.

    Among the dtype's instantiated tiles that match every given override,
    the first (in ``TILES`` order) whose walk keeps the busiest SM within
    ``BALANCE`` times an even share of the FMAs over ``sms`` SMs
    (``sm_fmas``), else the one whose busiest SM has the fewest.  No
    match raises ``ValueError`` naming the tiles there are.  Cached: the
    wrapper asks it on every call.
    """
    tiles = TILES[dtype]
    fits = [t for t in tiles
            if tile_m in (None, t.m) and tile_n in (None, t.n)
            and tile_k in (None, t.k)]
    if not fits:
        raise ValueError(
            f"no {dtype} matmul_tiled instantiation has tile_m={tile_m}, "
            f"tile_n={tile_n}, tile_k={tile_k}; the tiles (m, n, k) are "
            f"{[tuple(t) for t in tiles]}")

    def busiest(t: Tile) -> int:
        return max(sm_fmas(m, n, 1, t, sms))

    for t in fits:
        if busiest(t) <= BALANCE * m * n / sms:
            return t
    return min(fits, key=busiest)


class B6Plan(NamedTuple):
    """What the optimized kernel launches: ``grid`` blocks walking
    ``tile``'s C tiles, each through a ring of ``stages``."""

    tile: Tile
    grid: int
    stages: int


def ring_smem_bytes(tile, stages: int, esize: int = 4,
                    padded: bool = False) -> int:
    """Shared memory of a ring of ``stages`` at ``tile`` for elements of
    ``esize`` bytes: room to align, the stages (A's BM x BK box, its rows
    ``padded`` by 16 bytes as B6 lays them, then B's BK x BN) and the
    barriers (csrc/matmul_ring.cuh, ``RingShape``)."""
    t = Tile(*tile)
    a_row = t.k + (16 // esize if padded else 0)
    return (RING_ALIGN + stages * (t.m * a_row + t.k * t.n) * esize
            + 2 * RING_MAX_STAGES * 8)


def ring_stages(tile, esize: int = 4, smem_limit: int = H100_SMEM_OPTIN,
                padded: bool = False) -> int:
    """The deepest ring up to ``RING_MAX_STAGES`` whose shared memory fits
    ``smem_limit``; raises where not even two stages fit."""
    fits = [s for s in range(2, RING_MAX_STAGES + 1)
            if ring_smem_bytes(tile, s, esize, padded) <= smem_limit]
    if not fits:
        raise ValueError(f"no ring of two stages at tile {tuple(tile)} fits "
                         f"{smem_limit} bytes of shared memory")
    return fits[-1]


@functools.lru_cache(maxsize=256)
def b6_plan(m: int, n: int, dtype: torch.dtype, tile_m: int | None = None,
            tile_n: int | None = None, tile_k: int | None = None,
            sms: int = H100_SMS,
            smem_limit: int = H100_SMEM_OPTIN) -> B6Plan:
    """The optimized kernel's launch for an (m, n) output of ``dtype``:
    ``pick_tile``'s tile, ``grid_size`` blocks and the deepest ring that
    fits ``blocks_per_sm`` times in an SM (whose shared memory is the
    per-block limit plus the 1 KB the card keeps for each block).  Cached:
    the wrapper asks it on every call."""
    tile = pick_tile(m, n, dtype, tile_m, tile_n, tile_k, sms)
    esize = torch.empty((), dtype=dtype).element_size()
    per_block = (smem_limit + 1024) // blocks_per_sm(tile) - 1024
    return B6Plan(tile, grid_size(m, n, tile, sms),
                  ring_stages(tile, esize, min(smem_limit, per_block),
                              padded=True))


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of B6: f32 fused multiply-adds over k in
    ascending order from +0, then one rounding to A's dtype."""
    plain_calls["matmul"] += 1
    af, bf = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for kk in range(a.shape[1]):
        acc = _fma_f32(af[:, kk : kk + 1], bf[kk : kk + 1, :], acc)
    return acc.to(a.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bm25_matmul_naive.argtypes = [p, p, p, ll, ll, ll, i, p]
    lib.bm25_matmul_tiled.argtypes = [p, p, p, ll, ll, ll, ll, ll, i, i, i,
                                      i, i, ll, p]
    lib.bm25_smem_optin_bytes.argtypes = [i]
    for fn in (lib.bm25_matmul_naive, lib.bm25_matmul_tiled,
               lib.bm25_smem_optin_bytes):
        fn.restype = i
    return lib


@functools.cache
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The card's SM count (read once per device), an H100's on the
    CPU."""
    if device.type == "cuda":
        return _card_sms(device.index or 0)
    return H100_SMS


@functools.cache
def _card_smem_optin(index: int) -> int:
    return _lib().bm25_smem_optin_bytes(index)


def smem_optin_bytes(device: torch.device) -> int:
    """The opt-in limit of shared memory per block: read from the card,
    an H100's on the CPU."""
    if device.type == "cuda":
        return _card_smem_optin(device.index or 0)
    return H100_SMEM_OPTIN


def _on_device(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``device`` current, on its current
    stream (read in one call into torch's C layer where the build has it:
    the wrapper's host work counts where it outlasts the kernel).  The
    device is switched only where it is not the current one."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if device.index == torch.cuda.current_device():
        return fn(*args, raw(device.index) if raw else
                  torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _bulk_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` where its rows are whole 16-byte units from a 16-byte aligned
    start, as bulk copies and TMA take them; else a copy into a
    ``torch.empty`` whose rows are padded to a multiple of 16 bytes (the
    padding is never read into a sum)."""
    cols, unit = x.shape[1], 16 // x.element_size()
    if cols % unit == 0 and x.data_ptr() % 16 == 0:
        return x
    padded = torch.empty((x.shape[0], next_multiple(cols, unit)),
                         dtype=x.dtype, device=x.device)
    padded[:, :cols] = x
    return padded


def _optimized(a: torch.Tensor, b: torch.Tensor, plan: B6Plan,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the ring on a CUDA (a, b) as ``plan`` says into ``out`` (a
    contiguous (M, N) tensor of A's dtype; None: a new one), each operand
    staged into a padded copy where TMA cannot read it as it lies (the
    kernel reads the real (M, K) and (K, N) parts); counted."""
    (m, k), n = a.shape, b.shape[1]
    if out is None:
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    elif (out.shape != (m, n) or out.dtype != a.dtype
          or out.device != a.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({m}, {n}) {a.dtype} "
                         f"tensor on {a.device}")
    if m == 0 or n == 0:
        return out
    a_op, b_op = _bulk_operand(a), _bulk_operand(b)
    t, lib = plan.tile, _lib()
    err = _on_device(a.device, lib.bm25_matmul_tiled, a_op.data_ptr(),
                     b_op.data_ptr(), out.data_ptr(), m, n, k,
                     a_op.shape[1], b_op.shape[1],
                     int(a.dtype == torch.bfloat16), t.m, t.n, t.k,
                     plan.stages, plan.grid)
    _build.check(lib, err, "bm25_matmul_tiled launch")
    launches["matmul_tiled"] += 1
    return out


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    """What the kernels take (checked on every device, so the CPU twin
    refuses what the card would)."""
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError("matmul takes two float32 or two bfloat16 tensors, "
                        f"got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes contiguous (row-major) tensors")
    if a.device.type not in ("cuda", "cpu"):
        raise ValueError(f"matmul runs on cuda or cpu, not {a.device}")


def matmul(a: torch.Tensor, b: torch.Tensor, algorithm: str = "optimized",
           tile_m: int | None = None, tile_n: int | None = None,
           tile_k: int | None = None) -> torch.Tensor:
    """B6: C = A @ B with a selectable algorithm (``"optimized"``,
    ``"naive"`` or ``"xla"``), summed in f32, C in A's dtype.

    Same signature as the JAX ``matmul``.  Unlike it, the tile arguments
    choose among the tiled kernel's own tiles, and ``"naive"`` takes none
    (see the module docstring),
    and ``"naive"``/``"optimized"`` take f32 or bf16 operands of one dtype,
    contiguous and on one device.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"incompatible shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if algorithm == "xla":
        with full_f32_matmul():
            return torch.matmul(a.float(), b.float()).to(a.dtype)
    _check_operands(a, b)
    (m, k), n = a.shape, b.shape[1]
    cuda = a.device.type == "cuda"
    if algorithm == "naive":
        if (tile_m, tile_n, tile_k) != (None, None, None):
            raise ValueError("algorithm='naive' runs a fixed 32 x 32 thread "
                             "block and takes no tile_m, tile_n or tile_k")
    else:
        plan = b6_plan(m, n, a.dtype, tile_m, tile_n, tile_k,
                       sm_count(a.device), smem_optin_bytes(a.device))
    if not cuda:
        return matmul_plain(a, b)
    if algorithm == "optimized":
        return _optimized(a, b, plan)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    err = _on_device(a.device, lib.bm25_matmul_naive, a.data_ptr(),
                     b.data_ptr(), out.data_ptr(), m, n, k,
                     int(a.dtype == torch.bfloat16))
    _build.check(lib, err, "bm25_matmul_naive launch")
    launches["matmul_naive"] += 1
    return out


register_op("matrix_multiplication")(matmul)
