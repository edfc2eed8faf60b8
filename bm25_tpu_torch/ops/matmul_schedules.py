"""Schedules of the matrix product: CUDA kernels E1-E4 and their twins.

The four TPU experiments on kernel B6's ``C = A @ B``
(``scripts/exp_r4_matmul_{tiles3,tiles4,dma,precision}.py``), each as a
kernel of ``csrc/matmul_schedules.cu`` (see its header for the designs and
what bounds them).  Operands are row-major float32, any M, K, N unless a
kernel states a limit:

* ``matmul_sweep(a, b, tile)`` (E1, ``mm_noacc``): a (BM, BN, BK) block tile
  of ``SWEEP_TILES`` with the C tile in registers over the whole K loop;
  ``resident_tile`` picks the one-wave tile that stands for the script's
  ``mm_resident``;
* ``matmul_row_strip(a, b, strip_m, blocks=None)`` (E2,
  ``mm_b_resident``): a block holds a ``strip_m``-row strip of A in shared
  memory and streams B; ``blocks=1`` is ``mm_single_dot``'s grid of one;
* ``matmul_pipelined(a, b, tile, stages=2)`` (E3, ``mm_dma``): E1's block
  tile fed by a ``stages``-slot ``cp.async`` ring;
* ``matmul_mma(a, b, mode)`` (E4, ``pallas_matmul``): ``"default"`` on TF32
  and ``"bf16in"`` on bf16 tensor cores (``mma.sync``); ``"f32"``, the
  script's baseline, is B6's ``matmul_tiled`` and counts as its launch.

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
import functools

import torch

from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.ops.matmul import H100_SMS, Tile, matmul, matmul_plain
from bm25_tpu_torch.utils.padding import cdiv, next_multiple

SWEEP_TILES = tuple(Tile(m, n, k) for m, n in ((64, 64), (128, 64),
                                                (128, 128), (256, 128))
                    for k in (8, 16, 32))
STRIP_HEIGHTS = (8, 16, 32)
STRIP_BN, STRIP_BK = 128, 32  # E2's staging tile of B
PIPELINED_TILES = (Tile(64, 64, 16), Tile(128, 128, 16))
STAGES = (2, 3, 4)
MMA_MODES = ("f32", "default", "bf16in")
# an H100's opt-in limit of shared memory per block: the rule's default
# where no card is asked
H100_SMEM_OPTIN = 232448

# kernel launches, counted only where a kernel is launched (mode="f32" of
# matmul_mma counts under ops.matmul.launches["matmul_tiled"])
launches = {"matmul_sweep": 0, "matmul_row_strip": 0, "matmul_pipelined": 0,
            "matmul_mma": 0}


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
    lib.bm25_matmul_sweep.argtypes = [p, p, p, ll, ll, ll, i, i, i, i, p]
    lib.bm25_matmul_row_strip.argtypes = [p, p, p, ll, ll, ll, i, i, p]
    lib.bm25_matmul_pipelined.argtypes = [p, p, p, ll, ll, ll, i, i, p]
    lib.bm25_matmul_mma.argtypes = [p, p, p, ll, ll, ll, i, p]
    lib.bm25_smem_optin_bytes.argtypes = [i]
    for fn in (lib.bm25_matmul_sweep, lib.bm25_matmul_row_strip,
               lib.bm25_matmul_pipelined, lib.bm25_matmul_mma,
               lib.bm25_smem_optin_bytes):
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
            *args) -> torch.Tensor:
    """Launch ``fn`` of the library on (a, b) into a new C; counted."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, fn)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               m, n, k, *args, stream)
    _build.check(lib, err, f"{fn} launch")
    launches[name] += 1
    return out


def _tile(tile, tiles, what: str) -> Tile:
    t = Tile(*tile)
    if t not in tiles:
        raise ValueError(f"{what} has no tile {tuple(t)}; the tiles "
                         f"(m, n, k) are {[tuple(x) for x in tiles]}")
    return t


def sm_count(device: torch.device) -> int:
    """The card's SM count, an H100's on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def smem_optin_bytes(device: torch.device) -> int:
    """The opt-in limit of shared memory per block: read from the card,
    an H100's on the CPU."""
    if device.type == "cuda":
        return _lib().bm25_smem_optin_bytes(device.index or 0)
    return H100_SMEM_OPTIN


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


def matmul_sweep(a: torch.Tensor, b: torch.Tensor,
                 tile=Tile(128, 128, 16)) -> torch.Tensor:
    """E1: C = A @ B on the (BM, BN, BK) block tile ``tile`` of
    ``SWEEP_TILES``, the C tile in registers over the whole K loop."""
    _check(a, b, "matmul_sweep")
    t = _tile(tile, SWEEP_TILES, "matmul_sweep")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    k, n = b.shape
    vec = int(k % 4 == 0 and n % 4 == 0 and a.data_ptr() % 16 == 0
              and b.data_ptr() % 16 == 0)
    return _launch("matmul_sweep", "bm25_matmul_sweep", a, b, t.m, t.n, t.k,
                   vec)


def row_strip_smem_bytes(k: int, strip_m: int) -> int:
    """Shared memory of an E2 block: the A strip (K padded to 4) and the
    staging tile of B."""
    return (strip_m * next_multiple(k, 4) + STRIP_BK * STRIP_BN) * 4


def matmul_row_strip(a: torch.Tensor, b: torch.Tensor, strip_m: int = 8,
                     blocks: int | None = None) -> torch.Tensor:
    """E2: C = A @ B with each block holding a ``strip_m``-row strip of A
    (8, 16 or 32) in shared memory and streaming B.  ``blocks=None`` runs
    one block per strip; an int runs that many blocks over the strips
    (``blocks=1``: one block, on one SM).  A strip plus staging above the
    opt-in limit of shared memory raises ``ValueError``."""
    _check(a, b, "matmul_row_strip")
    if strip_m not in STRIP_HEIGHTS:
        raise ValueError(f"strip_m={strip_m} not in {STRIP_HEIGHTS}")
    if blocks is not None and (not isinstance(blocks, int) or blocks < 1):
        raise ValueError(f"blocks={blocks!r} must be None or a positive int")
    k = a.shape[1]
    need = row_strip_smem_bytes(k, strip_m)
    limit = smem_optin_bytes(a.device)
    if need > limit:
        raise ValueError(f"an A strip of {strip_m} x {k} f32 plus staging "
                         f"needs {need} bytes of shared memory, more than "
                         f"the {limit} a block can have")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    return _launch("matmul_row_strip", "bm25_matmul_row_strip", a, b, strip_m,
                   blocks or 0)


def matmul_pipelined(a: torch.Tensor, b: torch.Tensor,
                     tile=Tile(128, 128, 16), stages: int = 2
                     ) -> torch.Tensor:
    """E3: C = A @ B on a block tile of ``PIPELINED_TILES`` fed by a
    ``stages``-slot (2, 3 or 4) ``cp.async`` ring.  Its 16-byte copies need
    K and N multiples of 4 and 16-byte aligned operands, or it raises
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
    return _launch("matmul_pipelined", "bm25_matmul_pipelined", a, b, t.m,
                   stages)


def matmul_mma(a: torch.Tensor, b: torch.Tensor,
               mode: str = "bf16in") -> torch.Tensor:
    """E4: C = A @ B with f32 accumulation in one of the script's input
    precisions: ``"default"`` (TF32 tensor cores), ``"bf16in"`` (inputs
    rounded to bf16, bf16 tensor cores) or ``"f32"`` (B6's
    ``matmul_tiled``)."""
    if mode not in MMA_MODES:
        raise ValueError(f"unknown mode {mode!r}; the modes are {MMA_MODES}")
    _check(a, b, "matmul_mma")
    if mode == "f32":
        return matmul(a, b, algorithm="optimized")
    if a.device.type == "cpu":
        return matmul_mma_plain(a, b, mode)
    return _launch("matmul_mma", "bm25_matmul_mma", a, b,
                   int(mode == "bf16in"))
