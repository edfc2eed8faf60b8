"""Matrix product: CUDA kernel B6 (naive and block-tiled) and its plain twin.

PyTorch counterpart of ``bm25_tpu/ops/matmul.py``, the op library's
``matrix_multiplication``: ``C = A @ B`` for a row-major (M, K) A and
(K, N) B, f32 or bf16, summed in f32, with C in A's dtype.

* ``algorithm="naive"`` launches ``matmul_naive`` of ``csrc/matmul.cu``
  (one thread per output element; replaces the Pallas naive schedule);
* ``algorithm="optimized"`` launches ``matmul_tiled`` (shared-memory
  block tiling with register blocking; replaces the resident-C and
  K-tiled Pallas schedules);
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
kernel's instantiated tiles for the dtype, ``TILES[dtype]``; ``"naive"``
runs a fixed 32 x 32 thread block and takes no tile argument.  A tile
that cannot be honoured raises ``ValueError``: none is ignored.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from bm25_tpu_torch.utils.padding import cdiv
from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.ops.ell_score import _fma_f32
from bm25_tpu_torch.ops.registry import register_op
from bm25_tpu_torch.runtime.session import full_f32_matmul

ALGORITHMS = ("xla", "naive", "optimized")
DTYPES = (torch.float32, torch.bfloat16)
# an H100 SXM's SMs: the block-count rule's default where no card is asked
H100_SMS = 132

# kernel launches, counted only where a kernel is launched
launches = {"matmul_naive": 0, "matmul_tiled": 0}
# plain-twin runs (CPU tensors, or a direct call)
plain_calls = {"matmul": 0}


class Tile(NamedTuple):
    m: int
    n: int
    k: int


# the tiles matmul_tiled is instantiated for, per dtype, in order of
# preference; the K step is 16 for f32 and 8 for bf16 (the faster of the
# two at 1028^3 on an H100, PERF.md)
TILES = {
    torch.float32: (Tile(128, 128, 16), Tile(64, 64, 16)),
    torch.bfloat16: (Tile(128, 128, 8), Tile(64, 64, 8)),
}


def pick_tile(m: int, n: int, dtype: torch.dtype, tile_m: int | None = None,
              tile_n: int | None = None, tile_k: int | None = None,
              sms: int = H100_SMS) -> Tile:
    """The tile of ``matmul_tiled`` for an (m, n) output of ``dtype``.

    Among the dtype's instantiated tiles that match every given override,
    the first (in ``TILES`` order) that gives at least one block per SM,
    else the one with the most blocks.  No match raises ``ValueError``
    naming the tiles there are.
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

    def blocks(t: Tile) -> int:
        return cdiv(m, t.m) * cdiv(n, t.n)

    for t in fits:
        if blocks(t) >= sms:
            return t
    return max(fits, key=blocks)


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
    lib.bm25_matmul_naive.restype = i
    lib.bm25_matmul_tiled.argtypes = [p, p, p, ll, ll, ll, i, i, i, p]
    lib.bm25_matmul_tiled.restype = i
    return lib


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
    m, k = a.shape
    n = b.shape[1]
    cuda = a.device.type == "cuda"
    if algorithm == "naive":
        if (tile_m, tile_n, tile_k) != (None, None, None):
            raise ValueError("algorithm='naive' runs a fixed 32 x 32 thread "
                             "block and takes no tile_m, tile_n or tile_k")
    else:
        sms = (torch.cuda.get_device_properties(a.device).multi_processor_count
               if cuda else H100_SMS)
        tile = pick_tile(m, n, a.dtype, tile_m, tile_n, tile_k, sms)
    if not cuda:
        return matmul_plain(a, b)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    bf16 = int(a.dtype == torch.bfloat16)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if algorithm == "naive":
            err = lib.bm25_matmul_naive(a.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), m, n, k, bf16, stream)
        else:
            vw = 16 // a.element_size()
            vec = int(k % vw == 0 and n % vw == 0 and a.data_ptr() % 16 == 0
                      and b.data_ptr() % 16 == 0)
            err = lib.bm25_matmul_tiled(a.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), m, n, k, bf16, tile.m,
                                        vec, stream)
    name = "matmul_naive" if algorithm == "naive" else "matmul_tiled"
    _build.check(lib, err, f"bm25_{name} launch")
    launches[name] += 1
    return out


register_op("matrix_multiplication")(matmul)
