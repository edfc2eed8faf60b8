"""Winning-group gather over 128-wide super-rows: CUDA kernels E5-E7 and
their plain twin.

The function of three TPU experiments (``scripts/exp_r4_pallas_gather.py``,
``exp_r4_window_gather.py``, ``exp_r4_dyngather.py``), the gather beside
the top-k tree's selection step:

    out[q, j, :] = x3[q, rowof[q, j], :]

``x3`` (Q, R, 128) f32 is a query's score row cut into super-rows and
``rowof`` (Q, KP) int32 the winners' row ids.  Three kernels of
``csrc/super_row_gather.cu`` compute it (see its header for the designs
and what bounds them):

* ``super_row_gather`` (E5): one warp per output super-row,
  ``rows_per_warp`` rows in turn (the TPU kernel's unroll sweep);
* ``super_row_gather_window`` (E6): winners sorted within each query; a
  block walks a run of one query's winners and reads each distinct row
  once, through a ring of ``window`` row slots in shared memory;
  ``fallbacks`` gains the number of tiles of 8 whose span does not fit
  the script's window (``window_fallback_tiles``), a property of the ids;
* ``super_row_gather_resident`` (E7): one block per query holds the whole
  (H, 128) table in shared memory; an H above the card's opt-in limit
  raises ``ValueError``.

Each wrapper launches its kernel on CUDA tensors and raises on anything the
kernel does not take; only a tensor on the CPU runs the plain twin.  It is
a copy, so every kernel equals the twin bit for bit.  Row ids must lie in
[0, R).  Nothing on the engines' path calls these yet, and the op is not
registered: ``bm25_tpu.ops`` has no such op.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bm25_tpu_torch.ops import _build

ROW = 128  # floats per super-row
WINDOW_TILE = 8  # winners per window tile
ROWS_PER_WARP = (1, 4, 8, 16)

# kernel launches, counted only where a kernel is launched
launches = {"super_row_gather": 0, "super_row_gather_window": 0,
            "super_row_gather_resident": 0}
# plain-twin runs (CPU tensors, or a direct call)
plain_calls = {"super_row_gather": 0}


def super_row_gather_plain(x3: torch.Tensor,
                           rowof: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of E5-E7: ``x3[arange(Q)[:, None], rowof]``."""
    plain_calls["super_row_gather"] += 1
    q = x3.shape[0]
    return x3[torch.arange(q, device=x3.device)[:, None], rowof.long()]


def window_fallback_tiles(rowof: torch.Tensor, r: int,
                          window: int) -> torch.Tensor:
    """The number of E6 tiles whose 8 winners do not fit their window
    (``w7 - w0a >= window``), as a 0-d int64 tensor on rowof's device."""
    w0 = rowof[:, 0::WINDOW_TILE].clamp(0, r - 1)
    w7 = rowof[:, WINDOW_TILE - 1::WINDOW_TILE].clamp(0, r - 1)
    w0a = torch.clamp(w0 // 8 * 8, max=r - window)
    return (w7 - w0a >= window).sum()


def _check_window(x3: torch.Tensor, rowof: torch.Tensor, window: int) -> None:
    r, kp = x3.shape[1], rowof.shape[1]
    if window <= 0 or window % 8:
        raise ValueError(f"window={window} must be a positive multiple of 8")
    if r < window:
        raise ValueError(f"the window of {window} rows needs R >= {window}, "
                         f"got R={r}")
    if kp % WINDOW_TILE:
        raise ValueError(f"KP={kp} must be a multiple of {WINDOW_TILE}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("super_row_gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bm25_super_row_gather.argtypes = [p, p, i, i, i, i, p, p]
    lib.bm25_super_row_gather_window.argtypes = [p, p, i, i, i, i, p, p, p]
    lib.bm25_super_row_gather_resident.argtypes = [p, p, i, i, i, p, p]
    lib.bm25_smem_optin_bytes.argtypes = [i]
    for fn in (lib.bm25_super_row_gather, lib.bm25_super_row_gather_window,
               lib.bm25_super_row_gather_resident, lib.bm25_smem_optin_bytes):
        fn.restype = i
    return lib


@functools.cache
def smem_optin_bytes(device_index: int) -> int:
    """The card's opt-in limit of shared memory per block, in bytes."""
    return _lib().bm25_smem_optin_bytes(device_index)


def _checked(x3: torch.Tensor, rowof: torch.Tensor) -> torch.Tensor:
    """Validate CUDA inputs; returns the empty (Q, KP, 128) output."""
    device = x3.device
    if device.type != "cuda":
        raise ValueError(f"super_row_gather runs on cuda or cpu, not {device}")
    if x3.dim() != 3 or x3.shape[2] != ROW or x3.dtype != torch.float32:
        raise TypeError(f"x3 must be (Q, R, {ROW}) float32, got {x3.dtype} "
                        f"{tuple(x3.shape)}")
    if rowof.dim() != 2 or rowof.shape[0] != x3.shape[0]:
        raise ValueError(f"rowof must be (Q={x3.shape[0]}, KP), got "
                         f"{tuple(rowof.shape)}")
    if rowof.device != device:
        raise ValueError(f"rowof is on {rowof.device}, expected {device}")
    if rowof.dtype != torch.int32:
        raise TypeError(f"rowof must be int32, got {rowof.dtype}")
    if not (x3.is_contiguous() and rowof.is_contiguous()):
        raise ValueError("x3 and rowof must be contiguous")
    if x3.data_ptr() % 16:
        raise ValueError("x3 must be 16-byte aligned")
    if x3.shape[1] == 0 and rowof.numel():
        raise ValueError("x3 has no rows to gather from")
    return torch.empty((rowof.shape[0], rowof.shape[1], ROW),
                       dtype=torch.float32, device=device)


def _launch(name: str, fn, *args) -> None:
    lib = _lib()
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                                 else a for a in args], stream)
    _build.check(lib, err, f"{fn} launch")
    launches[name] += 1


def super_row_gather(x3: torch.Tensor, rowof: torch.Tensor,
                     rows_per_warp: int = 1) -> torch.Tensor:
    """E5: (Q, R, 128) f32 x (Q, KP) int32 row ids -> (Q, KP, 128) f32,
    one warp per output super-row, ``rows_per_warp`` (1, 4, 8 or 16) rows
    each."""
    if rows_per_warp not in ROWS_PER_WARP:
        raise ValueError(f"rows_per_warp={rows_per_warp} not in "
                         f"{ROWS_PER_WARP}")
    if x3.device.type == "cpu":
        return super_row_gather_plain(x3, rowof)
    out = _checked(x3, rowof)
    q, r, _ = x3.shape
    _launch("super_row_gather", "bm25_super_row_gather", x3, rowof, q, r,
            rowof.shape[1], rows_per_warp, out)
    return out


def super_row_gather_window(x3: torch.Tensor, rowof: torch.Tensor,
                            window: int = 32,
                            fallbacks: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """E6: the gather for winners sorted within each query, through a ring
    of ``window`` row slots (any order of ids gives the gather; sorted ids
    read each distinct row once per run).  Requires R >= window, window %
    8 == 0 and KP % 8 == 0, or raises ``ValueError``.  ``fallbacks`` (a
    (1,) int32 tensor on x3's device) gains ``window_fallback_tiles(rowof,
    R, window)``, the tiles of 8 whose span does not fit the window."""
    _check_window(x3, rowof, window)
    if fallbacks is not None and (fallbacks.device != x3.device or
                                  fallbacks.dtype != torch.int32 or
                                  fallbacks.numel() != 1):
        raise ValueError("fallbacks must be one int32 on x3's device")
    if x3.device.type == "cpu":
        if fallbacks is not None:
            fallbacks += window_fallback_tiles(rowof, x3.shape[1],
                                               window).to(torch.int32)
        return super_row_gather_plain(x3, rowof)
    out = _checked(x3, rowof)
    q, r, _ = x3.shape
    _launch("super_row_gather_window", "bm25_super_row_gather_window", x3,
            rowof, q, r, rowof.shape[1], window, out, fallbacks)
    return out


def super_row_gather_resident(x3: torch.Tensor,
                              rowof: torch.Tensor) -> torch.Tensor:
    """E7: the gather with each query's whole (H, 128) table held in shared
    memory.  On the card an H whose table exceeds the opt-in limit of
    shared memory per block raises ``ValueError``."""
    if x3.device.type == "cpu":
        return super_row_gather_plain(x3, rowof)
    out = _checked(x3, rowof)
    q, h, _ = x3.shape
    limit = smem_optin_bytes(x3.device.index or 0)
    if h * ROW * 4 > limit:
        raise ValueError(f"a table of H={h} rows needs {h * ROW * 4} bytes of "
                         f"shared memory, more than the card's {limit}")
    _launch("super_row_gather_resident", "bm25_super_row_gather_resident",
            x3, rowof, q, h, rowof.shape[1], out)
    return out
