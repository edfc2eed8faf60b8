"""Matmul schedule sweep: the four TPU schedule experiments as one script
for the port (kernels E1-E4 of ``ops/matmul_schedules.py``).

For each size s the operands are drawn as the scripts draw them,
``a, b = default_rng(0).standard_normal((s, s), float32)`` (in that order),
and the variants are gated by size as the scripts gate them:

* E1 (``exp_r4_matmul_tiles3.py``): ``matmul_sweep`` on every tile of
  ``SWEEP_TILES``, and at s <= 1600 the resident rows, the one-wave tile at
  each K step (the script's ``mm_resident`` at each ``tk``);
* E2 (``exp_r4_matmul_tiles4.py``): ``matmul_row_strip`` at every strip
  height whose A strip fits the card's shared memory, and at s <= 1600 one
  block over all strips (``mm_single_dot``'s grid of one);
* E3 (``exp_r4_matmul_dma.py``): ``matmul_pipelined`` on each tile at 2, 3
  and 4 stages, at s <= 2048 (the script's sizes 1028 and 2048) where s
  is a multiple of 4;
* E4 (``exp_r4_matmul_precision.py``): ``matmul_mma`` in its three modes.

Every variant is checked on all rows before it is timed, and a variant that
fails raises: E1-E3 and ``mode="f32"`` against ``torch.matmul`` in full f32
within ``2 K 2^-24 (|A| @ |B|)`` (two f32 sums of the same products in two
orders), E4's TF32 and bf16 modes against the float64 product of the
rounded inputs within ``K 2^-22 (|A^| @ |B^|)`` and within
``UNROUNDED_SHARE`` of the unrounded inputs' reading (``mma_readings``).
Each row also carries the
scripts' ``max_rel_err``: the largest ``|C - W| / (|W| + 1e-6)`` over the
first 128 rows, W the float64 product of the unrounded inputs.

Each row carries its time, its sustained TFLOP/s (FLOPs ``M N (2K - 1)``, as
``bench_matmul`` counts them), its bound (the larger of the operands and C
moved once over 3.35 TB/s and ``2 M N K`` over the data-sheet peak of its
operation: 67 TFLOP/s f32 FMA, 495 TF32, 989 bf16 tensor cores) and the
time of one PyTorch call computing the same function on the same inputs:
``torch.matmul`` in full f32 for f32, with TF32 allowed (inside a context
that restores the setting) for ``"default"``, and for ``"bf16in"``
``torch.mm(a16, b16, out_dtype=torch.float32)`` where the installed PyTorch
has that overload for the device, else ``torch.matmul`` of the bf16 operands (bf16 out),
named in the row.  The port never calls these yardsticks itself.

Timing on the card is device time: CUDA events around ``iters``
back-to-back launches after one warm-up call, the mean per launch.  On the
CPU (plain twins) the host clock times the calls; each row names its clock.

Run: ``python -m bm25_tpu_torch.bench.matmul_schedules [--sizes 1028 2048
4096] [--iters N] [--device cuda]``; it prints the JSON list of rows.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from bm25_tpu_torch.bench.matmul_bench import _seconds
from bm25_tpu_torch.ops import matmul_schedules as ms
from bm25_tpu_torch.runtime.session import full_f32_matmul

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
PRECISION = {"f32": "f32", "default": "tf32", "bf16in": "bf16"}
# E4's second limit.  The bound K 2^-22 (|A^| @ |B^|) grows as K^2, the
# distance of the unrounded inputs' product from the rounded ones' as
# K^0.5: from K ~ 1000 on, a kernel that skipped the TF32 rounding would
# pass the bound alone (standard-normal operands read 0.29 of it at 1028^3,
# 0.04 at 4096^3).  So E4 must also read at most this share of what the
# float64 product of the unrounded inputs reads: a sum of the rounded
# inputs in another order reads a few hundredths of that, a kernel with
# one operand left unrounded about 0.7.
UNROUNDED_SHARE = 0.25


def bound(m: int, k: int, n: int, precision: str) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time an H100 could take."""
    mem_ms = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * m * n * k / PEAK_OPS_PER_S[precision] * 1e3
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


@contextlib.contextmanager
def allow_tf32():
    """cuBLAS float32 products in TF32 inside the block; the caller's
    setting is restored on exit."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


def library_calls(a: torch.Tensor, b: torch.Tensor) -> dict:
    """{precision: (name, fn)}: one PyTorch call per precision."""
    def f32():
        with full_f32_matmul():
            return torch.matmul(a, b)

    def tf32():
        with allow_tf32():
            return torch.matmul(a, b)

    a16, b16 = a.bfloat16(), b.bfloat16()
    # aten::mm.dtype (bf16 in, f32 out) exists for CUDA tensors only
    if a.is_cuda and "dtype" in torch.ops.aten.mm.overloads():
        bf16 = ("torch.mm(bf16, out_dtype=float32)",
                lambda: torch.mm(a16, b16, out_dtype=torch.float32))
    else:
        bf16 = ("torch.matmul(bf16) (bf16 out: no aten::mm.dtype here)",
                lambda: torch.matmul(a16, b16))
    return {"f32": ("torch.matmul (full f32)", f32),
            "tf32": ("torch.matmul (TF32 allowed)", tf32), "bf16": bf16}


def variants(s: int, device: torch.device) -> list[tuple[dict, object]]:
    """(label, fn(a, b)) for every variant the scripts run at size s."""
    sms, smem = ms.sm_count(device), ms.smem_optin_bytes(device)
    out = []
    for t in ms.SWEEP_TILES:
        out.append(({"experiment": "E1", "variant": "sweep",
                     "tile": list(t)},
                    lambda a, b, t=t: ms.matmul_sweep(a, b, t)))
    if s <= 1600:
        for bk in (8, 16, 32):
            t = ms.resident_tile(s, s, bk, sms)
            out.append(({"experiment": "E1", "variant": "resident",
                         "tile": list(t)},
                        lambda a, b, t=t: ms.matmul_sweep(a, b, t)))
    fitting = [h for h in ms.STRIP_HEIGHTS
               if ms.row_strip_smem_bytes(s, h) <= smem]
    for h in fitting:
        out.append(({"experiment": "E2", "variant": "row_strip",
                     "strip_m": h},
                    lambda a, b, h=h: ms.matmul_row_strip(a, b, h)))
    if s <= 1600 and fitting:
        h = fitting[-1]
        out.append(({"experiment": "E2", "variant": "single_block",
                     "strip_m": h, "blocks": 1},
                    lambda a, b, h=h: ms.matmul_row_strip(a, b, h, blocks=1)))
    if s <= 2048 and s % 4 == 0:  # E3's 16-byte copies need K, N % 4 == 0
        for t in ms.PIPELINED_TILES:
            for st in ms.STAGES:
                out.append(({"experiment": "E3", "variant": "pipelined",
                             "tile": list(t), "stages": st},
                            lambda a, b, t=t, st=st: ms.matmul_pipelined(
                                a, b, t, st)))
    for mode in ms.MMA_MODES:
        out.append(({"experiment": "E4", "variant": "mma", "mode": mode},
                    lambda a, b, mode=mode: ms.matmul_mma(a, b, mode)))
    return out


def reading(got: torch.Tensor, want: torch.Tensor,
            bnd: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / bound), zero bounds read 0."""
    diff = (got.double() - want).abs()
    ratio = torch.where(bnd > 0, diff / bnd, torch.zeros_like(diff))
    return float(diff.max().item()), float(ratio.max().item())


def within(got: torch.Tensor, want: torch.Tensor, bnd: torch.Tensor,
           what: str) -> tuple[float, float]:
    """``reading``; raises past the bound."""
    diff = (got.double() - want).abs()
    if not bool((diff <= bnd).all()):
        raise RuntimeError(f"{what}: |diff| beyond the bound (max excess "
                           f"{(diff - bnd).max().item():.3e})")
    return reading(got, want, bnd)


def mma_readings(got: torch.Tensor, want: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, mode: str,
                 what: str) -> tuple[float, float, float]:
    """E4's check of ``got`` against ``want`` (its twin, or the float64
    product of the rounded inputs): within ``K 2^-22 (|A^| @ |B^|)``, and
    reading at most ``UNROUNDED_SHARE`` of what the float64 product of the
    unrounded inputs reads.  Returns (max |diff|, its largest share of the
    bound, the unrounded product's); raises past either limit."""
    rnd = ms.ROUNDING[mode]
    ar, br = rnd(a).double(), rnd(b).double()
    bnd = a.shape[1] * 2.0**-22 * (ar.abs() @ br.abs())
    err, ratio = within(got, want, bnd, what)
    unrounded = reading(a.double() @ b.double(), want, bnd)[1]
    if ratio > UNROUNDED_SHARE * unrounded:
        raise RuntimeError(
            f"{what}: reads {ratio:.3e} of K 2^-22 (|A^| @ |B^|), more than "
            f"{UNROUNDED_SHARE} of the unrounded inputs' {unrounded:.3e}: "
            f"are the inputs rounded to {PRECISION[mode]}?")
    return err, ratio, unrounded


def bench_schedules(sizes=(1028, 2048, 4096), iters: int | None = None,
                    device: torch.device | str = "cuda",
                    log=print) -> list[dict]:
    """Check and time every variant at each size on ``device``; ``iters``
    defaults to 20 launches on the card and 1 call elsewhere."""
    device = torch.device(device)
    if iters is None:
        iters = 20 if device.type == "cuda" else 1
    if iters < 1:
        raise ValueError(f"iters={iters} must be at least 1")
    cuda = device.type == "cuda"
    clock = "cuda_events" if cuda else "host"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    rows = []
    for s in sizes:
        rng = np.random.default_rng(0)
        a = torch.from_numpy(rng.standard_normal((s, s), dtype=np.float32))
        b = torch.from_numpy(rng.standard_normal((s, s), dtype=np.float32))
        a, b = a.to(device), b.to(device)
        k = s
        flops = s * s * (2 * k - 1)
        with full_f32_matmul():
            ref_f32 = torch.matmul(a, b)
        f32_bound = 2 * k * 2.0**-24 * (a.double().abs() @ b.double().abs())
        head = a[:128].double() @ b.double()
        rounded = {mode: rnd(a).double() @ rnd(b).double()
                   for mode, rnd in ms.ROUNDING.items()}
        lib = {}
        for prec, (name, fn) in library_calls(a, b).items():
            lib[prec] = (name, _seconds(fn, iters, device) * 1e3)
        for label, fn in variants(s, device):
            mode = label.get("mode", "f32")
            prec = PRECISION[mode]
            what = f"{s}^3 {label}"
            got = fn(a, b)
            if mode == "f32":
                err, ratio = within(got, ref_f32, f32_bound, what)
                unrounded = None
            else:
                err, ratio, unrounded = mma_readings(got, rounded[mode], a, b,
                                                     mode, what)
            rel = float(((got[:128].double() - head).abs()
                         / (head.abs() + 1e-6)).max().item())
            sec = _seconds(lambda: fn(a, b), iters, device)
            bnd = bound(s, k, s, prec)
            row = {"size": s, **label, "ms": sec * 1e3,
                   "tflops": flops / sec / 1e12, "bound_ms": bnd[0],
                   "bound_by": bnd[1], "library": lib[prec][0],
                   "library_ms": lib[prec][1], "max_abs_err": err,
                   "err_over_bound": ratio,
                   "unrounded_over_bound": unrounded, "max_rel_err": rel,
                   "clock": clock, "device": kind}
            rows.append(row)
            log(f"[schedules] {what}: {row['ms']:.4f} ms "
                f"({row['tflops']:.2f} TFLOP/s; bound {bnd[0]:.4f} ms, "
                f"{lib[prec][0]} {lib[prec][1]:.4f} ms), max |err| {err:.3e}"
                f" ({ratio:.3g} of its bound"
                + (f"; unrounded inputs {unrounded:.3g}" if unrounded else "")
                + f"), max_rel_err {rel:.2e}")
        del a, b, ref_f32, f32_bound, head, rounded
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[1028, 2048, 4096])
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = bench_schedules(args.sizes, iters=args.iters, device=args.device,
                           log=lambda *a: print(*a, file=sys.stderr))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
