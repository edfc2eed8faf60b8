"""Run one cell of the benchmark of ``bm25_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number the check compared beside its limit, which
also end standard error.  The program's builds go to ``benchmark/.cache/``
inside the checkout.  Without the checkout's ``bm25_tpu_torch``, with no
CUDA device or too few of them, or with JAX loaded in the process once the
window has closed, it prints no result and exits with a code other than
0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# top-level module names that may not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "bm25_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program in fixed directories
    inside the checkout, so that only a cell's first run there builds."""
    for var, sub in (("BM25_TPU_TORCH_BUILD_DIR", "build"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    try:  # the program of this checkout, never one installed elsewhere
        import bm25_tpu_torch
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 3
    where = os.path.realpath(bm25_tpu_torch.__file__)
    if not where.startswith(os.path.realpath(ROOT) + os.sep):
        print(f"bm25_tpu_torch comes from {where}, outside the checkout "
              f"{ROOT}", file=sys.stderr)
        return 3

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the process: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
