"""Command-line entry of the multi-device dry run.

``python -m bm25_tpu_torch.parallel._dryrun_main [N] [--device cpu]`` runs
one full sharded query step of both engines on tiny shapes over a mesh
that names the device N times (default 8; the card unless ``--device``
says otherwise) and checks it against the host oracle.
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from bm25_tpu_torch.parallel.sharded_engine import dryrun_sharded_step

    dryrun_sharded_step(args.n, device=args.device)
    print(f"dryrun ok on {args.n} shards of {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
