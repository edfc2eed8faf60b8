"""The control of the check: the reference computed in bfloat16, the
precision below the float32 that the configurations state, put in the
program's place and judged as a run judges the program.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's corpus and queries at the cell's size,
answers ``check_rows`` queries drawn from the seed (the longest among them)
with the bfloat16 reference, judges those answers against the float32
reference, and prints one JSON line: the numbers, the cell's limits and
whether the check would call the answers correct.  It must call them
wrong.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from benchmark import check, gen, harness  # noqa: E402
from benchmark.reference import Bm25Reference  # noqa: E402


def control_numbers(cell: dict, seed: int, device) -> dict:
    """The check's numbers for the bfloat16 reference's answers at
    ``seed``."""
    config, traffic = cell["config"], cell["traffic"]
    doc_lengths, flat, queries = gen.make_inputs(config, seed, device)
    lengths = gen.query_lengths(queries)
    longest = int(np.argmax(lengths))
    rng = np.random.default_rng([seed % (1 << 63), 1 << 31])
    n = min(int(traffic["check_rows"]), len(queries))
    rows = [longest] + [int(r) for r in rng.choice(len(queries), n,
                                                    replace=False)
                        if r != longest][: n - 1]
    p = config["bm25"]
    ref = Bm25Reference(doc_lengths, flat, config["vocab_size"], k1=p["k1"],
                        b=p["b"], device=device)
    low = Bm25Reference(doc_lengths, flat, config["vocab_size"], k1=p["k1"],
                        b=p["b"], device=device, dtype=torch.bfloat16)
    k = int(traffic["top_k"])
    answers = []
    for r in rows:
        docs, scores = low.top_k(queries[r], k)
        answers.append((queries[r], docs, scores))
    numbers = check.judge(answers, ref, k)
    numbers["unanswered"] = 0
    correct, checks = check.verdict(numbers, cell["limits"], len(answers))
    return {"workload": cell["name"], "seed": seed, "checked": len(answers),
            "postings": int(ref.post_doc.numel()),
            "correct": correct,
            "numbers": {name: c["value"] for name, c in checks.items()},
            "limits": {name: c["limit"] for name, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device; found none",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_numbers(cell, seed, torch.device("cuda", 0))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
