"""Multi-process end-to-end worker.

``python -m bm25_tpu_torch.parallel._multihost_main <pid> <nproc> <port>
[shards_per_proc] [--device cpu]`` joins a ``torch.distributed`` group
over localhost (gloo where the ranks share a card or run on the CPU, NCCL
where each has a card of its own), builds both doc-sharded engines over a
mesh whose doc axis spans every process (each rank holding only its own
``shards_per_proc`` shards, default 2, on its device: the card unless
``--device`` says otherwise), runs one query batch through each, and on
process 0 checks the results against the host oracle, printing
``MULTIHOST_OK`` on success.

Every process holds the full host index (as each host would after a
shared-filesystem load) and uploads only its shards; the top-k merge
gathers every rank's candidates across the process boundary.  Used by
``tests/test_torch_multihost.py`` (2 processes x 2 CPU shards) and by
``chip_smoke.py`` (2 processes sharing the card).
"""

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("shards_per_proc", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from bm25_tpu_torch.parallel import distributed as pd

    device = torch.device(args.device)
    backend = (pd.default_backend(args.nproc) if device.type == "cuda"
               else "gloo")
    pd.initialize(coordinator_address=f"127.0.0.1:{args.port}",
                  num_processes=args.nproc, process_id=args.pid,
                  backend=backend)
    try:
        return _run(args, device, backend)
    finally:
        dist.destroy_process_group()


def _run(args, device: torch.device, backend: str) -> int:
    from bm25_tpu_torch.parallel.distributed import (local_devices,
                                                     process_info)
    from bm25_tpu_torch.parallel.mesh import DOC_AXIS, make_mesh
    from bm25_tpu_torch.parallel.sharded_engine import (ShardedEngine,
                                                        ShardedSparseEngine)
    from bm25_tpu_torch.scoring import build_scored_index
    from bm25_tpu_torch.text.tokenizer import Tokenizer

    pid = args.pid
    idx_p, n_p = process_info()
    if device.type == "cuda":
        device = local_devices()[0]  # the rank's own card, or the shared one
        torch.cuda.set_device(device)
    mesh = make_mesh(devices=[device] * args.shards_per_proc)
    n_global = mesh.shape[DOC_AXIS]
    print(f"[p{pid}] process {idx_p}/{n_p}, {n_global} global shards "
          f"({backend}, {device})", flush=True)
    if n_global != args.nproc * args.shards_per_proc:
        print(f"[p{pid}] GROUP FAILED: expected "
              f"{args.nproc * args.shards_per_proc} global shards",
              flush=True)
        return 2

    # deterministic synthetic corpus: every process builds the same index
    rng = np.random.default_rng(3)
    lengths = np.maximum(1, rng.poisson(25, 3000))
    ranks = np.arange(1, 501)
    p = (1.0 / ranks) / np.sum(1.0 / ranks)
    corpus = [" ".join(f"w{t:04d}" for t in rng.choice(500, size=L, p=p))
              for L in lengths]
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))

    q = np.array([[0, 3, 7, -1], [5, 5, -1, -1]], dtype=np.int32)
    results = {}
    for cls in (ShardedSparseEngine, ShardedEngine):
        eng = cls.from_scored_index(idx, mesh=mesh)
        results[cls.__name__] = eng.search(q, top_k=5)

    if pid != 0:
        return 0
    from bm25_tpu_torch.reference import ReferenceEngine

    od, osc = ReferenceEngine.from_scored_index(idx).search(q, top_k=5)
    ok = True
    for name, (docs, scores) in results.items():
        ok &= bool(np.allclose(scores, osc, rtol=1e-5))
        # doc sets may differ where scores tie at the k boundary
        for a, b, sa in zip(docs, od, osc):
            strict = sa > sa[-1] + 1e-7
            ok &= set(np.asarray(a)[strict].tolist()) == set(
                np.asarray(b)[strict].tolist())
        print(f"[p0] {name} docs={docs.tolist()}", flush=True)
    print("MULTIHOST_OK" if ok else "MULTIHOST_MISMATCH", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
