"""Retrieval evaluation + index memory accounting.

Covers the BASELINE.md parity metrics: recall@k vs the reference scorer,
MRR, and index memory (device layout vs the reference CSC footprint —
"index memory equal to reference CSC" target).  The port's copy of
``bm25_tpu/eval.py``; device footprints count torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bm25_tpu_torch.scoring import ScoredIndex


def recall_at_k(got_docs: np.ndarray, ref_docs: np.ndarray) -> float:
    """Fraction of reference top-k docs recovered (micro-averaged).

    The library-wide canonical parity metric (bench and eval both use it):
    -1 slots — the filtered-search shortfall pad on BOTH sides — are
    excluded so masked-search parity doesn't read ~0, and the denominator
    counts only the COMPARED rows so a got/ref row-count mismatch (zip
    truncates) can't silently deflate recall.
    """
    hits = 0
    want = 0
    for g, r in zip(got_docs, ref_docs):
        gs = {int(x) for x in g.tolist() if x >= 0}
        rs = {int(x) for x in r.tolist() if x >= 0}
        hits += len(gs & rs)
        want += len(rs)
    return hits / want if want else 1.0


def mrr_at_k(got_docs: np.ndarray, relevant: list[set]) -> float:
    """Mean reciprocal rank of the first relevant doc per query."""
    total = 0.0
    for g, rel in zip(got_docs, relevant):
        for rank, d in enumerate(g.tolist(), 1):
            if d in rel:
                total += 1.0 / rank
                break
    return total / max(len(relevant), 1)


def ndcg_at_k(got_docs: np.ndarray, rel_grades: list[dict], k: int = 10
              ) -> float:
    """nDCG@k with graded relevance, trec_eval's ``ndcg_cut`` convention
    (the BEIR headline metric): linear gains, 1/log2(rank+1) discount
    with the first rank discounted by log2(2)=1.  Queries with no graded
    positives are skipped (macro average over judged queries).

    ``rel_grades[qi]`` maps doc position -> relevance grade (> 0).
    """
    import math

    out = []
    for qi, grades in enumerate(rel_grades):
        if not grades:
            continue
        dcg = sum(
            grades.get(int(d), 0) / math.log2(r + 2)
            for r, d in enumerate(got_docs[qi][:k].tolist())
        )
        ideal = sorted(grades.values(), reverse=True)[:k]
        idcg = sum(g / math.log2(r + 2) for r, g in enumerate(ideal))
        out.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(out)) if out else float("nan")


def write_trec_run(path: str, query_ids: list[str], doc_ids: list[str],
                   docs: np.ndarray, scores: np.ndarray,
                   tag: str = "bm25-tpu") -> int:
    """Write results as a TREC run file (``qid Q0 docid rank score tag``)
    consumable by trec_eval / pytrec_eval / ir_measures.  -1 sentinel
    slots (filtered-search shortfall) are skipped.  Returns lines written.
    """
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for qi, qid in enumerate(query_ids):
            rank = 0
            for d, s in zip(docs[qi].tolist(), scores[qi].tolist()):
                if d < 0:
                    continue
                rank += 1
                f.write(f"{qid} Q0 {doc_ids[d]} {rank} {s:.6f} {tag}\n")
                n += 1
    return n


def compare_engines(engine, oracle, queries: np.ndarray, top_k: int) -> dict:
    """Run both engines on the same queries; report parity metrics."""
    gd, gs = engine.search(queries, top_k=top_k)
    rd, rs = oracle.search(queries, top_k=top_k)
    return {
        "recall_at_k": recall_at_k(gd, rd),
        "max_score_abs_err": float(np.max(np.abs(gs - rs))) if gs.size else 0.0,
        "top1_agreement": float(np.mean(gd[:, 0] == rd[:, 0])) if gd.size else 1.0,
    }


@dataclass
class MemoryStats:
    csc_bytes: int          # reference footprint: indptr+indices+data
    device_bytes: int       # engine layout as uploaded
    overhead_ratio: float   # device / csc

    def as_dict(self) -> dict:
        return {
            "csc_bytes": self.csc_bytes,
            "device_bytes": self.device_bytes,
            "overhead_ratio": round(self.overhead_ratio, 3),
        }


def index_memory_stats(index: ScoredIndex, engine) -> MemoryStats:
    """Device-layout footprint vs the reference CSC triplet."""
    csc = (
        index.indptr.nbytes + index.indices.nbytes + index.data.nbytes
    )
    dev = engine_device_bytes(engine)
    return MemoryStats(
        csc_bytes=csc, device_bytes=dev,
        overhead_ratio=dev / csc if csc else float("inf"),
    )


def engine_device_bytes(engine) -> int:
    """Resident device footprint of any engine: every array the query step
    reads.  Index-free so the serving layer can size a hot reload without
    holding the old host index (serve.Server._auto_reload_mode)."""
    def _nbytes(x) -> int:
        return x.numel() * x.element_size()

    dev = 0
    name = type(engine).__name__
    if name == "UpdatableEngine":
        # the device footprint is the wrapped base engine's (the delta
        # segment is host-side)
        return engine_device_bytes(engine.base)
    if name == "DenseEngine":
        dev = _nbytes(engine.st) + _nbytes(engine.offsets)
        # matmul mode lazily caches a bf16 high/residual pair of st —
        # together the same byte count AGAIN; uncounted it halves the
        # reported footprint
        pair = getattr(engine, "_st_pair", None)
        if pair is not None:
            dev += sum(_nbytes(p) for p in pair)
    elif name == "SparseEngine":
        for b in engine.buckets:
            # every device array the query step reads (hotLo is the bf16
            # residual pair of hotT — same size again)
            dev += sum(_nbytes(b[key]) for key in b)
        for extra in ("offsets", "hot_table"):
            dev += _nbytes(getattr(engine, extra))
        for tail_key in ("tail_docs", "tail_vals", "tail_toks", "tail_rows",
                         "tail_gpos"):
            arr = getattr(engine, tail_key, None)
            if arr is not None:
                dev += _nbytes(arr)
    elif name == "ShardedEngine":
        dev = _nbytes(engine.st) + _nbytes(engine.offsets)
    elif name == "ShardedSparseEngine":
        for b in engine.buckets:
            dev += sum(_nbytes(b[key]) for key in b)
        for extra in ("offsets", "hot_table"):
            dev += _nbytes(getattr(engine, extra))
    else:
        # an unknown engine must not silently report a zero footprint —
        # that reads as a 'perfect' result for the BASELINE memory row
        raise TypeError(
            f"engine_device_bytes: unsupported engine type {name}"
        )
    return dev
