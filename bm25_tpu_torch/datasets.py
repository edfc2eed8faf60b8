"""Dataset loaders for retrieval evaluation (BEIR layout) + synthetic corpora.

The port's copy of ``bm25_tpu/datasets.py``, function for function.
``evaluate_dataset`` builds the port's engine through its own
``create_engine`` on ``session`` (default: the process's CUDA session), and
takes an optional ``tokenizer`` (default ``Tokenizer()``, as in JAX; a
machine without ``nltk`` passes ``Tokenizer(stemmer=None)``).

BASELINE.md's configs name BEIR SciFact/FiQA/NFCorpus and MS MARCO; the
loaders download nothing: they read the standard BEIR on-disk layout from
a local directory:

    <root>/corpus.jsonl   {"_id": ..., "title": ..., "text": ...}
    <root>/queries.jsonl  {"_id": ..., "text": ...}
    <root>/qrels/<split>.tsv  query-id \\t corpus-id \\t score

``synthetic_corpus`` provides the Zipf generator for data-free runs at any
scale.
"""

from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class RetrievalDataset:
    doc_ids: list[str]
    doc_texts: list[str]
    query_ids: list[str]
    query_texts: list[str]
    # qrels[qid] = {doc_id: relevance}
    qrels: dict[str, dict[str, int]] = field(default_factory=dict)

    @property
    def num_docs(self) -> int:
        return len(self.doc_texts)


def load_beir(root: str | os.PathLike, split: str = "test") -> RetrievalDataset:
    """Load a BEIR-format dataset directory."""
    root = os.fspath(root)
    doc_ids, doc_texts = [], []
    with open(os.path.join(root, "corpus.jsonl")) as f:
        for line in f:
            obj = json.loads(line)
            doc_ids.append(str(obj["_id"]))
            title = obj.get("title") or ""
            text = obj.get("text") or ""
            doc_texts.append(f"{title} {text}".strip())
    query_ids, query_texts = [], []
    with open(os.path.join(root, "queries.jsonl")) as f:
        for line in f:
            obj = json.loads(line)
            query_ids.append(str(obj["_id"]))
            query_texts.append(obj.get("text") or "")
    qrels: dict[str, dict[str, int]] = {}
    qrels_path = os.path.join(root, "qrels", f"{split}.tsv")
    if os.path.exists(qrels_path):
        with open(qrels_path) as f:
            reader = csv.reader(f, delimiter="\t")
            header = next(reader, None)
            head0 = (header[0].lower().replace("_", "-")
                     if header else "")
            if head0 not in ("query-id", "qid", "queryid"):
                f.seek(0)
                reader = csv.reader(f, delimiter="\t")
            for row in reader:
                if len(row) >= 4:
                    # TREC qrels layout (MS MARCO ships this): qid,
                    # iteration, doc id, relevance — reading columns
                    # 1/2 as doc/score silently drops every judgment
                    qid, did, score = row[0], row[2], row[3]
                elif len(row) == 3:
                    qid, did, score = row
                else:
                    continue
                qrels.setdefault(str(qid), {})[str(did)] = int(float(score))
    return RetrievalDataset(doc_ids, doc_texts, query_ids, query_texts, qrels)


def evaluate_dataset(
    ds: RetrievalDataset,
    top_k: int = 100,
    engine_mode: str = "auto",
    max_queries: int | None = None,
    log=print,
    run_file: str | None = None,
    session=None,
    tokenizer=None,
) -> dict:
    """Index ds.docs, run its queries, report recall@k / MRR@10 / nDCG@10
    vs qrels.  ``run_file`` additionally writes a TREC-format run
    (consumable by trec_eval / pytrec_eval for any metric not built in).

    Follows the BEIR evaluation protocol: only queries with at least one
    positive qrel for the split are scored (real BEIR drops ship ONE
    queries.jsonl covering all splits — evaluating unjudged queries
    deflates MRR and makes ``max_queries`` prefixes meaningless), and
    recall@k is MACRO-averaged per query (per-query recall, then the
    mean), the convention published baselines use.
    """
    from bm25_tpu_torch.eval import mrr_at_k, ndcg_at_k, write_trec_run
    from bm25_tpu_torch.index.builder import build_index
    from bm25_tpu_torch.models.auto import create_engine
    from bm25_tpu_torch.runtime.session import get_session
    from bm25_tpu_torch.text.tokenizer import Tokenizer

    tok = tokenizer or Tokenizer()
    index, stats = build_index(ds.doc_texts, tokenizer=tok)
    log(f"[eval] indexed {stats.num_docs} docs ({stats.docs_per_second:.0f}/s)")
    engine = create_engine(index, mode=engine_mode,
                           session=session or get_session())

    pos_of = {did: i for i, did in enumerate(ds.doc_ids)}
    text_of = dict(zip(ds.query_ids, ds.query_texts))

    def rel_set(qid):
        return {
            pos_of[did]
            for did, r in ds.qrels.get(qid, {}).items()
            if r > 0 and did in pos_of
        }

    qids = [q for q in ds.query_ids if rel_set(q)]
    if not qids:
        # no qrels at all (or none resolvable): fall back to every query
        # so the pipeline still runs; metrics come out nan/0
        qids = list(ds.query_ids)
    if max_queries is not None:
        qids = qids[:max_queries]
    qtexts = [text_of[q] for q in qids]
    ids = tok.tokenize_queries(qtexts, index.vocab)
    docs, scores = engine.search(ids, top_k=top_k)

    relevant = [rel_set(qid) for qid in qids]
    per_q = [
        len(set(docs[qi].tolist()) & rel) / len(rel)
        for qi, rel in enumerate(relevant) if rel
    ]
    recall = float(np.mean(per_q)) if per_q else float("nan")
    mrr = mrr_at_k(docs[:, :10], relevant)
    rel_grades = [
        {
            pos_of[did]: r
            for did, r in ds.qrels.get(qid, {}).items()
            if r > 0 and did in pos_of
        }
        for qid in qids
    ]
    ndcg = ndcg_at_k(docs, rel_grades, k=10)
    result = {
        "num_docs": ds.num_docs,
        "num_queries": len(qids),
        "top_k": top_k,
        f"recall@{top_k}": round(recall, 4),
        "mrr@10": round(mrr, 4),
        "ndcg@10": round(ndcg, 4),
        "engine": type(engine).__name__,
    }
    if run_file:
        n = write_trec_run(run_file, qids, ds.doc_ids, docs, scores)
        log(f"[eval] wrote {n} run lines to {run_file}")
        result["run_file"] = run_file
    log(f"[eval] {result}")
    return result


def synthetic_corpus(num_docs: int, vocab: int = 32768, avg_len: int = 48,
                     seed: int = 0) -> list[str]:
    """Zipf word corpus as text (exercises the full tokenizer pipeline)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    cum = np.cumsum(probs)
    lengths = np.maximum(3, rng.poisson(avg_len, num_docs))
    flat = np.searchsorted(cum, rng.random(int(lengths.sum())))
    np.clip(flat, 0, vocab - 1, out=flat)
    words = np.array([f"w{i:06d}" for i in range(vocab)])
    docs, pos = [], 0
    for L in lengths:
        docs.append(" ".join(words[flat[pos : pos + L]]))
        pos += L
    return docs


def synthetic_beir_dataset(
    num_docs: int = 5000,
    num_queries: int = 50,
    vocab: int = 8192,
    avg_len: int = 32,
    query_terms: int = 4,
    seed: int = 0,
) -> RetrievalDataset:
    """Self-labelled BEIR-style dataset (no download needed).

    Each query samples ``query_terms`` of the rarest words from one target
    document; that document is the (single) relevant qrel.  Exercises the
    full tokenize -> index -> search -> qrels pipeline the real BEIR drops
    would use, with a known-good expected recall (BM25 ranks the source doc
    highly for its own rare terms).
    """
    rng = np.random.default_rng(seed)
    docs = synthetic_corpus(num_docs, vocab=vocab, avg_len=avg_len, seed=seed)
    doc_ids = [f"d{i}" for i in range(num_docs)]
    targets = rng.choice(num_docs, size=num_queries, replace=False)
    query_ids, query_texts, qrels = [], [], {}
    for qi, t in enumerate(targets):
        words = docs[t].split()
        # rarest words of the doc = highest word id in the Zipf generator
        rare = sorted(set(words), key=lambda w: -int(w[1:]))[:query_terms]
        qid = f"q{qi}"
        query_ids.append(qid)
        query_texts.append(" ".join(rare))
        qrels[qid] = {doc_ids[t]: 1}
    return RetrievalDataset(
        doc_ids=doc_ids,
        doc_texts=docs,
        query_ids=query_ids,
        query_texts=query_texts,
        qrels=qrels,
    )


def synthetic_beir_hard(
    num_docs: int = 5000,
    num_queries: int = 50,
    vocab: int = 8192,
    avg_len: int = 32,
    query_terms: int = 5,
    decoys_per_query: int = 12,
    seed: int = 0,
) -> RetrievalDataset:
    """Adversarial self-labelled dataset whose metrics actually move.

    The plain ``synthetic_beir_dataset`` saturated (recall@10 = MRR = 1.0,
    VERDICT r2 weak item 4) because each target doc uniquely owns its rare
    query terms.  This variant plants, per query:

    * **hard negatives** — ``decoys_per_query`` docs sharing 60-85% of the
      query's terms, with skewed lengths (short decoys enjoy BM25's length
      normalization and crowd the top ranks);
    * **term dropout** — the query keeps only a subset of the target's
      rare terms, so the target's advantage over decoys shrinks;
    * **typos** — one query term may be corrupted to an OOV token
      (contributes nothing, widening the decoy/target overlap).

    The target doc is graded 2; the first two decoys per query carry the
    FULL query term set and are graded 1 (genuinely relevant — they can
    legitimately outrank the target), so each query has exactly THREE
    positive qrels; the remaining decoys are unlabelled negatives.
    Metrics land strictly inside (0, 1) at the default shape, so a
    ranking regression above top-1 moves them — the regression signal
    the saturated eval lost.
    """
    rng = np.random.default_rng(seed)
    base = synthetic_corpus(num_docs, vocab=vocab, avg_len=avg_len, seed=seed)
    docs = list(base)
    doc_ids = [f"d{i}" for i in range(num_docs)]
    targets = rng.choice(num_docs, size=num_queries, replace=False)
    query_ids, query_texts, qrels = [], [], {}
    for qi, t in enumerate(targets):
        words = base[t].split()
        rare = sorted(set(words), key=lambda w: -int(w[1:]))[:query_terms]
        # term dropout: keep 3..query_terms of the rare terms (for
        # query_terms < 3 the integers() call would raise low >= high —
        # just keep them all; the permutation below tolerates keep >
        # len(rare) either way)
        keep = (int(rng.integers(3, query_terms + 1)) if query_terms >= 3
                else query_terms)
        q_words = list(rng.permutation(rare)[:keep])
        # typo: corrupt one term to OOV with p=0.3
        if rng.random() < 0.3 and len(q_words) > 3:
            q_words[int(rng.integers(len(q_words)))] = f"xxtypo{qi}"
        # hard negatives + extra relevants, with skewed lengths (short
        # docs enjoy BM25's length normalization and crowd the top ranks)
        qid = f"q{qi}"
        qrels[qid] = {f"d{t}": 2}
        for dj in range(decoys_per_query):
            # the first two decoys carry the FULL query term set — they
            # are genuinely relevant (graded 1) and can outrank the
            # target; the rest carry most of it and stay negatives
            full = dj < 2
            share = 1.0 if full else rng.uniform(0.6, 0.9)
            n_shared = max(2, int(round(share * len(q_words))))
            shared = list(rng.permutation(
                [w for w in q_words if not w.startswith("xxtypo")]
            )[:n_shared])
            fill_len = max(3, int(avg_len * rng.choice([0.3, 0.6, 1.0, 2.5])))
            filler = [
                f"w{int(i):06d}"
                for i in np.minimum(
                    rng.zipf(1.4, size=fill_len), vocab - 1
                )
            ]
            decoy = " ".join(list(rng.permutation(shared + filler)))
            did = f"d{num_docs + qi * decoys_per_query + dj}"
            doc_ids.append(did)
            docs.append(decoy)
            if full:
                qrels[qid][did] = 1
        query_ids.append(qid)
        query_texts.append(" ".join(q_words))
    return RetrievalDataset(
        doc_ids=doc_ids,
        doc_texts=docs,
        query_ids=query_ids,
        query_texts=query_texts,
        qrels=qrels,
    )
