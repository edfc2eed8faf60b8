"""The comparison that decides ``correct``.

The program's answers (doc ids and float32 scores, top k a query) are held
against the plain reference (``reference.py``) on a sample of the window's
answers.  BM25 has ties, so the comparison asks two things that hold
whatever order tied docs come in:

* ``score_gap``: the widest gap between a returned score and the
  reference's score of that same doc, over the top score of the query;
* ``rank_gap``: the most by which the r-th returned score lies below the
  reference's r-th best, over the top score of the query (a better doc
  left out shows here).  Where the program returns the docs alone, the
  returned scores are the reference's scores of those docs, and
  ``score_gap`` has nothing to compare;

and counts what may never happen:

* ``bad_rows``: answers with a doc id outside the corpus, a doc twice,
  fewer than min(k, docs) entries, or scores that rise along the list;
* ``unanswered``: queries of calls that raised, whose answers never came;
* ``none_checked``: 1 where the window left no answer to check.

Each number has its limit in ``limits/<cell>.json``; ``PERF.md`` gives the
readings each limit was set from.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("score_gap", "rank_gap", "bad_rows", "unanswered", "none_checked")


def judge_row(docs: np.ndarray, scores: np.ndarray, best: np.ndarray,
              of_docs: np.ndarray, num_docs: int) -> dict:
    """The numbers of one answer: ``docs``/``scores`` the program's
    (``scores`` None where it returns the docs alone), ``best`` the
    reference's k best scores (descending) and ``of_docs`` the reference's
    scores of ``docs``."""
    docs = np.asarray(docs, np.int64)
    best = np.asarray(best, np.float64)
    of_docs = np.asarray(of_docs, np.float64)
    ids_only = scores is None
    scores = np.sort(of_docs)[::-1] if ids_only \
        else np.asarray(scores, np.float64)
    bad = (docs.shape != best.shape or docs.size != scores.size
           or bool(np.any((docs < 0) | (docs >= num_docs)))
           or len(np.unique(docs)) != docs.size
           or (not ids_only and bool(np.any(np.diff(scores) > 0)))
           or not bool(np.all(np.isfinite(scores))))
    scale = best[0] if best.size and best[0] > 0 else 1.0
    n = min(best.size, scores.size)
    gap = np.zeros(n) if ids_only else np.abs(scores[:n] - of_docs[:n])
    score_gap = float(np.max(gap, initial=0.0)) / scale
    if not np.all(np.isfinite(gap)):
        score_gap = math.inf
    rank_gap = max(float(np.max(best[:n] - scores[:n], initial=0.0)),
                   0.0) / scale
    return {"score_gap": float(score_gap), "rank_gap": float(rank_gap),
            "bad_rows": int(bad)}


def judge(answers: list, reference, k: int) -> dict:
    """The numbers over every sampled answer: ``answers`` is a list of
    ``(query, docs, scores)`` and ``reference`` a ``Bm25Reference``."""
    out = {"score_gap": 0.0, "rank_gap": 0.0, "bad_rows": 0}
    for query, docs, scores in answers:
        best, of = reference.judge(query, docs, k)
        row = judge_row(docs, scores, best, of, reference.num_docs)
        out["score_gap"] = max(out["score_gap"], row["score_gap"])
        out["rank_gap"] = max(out["rank_gap"], row["rank_gap"])
        out["bad_rows"] += row["bad_rows"]
    return out


def verdict(numbers: dict, limits: dict, checked: int) -> tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit; correct when
    every number is finite and within its limit.  ``checked`` is the
    number of answers judged."""
    numbers = {**numbers, "none_checked": int(checked == 0)}
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
