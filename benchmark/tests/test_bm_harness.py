"""Whole runs on the CPU at tiny sizes: the harness's path past its look for
a chip, correct on the program as it is, and not correct with the timed
path broken underneath."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from conftest import SEED, tiny_cell

CELLS = ["msmarco-k1000-b512", "quora-k100-b512"]
# mixes that no cell runs yet, each a data file or a data file's options:
# calls of 32 queries to ``search``, and ids alone from ``search_pipelined``
MIXES = {
    "online": {"traffic": "online-k100-b32"},
    "ids_only": {"kwargs": {"batch": 512, "ids_only": True}},
}
ALL = CELLS + list(MIXES)


def make_cell(name):
    """A cell of BENCHMARK.json, or one of ``MIXES`` on the Quora
    configuration, at tiny sizes."""
    if name in CELLS:
        return tiny_cell(name)
    mix = MIXES[name]
    traffic = mix.get("traffic")
    cell = tiny_cell("quora-k100-b512")
    if traffic:
        cell["traffic"] = harness.load_json(harness.os.path.join(
            harness.HERE, "traffic", traffic + ".json"))
        cell["traffic"].update({"check_rows": 48, "trace_calls": 2})
    cell["traffic"].update({k: v for k, v in mix.items() if k != "traffic"})
    return cell


def run(name, session, trace=False, seconds=0.3, queries=None):
    cell = make_cell(name)
    if queries:
        cell["config"]["num_queries"] = queries
    return harness.run_cell(cell, SEED, seconds, trace, torch.device("cpu"),
                            0.0, session=session)


@pytest.mark.parametrize("name", ALL)
def test_a_run_is_correct_and_reports_its_metrics(name, sparse_on_cpu):
    res = run(name, sparse_on_cpu)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = make_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    qps = [v["value"] for n, v in res["metrics"].items()
           if n.startswith("qps.")]
    assert all(v > 0 for v in qps)
    # a cell without qps end to end reads it per layer in its traced run
    assert qps or any(m["name"].startswith("window_qps.")
                      for m in cell["per_layer"])
    assert list(res)[-1] == "checks"
    json.dumps(res)


@pytest.mark.parametrize("name", ["quora-k100-b512", "online"])
def test_a_traced_run_reports_per_layer_metrics(name, sparse_on_cpu):
    res = run(name, sparse_on_cpu, trace=True)
    assert res["correct"] is True, res["checks"]
    # no device on the CPU: the kernels', the steps' and the device's
    # metrics are absent (a reader that finds nothing returns nothing)
    assert set(res["metrics"]) == {"index_build_s", "engine_build_s",
                                   "plan_ms.quora", "window_qps.quora"}
    assert res["metrics"]["window_qps.quora"]["value"] > 0
    assert "window_s" in res["device"] and "breakdown" in res


def test_a_traced_run_without_a_window_reader_makes_no_window(
        sparse_on_cpu):
    cell = make_cell("msmarco-k1000-b512")
    assert not harness.needs_window(cell)
    assert harness.needs_window(make_cell("quora-k100-b512"))
    res = harness.run_cell(cell, SEED, 60.0, True, torch.device("cpu"), 0.0,
                           session=sparse_on_cpu)
    assert res["correct"] is True, res["checks"]
    # the traced calls alone, each over the whole query set: the two
    # profiled windows' (their warm-up calls are not counted)
    n = cell["traffic"]["trace_calls"]
    calls = n + max(n // 4, 1)
    assert res["attempted"] == calls * cell["config"]["num_queries"]


def _break_step(monkeypatch, fault):
    """Wrap the engine's query step (the timed path's device step) with
    ``fault``, which gets and returns ``(scores, docs)`` (scores None where
    the step returns the docs alone)."""
    from bm25_tpu_torch.models.sparse import SparseEngine

    orig = SparseEngine.query_step

    def query_step(self, k, ids_only=False):
        step = orig(self, k, ids_only)

        def broken(*a, **kw):
            if ids_only:
                return fault(self, None, step(*a, **kw))[1]
            scores, docs = step(*a, **kw)
            return fault(self, scores, docs)
        return broken

    monkeypatch.setattr(SparseEngine, "query_step", query_step)


def altered(engine, scores, docs):
    """Each query's best answer replaced by the next doc."""
    docs = docs.clone()
    docs[:, 0] = (docs[:, 0] + 1) % engine.num_docs
    return scores, docs


def half_left_out(engine, scores, docs):
    """The second half of the chunk's rows not scored: they come back with
    the first half's answers."""
    h = (len(docs) + 1) // 2
    docs = docs.clone()
    docs[h:] = docs[: len(docs) - h]
    if scores is not None:
        scores = scores.clone()
        scores[h:] = scores[: len(docs) - h]
    return scores, docs


class Unchanged:
    """The step hands back the answers it returned first, whatever it is
    asked after (row i of a chunk gets row i of that first chunk)."""

    def __init__(self):
        self.first = None

    def __call__(self, engine, scores, docs):
        if self.first is None:
            self.first = (None if scores is None else scores.clone(),
                          docs.clone())
        rows = torch.arange(len(docs)) % len(self.first[1])
        first_scores = None if scores is None else self.first[0][rows]
        return first_scores, self.first[1][rows]


@pytest.mark.parametrize("fault", [altered, half_left_out, Unchanged],
                         ids=["altered", "half_left_out", "unchanged"])
@pytest.mark.parametrize("name", ALL)
def test_a_broken_step_is_not_correct(name, fault, sparse_on_cpu,
                                      monkeypatch):
    _break_step(monkeypatch, fault() if fault is Unchanged else fault)
    # two batches of the eval; some online calls past the first
    res = run(name, sparse_on_cpu, queries=600, seconds=2.0)
    assert res["correct"] is False
    c = res["checks"]
    assert c["score_gap"]["value"] > c["score_gap"]["limit"] or \
        c["rank_gap"]["value"] > c["rank_gap"]["limit"] or \
        c["bad_rows"]["value"] > 0


@pytest.mark.parametrize("name", ALL)
def test_answers_left_out_are_not_correct(name, sparse_on_cpu, monkeypatch):
    from bm25_tpu_torch.models.sparse import SparseEngine

    for method in ("search", "search_pipelined"):
        orig = getattr(SparseEngine, method)

        def short(self, *a, _orig=orig, **kw):
            out = _orig(self, *a, **kw)
            if not isinstance(out, tuple):  # ids alone
                return out[: len(out) // 2]
            docs, scores = out
            return docs[: len(docs) // 2], scores[: len(docs) // 2]
        monkeypatch.setattr(SparseEngine, method, short)
    res = run(name, sparse_on_cpu)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] > 0
    assert res["checks"]["unanswered"]["value"] > 0


def test_a_raising_call_is_counted_and_not_correct(sparse_on_cpu,
                                                   monkeypatch):
    from bm25_tpu_torch.models.sparse import SparseEngine

    calls = {"n": 0}
    orig = SparseEngine.search_pipelined

    def flaky(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:  # the warm-up passes, the window's call fails
            raise RuntimeError("device lost")
        return orig(self, *a, **kw)
    monkeypatch.setattr(SparseEngine, "search_pipelined", flaky)
    res = run("quora-k100-b512", sparse_on_cpu)
    assert res["correct"] is False and res["failed"] > 0


def test_keeper_samples_from_the_seed_and_keeps_the_longest():
    class FakeCalls:
        def rows(self, i):
            return np.arange(10)
    traffic = {"check_per_call": 3}
    picks = []
    for _ in range(2):
        keep = harness.Keeper(FakeCalls(), traffic, SEED, longest=7)
        for i in range(4):
            keep(i, np.arange(10)[:, None], np.zeros((10, 1)))
        picks.append([q for q, _, _ in keep.sample(5)])
    assert picks[0] == picks[1] and picks[0][0] == 7 and len(picks[0]) == 5
