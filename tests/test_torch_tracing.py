"""The port's tracer (``runtime/profiling.py``: ``span``, ``count``,
``tracing``, ``capture_trace``) and the spans and counters the sparse
engine's search and set-up record, on the CPU."""

import json
import os
import threading

import numpy as np
import pytest

from bm25_tpu_torch import Session, create_engine
from bm25_tpu_torch.bench import BenchConfig, make_synthetic_index
from bm25_tpu_torch.models.sparse import maybe_dedup
from bm25_tpu_torch.runtime import profiling

CPU = Session("cpu")
VOCAB = 400


@pytest.fixture(scope="module")
def index():
    return make_synthetic_index(BenchConfig(num_docs=3000, vocab=VOCAB,
                                            avg_len=12))


def engine(index, hot: int):
    """A CPU sparse engine: with a hot tier (``hot`` > 0) it routes by cold
    width, without one it does not."""
    return create_engine(index, mode="sparse", session=CPU, hot_tokens=hot,
                         hot_budget_bytes=1 << 24, max_buckets=2)


def queries(n: int, width: int, seed: int = 0, repeats: bool = False):
    """(n, width) ids with -1 pads; with ``repeats`` each row draws from a
    few ids, so that dedup shrinks it."""
    rng = np.random.default_rng(seed)
    hi = 6 if repeats else VOCAB
    q = rng.integers(0, hi, (n, width)).astype(np.int32)
    q[rng.random((n, width)) < 0.2] = -1
    return q


def by_id(records):
    return {r["id"]: r for r in records}


def test_off_by_default_span_is_the_shared_noop(index, monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read while tracing was off")

    monkeypatch.setattr(profiling, "_clock", no_clock)
    assert not profiling.enabled()
    first, second = profiling.span("a"), profiling.span("b", batch=3)
    assert first is second is profiling._NO_SPAN
    assert profiling.count("x", 5) is None
    eng = engine(index, hot=32)
    eng.search_pipelined(queries(300, 20, repeats=True), top_k=10,
                         batch=128)
    eng.search(queries(8, 4), top_k=10)


def test_tracing_blocks_do_not_nest():
    with profiling.tracing():
        with pytest.raises(RuntimeError, match="already on"):
            with profiling.tracing():
                pass
    assert not profiling.enabled()


@pytest.mark.parametrize("hot", [0, 32])
def test_spans_of_a_call_nest_and_share_its_id(index, hot):
    eng = engine(index, hot)
    with profiling.tracing() as trace:
        eng.search_pipelined(queries(300, 20), top_k=10, batch=128)
    recs = trace.records()
    ids = by_id(recs)
    (root,) = [r for r in recs if r["name"] == "search.call"]
    assert root["parent"] is None and root["call"] == root["id"]
    for r in recs:
        assert r["call"] == root["id"]
        if r["parent"] is not None:
            p = ids[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]
    parent = {r["name"]: ids[r["parent"]]["name"] for r in recs
              if r["parent"] is not None}
    assert parent["search.prepare"] == "search.call"
    assert parent["batch.dispatch"] == "search.call"
    assert parent["plan.dedup"] == parent["plan.chunks"] == "batch.dispatch"
    assert parent["step.launch"] == parent["fetch.enqueue"] \
        == "batch.dispatch"
    for name in ("step.offsets", "step.table", "step.scan", "step.select",
                 "step.merge"):
        assert parent[name] == "step.launch"
    assert parent["batch.wait"] == parent["batch.assemble"] == "search.call"
    assert parent["search.concat"] == "search.call"
    assert ("step.hot" in parent) == (hot > 0)
    assert ("plan.route_dp" in parent) == (hot > 0)
    assert parent.get("plan.route_dp", "plan.chunks") == "plan.chunks"
    # one scan and one selection a bucket, for each chunk
    n = {name: sum(r["name"] == name for r in recs)
         for name in ("step.launch", "step.scan", "step.select")}
    assert n["step.scan"] == n["step.select"] \
        == n["step.launch"] * len(eng.buckets)


@pytest.mark.parametrize("hot, repeats", [(0, True), (32, False),
                                          (32, True)])
def test_each_batch_counts_what_its_plan_decides(index, hot, repeats):
    eng = engine(index, hot)
    q = queries(300, 20, seed=1, repeats=repeats)
    batch, k = 128, 10
    with profiling.tracing() as trace:
        eng.search_pipelined(q, top_k=k, batch=batch)
    recs = trace.records()
    ids = by_id(recs)
    batches = sorted((r for r in recs if r["name"] == "batch.dispatch"),
                     key=lambda r: r["attrs"]["batch"])
    assert [r["attrs"]["batch"] for r in batches] == [0, 1, 2]  # ceil(Q/b)
    for b, r in zip(batches, range(0, len(q), batch)):
        rows = q[r : r + batch]
        qd, w = maybe_dedup(rows, None, eng.dedup_queries,
                            eng.dedup_min_width)
        perm, chunks = eng.plan_chunks(qd, w, k=k)
        kids = [ids[i] for i in ids if ids[i]["parent"] == b["id"]]
        named = {c["name"]: c for c in kids}
        dedup = named["plan.dedup"]["counts"]
        assert dedup["dedup.checked"] == 1
        assert dedup.get("dedup.applied", 0) == int(qd.shape != rows.shape)
        # a launch a chunk, and the routed DP where the rows were routed
        assert sum(c["name"] == "step.launch" for c in kids) == len(chunks)
        routed = [r for r in recs if r["name"] == "plan.route_dp"
                  and r["parent"] == named["plan.chunks"]["id"]]
        assert len(routed) == int(perm is not None)
        scanned = [c.padded if c.cold_padded is None else c.cold_padded
                   for c in chunks]
        assert named["plan.chunks"]["counts"] == {
            "plan.cells_real": sum(int((s >= 0).sum()) for s in scanned),
            "plan.cells_padded": sum(s.size for s in scanned),
        }
    assert trace.counts["dedup.checked"] == 3
    assert (trace.counts.get("dedup.applied", 0) > 0) == repeats


def test_answers_are_bit_equal_with_tracing_on_and_off(index):
    eng = engine(index, hot=32)
    q = queries(300, 20, seed=2, repeats=True)
    w = np.random.default_rng(3).uniform(0.5, 2.0, q.shape).astype(
        np.float32)
    mask = np.random.default_rng(4).random(index.num_docs) < 0.5

    def answers():
        return [eng.search_pipelined(q, top_k=10, batch=128),
                eng.search_pipelined(q, top_k=10, batch=128, weights=w,
                                     doc_mask=mask),
                eng.search(q[:40], top_k=10),
                (eng.search_ids(q[:40], top_k=10),)]

    off = answers()
    with profiling.tracing():
        on = answers()
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_spans_of_two_threads_never_nest_across_threads(index):
    eng = engine(index, hot=32)
    gate = threading.Barrier(2, timeout=30)
    errors = []

    def search(seed):
        try:
            gate.wait()
            eng.search_pipelined(queries(300, 20, seed=seed), top_k=10,
                                 batch=64)
        except Exception as e:  # reported below
            errors.append(e)

    with profiling.tracing() as trace:
        ts = [threading.Thread(target=search, args=(s,)) for s in (5, 6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in ts) and not errors
    recs = trace.records()
    ids = by_id(recs)
    roots = [r for r in recs if r["name"] == "search.call"]
    assert len(roots) == 2 and roots[0]["call"] != roots[1]["call"]
    assert roots[0]["thread"] != roots[1]["thread"]
    for r in recs:
        if r["parent"] is not None:
            assert ids[r["parent"]]["thread"] == r["thread"]
        assert ids[r["call"]]["thread"] == r["thread"]
    # the totals add every thread's: 5 batches of 64 rows a call, each
    # wide enough to be sorted
    assert trace.counts["dedup.checked"] == 10


def test_self_time_is_duration_less_the_childrens_cover(monkeypatch):
    ticks = iter([0, 10, 30, 40, 45, 100])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    with profiling.tracing() as trace:
        with profiling.span("outer"):
            with profiling.span("a"):
                pass
            with profiling.span("b"):
                pass
    own = {r["name"]: r["self_ns"] for r in trace.records()}
    assert own == {"outer": 100 - 20 - 5, "a": 20, "b": 5}


def test_self_times_of_a_search_add_up(index):
    eng = engine(index, hot=32)
    with profiling.tracing() as trace:
        eng.search_pipelined(queries(300, 20), top_k=10, batch=128)
    recs = trace.records()
    for r in recs:
        kids = [c for c in recs if c["parent"] == r["id"]]
        assert r["self_ns"] == r["end_ns"] - r["start_ns"] - sum(
            c["end_ns"] - c["start_ns"] for c in kids)
        assert r["self_ns"] >= 0


def test_counters_add_to_the_innermost_span_and_the_totals():
    with profiling.tracing() as trace:
        profiling.count("x", 4)  # outside every span: the totals alone
        with profiling.span("a"):
            profiling.count("x")
            with profiling.span("b"):
                profiling.count("x", 2)
                profiling.count("y", 3)
    counts = {r["name"]: r["counts"] for r in trace.records()}
    assert counts == {"a": {"x": 1}, "b": {"x": 2, "y": 3}}
    assert trace.counts == {"x": 7, "y": 3}


def test_set_up_spans(index):
    with profiling.tracing() as trace:
        engine(index, hot=32)
    recs = trace.records()
    ids = by_id(recs)
    (root,) = [r for r in recs if r["name"] == "build.engine"]
    assert root["parent"] is None
    kids = {r["name"] for r in recs if r["parent"] == root["id"]}
    assert {"build.hot_choice", "build.split", "build.ell",
            "build.hot_pair"} <= kids
    for r in recs:
        assert r["call"] == root["id"]
        assert r["parent"] is None or ids[r["parent"]]["name"] \
            .startswith("build.")


def test_capture_trace_writes_the_program_spans(index, tmp_path):
    eng = engine(index, hot=32)
    log_dir = str(tmp_path / "trace")
    with profiling.capture_trace(log_dir):
        eng.search(queries(40, 12), top_k=10)
    assert not profiling.enabled()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program"]
    names = {e["name"] for e in mine}
    assert {"search.call", "batch.dispatch", "plan.dedup", "plan.chunks",
            "step.launch", "step.scan", "batch.assemble"} <= names
    (call,) = [e for e in mine if e["name"] == "search.call"]
    assert call["args"]["id"] == call["args"]["call"]
    # on the profiler's clock: the torch ops the call ran lie inside it
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops
    for e in ops:
        assert call["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= call["ts"] + call["dur"]


def test_capture_trace_writes_its_file_when_the_block_raises(index,
                                                             tmp_path):
    eng = engine(index, hot=32)
    log_dir = str(tmp_path / "trace")
    with pytest.raises(ValueError, match="out of range"):
        with profiling.capture_trace(log_dir):
            eng.search(queries(40, 12), top_k=10)
            eng.search(np.full((2, 3), VOCAB + 5, np.int32), top_k=10)
    assert not profiling.enabled()
    with open(os.path.join(log_dir, "trace.json")) as f:
        mine = [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "program"]
    calls = [e for e in mine if e["name"] == "search.call"]
    assert len(calls) == 2  # the one that raised closed its span too
    assert {"batch.dispatch", "step.launch", "search.prepare"} <= {
        e["name"] for e in mine}


def test_capture_trace_inside_tracing_joins_the_open_trace(index, tmp_path):
    eng = engine(index, hot=0)
    log_dir = str(tmp_path / "trace")
    with profiling.tracing() as trace:
        eng.search(queries(8, 4), top_k=10)
        with profiling.capture_trace(log_dir):
            eng.search(queries(40, 12), top_k=10)
        assert profiling.enabled()
    assert not profiling.enabled()
    calls = [r for r in trace.records() if r["name"] == "search.call"]
    assert len(calls) == 2
    with open(os.path.join(log_dir, "trace.json")) as f:
        mine = [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "program" and e["name"] == "search.call"]
    # the file holds the spans that started inside its block
    assert [e["args"]["id"] for e in mine] == [calls[1]["id"]]


def test_a_record_function_inside_a_span_starts_with_it():
    """The tracer's clock is the profiler's: a ``record_function`` opened
    right inside a span starts a few µs after it and ends a few µs before
    it, on the epoch ns of ``kineto_results``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = 50
    with profiling.tracing() as trace, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(n):
            with profiling.span(f"s{i}"):
                with record_function(f"r{i}"):
                    pass
    ops = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = {r["name"]: r for r in trace.records()}
    after = [ops[f"r{i}"].start_ns() - spans[f"s{i}"]["start_ns"]
             for i in range(n)]
    before = [spans[f"s{i}"]["end_ns"] - ops[f"r{i}"].end_ns()
              for i in range(n)]
    # inside, and tightly: the clocks differ by at most the least gap
    assert min(after) >= 0 and min(before) >= 0
    assert max(min(after), min(before)) < 20_000
