"""The program's spans read against a device trace (``spans.py``) on
synthetic event lists, and ``trace_program.py`` on the CPU at tiny
sizes."""

import pytest
import torch

from benchmark import spans, trace_program
from conftest import SEED, tiny_cell


def span(i, name, lo, hi, parent=None, counts=None, own=None):
    return {"id": i, "name": name, "parent": parent, "call": 1,
            "start_ns": lo, "end_ns": hi, "self_ns": hi - lo if own is None
            else own, "attrs": {}, "counts": counts or {}}


# a call with one batch: plan, a launch with its selection, the wait
SPANS = [
    span(1, "search.call", 0, 1000, own=400),
    span(2, "batch.dispatch", 100, 600, 1, own=150),
    span(3, "plan.dedup", 110, 150, 2, {"dedup.checked": 1}),
    span(7, "plan.chunks", 150, 200, 2, {"plan.cells_real": 24,
                                         "plan.cells_padded": 64}),
    span(4, "step.launch", 200, 500, 2, own=200),
    span(5, "step.select", 300, 400, 4),
    span(6, "batch.wait", 700, 900, 1),
]
# (start, end, name, correlation) on the card; launches by correlation
DEVICE = [(210, 700, "ell_scan_kernel", 11), (700, 760, "reduce_kernel", 12),
          (760, 800, "radixSortKVInPlace", 13),
          (800, 805, "Memcpy DtoH (Device -> Pinned)", 14),
          (805, 900, "orphan_kernel", 15)]
LAUNCHES = {11: 250, 12: 350, 13: 450, 14: 800}


def test_each_kernel_goes_to_the_span_open_at_its_launch():
    got = {(n, p): (s, c) for n, p, s, c in
           spans.attribute(DEVICE, LAUNCHES, SPANS)}
    base = "search.call > batch.dispatch > step.launch"
    assert got == {
        ("ell_scan_kernel", base): (490e-9, 1),
        ("reduce_kernel", base + " > step.select"): (60e-9, 1),
        ("radixSortKVInPlace", base): (40e-9, 1),
        ("Memcpy DtoH (Device -> Pinned)",
         "search.call > batch.wait"): (5e-9, 1),
    }  # the orphan has no recorded launch


def test_innermost_and_partition_follow_the_nesting():
    assert spans.innermost(SPANS, [50, 120, 250, 350, 650, 800, 2000]) == \
        [1, 3, 4, 5, 1, 6, None]
    pieces = spans.partition(SPANS)
    assert pieces[0] == (0, 100, 1) and pieces[-1] == (900, 1000, 1)
    assert sum(b - a for a, b, _ in pieces) == 1000


def test_idle_splits_inside_and_outside_the_calls():
    dev = [(100, 300, "a", 1), (250, 280, "b", 2), (500, 1500, "c", 3)]
    idle = spans.gaps(dev, 0, 2000)
    assert idle == [(0, 100), (300, 500), (1500, 2000)]
    calls = [span(1, "search.call", 50, 1600),
             span(2, "batch.wait", 400, 1550, 1)]
    out = spans.idle_split(idle, calls)
    assert out["idle_s"] == pytest.approx(800e-9)
    assert out["inside_s"] == pytest.approx((50 + 200 + 100) * 1e-9)
    assert out["inside_s"] + out["outside_s"] == pytest.approx(out["idle_s"])
    assert out["by_span"] == pytest.approx({"search.call": 200e-9,
                                            "batch.wait": 150e-9})


def test_the_layers_metrics_from_spans_and_kernels():
    kernels = spans.attribute(DEVICE, LAUNCHES, SPANS)
    idle = {"inside_s": 2e-6, "outside_s": 1e-6}
    build = [span(9, "build.ell", 0, 2 * 10**9), span(10, "build.ell", 0, 5)]
    got = spans.metrics(SPANS, kernels, idle, build)
    assert got == pytest.approx({
        "dedup_ms": 40e-6, "dedup_use_pct": 0.0, "chunk_plan_ms": 50e-6,
        "launch_ms": 300e-6, "fill_pct": 37.5,
        "select_ms": 60e-6, "idle_in_call_ms": 2e-3,
        "ell_build_s": 2 + 5e-9})
    assert spans.per_batch_ms(SPANS)["batch.dispatch"] == 150e-6
    assert spans.metrics([], [], None, []) == {}


@pytest.fixture
def quora(sparse_on_cpu):
    return tiny_cell("quora-k100-b512")


def test_trace_program_on_the_cpu_reads_the_host_layers(quora,
                                                       sparse_on_cpu):
    out = trace_program.trace_cell(quora, SEED, torch.device("cpu"),
                                   session=sparse_on_cpu)
    assert out["failed"] == 0
    # no card: no device metric, nothing attributed
    assert set(out["metrics"]) == {"dedup_ms", "dedup_use_pct",
                                   "chunk_plan_ms", "launch_ms", "fill_pct",
                                   "ell_build_s"}
    assert out["idle"] is None and out["kernels_by_span"] == []
    assert set(out["call_ms"]) == {"tracing_off", "tracing_on"}
    assert out["counts"]["dedup.checked"] > 0
    assert out["host_self_ms_a_batch"]["batch.dispatch"] > 0
    assert 0 < out["metrics"]["fill_pct"] <= 100
    assert out["build_self_s"]["build.engine"] > 0
