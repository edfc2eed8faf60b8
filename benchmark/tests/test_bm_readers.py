"""Each per-layer reader on a canned traced record."""

import pytest

from benchmark import harness, trace

RECORD = {
    "spans_s": {"index_build": 12.5, "engine_build": 80.25},
    "plan_ms": [1.0, 2.0, 3.0],
    "least_bytes": 3.35e10,
    "peak_bytes_per_s": 3.35e12,
    "traced_calls": 2,
    "traced_batches": 4,
    "with_scores": True,
    "window_s": 4.0,
    "busy_s": 3.0,
    "kernel_busy_s": 2.0,
    "window": {"queries": 1000, "elapsed_s": 2.0},
    "kernels": [["ell_scan_kernel", 1.5, 40], ["ell_table_kernel", 0.1, 4],
                ["at::native::radixSortKVInPlace", 0.2, 80],
                ["at::native::reduce_kernel", 0.1, 20],
                ["Memcpy DtoH (Device -> Pinned)", 0.01, 8]],
}
GROUPS = ["msmarco", "quora"]
CASES = [("index_build_s", 12.5), ("engine_build_s", 80.25)]
for g in GROUPS:
    CASES += [
        (f"plan_ms.{g}", 2.0),
        (f"step_ms.{g}", 500.0),
        (f"step_roofline.{g}", 0.5),
        (f"scan_ms.{g}", 800.0),
        (f"device_idle_pct.{g}", 25.0),
    ]
CASES += [("window_qps.quora", 500.0)]
NAMES = [name for name, _ in CASES]


@pytest.mark.parametrize("name, want", CASES)
def test_reader(name, want):
    assert harness.read_metric(name, RECORD) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_reader_finds_nothing_in_an_empty_record(name):
    assert harness.read_metric(name, {}) is None


def test_no_device_time_gives_no_share():
    rec = {**RECORD, "busy_s": 0.0, "kernel_busy_s": 0.0, "kernels": []}
    for name in ("device_idle_pct.msmarco", "scan_ms.quora",
                 "step_ms.quora", "step_roofline.msmarco"):
        assert harness.read_metric(name, rec) is None


def test_every_per_layer_metric_has_a_reader():
    spec = harness.load_json(harness.os.path.join(harness.ROOT,
                                                  "BENCHMARK.json"))
    assert sorted(m["name"] for m in spec["per_layer"]) == sorted(NAMES)


def test_a_metric_split_by_group_reads_its_quantity():
    assert harness.reader_path("scan_ms.quora").endswith("metrics/scan_ms.py")
    assert harness.reader_path("setup_s").endswith("metrics/setup_s.py")


def test_busy_times_count_overlaps_once_and_copies_apart():
    dev = [(0.0, 10.0, "ell_scan_kernel"), (5.0, 20.0, "reduce_kernel"),
           (30.0, 40.0, "Memcpy HtoD (Pinned -> Device)"),
           (35.0, 45.0, "Memset (Device)")]
    assert trace.union_s(dev) == pytest.approx(35e-6)
    assert trace.union_s([d for d in dev if not trace.is_copy(d[2])]) \
        == pytest.approx(20e-6)
