"""The port's runtime hooks (runtime/health.py, runtime/profiling.py and the
first-use phase hooks of ops/_build.py) on the CPU, beside the JAX
package's probes."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from bm25_tpu.runtime import health as jax_health
from bm25_tpu.runtime import profiling as jax_profiling
from bm25_tpu_torch import DenseEngine, Session, SparseEngine
from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.runtime import health, profiling
from bm25_tpu_torch.scoring import build_scored_index

CPU = Session("cpu")


def _index():
    rng = np.random.default_rng(0)
    ids = [rng.integers(0, 30, size=5).astype(np.int32) for _ in range(20)]
    return build_scored_index(ids, vocab_size=30)


def test_device_probe_on_an_explicit_cpu_device():
    for device in ("cpu", torch.device("cpu")):
        pr = health.device_probe(device)
        assert pr.ok and pr.detail == "" and pr.latency_ms >= 0
    assert health.device_probe("cpu").as_dict().keys() == \
        jax_health.device_probe().as_dict().keys()


def test_device_probe_never_probes_the_cpu_in_place_of_the_card():
    """With no device the probe takes the default session (``cuda``):
    off the card it reports the failure in its result, never raises and
    never reads the CPU's answer as the card's."""
    pr = health.device_probe()
    if torch.cuda.is_available():
        assert pr.ok
    else:
        assert not pr.ok and "CUDA" in pr.detail
    bad = health.device_probe("meta")
    assert not bad.ok and bad.detail


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_engine_probe_on_port_engines(mode):
    idx = _index()
    cls = DenseEngine if mode == "dense" else SparseEngine
    eng = cls.from_scored_index(idx, session=CPU)
    pr = health.engine_probe(eng)
    assert pr.ok and pr.as_dict()["detail"] == ""


def test_engine_probe_reports_failures():
    class Broken:
        num_docs = 5

        def search(self, q, top_k):
            raise RuntimeError("device wedged")

    class Unsorted:
        num_docs = 5

        def search(self, q, top_k):
            return (np.array([[0, 1, 2]], np.int32),
                    np.array([[1.0, 2.0, 0.5]], np.float32))

    pr = health.engine_probe(Broken())
    assert not pr.ok and "device wedged" in pr.detail
    want = jax_health.engine_probe(Broken()).as_dict()
    assert {k: v for k, v in pr.as_dict().items() if k != "latency_ms"} == \
        {k: v for k, v in want.items() if k != "latency_ms"}
    pr = health.engine_probe(Unsorted())
    assert not pr.ok and pr.detail == "invariant violation"


def test_compile_phase_collector_keys_and_zero_without_builds():
    with profiling.compile_phase_collector() as phases:
        DenseEngine.from_scored_index(_index(), session=CPU).search(
            np.zeros((1, 8), np.int32), top_k=3)
    assert phases == {"nvcc_build_s": 0.0, "native_build_s": 0.0,
                      "library_load_s": 0.0}


def test_compile_phase_collector_charges_first_use(monkeypatch, tmp_path):
    """A build and a load inside the block are charged, in any thread;
    after the block nothing accumulates, and outside any collector the
    hooks time nothing."""
    built = tmp_path / "libfake.so"
    calls = []
    monkeypatch.setattr(_build, "build", lambda name: (calls.append(name),
                                                       str(built))[1])
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_libs", {})
    with profiling.compile_phase_collector() as phases:
        with _build._charged("nvcc_build_s"):
            pass
        t = threading.Thread(target=_build.load, args=("fake",))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert calls == ["fake"] and phases["library_load_s"] > 0
    assert phases["nvcc_build_s"] > 0
    snapshot = dict(phases)
    monkeypatch.setattr(_build, "_libs", {})
    _build.load("fake")
    with _build._charged("nvcc_build_s"):
        pass
    assert phases == snapshot and not _build._sinks


def test_load_builds_once_for_racing_threads(monkeypatch, tmp_path):
    """Two threads asking for one library first share one build."""
    gate = threading.Event()
    calls = []

    def slow_build(name):
        calls.append(name)
        gate.wait(timeout=5)
        return str(tmp_path / "lib.so")

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_libs", {})
    out = []
    ts = [threading.Thread(target=lambda: out.append(_build.load("x")))
          for _ in range(4)]
    for t in ts:
        t.start()
    gate.set()
    for t in ts:
        t.join(timeout=10)
        assert not t.is_alive()
    assert calls == ["x"] and len(out) == 4 and len({id(o) for o in out}) == 1


def test_spans_inside_capture_trace_write_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    eng = DenseEngine.from_scored_index(_index(), session=CPU)
    with profiling.capture_trace(log_dir) as d:
        with profiling.host_span("bm25_query_batch"):
            with profiling.op_span("bm25_score"):
                eng.search(np.zeros((2, 3), np.int32), top_k=2)
    assert d == log_dir
    with open(os.path.join(log_dir, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"bm25_query_batch", "bm25_score"} <= names


def test_spans_compose_outside_a_trace():
    with profiling.host_span("a"), profiling.op_span("b"):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0


def test_step_timer_percentiles():
    t = profiling.StepTimer()
    assert np.isnan(t.percentile(50)) and np.isnan(t.summary()["mean_ms"])
    for _ in range(10):
        with t.measure():
            pass
    s = t.summary()
    assert s["count"] == 10 and s["p50_ms"] >= 0
    assert s["p99_ms"] >= s["p50_ms"]
    ref = jax_profiling.StepTimer()
    t.samples_s = ref.samples_s = [0.001 * i for i in range(100, 0, -1)]
    for p in (0, 50, 90, 99, 100):
        assert t.percentile(p) == ref.percentile(p)
    assert t.summary() == ref.summary()
