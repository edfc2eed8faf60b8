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
        with profiling.span("bm25_query_batch"):
            with profiling.span("bm25_score"):
                eng.search(np.zeros((2, 3), np.int32), top_k=2)
    assert d == log_dir
    with open(os.path.join(log_dir, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"bm25_query_batch", "bm25_score"} <= names


def test_spans_compose_outside_a_trace():
    with profiling.span("a") as a, profiling.span("b") as b:
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    assert a is b  # the shared no-op: nothing is tracing


# -- JAX's session API: accelerator_count, get_device, Session.create /
# platform / compile, enable_persistent_compile_cache ----------------------


def test_accelerator_count_and_get_device_off_the_card():
    from bm25_tpu_torch.runtime import accelerator_count, get_device

    if torch.cuda.is_available():
        pytest.skip("checks the machine with no CUDA card")
    assert accelerator_count() == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device(prefer="gpu")
    assert get_device(prefer="cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="out of range"):
        get_device(1, prefer="cpu")
    with pytest.raises(ValueError, match="'tpu'"):
        get_device(prefer="tpu")


def test_session_create_and_platform_match_jax_names():
    from bm25_tpu.runtime.session import Session as JaxSession

    s = Session.create(prefer="cpu")
    assert s.device == torch.device("cpu") and s.platform == "cpu"
    assert s.platform == JaxSession.create(prefer="cpu").platform
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Session.create()


def test_session_compile_builds_once_for_racing_threads():
    s = Session("cpu")
    builds, start = [], threading.Barrier(8)

    def build():
        builds.append(1)
        return lambda x: x + 1

    got = []

    def worker():
        start.wait()
        got.append(s.compile(("step", 10), build))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 8
    assert all(f is got[0] for f in got) and got[0](1) == 2
    assert s.compile(("step", 100), build) is not got[0]
    assert len(builds) == 2


def test_enable_persistent_compile_cache_sets_the_build_dir(monkeypatch,
                                                            tmp_path):
    from bm25_tpu_torch.runtime import session as sess

    monkeypatch.setattr(sess, "_cache_configured", False)
    monkeypatch.setattr(_build, "_dir", None)
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    # no path, no variable: the package's default, and the call latches
    sess.enable_persistent_compile_cache()
    assert _build.build_dir() == _build.BUILD_DIR
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "env"))
    sess.enable_persistent_compile_cache()  # latched: no effect
    assert _build.build_dir() == str(tmp_path / "env")
    # an explicit path wins over the earlier call and the variable
    sess.enable_persistent_compile_cache(str(tmp_path / "a"))
    assert _build.build_dir() == str(tmp_path / "a")
    assert (tmp_path / "a").is_dir()
    assert os.path.dirname(_build.library_path("topk")) == str(tmp_path / "a")
    sess.enable_persistent_compile_cache()  # an implicit call defers
    assert _build.build_dir() == str(tmp_path / "a")
    sess.enable_persistent_compile_cache(str(tmp_path / "b"))
    assert _build.build_dir() == str(tmp_path / "b")
    # an empty string disables it: a temporary directory of this process
    sess.enable_persistent_compile_cache("")
    off = _build.build_dir()
    assert os.path.isdir(off) and off not in (
        _build.BUILD_DIR, str(tmp_path / "b"))
    # the variable set to "" disables it too, on the first implicit call
    monkeypatch.setattr(sess, "_cache_configured", False)
    monkeypatch.setattr(_build, "_dir", None)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, "")
    sess.enable_persistent_compile_cache()
    assert _build.build_dir() not in (_build.BUILD_DIR, off)
    monkeypatch.setattr(_build, "_dir", None)
    monkeypatch.delenv(_build.BUILD_DIR_ENV)
    assert _build.build_dir() == _build.BUILD_DIR


def test_sparse_engine_total_positions_matches_jax():
    from bm25_tpu.models.sparse import SparseEngine as JaxSparseEngine

    from bm25_tpu_torch.bench import BenchConfig, make_synthetic_index

    idx = make_synthetic_index(BenchConfig(num_docs=3000, vocab=400))
    for kw in ({"max_buckets": 1}, {"max_buckets": 3, "hot_tokens": 16,
                                     "hot_budget_bytes": 1 << 24}):
        port = SparseEngine.from_scored_index(idx, session=CPU, **kw)
        jax_eng = JaxSparseEngine.from_scored_index(idx, **kw)
        assert port.total_positions == jax_eng.total_positions
        assert port.total_positions == sum(
            b["doc_ids"].shape[0] for b in port.buckets) >= idx.num_docs
