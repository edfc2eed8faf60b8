"""The port's query benchmark harness (bench/query_bench.py) against the
JAX harness, on the CPU, at tests/test_bench_run.py's tiny config: the
same record keys apart from the ones the port names as omitted (the
sharded row's among them), recall 1.0 in every row, a compact headline
under 500 bytes, the timing helpers (the port's in-process shard-scaling
curve among them: JAX's runs a script in a subprocess) and the entry
point's last line.
"""

import json

import numpy as np
import pytest

from bm25_tpu.bench import query_bench as jax_bench
from bm25_tpu_torch import Session
from bm25_tpu_torch.bench import query_bench as port_bench
from bm25_tpu_torch.ops import _build

TINY = dict(
    num_docs=256, vocab=512, avg_len=16, num_queries=64, batch=32,
    top_k=20, top_k2=5, baseline_queries=8, engine="sparse",
    max_buckets=2, eval_docs=200, eval_queries=8,
    longdoc_docs=96, longdoc_long_len=320, longdoc_short_len=16,
    sharded_docs=128, cold_start=0, shard_scaling=0,
)


def quiet(*_args):
    pass


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    # the port's record with its cold-start row, over a build directory
    # holding one (fake) library for the cache export to ship
    build_dir = tmp_path_factory.mktemp("build")
    (build_dir / "libfake-0123456789abcdef.so").write_bytes(b"lib")
    with pytest.MonkeyPatch.context() as m:
        m.setenv(_build.BUILD_DIR_ENV, str(build_dir))
        port = port_bench.run(port_bench.BenchConfig(**{**TINY, "cold_start": 1}),
                              log=quiet, session=Session("cpu"))
    port["build_dir"] = str(build_dir)
    jax = jax_bench.run(jax_bench.BenchConfig(**TINY), log=quiet)
    return port, jax


def test_record_keys_match_jax(records):
    port, jax = records
    port = {k: v for k, v in port.items() if k != "build_dir"}
    assert port.keys() == jax.keys()
    assert port["metric"] == jax["metric"] == "bm25_query_throughput"
    pe, je = port["extra"], jax["extra"]
    omitted = set(pe["omitted"])
    assert omitted == set(port_bench.OMITTED) | set(port_bench.CARD_ONLY)
    assert pe["device"] == {"type": "cpu"}
    # the port records each row's planned chunks (routed ones carry a
    # cold width)
    for got, want in [(pe["headline"], je["headline"])] + list(
            zip(pe["secondary"], je["secondary"])):
        assert set(got) == (set(want) - omitted) | {"chunks"}
    assert set(pe["longdoc"]) == set(je["longdoc"]) | {"layout", "chunks"}
    for row in [pe["headline"], pe["longdoc"]] + pe["secondary"]:
        assert row["chunks"] and all(
            set(c) == {"rows", "height", "cold_width"} for c in row["chunks"])
    assert pe["memory_parity"].keys() == je["memory_parity"].keys()
    assert [r["point"] for r in pe["memory_trade"]] == ["parity", "mid",
                                                        "speed"]
    assert [r["point"] for r in je["memory_trade"]] == ["parity", "mid",
                                                        "speed"]
    for got, want in zip(pe["memory_trade"], je["memory_trade"]):
        assert got.keys() == want.keys()
    assert pe["memory_trade"][1]["overhead_target"] == 3.0
    # every row the JAX record has, the port's has
    assert pe["not_ported"] == {}
    assert set(je) <= set(pe)
    assert pe["sharded"].keys() == je["sharded"].keys()
    assert pe["sharded"]["mesh"] == {"data": 1, "docs": 1}
    # the config fixes max_buckets: the headline asks the model nothing;
    # the long-document row takes the model's layout
    assert "layout" not in pe
    ld = pe["longdoc"]["layout"]
    assert ld["top_k"] == pe["longdoc"]["top_k"]
    assert [c["max_buckets"] for c in ld["candidates"]] == [2, 3, 4, 6, 8]
    assert min(ld["candidates"], key=lambda c: c["total_ms"])[
        "max_buckets"] == ld["max_buckets"]
    assert pe["beir_synthetic_eval"].keys() == je["beir_synthetic_eval"].keys()


def test_cold_start_row(records):
    """JAX's cold-start keys, each timing a first step in a fresh process
    (an empty build directory, this process's, an imported copy of it),
    with the first-use work of each; on the CPU nothing is built."""
    port, _ = records
    cold = port["extra"]["cold_start"]
    keys = ("headline_step_cold_compile_s", "headline_step_warm_cache_s",
            "headline_step_cache_import_s")
    assert set(cold) == {"persistent_cache_dir", "upload_init_warm_s",
                         "first_use", *keys}
    assert cold["persistent_cache_dir"] == port["build_dir"]
    assert all(cold[key] > 0 for key in keys)
    assert set(cold["first_use"]) == {"cold", "warm", "cache_import"}
    for phases in cold["first_use"].values():
        assert phases == {"nvcc_build_s": 0.0, "native_build_s": 0.0,
                          "library_load_s": 0.0}
    assert cold["upload_init_warm_s"] == port["extra"]["upload_init_s"]


def test_recall_is_exact_in_every_row(records):
    for rec in records:
        extra = rec["extra"]
        rows = [extra["headline"], *extra["secondary"],
                extra["memory_parity"], extra["longdoc"], extra["sharded"]]
        assert [r["recall_vs_reference"] for r in rows] == [1.0] * len(rows)
        assert all(r["device_step_ms"] >= 0 for r in rows)
    # the synthetic-BEIR eval reads the same on both (same corpus, same
    # tokens: its words have nothing to stem)
    port, jax = records
    for mode in ("dense", "sparse"):
        got = dict(port["extra"]["beir_synthetic_eval"][mode])
        want = dict(jax["extra"]["beir_synthetic_eval"][mode])
        assert got.pop("engine") == want.pop("engine")
        assert got == want


def test_compact_headline_is_small(records):
    port, _ = records
    line = json.dumps(port_bench.compact_headline(port))
    assert len(line.encode()) < 500
    head = json.loads(line)
    assert head["recall"] == 1.0 and head["top_k"] == 20
    assert [r["top_k"] for r in head["secondary"]] == [5]


def test_step_bytes_and_timing_helpers():
    """estimate_step_hbm_bytes sums b1_bytes over the plan's chunks,
    scaled to the batch;
    measure_device_step_ms returns a time for the sparse engine only,
    measure_sharded_step_ms for the sharded one only; the shard-scaling
    curve (8 queries here) has JAX's keys at S = 1, 2, 4, 8, recall 1.0."""
    from bm25_tpu_torch import create_engine
    from bm25_tpu_torch.models.sparse import b1_bytes

    cfg = port_bench.BenchConfig(**TINY)
    index = port_bench.make_synthetic_index(cfg)
    queries = port_bench.make_queries(cfg)
    cpu = Session("cpu")
    eng = create_engine(index, mode="sparse", session=cpu, hot_tokens=32,
                        hot_budget_bytes=1 << 20, max_buckets=2)
    want = 0
    put = lambda x: None if x is None else cpu.put(x)  # noqa: E731
    plan = eng.plan_chunks(queries, k=10)
    for c in plan[1]:
        want += sum(b.scan + b.epilogue for b in b1_bytes(
            eng, cpu.put(c.padded), cold_ids=put(c.cold_padded)))
    want = want * 40 // len(queries)
    assert port_bench.estimate_step_hbm_bytes(eng, 40, plan) == want > 0
    assert port_bench.measure_device_step_ms(eng, queries, 10,
                                             iters=2) >= 0
    dense = create_engine(index, mode="dense", session=cpu)
    assert port_bench.measure_device_step_ms(dense, queries, 10) is None
    assert port_bench.estimate_step_hbm_bytes(dense, 40, None) is None
    assert port_bench.measure_sharded_step_ms(eng, queries, 10) is None
    sharded = create_engine(index, mode="sharded_sparse", session=cpu)
    assert port_bench.measure_sharded_step_ms(sharded, queries, 10,
                                              iters=2) >= 0
    curve = port_bench._measure_shard_scaling(port_bench.BenchConfig(**{
        **TINY, "num_queries": 8, "shard_scaling_docs": 64}), quiet, cpu)
    assert curve["k"] == TINY["top_k"]
    assert [r["shards"] for r in curve["strong"]] == [1, 2, 4, 8]
    for row in curve["strong"]:
        assert {"shards", "step_full_ms", "step_local_ms", "merge_share",
                "recall"} <= set(row)
        assert row["recall"] == 1.0 and row["step_full_ms"] >= 0


def test_model_layout_is_choose_layouts_choice():
    """With max_buckets=0 the harness takes choose_layout's layout at the
    headline k and the benchmark's batch, and keeps each candidate's
    modelled ms."""
    from bm25_tpu_torch.models.sparse import choose_layout

    cfg = port_bench.BenchConfig(**TINY)
    index = port_bench.make_synthetic_index(cfg)
    cpu = Session("cpu")
    got = port_bench.model_layout(index, cfg.top_k, cfg, cpu)
    want = choose_layout(index, cfg.top_k, q=cfg.batch, t=8,
                         device=cpu.device)
    assert {key: got[key] for key in want} == want
    assert got["top_k"] == cfg.top_k and len(got["candidates"]) == 5


def test_entry_point_prints_headline_last(capsys, monkeypatch):
    for field, value in TINY.items():
        monkeypatch.setenv(f"BM25_BENCH_{field.upper()}", str(value))
    assert port_bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    full, last = (json.loads(x) for x in lines)
    assert last == port_bench.compact_headline(full)
    assert last["metric"] == "bm25_query_throughput" and last["recall"] == 1.0
