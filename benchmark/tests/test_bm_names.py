"""BENCHMARK.json and the benchmark's data files against the contract's
shapes: names, units, keys and the files each entry needs."""

import json
import os
import re

import pytest

from benchmark import harness
from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]
    assert all(PATH.match(p) for p in s["paths"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_configs():
    s = spec()
    names = [c["name"] for c in s["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in s["workloads"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used


def test_workloads_and_their_files():
    s = spec()
    names = [w["name"] for w in s["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        for sub, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(BENCH, sub, name + ".json"))
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= 1


def test_metrics():
    s = spec()
    cells = {w["name"] for w in s["workloads"]}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in s["per_layer"]]
    assert len(set(names)) == len(names)
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
        where = m.get("workloads", sorted(cells))
        assert set(where) <= cells
        for cell in where:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert os.path.exists(harness.reader_path(m["name"]))
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:  # setup_s, one more end-to-end, one per-layer
        mine = [m for m in s["end_to_end"]
                if cell in m.get("workloads", [cell])]
        assert len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in s["per_layer"])


@pytest.mark.parametrize("sub", ["traffic", "configs", "limits"])
def test_data_file_names(sub):
    for name in os.listdir(os.path.join(BENCH, sub)):
        assert NAME.match(name[: -len(".json")]) and name.endswith(".json")


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel
