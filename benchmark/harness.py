"""One run of one cell: set-up, the measured (or traced) window, the check,
and the result line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is data found by name: ``BENCHMARK.json`` names the cell's
configuration file and traffic mix (``traffic/<name>.json``), the cell's
limits are ``limits/<cell>.json``, and each per-layer metric is read by
``metrics/<metric>.py``.

From the program, ``bm25_tpu_torch``, the harness calls
``scoring.build_scored_index_flat``, ``models.auto.create_engine`` and the
engine's ``search``, ``search_pipelined``, ``plan_chunks`` and
``query_step`` (with ``models.sparse.maybe_dedup``, the host plan's first
step).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import resource
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import check, gen
from benchmark import trace as btrace
from benchmark.reference import Bm25Reference

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GIB = 1 << 30


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, limits and the metrics it reports."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    cell = cells[name]
    cfg_file = {c["name"]: c["file"] for c in spec["configs"]}[cell["config"]]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {
        "name": name,
        "chips": int(cell["chips"]),
        "config": load_json(os.path.join(root, cfg_file)),
        "traffic": load_json(os.path.join(HERE, "traffic",
                                          cell["traffic"] + ".json")),
        "limits": load_json(os.path.join(HERE, "limits", name + ".json")),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_program(doc_lengths, flat, config: dict, session=None):
    """The program's set-up: the scored index, then the engine that
    ``create_engine`` builds with the configuration's ``engine`` options
    (its defaults otherwise).  Returns ``(engine, spans)``, the host
    seconds of each step."""
    from bm25_tpu_torch.models.auto import create_engine
    from bm25_tpu_torch.scoring import BM25Params, build_scored_index_flat

    p = config["bm25"]
    params = BM25Params(k1=p["k1"], b=p["b"], method=p["method"])
    t0 = time.perf_counter()
    index = build_scored_index_flat(flat, doc_lengths,
                                    vocab_size=int(config["vocab_size"]),
                                    params=params)
    t1 = time.perf_counter()
    kw = dict(config.get("engine", {}))
    if session is not None:
        kw["session"] = session
    engine = create_engine(index, **kw)
    _sync(engine.session.device)
    t2 = time.perf_counter()
    return engine, {"index_build": t1 - t0, "engine_build": t2 - t1}


class Calls:
    """The traffic mix's calls into the engine.

    Each call is ``engine.<entry>(queries, top_k=top_k, **kwargs)`` over
    ``call_queries`` queries: the next ones of the set, padded to their own
    longest and wrapping at its end, so the calls cycle through the set; or
    the whole set a call where ``call_queries`` is null.  An entry that
    takes a ``batch`` option dispatches a call in batches of that many
    queries; any other dispatches a call as one batch.  A call answers
    ``(docs, scores)``, or the docs alone (scores None)."""

    def __init__(self, engine, queries: np.ndarray, traffic: dict):
        self.engine, self.queries = engine, queries
        self.entry = traffic["entry"]
        self.kwargs = dict(traffic.get("kwargs", {}))
        self.k = int(traffic["top_k"])
        self.batch = self.kwargs.get("batch")
        q = len(queries)
        n = traffic.get("call_queries")
        if n is None:
            self.blocks = [np.arange(q)]
            self.inputs = [queries]
        else:
            n = int(n)
            self.blocks = [(b * n + np.arange(n)) % q
                           for b in range(math.ceil(q / n))]
            self.inputs = [gen.trim(queries[r]) for r in self.blocks]

    def __len__(self) -> int:
        """Calls in one cycle through the query set."""
        return len(self.blocks)

    def rows(self, i: int) -> np.ndarray:
        return self.blocks[i % len(self.blocks)]

    def __call__(self, i: int):
        """Call ``i``: ``(docs, scores)`` on the host as numpy, scores None
        where the entry returns the docs alone."""
        x = self.inputs[i % len(self.blocks)]
        out = getattr(self.engine, self.entry)(x, top_k=self.k,
                                               **self.kwargs)
        if isinstance(out, tuple):
            return out
        return out, None

    def batches(self, i: int) -> list:
        """The query batches call ``i`` dispatches, as the engine gets
        them."""
        x = self.inputs[i % len(self.blocks)]
        if not self.batch:
            return [x]
        return [x[j : j + self.batch] for j in range(0, len(x), self.batch)]


class Keeper:
    """Keeps the answers that the check may judge: in each call a sample of
    ``check_per_call`` rows drawn from the seed and call index, and every
    answer to the longest query."""

    def __init__(self, calls: Calls, traffic: dict, seed: int,
                 longest: int):
        self.calls, self.seed, self.longest = calls, seed, longest
        self.per_call = int(traffic["check_per_call"])
        self.kept: list = []  # (query index, docs, scores)

    def __call__(self, i: int, docs: np.ndarray, scores: np.ndarray):
        rows = self.calls.rows(i)
        rng = np.random.default_rng([self.seed % (1 << 63), i])
        pos = set(rng.choice(len(rows), min(self.per_call, len(rows)),
                             replace=False).tolist())
        pos |= set(np.flatnonzero(rows == self.longest).tolist())
        for p in sorted(pos):
            self.kept.append((int(rows[p]), docs[p].copy(),
                              None if scores is None else scores[p].copy()))

    def sample(self, n: int) -> list:
        """Up to ``n`` kept answers drawn from the seed, the last answer
        to the longest query always among them."""
        forced = [j for j, e in enumerate(self.kept) if e[0] == self.longest]
        forced = forced[-1:]
        rest = [j for j in range(len(self.kept)) if j not in set(forced)]
        rng = np.random.default_rng([self.seed % (1 << 63), 1 << 30])
        m = max(min(n - len(forced), len(rest)), 0)
        take = rng.choice(len(rest), m, replace=False) if m else []
        return [self.kept[j] for j in forced + [rest[t] for t in take]]


def one_call(calls: Calls, keep: Keeper, i: int, tally: dict) -> bool:
    """Call ``i``, timed from just before it to its numpy results, its
    answers kept for the check.  A call that raises, or answers fewer rows
    than it was asked, counts its queries as failed; one that raises
    returns False."""
    n = len(calls.rows(i))
    tally["attempted"] += n
    t0 = time.perf_counter()
    try:
        docs, scores = calls(i)
    except Exception:  # reported, and counted against the run
        traceback.print_exc()
        tally["failed"] += n
        return False
    tally["latencies"].append(time.perf_counter() - t0)
    if len(docs) != n or (scores is not None and len(scores) != n):
        # rows left out
        tally["failed"] += n
    else:
        keep(i, docs, scores)
    return True


def new_tally() -> dict:
    return {"attempted": 0, "failed": 0, "latencies": []}


def window(calls: Calls, keep: Keeper, seconds: float) -> dict:
    """Whole calls, one after another, until ``seconds`` have passed (a
    call that raises ends the window)."""
    tally, i = new_tally(), 0
    t_start = time.perf_counter()
    while one_call(calls, keep, i, tally):
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    tally["elapsed"] = time.perf_counter() - t_start
    return tally


def plan_times(engine, calls: Calls) -> list:
    """Host ms of the host plan (``maybe_dedup``, ``plan_chunks``) of each
    batch of one cycle of calls; none for an engine without that plan."""
    from bm25_tpu_torch.models.sparse import maybe_dedup

    out = []
    if not hasattr(engine, "plan_chunks"):
        return out
    for i in range(len(calls)):
        for b in calls.batches(i):
            t0 = time.perf_counter()
            q, w = maybe_dedup(b, None, engine.dedup_queries,
                               engine.dedup_min_width)
            engine.plan_chunks(q, w, k=min(calls.k, engine.num_docs))
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def least_bytes(calls: Calls, df: np.ndarray, num_docs: int,
                calls_made: range, with_scores: bool) -> float:
    """The least bytes of the calls ``calls_made``: every posting of each
    distinct query token of a batch read once (an int32 doc id and a
    float32 score), the batch's query ids, and the results written (k int32
    ids a query, and k float32 scores where the calls return scores).
    Counted from the benchmark's own postings, whatever layout serves
    them."""
    total = 0
    k = min(calls.k, num_docs)
    per_result = 8 if with_scores else 4
    for i in calls_made:
        for b in calls.batches(i):
            toks = np.unique(b[b >= 0])
            total += 8 * int(df[toks].sum()) + 4 * b.size \
                + per_result * len(b) * k
    return float(total)


def peak_bytes_per_s(device_name: str) -> float | None:
    """The card's peak memory bandwidth from ``peaks.json``, by name."""
    for key, peak in load_json(os.path.join(HERE, "peaks.json")).items():
        if key in device_name:
            return float(peak["hbm_bytes_per_s"])
    return None


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def reader_path(name: str) -> str:
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    or for a name ``<quantity>.<group>`` split by the end-to-end metric it
    moves, ``metrics/<quantity>.py`` where the first is missing."""
    own = os.path.join(HERE, "metrics", name + ".py")
    if os.path.exists(own) or "." not in name:
        return own
    return os.path.join(HERE, "metrics", name.split(".")[0] + ".py")


def load_reader(name: str):
    """The reader module of the per-layer metric ``name``
    (``reader_path``)."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, record: dict):
    """The per-layer metric ``name`` read from ``record`` by its reader;
    None where the reader finds nothing."""
    return load_reader(name).read(record)


def needs_window(cell: dict) -> bool:
    """Whether a reader of the cell's per-layer metrics reads the untraced
    window (its module sets ``WINDOW = True``), which a ``--trace 1`` run
    then makes before its traced calls."""
    return any(getattr(load_reader(m["name"]), "WINDOW", False)
               for m in cell["per_layer"])


def _cpu_s() -> float:
    """This process's CPU seconds (all its threads)."""
    t = os.times()
    return t.user + t.system


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, session=None) -> dict:
    """One run of ``cell``: the result line's object and the checks.

    ``t_process`` is the process's start on ``time.perf_counter``'s clock;
    ``session`` (a ``bm25_tpu_torch`` session) is the CPU tests' only way
    to put the program on another device than the default CUDA one."""
    config, traffic = cell["config"], cell["traffic"]
    cuda = device.type == "cuda"

    # 1. inputs, made on the device from the seed and handed to both sides
    t_gen = time.perf_counter()
    doc_lengths, flat, queries = gen.make_inputs(config, seed, device)
    longest = int(np.argmax(gen.query_lengths(queries)))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    # 2. the program's set-up
    engine, spans = build_program(doc_lengths, flat, config, session)
    gc.collect()
    calls = Calls(engine, queries, traffic)
    # 3. warm every shape of the traffic: one cycle of calls
    t_warm = time.perf_counter()
    for i in range(len(calls)):
        calls(i)
    _sync(device)
    spans_info = {"gen_s": t_warm - t_gen - sum(spans.values()),
                  "warm_s": time.perf_counter() - t_warm}
    keep = Keeper(calls, traffic, seed, longest)
    t_window = time.perf_counter()
    setup_s = t_window - t_process

    # 4. the window
    record: dict = {"spans_s": spans}
    cpu0 = _cpu_s()
    if not trace:
        win = window(calls, keep, seconds)
    else:
        win = new_tally()
        if needs_window(cell):
            win = window(calls, keep, seconds)
            record["window"] = {"queries": win["attempted"] - win["failed"],
                                "elapsed_s": win["elapsed"]}
        traced = traced_window(calls, keep, traffic, record, device)
        for key in ("attempted", "failed", "latencies"):
            win[key] += traced[key]
    cpu1 = _cpu_s()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    name = torch.cuda.get_device_name(device) if cuda else "cpu"

    # 5. the check, after the program's state is freed
    calls.engine = None
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    p = config["bm25"]
    ref = Bm25Reference(doc_lengths, flat, config["vocab_size"], k1=p["k1"],
                        b=p["b"], device=device)
    answers = [(queries[q], d, s)
               for q, d, s in keep.sample(int(traffic["check_rows"]))]
    numbers = check.judge(answers, ref, calls.k)
    numbers["unanswered"] = win["failed"]
    correct, checks = check.verdict(numbers, cell["limits"], len(answers))
    check_s = time.perf_counter() - t_check

    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"]}
    if not trace:
        values = {
            "qps": (win["attempted"] - win["failed"]) / win["elapsed"],
            "latency_p95_ms": (percentile(win["latencies"], 95) * 1e3
                               if win["latencies"] else math.nan),
            "peak_device_gib": peak / GIB,
            "setup_s": setup_s,
        }
    else:
        df = ref.df.cpu().numpy()
        record["least_bytes"] = least_bytes(
            calls, df, ref.num_docs, range(record["traced_calls"]),
            record["with_scores"])
        record["peak_bytes_per_s"] = peak_bytes_per_s(name)
        values = {}
        for m in cell["per_layer"]:
            v = read_metric(m["name"], record)
            if v is not None:
                values[m["name"]] = v
    del ref
    if not trace:
        # an end-to-end metric's name is its quantity, then after a dot
        # the group of cells that its bound holds
        values = {m["name"]: values[m["name"].split(".")[0]]
                  for m in cell["end_to_end"]}
    wanted = cell["end_to_end"] if not trace else cell["per_layer"]
    result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                     "unit": m["unit"]}
                         for m in wanted if m["name"] in values}
    result["device"] = {"platform": "gpu" if cuda else "cpu", "kind": name,
                        "count": cell["chips"], "memory_peak_bytes": peak}
    if cuda:
        result["device"]["power"] = power_limit()
    if trace:
        result["device"]["busy_s"] = record["busy_s"]
        result["device"]["window_s"] = record["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s, _ in record["kernels"][:10]],
            "idle_gaps": record["gaps"][:10]}
    result["checks"] = checks
    lat_ms = np.asarray(win["latencies"]) * 1e3
    info = {"setup_s": setup_s, "check_s": check_s,
            "calls": len(win["latencies"]), **spans, **spans_info,
            "call_ms_p5_50_95": (np.percentile(lat_ms, [5, 50, 95]).tolist()
                                 if lat_ms.size else None),
            "window_cpu_s": cpu1 - cpu0,
            "host_peak_gib": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / (1 << 20)}
    print(f"[bench] {cell['name']} seed={seed} " + json.dumps(info),
          file=sys.stderr)
    return result


def traced_window(calls: Calls, keep: Keeper, traffic: dict, record: dict,
                  device: torch.device) -> dict:
    """The traced run's window: ``trace_calls`` calls under the profiler
    recording the device alone (busy time, kernels), a quarter as many
    recording the host too (the idle gaps' names), then the host plan's
    timing over one cycle of calls.  Fills ``record``; returns the window's
    counts as ``window`` does."""
    n = int(traffic["trace_calls"])
    tally = new_tally()
    scored = []

    def fn(i):
        if i < 0:  # the profiler's warm-up call
            scored.append(calls(0)[1] is not None)
        else:
            one_call(calls, keep, i, tally)

    t0 = time.perf_counter()
    prof, window_s = btrace.profiled_window(fn, n, device, host_ops=False)
    record.update(btrace.read_profile(prof, window_s))
    prof, window_s = btrace.profiled_window(fn, max(n // 4, 1), device,
                                            host_ops=True)
    record["gaps"] = btrace.read_profile(prof, window_s)["gaps"]
    elapsed = time.perf_counter() - t0
    del prof
    record["traced_calls"] = n
    record["traced_batches"] = sum(len(calls.batches(i)) for i in range(n))
    record["with_scores"] = scored[0]
    record["plan_ms"] = plan_times(calls.engine, calls)
    tally["elapsed"] = elapsed
    return tally
