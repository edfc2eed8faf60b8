"""The port's HTTP serving daemon (bm25_tpu_torch/serve.py) on the CPU.

Two groups.  Parity: a JAX ``Server`` and a port ``Server`` over the same
index dir answer the same requests: ``/search`` ids under the parity
comparator (``utils/parity.py``: scores within 2e-5 x the row's largest
|score| + 5e-5 x |score|), texts equal; ``/explain`` bodies and
``/healthz`` keys equal; JAX's bad-request matrix gives the same status
and error text; a write-ahead log written by either package replays in
the other.  Then the tests of ``tests/test_serve.py``, on
the port (engines on ``Session("cpu")``), with short waits, and the pins of the two reference faults the copy fixes: the
auto-compaction counted before its runtime is published, and no cached
row from a search that raced a mutation.
"""

import json
import os
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest

from bm25_tpu.serve import Server as JaxServer
from bm25_tpu_torch import Session, build_index, serve
from bm25_tpu_torch.index.updates import UpdatableEngine, UpdateLog
from bm25_tpu_torch.reference import ReferenceEngine
from bm25_tpu_torch.scoring import build_scored_index
from bm25_tpu_torch.serve import (EngineRuntime, MicroBatcher,
                                  QueueFullError, ResultCache, ServeLimits)
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = Session("cpu")


def port_server(index_dir, **kw):
    """The port's Server, its engines on the CPU session."""
    kw.setdefault("engine_kwargs", {"session": CPU})
    return serve.Server(index_dir, **kw)


def _request(srv, path, payload=None, raw=None, timeout=30):
    """(status, JSON body, headers) of one request; GET without a body."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _post_path(srv, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _post(srv, payload):
    return _post_path(srv, "/search", payload)


def _healthz(srv, deep=False):
    url = f"http://127.0.0.1:{srv.port}/healthz" + ("?deep=1" if deep else "")
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _build(tmp_path_factory, corpus, name, save_corpus=True):
    d = tmp_path_factory.mktemp(name)
    build_index(corpus, save_to=str(d), save_corpus=save_corpus)
    return str(d)


@pytest.fixture(scope="module")
def animal_dir(tmp_path_factory, animal_corpus):
    return _build(tmp_path_factory, animal_corpus, "idx")


@pytest.fixture(scope="module")
def server(animal_dir):
    srv = port_server(animal_dir, port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _zipf_corpus(n=400, vocab=60, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [" ".join(f"w{t}" for t in rng.choice(vocab, rng.integers(3, 20),
                                                p=p))
            for _ in range(n)]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory, animal_corpus):
    """{corpus: (JAX server, port server)} over one index dir each."""
    out = {}
    for name, corpus in (("animal", animal_corpus), ("zipf", _zipf_corpus())):
        d = _build(tmp_path_factory, corpus, f"pair_{name}")
        jax_srv, port_srv = JaxServer(d, port=0), port_server(d, port=0)
        for s in (jax_srv, port_srv):
            s.start_background()
        out[name] = (jax_srv, port_srv)
    yield out
    for pair in out.values():
        for s in pair:
            s.shutdown()


@pytest.fixture(scope="module")
def upd_pair(tmp_path_factory, animal_corpus):
    """Updatable JAX and port servers over two copies of one index."""
    d = _build(tmp_path_factory, animal_corpus, "upd_pair")
    d2 = str(tmp_path_factory.mktemp("upd_pair_copy") / "idx")
    shutil.copytree(d, d2)
    srvs = (JaxServer(d, port=0, updatable=True),
            port_server(d2, port=0, updatable=True))
    for s in srvs:
        s.start_background()
    yield srvs
    for s in srvs:
        s.shutdown()


# -- parity with the JAX Server ------------------------------------------------

SEARCHES = {
    "animal": {
        "plain": {"queries": ["does the fish purr like a cat?",
                              "bird that can fly", "zzz unknown"],
                  "top_k": 3},
        "weighted": {"queries": [{"fish": 50.0, "purr": 1, "cat": 1},
                                 "dog play", {"water": 0.5, "dog": 2}],
                     "top_k": 4},
        "no_scores": {"queries": ["does the fish purr like a cat?"],
                      "top_k": 2, "include_scores": False},
        "filter_ids": {"queries": ["does the fish purr like a cat?", "cat"],
                       "top_k": 3, "filter_ids": [1, 3]},
        "top_k_past_num_docs": {"queries": ["cat", "fish water"],
                                "top_k": 50},
    },
    "zipf": {
        "plain": {"queries": ["w0 w3 w17", "w44 w59", "w1", "w5 w5 w2 w30"],
                  "top_k": 10},
        "weighted": {"queries": [{"w3": 2.0, "w17": 0.5},
                                 {"w40": 1.5, "w1": 0.1, "w8": 3.0}, "w9 w2"],
                     "top_k": 10},
        "no_scores": {"queries": ["w0 w3 w17", "w20"], "top_k": 10,
                      "include_scores": False},
        "filter_ids": {"queries": ["w0 w3 w17", "w6 w2"], "top_k": 10,
                       "filter_ids": list(range(0, 400, 7))},
        "top_k_past_num_docs": {"queries": ["w12 w13"], "top_k": 500},
    },
}


def _rows(body, scored=None):
    """(docs, scores) per row from a /search body; scores from ``scored``
    (the same request with scores) where the body has none."""
    out = []
    for i, row in enumerate(body["results"]):
        docs = np.array([[it["doc"] for it in row]], np.int32)
        src = row if "score" in (row[0] if row else {}) or scored is None \
            else scored["results"][i]
        scores = np.array([[it.get("score", 0.0) for it in src]], np.float32)
        out.append((docs, scores, [it.get("text") for it in row]))
    return out


@pytest.mark.parametrize("case", sorted(SEARCHES["animal"]))
@pytest.mark.parametrize("corpus", ["animal", "zipf"])
def test_search_matches_jax_server(pairs, corpus, case):
    jax_srv, port_srv = pairs[corpus]
    payload = SEARCHES[corpus][case]
    code_j, want, _ = _request(jax_srv, "/search", payload)
    code_p, got, _ = _request(port_srv, "/search", payload)
    assert code_j == code_p == 200
    assert len(got["results"]) == len(want["results"])
    scored = None
    if payload.get("include_scores") is False:
        scored = _request(jax_srv, "/search",
                          dict(payload, include_scores=True))[1]
        assert all("score" not in it for row in got["results"] for it in row)
    texts = {}
    for (jd, js, jt), (pd, ps, pt) in zip(_rows(want, scored),
                                          _rows(got, scored)):
        assert pd.shape == jd.shape
        if scored is None:
            assert_matches_oracle(pd, ps, jd, js)
        else:  # no scores: the ids, where the scores fix them
            assert_matches_oracle(pd, js, jd, js)
        texts.update(zip(jd[0].tolist(), jt))
        for d, t in zip(pd[0].tolist(), pt):
            assert texts.get(d, t) == t


@pytest.mark.parametrize("query,doc_id", [
    ("does the fish purr like a cat?", 0),
    ("does the fish purr like a cat?", 3),
    ({"cat": 2.0, "fish": 0.5}, 0),
    ("zzz unknown words", 2),
])
def test_explain_matches_jax_server(pairs, query, doc_id):
    jax_srv, port_srv = pairs["animal"]
    body = {"query": query, "doc_id": doc_id}
    code_j, want, _ = _request(jax_srv, "/explain", body)
    code_p, got, _ = _request(port_srv, "/explain", body)
    assert code_j == code_p == 200 and got == want


@pytest.mark.parametrize("deep", [False, True])
def test_healthz_keys_match_jax_server(pairs, deep):
    jax_srv, port_srv = pairs["zipf"]
    want, got = _healthz(jax_srv, deep), _healthz(port_srv, deep)
    assert got.keys() == want.keys()
    assert got["metrics"].keys() == want["metrics"].keys()
    for key in ("status", "num_docs", "vocab_size", "engine", "csc_bytes",
                "batch_window_ms", "index_dir"):
        assert got[key] == want[key], key
    if deep:
        for probe in ("device_probe", "engine_probe"):
            assert got[probe].keys() == want[probe].keys()
            assert got[probe]["ok"] and want[probe]["ok"]


# JAX's bad-request matrix (tests/test_serve.py:51-66, :394-427,
# :1353-1365, :1481, :1589, :1791 and the weighted / updatable cases):
# (route, JSON payload or raw bytes, updatable server)
BAD_REQUESTS = {
    "empty_queries": ("/search", {"queries": []}, False),
    "top_k_zero": ("/search", {"queries": ["x"], "top_k": 0}, False),
    "unknown_route_post": ("/nope", {"queries": ["x"]}, False),
    "search_list_body": ("/search", b"[1,2]", False),
    "search_str_body": ("/search", b'"x"', False),
    "search_num_body": ("/search", b"3", False),
    "explain_list_body": ("/explain", b"[1,2]", False),
    "explain_str_body": ("/explain", b'"x"', False),
    "explain_num_body": ("/explain", b"3", False),
    "reload_list_body": ("/reload", b"[1,2]", False),
    "reload_str_body": ("/reload", b'"x"', False),
    "reload_num_body": ("/reload", b"3", False),
    "weight_nan": ("/search", b'{"queries": [{"fish": NaN}], "top_k": 2}',
                   False),
    "weight_inf": ("/search",
                   b'{"queries": [{"fish": Infinity}], "top_k": 2}', False),
    "weight_neg_inf": ("/search",
                       b'{"queries": [{"fish": -Infinity}], "top_k": 2}',
                       False),
    "weight_not_a_number": ("/search",
                            {"queries": [{"fish": "heavy"}], "top_k": 2},
                            False),
    "too_many_queries": ("/search", {"queries": ["x"] * 2000, "top_k": 1},
                         False),
    "too_many_terms": ("/search", {"queries": [{f"t{i}": 1.0
                                                for i in range(500)}],
                                   "top_k": 1}, False),
    "top_k_over_cap": ("/search", {"queries": ["x"], "top_k": 1 << 20},
                       False),
    "body_over_cap": ("/search", {"queries": ["y" * (2 << 20)], "top_k": 1},
                      False),
    "filter_empty": ("/search", {"queries": ["cat"], "top_k": 2,
                                 "filter_ids": []}, False),
    "filter_strings": ("/search", {"queries": ["cat"], "top_k": 2,
                                   "filter_ids": ["x"]}, False),
    "filter_past_end": ("/search", {"queries": ["cat"], "top_k": 2,
                                    "filter_ids": [99]}, False),
    "filter_negative": ("/search", {"queries": ["cat"], "top_k": 2,
                                    "filter_ids": [-1]}, False),
    "filter_booleans": ("/search", {"queries": ["cat"], "top_k": 2,
                                    "filter_ids": [True, False]}, False),
    "explain_no_doc": ("/explain", {"query": "cat"}, False),
    "explain_str_doc": ("/explain", {"query": "cat", "doc_id": "zero"},
                        False),
    "explain_bool_doc": ("/explain", {"query": "cat", "doc_id": True}, False),
    "explain_doc_past_end": ("/explain", {"query": "cat", "doc_id": 99},
                             False),
    "explain_no_query": ("/explain", {"doc_id": 0}, False),
    "explain_list_query": ("/explain", {"query": ["cat"], "doc_id": 0},
                           False),
    "explain_inf_weight": ("/explain", {"query": {"cat": float("inf")},
                                        "doc_id": 0}, False),
    "reload_bad_mode": ("/reload", {"mode": "yolo"}, False),
    "reload_dir_not_str": ("/reload", {"index_dir": 7}, False),
    "reload_missing_dir": ("/reload", {"index_dir": "/does/not/exist"},
                           False),
    "add_not_updatable": ("/add", {"docs": ["a new document"]}, False),
    "add_empty": ("/add", {"docs": []}, True),
    "add_not_strings": ("/add", {"docs": [123]}, True),
    "add_missing": ("/add", {}, True),
    "delete_empty": ("/delete", {"doc_ids": []}, True),
    "delete_strings": ("/delete", {"doc_ids": ["x"]}, True),
    "delete_past_end": ("/delete", {"doc_ids": [99999]}, True),
    "delete_booleans": ("/delete", {"doc_ids": [True, False]}, True),
    "compact_dir_not_str": ("/compact", {"save_dir": 7}, True),
    "explain_on_updatable": ("/explain", {"query": "cat", "doc_id": 0}, True),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_requests_match_jax_server(pairs, upd_pair, case):
    path, body, updatable = BAD_REQUESTS[case]
    jax_srv, port_srv = upd_pair if updatable else pairs["animal"]
    kw = {"raw": body} if isinstance(body, bytes) else {"payload": body}
    code_j, want, _ = _request(jax_srv, path, **kw)
    code_p, got, _ = _request(port_srv, path, **kw)
    assert code_p == code_j and code_p in (400, 404, 409), (code_p, got)
    assert got == want
    if updatable:  # nothing was applied
        assert _healthz(port_srv)["updates"]["deleted_docs"] == 0
        assert _healthz(port_srv)["updates"]["live_docs"] == 4


def test_get_unknown_route_matches_jax_server(pairs):
    for srv in pairs["animal"]:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=30)
        assert e.value.code == 404


def _mutate(srv):
    """Adds, deletes and a logged in-memory compact; returns the doc ids
    the adds got."""
    ids = _post_path(srv, "/add", {"docs": [
        "a quokka is a smiling marsupial",
        "a wombat digs square scat burrows"]})["doc_ids"]
    _post_path(srv, "/delete", {"doc_ids": [1]})
    _post_path(srv, "/compact", {})
    ids += _post_path(srv, "/add", {"docs": ["a numbat eats termites"]}
                      )["doc_ids"]
    _post_path(srv, "/delete", {"doc_ids": [0]})
    return ids


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_replays_across_packages(tmp_path_factory, animal_corpus, writer):
    """A log the JAX Server wrote replays in the port's Server, and the
    other way round, to the same live state and the same results."""
    d = _build(tmp_path_factory, animal_corpus, f"wal_x_{writer}")
    make = {"jax": lambda: JaxServer(d, port=0, updatable=True),
            "port": lambda: port_server(d, port=0, updatable=True)}
    reader = "port" if writer == "jax" else "jax"
    q = {"queries": ["quokka", "dog", "numbat termites", "bird"], "top_k": 4}
    srv = make[writer]()
    srv.start_background()
    try:
        assert _mutate(srv) == [4, 5, 5]
        before = _post(srv, q)
    finally:
        srv.shutdown()
    srv2 = make[reader]()
    srv2.start_background()
    try:
        rt = srv2._handler.runtime
        assert rt.stats["wal_replayed"] == 5
        assert (rt.engine.live_docs, rt.engine.delta_docs,
                rt.engine.deleted_docs) == (5, 1, 1)
        after = _post(srv2, q)
        for (jd, js, jt), (pd, ps, pt) in zip(_rows(before), _rows(after)):
            assert_matches_oracle(pd, ps, jd, js)
            assert pt == jt
        out = _post_path(srv2, "/add", {"docs": ["another marsupial"]})
        assert out["doc_ids"] == [6]
    finally:
        srv2.shutdown()


# -- the reference's two faults, fixed in the copy ----------------------------


def test_auto_compaction_counted_before_it_is_published(tmp_path_factory,
                                                        animal_corpus):
    """ROADMAP §C 2: /healthz never shows the delta folded while
    ``compactions`` is still 0.  The count is taken while the old (or the
    drop-mode stub) runtime is still the published one, and a poller
    across the compaction never reads the folded delta uncounted."""
    d = _build(tmp_path_factory, animal_corpus, "ac_order_idx")
    srv = port_server(d, port=0, updatable=True, auto_compact=True,
                      auto_compact_interval_s=0.05,
                      auto_compact_delta_docs=2)
    published_at_count = []
    record = srv.metrics.record_compaction

    def counting():
        published_at_count.append(srv._handler.runtime.engine)
        record()

    srv.metrics.record_compaction = counting
    # the fold waits until the poller has read the grown delta, so a
    # poller slower than the 0.05 s policy tick cannot miss it
    grown_read = threading.Event()
    compact = srv.compact

    def compact_once_read(*a, **kw):
        grown_read.wait(timeout=30)
        return compact(*a, **kw)

    srv.compact = compact_once_read
    srv.start_background()
    seen, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            h = _healthz(srv)
            if "updates" in h:
                seen.append((h["updates"]["delta_docs"],
                             h["metrics"]["compactions"]))
                if seen[-1][0] == 3:
                    grown_read.set()

    poller = threading.Thread(target=poll)
    try:
        poller.start()
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial",
                                          "a wombat digs square scat burrows",
                                          "a numbat eats termites all day"]})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                seen and seen[-1] == (0, 1)):
            time.sleep(0.02)
    finally:
        stop.set()
        poller.join(timeout=30)
        srv.shutdown()
    assert not poller.is_alive()
    assert seen[-1] == (0, 1), seen[-5:]
    assert len(published_at_count) == 1
    eng = published_at_count[0]
    assert eng is None or eng.delta_docs == 3  # not the compacted runtime
    grown = seen.index(next(s for s in seen if s[0] == 3))
    assert all(c == 1 for delta, c in seen[grown:] if delta == 0), seen


def test_result_cache_drops_rows_of_a_search_that_raced_a_mutation(
        tmp_path_factory, animal_corpus):
    """ROADMAP §C 3: a search whose engine call ran before an /add (and so
    computed a pre-add row) must not store that row after the add cleared
    the cache.  A hook runs the add inside the search's engine call,
    after the engine answered: the handler's put comes after the clear."""
    d = _build(tmp_path_factory, animal_corpus, "rc_race_idx")
    srv = port_server(d, port=0, updatable=True, result_cache=8)
    srv.start_background()
    try:
        eng = srv._handler.runtime.engine
        search = eng.search
        added = []

        def racing_search(*a, **kw):
            out = search(*a, **kw)
            if not added:
                added.append(srv.add_documents(
                    ["a second cat likes to purr"])["doc_ids"][0])
            return out

        eng.search = racing_search
        q = {"queries": ["purr"], "top_k": 4}
        first = _post(srv, q)
        assert added and added[0] not in [it["doc"]
                                          for it in first["results"][0]]
        assert srv._handler.runtime.result_cache.stats()["entries"] == 0
        second = _post(srv, q)
        assert added[0] in [it["doc"] for it in second["results"][0]]
        third = _post(srv, q)  # a fresh row is cached and served
        assert third == second
        assert srv._handler.runtime.result_cache.stats()["hits"] == 1
    finally:
        srv.shutdown()


def test_persisted_compaction_leaves_open_corpus_readers_intact(
        tmp_path_factory, animal_corpus):
    """A compaction persisted into the served dir rewrites corpus.jsonl
    while in-flight searches of the old runtime read texts through the
    old MMapCorpus: the files are replaced, not truncated under it."""
    from bm25_tpu_torch.index.io import MMapCorpus, save_corpus

    d = _build(tmp_path_factory, animal_corpus, "corpus_swap_idx")
    reader = MMapCorpus.open(d)
    save_corpus(d, ["a much longer replacement text about capybaras"] * 5)
    assert [reader[i]["text"] for i in range(4)] == animal_corpus
    fresh = MMapCorpus.open(d)
    assert len(fresh) == 5 and "capybaras" in fresh[4]["text"]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_connection_burst_beyond_the_old_backlog(tmp_path_factory,
                                                 animal_corpus):
    """64 clients at once while each search holds the interpreter lock:
    the listen backlog (128, socketserver's default is 5) takes them all,
    none is reset."""
    d = _build(tmp_path_factory, animal_corpus, "burst_idx")
    srv = port_server(d, port=0)
    eng = srv._handler.runtime.engine
    search = eng.search

    def busy_search(*a, **kw):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.01:
            pass
        return search(*a, **kw)

    eng.search = busy_search
    srv.start_background()
    errors = []

    def client():
        try:
            _post(srv, {"queries": ["cat"], "top_k": 1})
        except Exception as e:  # noqa: BLE001 — collected, fail below
            errors.append(repr(e))

    try:
        _run_threads([client] * 64, timeout=120)
    finally:
        srv.shutdown()
    assert not errors, errors[:3]


def test_result_cache_generation_unit():
    c = ResultCache(4)
    gen = c.generation
    c.clear()
    c.put(("a", 1, True), ["stale"], generation=gen)
    assert c.lookup_batch([("a", 1, True)]) is None
    c.put(("a", 1, True), ["fresh"], generation=c.generation)
    c.put(("b", 1, True), ["no generation"])
    assert c.lookup_batch([("a", 1, True), ("b", 1, True)]) == [
        ["fresh"], ["no generation"]]


# -- device checkpoints -------------------------------------------------------


def test_device_checkpoint_raises_before_building(monkeypatch, capsys,
                                                  tmp_path):
    """A server started from a device checkpoint never builds from an
    index: a missing checkpoint, or ``updatable=True`` beside one, raises
    before any build."""
    def no_build(*a, **kw):
        raise AssertionError("built something")

    monkeypatch.setattr(serve.Server, "_build_runtime", no_build)
    missing = str(tmp_path / "no_ck")
    with pytest.raises(ValueError, match="no metadata sidecar"):
        port_server(None, port=0, device_checkpoint=missing)
    with pytest.raises(ValueError, match="updatable"):
        port_server(None, port=0, device_checkpoint=missing, updatable=True)
    from bm25_tpu_torch.cli.main import main

    with pytest.raises(ValueError, match="no metadata sidecar"):
        main(["--device", "cpu", "serve", "--device-checkpoint", missing])
    assert main(["--device", "cpu", "serve"]) == 2
    assert "index dir" in capsys.readouterr().err


def test_serve_from_device_checkpoint(tmp_path_factory, animal_corpus,
                                      server, capsys):
    """``checkpoint`` + ``Server(device_checkpoint=...)``: the server
    warm-restarts from the checkpoint (no index build) on the session of
    ``engine_kwargs`` and answers what the server built from the same
    index answers, bit for bit."""
    from bm25_tpu_torch.cli.main import main

    d = tmp_path_factory.mktemp("idx_ck")
    build_index(animal_corpus, save_to=str(d), save_corpus=True)
    ck = str(tmp_path_factory.mktemp("ck_dir") / "ck")
    assert main(["--device", "cpu", "checkpoint", str(d), "-o", ck]) == 0
    assert "device checkpoint saved" in capsys.readouterr().out
    srv = port_server(None, port=0, device_checkpoint=ck)
    srv.start_background()
    try:
        assert srv._handler.runtime.stats["device_checkpoint"] == ck
        assert srv._handler.runtime.engine.session is CPU
        out = _post(srv, {"queries": ["does the fish purr like a cat?"],
                          "top_k": 2})
        assert out["results"][0][0]["doc"] == 0
        # no corpus dir -> no text in responses, but ids/scores work
        assert "text" not in out["results"][0][0]
        for q in ("does the fish purr like a cat?", "bird that can fly",
                  {"cat": 2.0, "fish": 0.5}):
            body = {"queries": [q], "top_k": 5}
            (gd, gs, _), = _rows(_post(srv, body))
            (wd, ws, _), = _rows(_post(server, body))
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gs, ws)
        # reload without an index dir is a client error, not a crash
        code, body, _ = _request(srv, "/reload", {})
        assert code == 400 and "no index dir" in body["error"]
        assert _healthz(srv, deep=True)["status"] == "ok"
    finally:
        srv.shutdown()

    # with the index dir alongside, corpus text comes back
    srv2 = port_server(str(d), port=0, device_checkpoint=ck)
    srv2.start_background()
    try:
        out = _post(srv2, {"queries": ["bird that can fly"], "top_k": 1})
        assert "fly" in out["results"][0][0]["text"]
    finally:
        srv2.shutdown()


def test_updatable_rejects_device_checkpoint():
    with pytest.raises(ValueError, match="updatable"):
        port_server(None, port=0, updatable=True, device_checkpoint="ck")


def test_cli_serve_runs_the_port_server(monkeypatch, animal_dir):
    """``serve`` builds the port's Server with the global ``--device``'s
    session and the command's flags."""
    from bm25_tpu_torch.cli.main import main

    made = []

    class Fake:
        def __init__(self, index_dir, **kw):
            made.append((index_dir, kw))

        def serve_forever(self):
            pass

    monkeypatch.setattr(serve, "Server", Fake)
    assert main(["--device", "cpu", "serve", animal_dir, "--port", "0",
                 "--updatable", "--batch-window-ms", "2", "--score-dtype",
                 "bfloat16", "--result-cache", "5"]) == 0
    (index_dir, kw), = made
    assert index_dir == animal_dir and kw["updatable"]
    assert kw["engine_kwargs"]["session"].device.type == "cpu"
    assert kw["engine_kwargs"]["score_dtype"] == "bfloat16"
    assert kw["batch_window_ms"] == 2.0 and kw["result_cache"] == 5


# -- tests/test_serve.py on the port --------------------------------------------


def test_healthz(server):
    h = _healthz(server)
    assert h["status"] == "ok" and h["num_docs"] == 4
    assert h["engine"] == "DenseEngine"


def test_search_batch(server):
    r = _post(server, {"queries": ["does the fish purr like a cat?",
                                   "bird that can fly"], "top_k": 2})["results"]
    assert len(r) == 2 and len(r[0]) == 2
    assert r[0][0]["doc"] == 0 and "feline" in r[0][0]["text"]
    assert r[1][0]["doc"] == 2


def test_healthz_deep_probes_the_engine_device(server):
    h = _healthz(server, deep=True)
    assert h["status"] == "ok"
    assert h["device_probe"]["ok"] and h["engine_probe"]["ok"]


def test_healthz_deep_unhealthy_is_503(server, monkeypatch):
    monkeypatch.setattr(server._handler.runtime.engine, "search",
                        lambda *a, **k: 1 / 0)
    with pytest.raises(urllib.error.HTTPError) as e:
        _healthz(server, deep=True)
    assert e.value.code == 503
    body = json.loads(e.value.read())
    assert body["status"] == "unhealthy" and not body["engine_probe"]["ok"]


def test_concurrent_requests(server):
    results = [None] * 6

    def hit(i):
        q = ["does the fish purr like a cat?", "bird that can fly"][i % 2]
        results[i] = _post(server, {"queries": [q], "top_k": 2})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for i, r in enumerate(results):
        assert r["results"][0][0]["doc"] == (0 if i % 2 == 0 else 2)


def test_search_weighted_terms(server):
    base = _post(server, {"queries": ["fish purr cat"], "top_k": 4})
    assert base["results"][0][0]["doc"] == 0
    out = _post(server, {"queries": [{"fish": 50.0, "purr": 1, "cat": 1}],
                         "top_k": 4})
    assert "fish" in out["results"][0][0]["text"]
    w1 = _post(server, {"queries": [{"fish": 1, "purr": 1, "cat": 1}],
                        "top_k": 4})
    for a, b in zip(w1["results"][0], base["results"][0]):
        assert a["doc"] == b["doc"] and abs(a["score"] - b["score"]) < 1e-3


def test_search_filter_ids(server):
    out = _post(server, {"queries": ["does the fish purr like a cat?"],
                         "top_k": 3, "filter_ids": [1, 3]})
    row = out["results"][0]
    assert [it["doc"] for it in row] == [3, 1]
    assert all(it["score"] >= 0 for it in row)
    out = _post(server, {"queries": ["cat"], "top_k": 3, "filter_ids": [2]})
    assert [it["doc"] for it in out["results"][0]] == [2]


def test_explain_endpoint_matches_search(server):
    q = "does the fish purr like a cat?"
    top = _post(server, {"queries": [q], "top_k": 2})["results"][0][0]
    exp = _post_path(server, "/explain", {"query": q, "doc_id": top["doc"]})
    assert exp["doc_id"] == top["doc"]
    assert abs(exp["score"] - top["score"]) < 1e-4
    matched = [t for t in exp["terms"] if t["matched"]]
    assert matched and all(t["df"] > 0 for t in matched)
    (t,) = _post_path(server, "/explain",
                      {"query": {"cat": 2.0}, "doc_id": 0})["terms"]
    assert t["weight"] == 2.0 and t["matched"]


def test_reload_window_503_has_retry_after(server):
    old_rt = server._handler.runtime
    server._handler.runtime = EngineRuntime(
        engine=None, tokenizer=old_rt.tokenizer, vocab=old_rt.vocab,
        corpus=old_rt.corpus, stats=dict(old_rt.stats, reloading=True))
    try:
        code, body, headers = _request(server, "/search",
                                       {"queries": ["cat"], "top_k": 1})
        assert code == 503 and headers.get("Retry-After") is not None
        assert "retry" in body["error"]
    finally:
        server._handler.runtime = old_rt
    assert _post(server, {"queries": ["cat"], "top_k": 1})["results"][0]


def test_reload_window_503_reads_the_body_first(server):
    """A /search in a drop-mode reload window is answered only after its
    body is read: a socket closed over unread bytes resets the
    connection, and the client may lose the 503 (seen once on the card
    under load).  The body follows the headers 0.3 s late here: no answer
    may come before it, and the whole 503 after it."""
    old_rt = server._handler.runtime
    server._handler.runtime = EngineRuntime(
        engine=None, tokenizer=old_rt.tokenizer, vocab=old_rt.vocab,
        corpus=old_rt.corpus, stats=dict(old_rt.stats, reloading=True))
    body = json.dumps({"queries": ["cat"], "top_k": 1}).encode()
    try:
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=10) as sock:
            sock.sendall(b"POST /search HTTP/1.0\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: " + str(len(body)).encode()
                         + b"\r\n\r\n")
            sock.settimeout(0.3)
            with pytest.raises(socket.timeout):
                sock.recv(1)
            sock.settimeout(10)
            sock.sendall(body)
            reply = b""
            while chunk := sock.recv(1 << 16):
                reply += chunk
    finally:
        server._handler.runtime = old_rt
    head, _, payload = reply.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.0 503") and b"Retry-After" in head
    assert "retry" in json.loads(payload)["error"]


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_search_include_scores_false(tmp_path_factory, animal_corpus, mode):
    d = _build(tmp_path_factory, animal_corpus, f"idx_ro_{mode}")
    srv = port_server(d, port=0, engine_mode=mode)
    srv.start_background()
    try:
        q = "does the fish purr like a cat?"
        row = _post(srv, {"queries": [q], "top_k": 2,
                          "include_scores": False})["results"][0]
        assert row[0]["doc"] == 0 and "score" not in row[0]
        assert "text" in row[0]
        full = _post(srv, {"queries": [q], "top_k": 2})
        assert [r["doc"] for r in row] == [r["doc"]
                                           for r in full["results"][0]]
    finally:
        srv.shutdown()


# -- micro-batching -------------------------------------------------------------


class _RecordingEngine:
    """Engine stub: top_k copies of the row-sum as 'scores', row index as doc."""

    def __init__(self):
        self.batch_sizes = []

    def search(self, ids, top_k):
        self.batch_sizes.append(len(ids))
        n = len(ids)
        scores = np.repeat(np.where(ids >= 0, ids, 0).sum(axis=1,
                                                          keepdims=True),
                           top_k, axis=1).astype(np.float32)
        return np.tile(np.arange(top_k, dtype=np.int32), (n, 1)), scores


def _run_threads(targets, timeout=15):
    ts = [threading.Thread(target=t) for t in targets]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
        assert not t.is_alive()


def test_microbatcher_coalesces_and_splits():
    eng = _RecordingEngine()
    mb = MicroBatcher(eng, window_ms=200.0)
    try:
        outs = [None] * 4

        def submit(i):
            outs[i] = mb.search(np.full((i + 1, 3), i, dtype=np.int32),
                                top_k=2)

        _run_threads([lambda i=i: submit(i) for i in range(4)])
        assert eng.batch_sizes == [10]
        for i, (docs, scores) in enumerate(outs):
            assert docs.shape == (i + 1, 2) and (scores == 3 * i).all()
    finally:
        mb.close()


def test_microbatcher_groups_by_top_k():
    eng = _RecordingEngine()
    mb = MicroBatcher(eng, window_ms=200.0)
    try:
        outs = {}

        def submit(k):
            outs[k] = mb.search(np.zeros((1, 2), np.int32), top_k=k)

        _run_threads([lambda k=k: submit(k) for k in (3, 5, 3)])
        assert sorted(eng.batch_sizes) == [1, 2]
        assert outs[3][0].shape[1] == 3 and outs[5][0].shape[1] == 5
    finally:
        mb.close()


def test_microbatcher_pads_mixed_query_widths():
    eng = _RecordingEngine()
    mb = MicroBatcher(eng, window_ms=200.0)
    try:
        outs = [None, None]

        def submit(i, width):
            outs[i] = mb.search(np.ones((1, width), np.int32), top_k=1)

        _run_threads([lambda: submit(0, 2), lambda: submit(1, 6)])
        assert eng.batch_sizes == [2]
        assert outs[0][1][0, 0] == 2 and outs[1][1][0, 0] == 6
    finally:
        mb.close()


def test_microbatcher_propagates_engine_errors():
    class Boom:
        def search(self, ids, top_k):
            raise RuntimeError("device on fire")

    mb = MicroBatcher(Boom(), window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            mb.search(np.zeros((1, 2), np.int32), top_k=1)
    finally:
        mb.close()


def test_microbatcher_dead_collector_raises():
    mb = MicroBatcher(_RecordingEngine(), window_ms=1.0)
    mb.close()
    with pytest.raises(RuntimeError, match="draining"):
        mb.search(np.zeros((1, 2), np.int32), top_k=1)
    mb2 = MicroBatcher(_RecordingEngine(), window_ms=1.0)
    mb2._q.put(MicroBatcher._SENTINEL)
    mb2._thread.join(timeout=5)
    with pytest.raises(RuntimeError, match="collector thread died"):
        mb2.search(np.zeros((1, 2), np.int32), top_k=1)


def _slow_engine(gate, wait_s):
    class Slow:
        def search(self, ids, top_k):
            gate.wait(timeout=wait_s)
            n = len(ids)
            return (np.zeros((n, top_k), np.int32),
                    np.zeros((n, top_k), np.float32))
    return Slow()


def test_microbatcher_queue_full_raises():
    gate = threading.Event()
    mb = MicroBatcher(_slow_engine(gate, 10), window_ms=1.0,
                      max_pending_rows=4)
    try:
        ts = [threading.Thread(
            target=lambda: mb.search(np.zeros((2, 2), np.int32), top_k=1))
            for _ in range(2)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 5
        while mb.pending_rows < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(QueueFullError):
            mb.search(np.zeros((1, 2), np.int32), top_k=1)
        gate.set()
        for t in ts:
            t.join(timeout=10)
        assert mb.pending_rows == 0
    finally:
        gate.set()
        mb.close()


def test_microbatcher_timeout():
    """The first request occupies the collector; the second expires in
    the queue and answers TimeoutError when the collector reaches it."""
    gate = threading.Event()
    mb = MicroBatcher(_slow_engine(gate, 1.0), window_ms=1.0)
    try:
        t = threading.Thread(
            target=lambda: mb.search(np.zeros((1, 2), np.int32), top_k=1))
        t.start()
        time.sleep(0.1)
        with pytest.raises(TimeoutError):
            mb.search(np.zeros((1, 2), np.int32), top_k=1, timeout=0.05)
        gate.set()
        t.join(timeout=10)
    finally:
        gate.set()
        mb.close()


def test_microbatcher_isolates_bad_request():
    class Picky:
        def search(self, ids, top_k, weights=None):
            if weights is not None and (weights < 0).any():
                raise ValueError("negative weights unsupported")
            n = len(ids)
            return (np.tile(np.arange(top_k, dtype=np.int32), (n, 1)),
                    np.ones((n, top_k), np.float32))

    mb = MicroBatcher(Picky(), window_ms=50.0)
    try:
        results = {}

        def good():
            results["good"] = mb.search(np.zeros((1, 2), np.int32), top_k=2)

        def bad():
            try:
                mb.search(np.zeros((1, 2), np.int32), top_k=2,
                          weights=np.array([[-1.0, 1.0]], np.float32))
            except ValueError as e:
                results["bad"] = e

        _run_threads([good, bad])
        assert isinstance(results["bad"], ValueError)
        assert results["good"][0].shape == (1, 2)
    finally:
        mb.close()


def test_graceful_drain_finishes_queued_work():
    mb = MicroBatcher(_RecordingEngine(), window_ms=200.0)
    outs = []
    ts = [threading.Thread(target=lambda: outs.append(
        mb.search(np.zeros((1, 2), np.int32), top_k=1))) for _ in range(3)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5
    while mb.pending_rows < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    mb.drain(timeout=15)
    for t in ts:
        t.join(timeout=15)
    assert len(outs) == 3 and all(o is not None for o in outs)


def test_microbatcher_infra_errors_not_retried_per_item():
    calls = []

    class Flaky:
        def search(self, ids, top_k):
            calls.append(len(ids))
            raise RuntimeError("device on fire")

    mb = MicroBatcher(Flaky(), window_ms=200.0)
    try:
        errs = []

        def hit():
            try:
                mb.search(np.zeros((1, 2), np.int32), top_k=1)
            except RuntimeError as e:
                errs.append(e)

        _run_threads([hit] * 4)
        assert len(errs) == 4 and calls == [4]
    finally:
        mb.close()


def test_microbatcher_releases_flushed_engines():
    """Once a batch ran, the collector holds no reference to its engine:
    a drop-mode reload can free the old engine while the queue is idle."""
    import gc
    import weakref

    eng = _RecordingEngine()
    mb = MicroBatcher(None, window_ms=1.0)
    try:
        mb.search(np.zeros((1, 2), np.int32), top_k=1, engine=eng)
        ref = weakref.ref(eng)
        del eng
        gc.collect()
        assert ref() is None
    finally:
        mb.close()


@pytest.fixture(scope="module")
def batched_server(animal_dir):
    srv = port_server(animal_dir, port=0, batch_window_ms=20.0)
    srv.start_background()
    yield srv
    srv.shutdown()


def test_batched_server_concurrent_correctness(batched_server):
    results = [None] * 8

    def hit(i):
        q = ["does the fish purr like a cat?", "bird that can fly"][i % 2]
        results[i] = _post(batched_server, {"queries": [q], "top_k": 2})

    _run_threads([lambda i=i: hit(i) for i in range(8)], timeout=30)
    for i, r in enumerate(results):
        assert r["results"][0][0]["doc"] == (0 if i % 2 == 0 else 2)
    assert batched_server.batcher.batches_run < batched_server.batcher.rows_run
    assert _healthz(batched_server)["batch_window_ms"] == 20.0


@pytest.mark.parametrize("mode,op,kernel", [
    ("dense", "gather_rows", "gather_add_rows"),
    ("sparse", "ell_score", "ell_score_fused"),
])
def test_warmup_runs_the_served_path(tmp_path_factory, animal_corpus, mode,
                                     op, kernel):
    """The T=8 warm query goes through the served engine's kernel (its
    plain twin here, on the CPU session)."""
    import importlib

    mod = importlib.import_module(f"bm25_tpu_torch.ops.{op}")
    d = _build(tmp_path_factory, animal_corpus, f"idx_warm_{mode}")
    before = mod.plain_calls[kernel]
    srv = port_server(d, port=0, engine_mode=mode, warmup_top_k=3)
    assert mod.plain_calls[kernel] > before  # no build step runs it
    srv.httpd.server_close()


def test_server_warmup(tmp_path_factory, animal_corpus, capsys):
    d = _build(tmp_path_factory, animal_corpus, "idx_warm")
    srv = port_server(d, port=0, warmup_top_k=3)
    try:
        assert "warmup (top_k=3)" in capsys.readouterr().out
        bd = srv.last_warmup_breakdown
        assert bd is not None and bd["wall_s"] >= 0
        assert set(bd) == {"wall_s", "nvcc_build_s", "native_build_s",
                           "library_load_s", "other_s"}
        assert bd["nvcc_build_s"] == bd["library_load_s"] == 0.0  # CPU
        assert bd["native_build_s"] == 0.0  # the warm-up tokenizes nothing
        srv.start_background()
        out = _post(srv, {"queries": ["a cat that purrs"], "top_k": 3})
        assert out["results"][0][0]["doc"] == 0
        assert _healthz(srv, deep=True)["warmup_breakdown"] == bd
    finally:
        srv.shutdown()


def test_healthz_reports_request_metrics(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "idx_metrics")
    srv = port_server(d, port=0, batch_window_ms=1.0)
    srv.start_background()
    try:
        for _ in range(3):
            _post(srv, {"queries": ["cat", "fish in water"], "top_k": 2})
        m = _healthz(srv)["metrics"]
        assert m["requests"] == 3 and m["queries"] == 6 and m["errors"] == 0
        assert m["latency_ms"]["p50"] > 0
        assert m["latency_ms"]["p99"] >= m["latency_ms"]["p50"]
        assert m["batches_run"] >= 1 and m["batch_occupancy"] >= 2.0
    finally:
        srv.shutdown()


# -- reload -------------------------------------------------------------------


def test_hot_reload(tmp_path_factory, animal_corpus):
    d1 = _build(tmp_path_factory, animal_corpus, "idx_reload_a")
    d2 = _build(tmp_path_factory, ["the zebra gallops across the plain",
                                   "a silent submarine dives deep"],
                "idx_reload_b")
    srv = port_server(d1, port=0)
    srv.start_background()
    try:
        out = _post(srv, {"queries": ["cat"], "top_k": 1})
        assert "feline" in out["results"][0][0]["text"]
        rl = _post_path(srv, "/reload", {"index_dir": d2})
        assert rl["status"] == "reloaded" and rl["num_docs"] == 2
        out = _post(srv, {"queries": ["zebra"], "top_k": 1})
        assert "zebra" in out["results"][0][0]["text"]
        h = _healthz(srv)
        assert h["num_docs"] == 2 and h["metrics"]["reloads"] == 1
        code, _, _ = _request(srv, "/reload", {"index_dir": "/does/not/exist"})
        assert code == 400
        out = _post(srv, {"queries": ["zebra"], "top_k": 1})
        assert "zebra" in out["results"][0][0]["text"]
    finally:
        srv.shutdown()


def test_reload_auto_mode_swaps_with_zero_errors(tmp_path_factory,
                                                 animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "idx_auto_swap")
    srv = port_server(d, port=0)
    srv.start_background()
    try:
        _post(srv, {"queries": ["cat"], "top_k": 1})
        stop = threading.Event()
        errors = []

        def hammer():
            while not stop.is_set():
                try:
                    out = _post(srv, {"queries": ["cat"], "top_k": 1})
                    assert "feline" in out["results"][0][0]["text"]
                except Exception as e:  # noqa: BLE001 — collect, fail below
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            rl = _post_path(srv, "/reload", {})
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=15)
        assert rl["status"] == "reloaded" and rl["mode"] == "swap", rl
        sizing = rl["sizing"]
        assert sizing["fits"] is True and sizing["old_device_bytes"] > 0
        assert sizing["est_new_device_bytes"] > 0
        assert not errors, errors[:3]
    finally:
        srv.shutdown()


def test_reload_auto_mode_budget_reads_the_engine_device(
        tmp_path_factory, animal_corpus, monkeypatch):
    """The budget is the served engine's device memory x the usable
    fraction; the new engine is projected at the old one's ratio."""
    import bm25_tpu_torch.models.sparse as sparse_mod

    d = _build(tmp_path_factory, animal_corpus, "idx_auto_budget")
    srv = port_server(d, port=0)
    srv.start_background()
    asked = []
    monkeypatch.setattr(sparse_mod, "device_hbm_bytes",
                        lambda dev: asked.append(dev) or 1 << 30)
    try:
        rl = _post_path(srv, "/reload", {})
        assert [str(x) for x in asked] == ["cpu"]
        sizing = rl["sizing"]
        assert sizing["budget_bytes"] == int(
            (1 << 30) * sparse_mod._USABLE_HBM_FRACTION)
        assert sizing["est_new_device_bytes"] == sizing["old_device_bytes"]
    finally:
        srv.shutdown()


def test_reload_auto_mode_drops_when_over_budget(tmp_path_factory,
                                                 animal_corpus, monkeypatch):
    import bm25_tpu_torch.models.sparse as sparse_mod

    d = _build(tmp_path_factory, animal_corpus, "idx_auto_drop")
    srv = port_server(d, port=0)
    srv.start_background()
    try:
        monkeypatch.setattr(sparse_mod, "device_hbm_bytes", lambda *a: 64)
        rl = _post_path(srv, "/reload", {})
        assert rl["mode"] == "drop" and rl["sizing"]["fits"] is False, rl
        out = _post(srv, {"queries": ["cat"], "top_k": 1})
        assert "feline" in out["results"][0][0]["text"]
    finally:
        srv.shutdown()


def test_auto_reload_mode_fallback_ratio(animal_dir):
    """With no CSC bytes on record the new engine is projected at the
    measured fallback ratio; an unknown engine or device drops."""
    srv = port_server(animal_dir, port=0)
    try:
        index, _ = srv._load_host(animal_dir)
        csc = index.indptr.nbytes + index.indices.nbytes + index.data.nbytes
        srv._handler.runtime.stats["csc_bytes"] = 0
        mode, sizing = srv._auto_reload_mode(srv._handler.runtime.engine,
                                             index)
        assert mode == "swap" and sizing["est_new_device_bytes"] == int(
            serve.FALLBACK_DEVICE_CSC_RATIO * csc)
        assert srv._auto_reload_mode(None, index)[0] == "drop"
        srv._engine_kwargs = {}
        assert srv._auto_reload_mode(None, index) == (
            "drop", {"reason": "served device unknown"})
    finally:
        srv.httpd.server_close()
        if srv.batcher is not None:
            srv.batcher.close()


def test_reload_drop_mode_releases_engine_and_503s(tmp_path_factory,
                                                   animal_corpus):
    """mode='drop' serves 503 (/search and /explain) while the engine
    rebuilds, the old engine is freed before the new one builds, and the
    server recovers."""
    import gc
    import weakref

    d = _build(tmp_path_factory, animal_corpus, "idx_drop")
    srv = port_server(d, port=0, batch_window_ms=2.0)
    srv.start_background()
    try:
        _post(srv, {"queries": ["cat"], "top_k": 1})  # through the batcher
        old = weakref.ref(srv._handler.runtime.engine)
        orig = srv._make_runtime
        gate = threading.Event()
        freed = []

        def slow_make(*a, **kw):
            gc.collect()
            freed.append(old() is None)
            gate.wait(timeout=10)
            return orig(*a, **kw)

        srv._make_runtime = slow_make
        t = threading.Thread(target=lambda: _request(srv, "/reload",
                                                     {"mode": "drop"}))
        t.start()
        deadline = time.monotonic() + 5
        saw_503 = saw_503_explain = False
        while time.monotonic() < deadline and not (saw_503
                                                   and saw_503_explain):
            code, _, _ = _request(srv, "/search",
                                  {"queries": ["cat"], "top_k": 1})
            saw_503 = saw_503 or code == 503
            code, _, _ = _request(srv, "/explain",
                                  {"query": "cat", "doc_id": 0})
            assert code != 409, "explain 409'd during a reload window"
            saw_503_explain = saw_503_explain or code == 503
            time.sleep(0.02)
        gate.set()
        t.join(timeout=30)
        assert saw_503 and saw_503_explain
        assert freed == [True], "the old engine outlived the drop"
        out = _post(srv, {"queries": ["cat"], "top_k": 1})
        assert "feline" in out["results"][0][0]["text"]
    finally:
        gate.set()
        srv.shutdown()


def test_serve_mmap_host_load(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "idx_mmap")
    srv = port_server(d, port=0, mmap=True)
    srv.start_background()
    try:
        assert isinstance(srv._handler.runtime.index.data, np.memmap)
        out = _post(srv, {"queries": ["does the fish purr like a cat"],
                          "top_k": 2})
        assert out["results"][0][0]["doc"] == 0
        assert _post_path(srv, "/reload", {})["status"] == "reloaded"
        assert isinstance(srv._handler.runtime.index.data, np.memmap)
    finally:
        srv.shutdown()


# -- live updates (updatable=True) ----------------------------------------------


@pytest.fixture()
def upd_server(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "upd_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    yield srv
    srv.shutdown()


def test_updatable_add_search_delete(upd_server):
    srv = upd_server
    h = _healthz(srv)
    assert h["updatable"] is True and h["updates"]["live_docs"] == 4
    assert isinstance(srv._handler.runtime.engine, UpdatableEngine)
    out = _post_path(srv, "/add", {
        "docs": ["the quokka is a smiling marsupial from rottnest",
                 "a second quokka document about marsupials"]})
    assert out["doc_ids"] == [4, 5] and out["live_docs"] == 6
    top = _post(srv, {"queries": ["quokka marsupial"], "top_k": 3}
                )["results"][0]
    assert {top[0]["doc"], top[1]["doc"]} == {4, 5}
    assert "quokka" in top[0]["text"]
    res = _post(srv, {"queries": [{"quokka": 2.0, "bird": 0.5}], "top_k": 2})
    assert res["results"][0][0]["doc"] in (4, 5)
    out = _post_path(srv, "/delete", {"doc_ids": [4]})
    assert out["deleted"] == 1 and out["live_docs"] == 5
    docs = [r["doc"] for r in _post(srv, {"queries": ["quokka marsupial"],
                                          "top_k": 3})["results"][0]]
    assert 4 not in docs and 5 in docs
    h = _healthz(srv)
    assert h["updates"]["delta_docs"] == 2
    assert h["updates"]["deleted_docs"] == 1


def test_updatable_compact_and_save(upd_server, tmp_path):
    srv = upd_server
    _post_path(srv, "/add", {"docs": ["axolotl regeneration is remarkable"]})
    _post_path(srv, "/delete", {"doc_ids": [1]})
    save_dir = str(tmp_path / "compacted")
    out = _post_path(srv, "/compact", {"save_dir": save_dir})
    assert out["status"] == "compacted" and out["live_docs"] == 4
    assert out["saved_to"] == save_dir
    h = _healthz(srv)
    assert h["updates"]["delta_docs"] == 0 and h["updates"]["deleted_docs"] == 0
    res = _post(srv, {"queries": ["axolotl regeneration"], "top_k": 1})
    assert res["results"][0][0]["doc"] == 3
    assert "axolotl" in res["results"][0][0]["text"]
    srv2 = port_server(save_dir, port=0)
    srv2.start_background()
    try:
        res2 = _post(srv2, {"queries": ["axolotl regeneration"], "top_k": 1})
        assert res2["results"][0][0]["doc"] == 3
        assert (res2["results"][0][0]["score"]
                == pytest.approx(res["results"][0][0]["score"]))
    finally:
        srv2.shutdown()
    assert _post_path(srv, "/add", {"docs": ["one more axolotl fact"]}
                      )["doc_ids"] == [4]
    docs = [r["doc"] for r in _post(srv, {"queries": ["axolotl"],
                                          "top_k": 2})["results"][0]]
    assert set(docs) == {3, 4}


def test_updatable_with_microbatcher_concurrent(tmp_path_factory,
                                                animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "upd_mb_idx")
    srv = port_server(d, port=0, updatable=True, batch_window_ms=5.0)
    srv.start_background()
    try:
        errors = []

        def searcher():
            for _ in range(20):
                try:
                    _post(srv, {"queries": ["fish cat", "capybara rodent"],
                                "top_k": 2})
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        threads = [threading.Thread(target=searcher) for _ in range(4)]
        for t in threads:
            t.start()
        for i in range(10):
            _post_path(srv, "/add",
                       {"docs": [f"capybara rodent fact number {i}"]})
        for t in threads:
            t.join(timeout=60)
        assert not errors
        res = _post(srv, {"queries": ["capybara rodent"], "top_k": 10})
        assert {r["doc"] for r in res["results"][0]} & set(range(4, 14))
    finally:
        srv.shutdown()


def test_updatable_without_corpus(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "upd_nocorpus_idx",
               save_corpus=False)
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        assert _post_path(srv, "/add", {"docs": ["a quokka marsupial doc"]}
                          )["doc_ids"] == [4]
        top = _post(srv, {"queries": ["quokka"], "top_k": 1})["results"][0][0]
        assert top["doc"] == 4 and "quokka" in top["text"]
        res = _post(srv, {"queries": ["cat"], "top_k": 1})
        assert res["results"][0][0]["text"] == ""
        code, body, _ = _request(srv, "/compact", {})
        assert code == 400 and "corpus" in body["error"]
        _post_path(srv, "/delete", {"doc_ids": [0, 1, 2, 3]})
        assert _post_path(srv, "/compact", {})["live_docs"] == 1
        res = _post(srv, {"queries": ["quokka"], "top_k": 1})
        assert res["results"][0][0]["doc"] == 0
    finally:
        srv.shutdown()


def test_search_filter_ids_with_batcher_and_updatable(tmp_path_factory,
                                                      animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "filter_upd_idx")
    srv = port_server(d, port=0, updatable=True, batch_window_ms=5.0)
    srv.start_background()
    try:
        new_id = _post_path(srv, "/add", {"docs": ["a quokka cat marsupial"]}
                            )["doc_ids"][0]
        row = _post(srv, {"queries": ["cat"], "top_k": 3,
                          "filter_ids": [new_id]})["results"][0]
        assert [it["doc"] for it in row] == [new_id]
        assert "quokka" in row[0]["text"]
        res = _post(srv, {"queries": [{"cat": 2.0, "dog": 1.0}], "top_k": 2,
                          "filter_ids": [1]})
        assert [it["doc"] for it in res["results"][0]] == [1]
    finally:
        srv.shutdown()


def test_needs_compaction_reports_configured_thresholds(tmp_path_factory,
                                                        animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "thresh_idx")
    srv = port_server(d, port=0, updatable=True, auto_compact_delta_docs=1)
    srv.start_background()
    try:
        out = _post_path(srv, "/add", {"docs": ["doc one here",
                                                "doc two here"]})
        assert out["needs_compaction"] is True
        assert _healthz(srv)["updates"]["needs_compaction"] is True
    finally:
        srv.shutdown()


def test_filtered_search_shares_admission_cap(tmp_path_factory,
                                              animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "fadm_idx")
    srv = port_server(d, port=0, batch_window_ms=2.0,
                      limits=ServeLimits(max_pending_rows=2))
    srv.start_background()
    try:
        code, _, headers = _request(srv, "/search", {
            "queries": ["cat", "dog", "bird"], "top_k": 1,
            "filter_ids": [0, 1]})
        assert code == 429 and headers.get("Retry-After") == "1"
        out = _post(srv, {"queries": ["cat", "dog"], "top_k": 1,
                          "filter_ids": [0, 1]})
        assert len(out["results"]) == 2 and srv.batcher.pending_rows == 0
        assert _healthz(srv)["metrics"]["rejected"] == 1
    finally:
        srv.shutdown()


def test_socket_timeout_closes_stalled_connection(tmp_path_factory,
                                                  animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "sockto_idx")
    srv = port_server(d, port=0, limits=ServeLimits(socket_timeout_s=0.5))
    srv.start_background()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(b"POST /search HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 100\r\n\r\n{\"partial")
        s.settimeout(10)
        t0 = time.monotonic()
        try:
            while s.recv(4096):
                pass
        except (ConnectionResetError, TimeoutError, socket.timeout):
            pass
        assert time.monotonic() - t0 < 8
        s.close()
        assert _post(srv, {"queries": ["cat"], "top_k": 1}
                     )["results"][0][0]["doc"] == 0
    finally:
        srv.shutdown()


# -- write-ahead log --------------------------------------------------------------


def test_wal_replays_acked_ops_after_kill(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "wal_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        out = _post_path(srv, "/add", {"docs": [
            "a quokka is a smiling marsupial",
            "a wombat digs square scat burrows"]})
        assert out["doc_ids"] == [4, 5]
        _post_path(srv, "/delete", {"doc_ids": [1]})
        before = _post(srv, {"queries": ["quokka", "dog"], "top_k": 3})
    finally:
        srv.shutdown()
    srv2 = port_server(d, port=0, updatable=True)
    srv2.start_background()
    try:
        assert srv2._handler.runtime.stats["wal_replayed"] == 2
        after = _post(srv2, {"queries": ["quokka", "dog"], "top_k": 3})
        assert after == before
        assert 1 not in [it["doc"] for it in after["results"][1]
                         if it["score"] > 0]
        assert _post_path(srv2, "/add", {"docs": ["another marsupial doc"]}
                          )["doc_ids"] == [6]
    finally:
        srv2.shutdown()


def test_wal_logged_compact_replays_deterministically(tmp_path_factory,
                                                      animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "wal_cpt_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial"]})
        _post_path(srv, "/delete", {"doc_ids": [0]})
        assert _post_path(srv, "/compact", {})["live_docs"] == 4
        _post_path(srv, "/delete", {"doc_ids": [0]})
        before = _post(srv, {"queries": ["quokka", "dog"], "top_k": 3})
    finally:
        srv.shutdown()
    srv2 = port_server(d, port=0, updatable=True)
    srv2.start_background()
    try:
        assert srv2._handler.runtime.stats["wal_replayed"] == 4
        assert _post(srv2, {"queries": ["quokka", "dog"], "top_k": 3}) == before
        assert srv2._handler.runtime.engine.live_docs == 3
    finally:
        srv2.shutdown()


def test_wal_truncated_by_persisted_compact(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "wal_trunc_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial"]})
        assert len(UpdateLog(d).read_pending()) == 1
        assert _post_path(srv, "/compact", {"save_dir": d})["saved_to"] == d
        assert UpdateLog(d).read_pending() == []
    finally:
        srv.shutdown()
    srv2 = port_server(d, port=0, updatable=True)
    srv2.start_background()
    try:
        assert "wal_replayed" not in srv2._handler.runtime.stats
        top = _post(srv2, {"queries": ["quokka"], "top_k": 1})["results"][0][0]
        assert top["score"] > 0 and "quokka" in top["text"]
    finally:
        srv2.shutdown()


def test_wal_torn_tail_dropped_with_warning(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "wal_torn_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial"]})
    finally:
        srv.shutdown()
    with open(os.path.join(d, "updates.wal"), "a", encoding="utf-8") as f:
        f.write('{"op": "add", "docs": ["torn rec')
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        srv2 = port_server(d, port=0, updatable=True)
    assert any("torn" in str(x.message) for x in w)
    srv2.start_background()
    try:
        assert srv2._handler.runtime.stats["wal_replayed"] == 1
        assert _post(srv2, {"queries": ["quokka"], "top_k": 1}
                     )["results"][0][0]["doc"] == 4
    finally:
        srv2.shutdown()


def test_wal_no_corpus_adds_survive_restart(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "wal_nc_idx",
               save_corpus=False)
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial"]})
    finally:
        srv.shutdown()
    srv2 = port_server(d, port=0, updatable=True)
    srv2.start_background()
    try:
        top = _post(srv2, {"queries": ["quokka"], "top_k": 1})["results"][0][0]
        assert top["doc"] == 4 and "quokka" in top["text"]
    finally:
        srv2.shutdown()


def test_wal_reload_switches_log(tmp_path_factory, animal_corpus):
    d1 = _build(tmp_path_factory, animal_corpus, "wal_rl1_idx")
    d2 = _build(tmp_path_factory, animal_corpus, "wal_rl2_idx")
    pre = port_server(d2, port=0, updatable=True)
    pre.start_background()
    try:
        _post_path(pre, "/add", {"docs": ["a quokka is a smiling marsupial"]})
    finally:
        pre.shutdown()

    def size(d):
        p = os.path.join(d, "updates.wal")
        return os.path.getsize(p) if os.path.exists(p) else 0

    srv = port_server(d1, port=0, updatable=True)
    srv.start_background()
    try:
        size1 = size(d1)
        _post_path(srv, "/reload", {"index_dir": d2})
        assert _post(srv, {"queries": ["quokka"], "top_k": 1}
                     )["results"][0][0]["doc"] == 4
        _post_path(srv, "/delete", {"doc_ids": [4]})
        assert size(d1) == size1 and size(d2) > 0
    finally:
        srv.shutdown()


def test_wal_stale_generation_discarded_on_restart(tmp_path_factory,
                                                   animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "wal_stale_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial"]})
    finally:
        srv.shutdown()
    build_index(animal_corpus + ["a quokka is a smiling marsupial"],
                save_to=d, save_corpus=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        srv2 = port_server(d, port=0, updatable=True)
    assert any("base artifacts changed" in str(x.message) for x in w)
    srv2.start_background()
    try:
        assert "wal_replayed" not in srv2._handler.runtime.stats
        top = _post(srv2, {"queries": ["quokka"], "top_k": 1})["results"][0][0]
        assert top["doc"] == 4 and srv2._handler.runtime.engine.num_docs == 5
    finally:
        srv2.shutdown()


def test_reload_failure_keeps_old_wal(tmp_path_factory, animal_corpus):
    d1 = _build(tmp_path_factory, animal_corpus, "wal_rlf1_idx")
    d2 = _build(tmp_path_factory, animal_corpus, "wal_rlf2_idx")
    with open(os.path.join(d2, "updates.wal"), "w", encoding="utf-8") as f:
        f.write("garbage line\n")
        f.write('{"op": "delete", "doc_ids": [0]}\n')
    srv = port_server(d1, port=0, updatable=True)
    srv.start_background()
    try:
        code, _, _ = _request(srv, "/reload", {"index_dir": d2})
        assert code == 500
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial"]})
    finally:
        srv.shutdown()
    assert len(UpdateLog(d1).read_pending()) == 1
    srv2 = port_server(d1, port=0, updatable=True)
    srv2.start_background()
    try:
        assert _post(srv2, {"queries": ["quokka"], "top_k": 1}
                     )["results"][0][0]["doc"] == 4
    finally:
        srv2.shutdown()


def test_wal_poison_disables_mutations_not_search(tmp_path_factory,
                                                  animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "wal_poison_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        srv._wal_broken = True
        code, body, _ = _request(srv, "/add", {"docs": ["doomed doc"]})
        assert code == 500 and "update log" in body["error"]
        assert srv._handler.runtime.engine.num_docs == 4
        assert _post(srv, {"queries": ["cat"], "top_k": 1}
                     )["results"][0][0]["doc"] == 0
    finally:
        srv.shutdown()


def test_wal_crash_replay_fuzz(tmp_path_factory, animal_corpus):
    """Randomized kill/replay cycles: every acked mutation survives, no
    unacked record resurfaces (adds, deletes, in-memory and persisted
    compacts, a torn unacked tail)."""
    import random

    rng = random.Random(20260817)
    d = _build(tmp_path_factory, animal_corpus, "wal_fuzz_idx")
    model: dict[str, bool] = {}
    texts: dict[str, str] = {}
    n = 0

    def check(srv):
        for tok, alive in model.items():
            out = _post(srv, {"queries": [tok], "top_k": 1})
            hits = [it for it in out["results"][0] if it["score"] > 0]
            if alive:
                assert hits and hits[0]["text"] == texts[tok], tok
            else:
                assert not hits or hits[0]["text"] != texts[tok], tok

    for cycle in range(3):
        srv = port_server(d, port=0, updatable=True)
        srv.start_background()
        try:
            check(srv)
            for _ in range(10):
                r = rng.random()
                eng = srv._handler.runtime.engine
                if r < 0.5 or not any(model.values()):
                    tok = f"zq{n}x"
                    text = f"{tok} fuzz marker document number {n}"
                    n += 1
                    _post_path(srv, "/add", {"docs": [text]})
                    model[tok], texts[tok] = True, text
                elif r < 0.8 and eng.live_docs > 3:
                    tok = rng.choice([t for t, a in model.items() if a])
                    out = _post(srv, {"queries": [tok], "top_k": 1})
                    _post_path(srv, "/delete", {
                        "doc_ids": [out["results"][0][0]["doc"]]})
                    model[tok] = False
                elif r < 0.92:
                    _post_path(srv, "/compact", {})
                else:
                    _post_path(srv, "/compact", {"save_dir": d})
            check(srv)
        finally:
            srv.shutdown()
        if cycle == 1:
            with open(os.path.join(d, "updates.wal"), "a") as f:
                f.write('{"op": "add", "docs": ["never ack')
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        check(srv)
        assert any(model.values()) and not all(model.values())
    finally:
        srv.shutdown()


def test_compact_export_dir_keeps_served_wal(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "exp_src_idx")
    exp = str(tmp_path_factory.mktemp("exp_dst_idx"))
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial"]})
        assert _post_path(srv, "/compact", {"save_dir": exp}
                          )["saved_to"] == exp
        assert srv._index_dir == d and srv._wal.index_dir == d
        _post_path(srv, "/add", {"docs": ["a wombat digs square burrows"]})
        before = _post(srv, {"queries": ["quokka", "wombat"], "top_k": 1})
    finally:
        srv.shutdown()
    srv2 = port_server(d, port=0, updatable=True)
    srv2.start_background()
    try:
        assert _post(srv2, {"queries": ["quokka", "wombat"], "top_k": 1}
                     ) == before
    finally:
        srv2.shutdown()
    srv3 = port_server(exp, port=0, updatable=True)
    srv3.start_background()
    try:
        assert "wal_replayed" not in srv3._handler.runtime.stats
        assert _post(srv3, {"queries": ["quokka"], "top_k": 1}
                     )["results"][0][0]["score"] > 0
        assert srv3._handler.runtime.engine.live_docs == 5
    finally:
        srv3.shutdown()


def test_compact_apply_failure_poisons_mutations(tmp_path_factory,
                                                 animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "cfail_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial"]})

        def boom(*a, **k):
            raise RuntimeError("injected device build failure")

        orig = srv._make_runtime
        srv._make_runtime = boom
        assert _request(srv, "/compact", {})[0] == 500
        srv._make_runtime = orig
        assert srv._wal_broken is True
        assert _request(srv, "/add", {"docs": ["nope"]})[0] == 503
        _post_path(srv, "/reload", {})
        assert srv._wal_broken is False
        assert _post_path(srv, "/add", {"docs": ["a numbat eats termites"]}
                          )["status"] == "added"
        assert srv._handler.runtime.engine.delta_docs == 1
    finally:
        srv.shutdown()
    srv2 = port_server(d, port=0, updatable=True)
    srv2.start_background()
    try:
        out = _post(srv2, {"queries": ["quokka", "numbat"], "top_k": 1})
        assert out["results"][0][0]["score"] > 0
        assert out["results"][1][0]["score"] > 0
        assert srv2._handler.runtime.engine.delta_docs == 1
    finally:
        srv2.shutdown()


def test_compact_out_of_memory_is_a_500(tmp_path_factory, animal_corpus):
    """torch.OutOfMemoryError subclasses RuntimeError: a rebuild that runs
    out of device memory answers 500 (not retryable), not 503."""
    import torch

    assert issubclass(torch.OutOfMemoryError, RuntimeError)
    d = _build(tmp_path_factory, animal_corpus, "coom_idx")
    srv = port_server(d, port=0, updatable=True)
    srv.start_background()
    try:
        def oom(*a, **k):
            raise torch.OutOfMemoryError("CUDA out of memory")

        srv._make_runtime = oom
        code, body, _ = _request(srv, "/compact", {})
        assert code == 500 and "out of memory" in body["error"]
        assert _healthz(srv)["metrics"]["errors"] == 1
    finally:
        srv.shutdown()


# -- auto-compaction ------------------------------------------------------------


def test_auto_compact_requires_updatable(animal_dir):
    with pytest.raises(ValueError, match="updatable"):
        port_server(animal_dir, port=0, auto_compact=True)


def test_auto_compact_folds_delta(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "ac_idx")
    srv = port_server(d, port=0, updatable=True, auto_compact=True,
                      auto_compact_interval_s=0.05,
                      auto_compact_delta_docs=2)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial",
                                          "a wombat digs square scat burrows",
                                          "a numbat eats termites all day"]})
        deadline = time.monotonic() + 30
        h = None
        while time.monotonic() < deadline:
            h = _healthz(srv)
            if h.get("updates", {}).get("delta_docs") == 0:
                break
            time.sleep(0.05)
        assert h["updates"]["delta_docs"] == 0, h
        assert h["updates"]["live_docs"] == 7
        assert h["updates"]["auto_compact"] is True
        assert h["metrics"]["compactions"] >= 1
        assert UpdateLog(d).read_pending() == []
        top = _post(srv, {"queries": ["numbat"], "top_k": 1})["results"][0][0]
        assert top["score"] > 0 and "termites" in top["text"]
    finally:
        srv.shutdown()
    srv2 = port_server(d, port=0, updatable=True)
    srv2.start_background()
    try:
        assert "wal_replayed" not in srv2._handler.runtime.stats
        assert _healthz(srv2)["updates"]["live_docs"] == 7
    finally:
        srv2.shutdown()


def test_auto_compact_failure_warns_once_and_serving_survives(
        tmp_path_factory, animal_corpus, capsys):
    d = _build(tmp_path_factory, animal_corpus, "ac_fail_idx",
               save_corpus=False)
    srv = port_server(d, port=0, updatable=True, auto_compact=True,
                      auto_compact_interval_s=0.05,
                      auto_compact_delta_docs=1)
    srv.start_background()
    try:
        _post_path(srv, "/add", {"docs": ["a quokka is a smiling marsupial",
                                          "a wombat digs square scat burrows"]})
        time.sleep(0.6)  # several intervals: must attempt once, then hold
        h = _healthz(srv)
        assert h["updates"]["delta_docs"] == 2
        assert h["metrics"]["compactions"] == 0
        assert _post(srv, {"queries": ["quokka"], "top_k": 1}
                     )["results"][0][0]["score"] > 0
    finally:
        srv.shutdown()
    assert capsys.readouterr().out.count("auto-compaction failed") == 1


# -- result cache -----------------------------------------------------------------


def test_result_cache_serves_repeats_and_counts(tmp_path_factory,
                                                animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "idx_rcache")
    srv = port_server(d, port=0, result_cache=8)
    srv.start_background()
    try:
        q = {"queries": ["does the fish purr like a cat"], "top_k": 2}
        first = _post(srv, q)
        assert _post(srv, q) == first
        rc = _healthz(srv)["result_cache"]
        assert rc["hits"] == 1 and rc["misses"] == 1 and rc["entries"] == 1
        assert len(_post(srv, {"queries": q["queries"], "top_k": 1}
                         )["results"][0]) == 1
        _post(srv, {"queries": [{"cat": 2.0}], "top_k": 1})
        assert _healthz(srv)["result_cache"]["entries"] == 2
        _post_path(srv, "/reload", {})
        rc3 = _healthz(srv)["result_cache"]
        assert rc3["entries"] == 0 and rc3["hits"] == 0
    finally:
        srv.shutdown()


def test_result_cache_cleared_by_mutations(tmp_path_factory, animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "idx_rcache_mut")
    srv = port_server(d, port=0, updatable=True, result_cache=8)
    srv.start_background()
    try:
        q = {"queries": ["purr"], "top_k": 4}
        base = _post(srv, q)
        new_id = _post_path(srv, "/add", {
            "docs": ["a second cat likes to purr"]})["doc_ids"][0]
        after = _post(srv, q)
        assert new_id in [it["doc"] for it in after["results"][0]]
        assert after != base
        _post_path(srv, "/delete", {"doc_ids": [new_id]})
        gone = _post(srv, q)
        assert new_id not in [i["doc"] for i in gone["results"][0]]
    finally:
        srv.shutdown()


def test_result_cache_lru_and_batch_semantics():
    c = ResultCache(2)
    c.put(("a", 1, True), ["ra"])
    c.put(("b", 1, True), ["rb"])
    assert c.lookup_batch([("a", 1, True)]) == [["ra"]]
    assert c.lookup_batch([("a", 1, True), ("c", 1, True)]) is None
    s = c.stats()
    assert s["hits"] == 1 and s["misses"] == 1
    c.put(("c", 1, True), ["rc"])
    assert c.lookup_batch([("b", 1, True)]) is None
    assert c.lookup_batch([("a", 1, True), ("c", 1, True)]) == [["ra"], ["rc"]]


def test_result_cache_composes_with_microbatcher(tmp_path_factory,
                                                 animal_corpus):
    d = _build(tmp_path_factory, animal_corpus, "idx_rcache_mb")
    srv = port_server(d, port=0, batch_window_ms=2.0, result_cache=8)
    srv.start_background()
    try:
        q = {"queries": ["does the fish purr like a cat"], "top_k": 2}
        first = _post(srv, q)
        assert _post(srv, q) == first
        h = _healthz(srv)
        assert h["result_cache"]["hits"] == 1
        assert h["metrics"]["requests"] >= 2
        assert srv.batcher.rows_run == 1  # the batcher saw the miss only
    finally:
        srv.shutdown()

