"""HTTP serving daemon for a loaded BM25 index.

The port's copy of ``bm25_tpu/serve.py``: the same routes, JSON bodies,
limits, micro-batcher, write-ahead log, reload modes and drain, serving
the port's engines on the device of the ``Session`` passed in
``engine_kwargs`` (``Server(dir, engine_kwargs={"session":
Session("cpu")})``; by default the CUDA session).  ``device_checkpoint=``
restores the engine from the port's device checkpoint
(``index/device_checkpoint.py``) onto that session's device.

The reference is script-only (no server — SURVEY.md section 0); production
deployment needs a long-lived process with the index resident on device.
Stdlib-only JSON-over-HTTP:

    POST /search   {"queries": ["text", ...], "top_k": 10}
                -> {"results": [[{"doc": id, "score": s, "text": ...}]]}
                   a query may also be a {term: weight, ...} object —
                   weighted retrieval (query expansion), scored on device;
                   "include_scores": false returns rankings only (skips
                   the device->host score transfer where supported);
                   "filter_ids": [id, ...] restricts results to that doc
                   allowlist (filtered search, exact on-device masking;
                   rows end early when fewer docs are eligible than top_k).
                   With --result-cache N, repeat plain-string queries are
                   served from a per-query LRU without touching the device
                   (invalidated on reload and on every live mutation)
    POST /explain  {"query": "text" | {term: weight}, "doc_id": N}
                -> per-term score breakdown for that (query, doc) pair
                   (scoring.explain_score; host-side, no device work).
                   409 when no host index matches the served docs
                   (updatable or device-checkpoint serving)
    POST /reload   {"index_dir": "...", "mode": "auto"|"swap"|"drop"}
                   (both optional; dir defaults to the served dir) — load
                   the index fresh and swap the engine atomically;
                   in-flight requests finish on the old engine.  mode
                   "auto" (default) builds the new engine side-by-side
                   (zero downtime) when old+new fit the device budget, else
                   releases the old engine first (brief 503+Retry-After
                   window); response reports the decided mode + sizing
    POST /add      {"docs": ["text", ...]}        (updatable=True only)
                -> {"doc_ids": [...]} — live adds via a host delta segment
                   scored with frozen base statistics (index/updates.py);
                   new docs and new TERMS are searchable immediately
    POST /delete   {"doc_ids": [id, ...]}         (updatable=True only)
                   tombstones; deleted docs stop appearing at once
    POST /compact  {"save_dir": "..."} (optional) (updatable=True only)
                   rebuild one fresh base segment from the live corpus
                   (ids reassigned, scores current-corpus-exact again)

Durability (updatable=True): every acked mutation is fsynced to an
append-only write-ahead log (<index_dir>/updates.wal) before the 200, and
replayed on the next start — a kill between compactions loses nothing
that was acknowledged.  A compact with ``save_dir`` folds the log into
the persisted base and truncates it (index/updates.py::UpdateLog).
    GET  /healthz  -> {"status": "ok", "num_docs": N, ...}

Batched: each request's queries run as one device batch.  With
``batch_window_ms > 0`` a :class:`MicroBatcher` additionally coalesces
queries from *concurrent* requests that arrive within the window into one
device dispatch (admission control), so many small clients share the
throughput of one large batch instead of serializing per-request launches.

Robustness: request-size caps (body bytes, queries/request, terms/query),
a per-request timeout, a bounded pending queue that answers 429 when the
device can't keep up, and graceful drain on SIGTERM (stop accepting, let
in-flight batches finish, then exit).  Start with
``bm25-tpu-torch serve <index_dir>`` or ``Server(...).serve_forever()``.
"""

from __future__ import annotations

import json
import math
import queue
import signal
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


@dataclass(frozen=True)
class ServeLimits:
    """Request admission caps; one frozen object so a snapshot is atomic."""

    max_body_bytes: int = 1 << 20          # 1 MiB request body
    max_queries: int = 1024                # queries per request
    max_terms: int = 256                   # terms per query
    max_top_k: int = 16384
    request_timeout_s: float = 60.0        # wall clock per request
    max_pending_rows: int = 8192           # bounded batcher queue -> 429
    max_add_docs: int = 1024               # docs per /add request
    max_doc_chars: int = 1 << 20           # chars per added doc
    max_filter_ids: int = 1 << 20          # allowlist ids per /search
    socket_timeout_s: float = 75.0         # per-connection socket I/O bound


@dataclass
class EngineRuntime:
    """Everything a request needs, swapped as ONE reference on hot reload.

    Handlers snapshot ``self.runtime`` once per request, so a concurrent
    reload can never mix the old engine with the new vocab (or vice versa).
    """

    engine: object
    tokenizer: object
    vocab: dict
    corpus: object | None
    stats: dict = field(default_factory=dict)
    # host ScoredIndex backing /explain; None when no host CSC matches the
    # served docs (updatable serving: adds/compaction remap ids past the
    # base index)
    index: object | None = None
    # optional per-query LRU over assembled result rows (--result-cache):
    # lives ON the runtime so a hot reload naturally drops it with the
    # old engine; live mutations clear it explicitly (_do_update)
    result_cache: "ResultCache | None" = None


class ResultCache:
    """Thread-safe LRU over assembled /search result rows.

    Key = (query string, top_k, include_scores); value = the JSON-ready
    row (docs + scores + texts).  Repeat queries skip tokenization, the
    device step, and the corpus reads entirely — the standard result
    cache every production search tier runs in front of the index (no
    reference counterpart: ``reference/main.py`` is single-shot).

    Only plain string queries cache (weighted dicts and filtered
    requests bypass: per-request masks/weights explode the key space for
    near-zero repeat probability).  Staleness cannot occur: the cache
    rides the runtime (reload swaps it away), every acked mutation
    clears it before the 200 (serve.Server._do_update), and ``clear()``
    bumps ``generation``: a search records the generation before it
    looks its keys up and passes it to ``put``, which drops rows computed
    before a clear (a search racing an /add or /delete would otherwise
    store a pre-mutation row after the clear).
    """

    def __init__(self, max_entries: int):
        from collections import OrderedDict

        self.max_entries = int(max_entries)
        self._d = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.generation = 0  # bumped by clear()

    def get(self, key):
        with self._lock:
            row = self._d.get(key)
            if row is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return row

    def lookup_batch(self, keys) -> list | None:
        """All-or-nothing batch lookup: the engine call is per-batch, so a
        partial hit recomputes everything anyway — only a full hit skips
        the device.  Counters reflect that (a partial hit is counted as
        misses for the rows that were absent, not as phantom hits)."""
        with self._lock:
            rows = [self._d.get(k) for k in keys]
            absent = sum(r is None for r in rows)
            if absent:
                self.misses += absent
                return None
            for k in keys:
                self._d.move_to_end(k)
            self.hits += len(keys)
            return rows

    def put(self, key, row, generation: int | None = None) -> None:
        """Store ``row``; with ``generation`` (read before the lookup that
        missed) a row computed before a later ``clear()`` is dropped."""
        with self._lock:
            if generation is not None and generation != self.generation:
                return
            self._d[key] = row
            self._d.move_to_end(key)
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.generation += 1

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._d), "capacity": self.max_entries,
                    "hits": self.hits, "misses": self.misses}


class CorpusView:
    """Read view over base corpus + live-added texts (updatable serving).

    Base docs come from the loaded corpus (an :class:`MMapCorpus` or a
    list); docs added through ``POST /add`` land in an in-memory overlay.
    Doc ids are global engine ids: ``[0, base_len)`` reads the base,
    onward reads the overlay.  A missing base (index saved without a
    corpus) degrades to empty text rather than failing the response.
    """

    def __init__(self, base, extra: list | None = None,
                 base_len: int | None = None):
        self.base = base
        # base_len is the engine's base doc count — the id offset of the
        # overlay.  With no base corpus it must still equal the engine's
        # base_num_docs (pass it explicitly) or added docs' texts would be
        # looked up at the wrong overlay position.
        self.base_len = (len(base) if base is not None
                         else int(base_len or 0))
        self.extra = list(extra or [])

    def __len__(self) -> int:
        return self.base_len + len(self.extra)

    def __getitem__(self, i: int):
        if i < self.base_len:
            return self.base[i] if self.base is not None else {"text": ""}
        j = i - self.base_len
        if j < len(self.extra):
            return self.extra[j]
        return {"text": ""}

    def append_texts(self, texts: list[str]) -> None:
        self.extra.extend({"text": t} for t in texts)

    def live_texts(self, live_mask) -> list[str]:
        """Texts of every live doc, in global id order (compaction input)."""
        live_ids = [i for i, alive in enumerate(live_mask) if alive]
        base_ids = [i for i in live_ids if i < self.base_len]
        if self.base is not None and hasattr(self.base, "batch"):
            base_docs = self.base.batch(base_ids)  # one file pass
        else:
            base_docs = [self[i] for i in base_ids]
        out = [d.get("text", "") for d in base_docs]
        out.extend(
            self[i].get("text", "") for i in live_ids if i >= self.base_len
        )
        return out


class ServerMetrics:
    """Thread-safe request/latency/batch-occupancy counters for /healthz.

    Latency percentiles are computed over a sliding window of the most
    recent requests (default 4096) so long-running servers report current
    behavior, not lifetime averages.
    """

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self.requests = 0
        self.queries = 0
        self.errors = 0
        self.rejected = 0  # 429s (queue full) + 504s (timeout)
        self.reloads = 0
        self.compactions = 0  # auto-compactions (manual /compact excluded)
        self._lat = deque(maxlen=window)

    def record(self, n_queries: int, seconds: float) -> None:
        with self._lock:
            self.requests += 1
            self.queries += n_queries
            self._lat.append(seconds)

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_reload(self) -> None:
        with self._lock:
            self.reloads += 1

    def record_compaction(self) -> None:
        with self._lock:
            self.compactions += 1

    def snapshot(self, batcher=None) -> dict:
        with self._lock:
            lat = list(self._lat)
            out = {
                "requests": self.requests,
                "queries": self.queries,
                "errors": self.errors,
                "rejected": self.rejected,
                "reloads": self.reloads,
                "compactions": self.compactions,
            }
        if lat:
            arr = np.asarray(lat)
            out["latency_ms"] = {
                "p50": round(float(np.percentile(arr, 50)) * 1e3, 2),
                "p90": round(float(np.percentile(arr, 90)) * 1e3, 2),
                "p99": round(float(np.percentile(arr, 99)) * 1e3, 2),
            }
        if batcher is not None:
            out["batches_run"] = batcher.batches_run
            out["batch_occupancy"] = round(
                batcher.rows_run / max(batcher.batches_run, 1), 2
            )
            out["pending_rows"] = batcher.pending_rows
        return out


class QueueFullError(RuntimeError):
    """Pending-row cap reached; the caller should answer 429."""


class MicroBatcher:
    """Cross-request micro-batching for a shared device engine.

    ``search()`` blocks the calling (request handler) thread; a single
    collector thread drains the queue, waits up to ``window_ms`` after the
    first arrival for companions (or until ``max_rows`` queries are
    pending), groups by (top_k, engine) and pads query matrices to a
    common width and runs ONE ``engine.search`` per group.  An idle server
    keeps the request = batch behavior (the window only opens when a
    request is already in hand, so a lone request pays at most
    ``window_ms`` extra).

    Back-pressure: admission is bounded by ``max_pending_rows`` — when the
    device falls behind, ``search`` raises :class:`QueueFullError`
    immediately instead of queueing unboundedly.  A per-call ``timeout``
    bounds the total wait; an expired item is skipped by the collector
    (its event carries a TimeoutError).
    """

    _SENTINEL = object()

    def __init__(self, engine, window_ms: float = 2.0, max_rows: int = 2048,
                 max_pending_rows: int = 8192):
        self.engine = engine  # default engine; per-item override on reload
        self.window = window_ms / 1e3
        self.max_rows = max_rows
        self.max_pending_rows = max_pending_rows
        self.batches_run = 0
        self.rows_run = 0
        self.pending_rows = 0
        self._pending_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._draining = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="bm25-microbatcher", daemon=True
        )
        self._thread.start()

    def search(self, ids: np.ndarray, top_k: int,
               weights: np.ndarray | None = None,
               engine=None, timeout: float | None = None):
        """Submit one request's (n, T) query matrix; blocks until scored.

        Raises :class:`QueueFullError` when ``max_pending_rows`` queries
        are already waiting, and :class:`TimeoutError` when ``timeout``
        seconds elapse before the batch containing this item runs.
        """
        if self._draining.is_set():
            raise QueueFullError("server is draining")
        n = len(ids)
        with self._pending_lock:
            if self.pending_rows + n > self.max_pending_rows:
                raise QueueFullError(
                    f"{self.pending_rows} queries already pending "
                    f"(cap {self.max_pending_rows})"
                )
            self.pending_rows += n
        item = {"ids": ids, "w": weights, "k": int(top_k),
                "engine": engine if engine is not None else self.engine,
                "deadline": (time.monotonic() + timeout) if timeout else None,
                "ev": threading.Event(), "out": None}
        self._q.put(item)
        # poll the collector's liveness so a dead thread can't strand waiters
        while not item["ev"].wait(timeout=1.0):
            if not self._thread.is_alive():
                raise RuntimeError("MicroBatcher collector thread died")
        if isinstance(item["out"], Exception):
            raise item["out"]
        return item["out"]

    def admit_rows(self, n: int) -> None:
        """Reserve ``n`` rows of device capacity for a DIRECT dispatch
        (filtered searches bypass the batch queue but must share its
        admission cap, or a burst of per-request-mask searches queues
        unbounded concurrent device work the plain path would 429)."""
        if self._draining.is_set():
            raise QueueFullError("server is draining")
        with self._pending_lock:
            if self.pending_rows + n > self.max_pending_rows:
                raise QueueFullError(
                    f"{self.pending_rows} queries already pending "
                    f"(cap {self.max_pending_rows})"
                )
            self.pending_rows += n

    def release_rows(self, n: int) -> None:
        with self._pending_lock:
            self.pending_rows -= n

    def drain(self, timeout: float = 30.0) -> None:
        """Stop admitting, finish everything queued, stop the collector."""
        self._draining.set()
        self._q.put(self._SENTINEL)
        self._thread.join(timeout=timeout)

    def close(self):
        self.drain(timeout=10)

    # internal -----------------------------------------------------------

    def _loop(self):
        while True:
            first = self._q.get()
            if first is self._SENTINEL:
                self._flush_remaining()
                return
            batch = [first]
            rows = len(first["ids"])
            deadline = time.monotonic() + self.window
            stop = False
            while rows < self.max_rows:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is self._SENTINEL:
                    stop = True
                    break
                batch.append(item)
                rows += len(item["ids"])
            self._flush(batch)
            # flushed items hold their engine: drop them before blocking
            # on the queue, or a drop-mode reload's old engine stays alive
            # through this frame until the next request arrives
            batch = first = item = None
            if stop:
                self._flush_remaining()
                return

    def _flush_remaining(self):
        """Drain path: run whatever is still queued, then exit."""
        leftover = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not self._SENTINEL:
                leftover.append(item)
        if leftover:
            self._flush(leftover)

    def _flush(self, batch):
        now = time.monotonic()
        live = []
        for it in batch:
            if it["deadline"] is not None and now > it["deadline"]:
                it["out"] = TimeoutError(
                    "request timed out waiting for a device batch"
                )
                self._finish(it)
            else:
                live.append(it)
        by_group: dict[tuple, list] = {}
        for it in live:
            by_group.setdefault((it["k"], id(it["engine"])), []).append(it)
        for (k, _), items in by_group.items():
            try:
                self._run_group(items[0]["engine"], k, items)
            except ValueError:
                # one bad REQUEST must not poison its co-batched neighbors
                # (e.g. a ValueError for negative weights would otherwise
                # reach every waiter in the group): retry each item alone
                # so only the offending request(s) observe the failure.
                # ONLY request-fault errors retry — an infrastructure
                # failure (device OOM, transport error) must not amplify
                # into N sequential calls against an unhealthy device
                for it in items:
                    try:
                        self._run_group(it["engine"], k, [it])
                    except Exception as e:
                        it["out"] = e
            except Exception as e:
                for it in items:
                    if it["out"] is None:
                        it["out"] = e
            finally:
                for it in items:
                    self._finish(it)

    def _run_group(self, engine, k, items):
        t_max = max(it["ids"].shape[1] for it in items)
        mats = [
            np.pad(
                it["ids"],
                ((0, 0), (0, t_max - it["ids"].shape[1])),
                constant_values=-1,
            )
            for it in items
        ]
        ids = np.concatenate(mats, axis=0)
        if any(it.get("w") is not None for it in items):
            # mixed batch: plain queries ride the weighted path
            # with unit weights (identical scores)
            wmats = []
            for it in items:
                w = it.get("w")
                if w is None:
                    w = (it["ids"] >= 0).astype(np.float32)
                wmats.append(np.pad(
                    w, ((0, 0), (0, t_max - w.shape[1]))
                ))
            weights = np.concatenate(wmats, axis=0)
            docs, scores = engine.search(ids, top_k=k, weights=weights)
        else:
            docs, scores = engine.search(ids, top_k=k)
        self.batches_run += 1
        self.rows_run += len(ids)
        off = 0
        for it in items:
            n = len(it["ids"])
            it["out"] = (docs[off: off + n], scores[off: off + n])
            off += n

    def _finish(self, item):
        if not item["ev"].is_set():
            with self._pending_lock:
                self.pending_rows -= len(item["ids"])
            item["ev"].set()


def _call_with_timeout(fn, timeout_s: float, what: str):
    """Run ``fn`` in a worker thread, bounded by ``timeout_s`` wall clock.

    On timeout the worker keeps running to completion (its compile/search
    work is not abandonable mid-dispatch — same semantics as a timed-out
    micro-batcher waiter) but the request answers 504 instead of hanging
    a handler thread for an unbounded cold compile.
    """
    out: list = [None]
    err: list = [None]

    def run():
        try:
            out[0] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in caller
            err[0] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if t.is_alive():
        raise TimeoutError(
            f"{what} exceeded the {timeout_s:.0f}s request timeout (a "
            "first-use shape compile may still be in progress; retry)"
        )
    if err[0] is not None:
        raise err[0]
    return out[0]


def _validate_request(req: dict, limits: ServeLimits):
    """Parse + bound-check one /search body; returns (queries, top_k, incl)."""
    queries = req.get("queries")
    if not isinstance(queries, list) or not queries:
        raise ValueError(
            "'queries' must be a non-empty list of strings or "
            "{term: weight} objects"
        )
    if len(queries) > limits.max_queries:
        raise ValueError(
            f"{len(queries)} queries exceeds the per-request cap of "
            f"{limits.max_queries}"
        )
    for q in queries:
        if not isinstance(q, (str, dict)):
            raise ValueError(
                "each query must be a string or a {term: weight} object"
            )
        if isinstance(q, dict):
            if len(q) > limits.max_terms:
                raise ValueError(
                    f"query has {len(q)} terms; cap is {limits.max_terms}"
                )
            for wt in q.values():
                w = float(wt)  # raises ValueError on junk
                # json.loads accepts NaN/Infinity literals; a NaN weight
                # slips past the engine's negative-weight check (NaN < 0 is
                # False) and would 200 with garbage rankings
                if not math.isfinite(w):
                    raise ValueError(
                        f"query weight {w!r} is not finite"
                    )
        elif len(q) > limits.max_terms * 64:  # generous: chars, not terms
            raise ValueError("query string too long")
    top_k = int(req.get("top_k", 10))
    if top_k < 1:
        raise ValueError("'top_k' must be >= 1")
    if top_k > limits.max_top_k:
        raise ValueError(
            f"'top_k' {top_k} exceeds the cap of {limits.max_top_k}"
        )
    include_scores = bool(req.get("include_scores", True))
    return queries, top_k, include_scores


class BM25RequestHandler(BaseHTTPRequestHandler):
    # set by Server
    runtime: EngineRuntime = None
    limits: ServeLimits = ServeLimits()
    batcher = None  # optional MicroBatcher
    metrics = None  # ServerMetrics
    server_ref = None  # back-pointer for /reload

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code == 503:
            # every 503 here is the retryable kind (drop-mode reload /
            # rebuild window: the host load and the device build);
            # standard clients and load balancers honor Retry-After
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def do_GET(self):
        if self.path.startswith("/healthz"):
            rt = self.runtime
            payload = {"status": "ok", **(rt.stats or {})}
            if (rt.stats or {}).get("updatable") and rt.engine is not None:
                eng = rt.engine
                srv = self.server_ref
                payload["updates"] = {
                    "live_docs": eng.live_docs,
                    "delta_docs": eng.delta_docs,
                    "deleted_docs": eng.deleted_docs,
                    # judged against the server's CONFIGURED thresholds —
                    # the hard-coded defaults would tell an operator
                    # "needs_compaction: false" while a tightly-configured
                    # auto-compact loop is churning
                    "needs_compaction": (
                        srv._needs_compaction(eng) if srv is not None
                        else eng.needs_compaction()
                    ),
                    "auto_compact": bool(
                        srv is not None and srv._auto_compact
                    ),
                }
            if self.metrics is not None:
                payload["metrics"] = self.metrics.snapshot(self.batcher)
            if rt.result_cache is not None:
                payload["result_cache"] = rt.result_cache.stats()
            if "deep=1" in self.path:
                from bm25_tpu_torch.runtime.health import device_probe, engine_probe

                srv = self.server_ref
                if (srv is not None
                        and getattr(srv, "last_warmup_breakdown", None)):
                    payload["warmup_breakdown"] = srv.last_warmup_breakdown
                dev = device_probe(_engine_device(
                    rt.engine, srv._engine_kwargs if srv is not None
                    else None))
                eng = engine_probe(rt.engine)
                payload["device_probe"] = dev.as_dict()
                payload["engine_probe"] = eng.as_dict()
                if not (dev.ok and eng.ok):
                    payload["status"] = "unhealthy"
                    self._send(503, payload)
                    return
            self._send(200, payload)
        else:
            self._send(404, {"error": "not found"})

    def _discard_body(self) -> None:
        """Read and drop the request body.  Every answer given before the
        body is read calls this first: closing a socket that still holds
        unread bytes resets the connection, and the client may then never
        read the answer (a 503 in a drop-mode reload window, a 400)."""
        remaining = int(self.headers.get("Content-Length", 0))
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 16))
            if not chunk:
                break
            remaining -= len(chunk)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length > self.limits.max_body_bytes:
            self._discard_body()
            raise ValueError(
                f"request body {length} bytes exceeds the cap of "
                f"{self.limits.max_body_bytes}"
            )
        body = json.loads(self.rfile.read(length) or b"{}")
        if not isinstance(body, dict):
            # every endpoint reads fields via .get(); a top-level list/str/
            # number would otherwise escape as AttributeError (conn reset)
            raise ValueError("request body must be a JSON object")
        return body

    def do_POST(self):
        if self.path == "/reload":
            self._do_reload()
            return
        if self.path in ("/add", "/delete", "/compact"):
            self._do_update()
            return
        if self.path == "/explain":
            self._do_explain()
            return
        if self.path != "/search":
            self._discard_body()
            self._send(404, {"error": "not found"})
            return
        srv = self.server_ref
        if srv is not None:
            # count this thread against drop-mode quiescence: it is about
            # to snapshot the runtime, and that local reference keeps the
            # old engine's device buffers alive until the handler returns
            srv._inflight_enter()
        try:
            self._do_search()
        finally:
            if srv is not None:
                srv._inflight_exit()

    def _do_explain(self):
        """POST /explain {"query": str | {term: weight}, "doc_id": N} —
        per-term score breakdown (host-side; never touches the device)."""
        rt = self.runtime
        try:
            req = self._read_body()
            query = req.get("query")
            # reuse the /search query validation (type/term/weight caps)
            _validate_request(
                {"queries": [query], "top_k": 1}, self.limits
            )
            doc_id = req.get("doc_id")
            if not isinstance(doc_id, int) or isinstance(doc_id, bool):
                raise ValueError("'doc_id' must be an integer")
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        if rt.engine is None:
            # a mode="drop" reload is rebuilding the runtime: retryable,
            # unlike the permanent 409 below (the stub runtime also has
            # index=None, which would misreport this window as permanent)
            self._send(503, {"error": "index reloading; retry shortly"})
            return
        if rt.index is None:
            self._send(409, {"error": (
                "explain unavailable: no host index matches the served "
                "docs (updatable or device-checkpoint serving)"
            )})
            return
        from bm25_tpu_torch.scoring import explain_score

        t0 = time.monotonic()
        try:
            out = explain_score(rt.index, rt.tokenizer, query, doc_id)
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return
        if self.metrics is not None:
            self.metrics.record(1, time.monotonic() - t0)
        self._send(200, out)

    def _do_search(self):
        rt = self.runtime  # one snapshot: engine+vocab+corpus stay coherent
        if rt.engine is None:
            # a mode="drop" reload is rebuilding the engine
            self._discard_body()
            self._send(503, {"error": "index reloading; retry shortly"})
            return
        try:
            req = self._read_body()
            queries, top_k, include_scores = _validate_request(
                req, self.limits
            )
            fmask = None
            filter_ids = req.get("filter_ids")
            if filter_ids is not None:
                if (not isinstance(filter_ids, list) or not filter_ids
                        or not all(isinstance(i, int)
                                   and not isinstance(i, bool)
                                   for i in filter_ids)):
                    # NB bool: isinstance(True, int) is True in Python —
                    # [true, false] would silently filter to docs 1 and 0
                    raise ValueError(
                        "'filter_ids' must be a non-empty list of doc ids"
                    )
                if len(filter_ids) > self.limits.max_filter_ids:
                    raise ValueError(
                        f"{len(filter_ids)} filter ids exceeds the cap of "
                        f"{self.limits.max_filter_ids}"
                    )
                n = rt.engine.num_docs
                ids_arr = np.asarray(filter_ids, dtype=np.int64)
                if int(ids_arr.min()) < 0 or int(ids_arr.max()) >= n:
                    raise ValueError(
                        f"filter id out of range [0, {n})"
                    )
                fmask = np.zeros(n, dtype=bool)
                fmask[ids_arr] = True
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return

        t0 = time.monotonic()
        cache = rt.result_cache
        cache_keys = None
        if (cache is not None and fmask is None
                and all(isinstance(q, str) for q in queries)):
            cache_keys = [(q, top_k, include_scores) for q in queries]
            cache_gen = cache.generation  # before the lookup (put drops
            # rows a racing mutation's clear made stale)
            rows = cache.lookup_batch(cache_keys)
            if rows is not None:
                if self.metrics is not None:
                    self.metrics.record(len(queries),
                                        time.monotonic() - t0)
                self._send(200, {"results": rows})
                return
        try:
            weighted = any(isinstance(q, dict) for q in queries)
            if weighted:
                ids, wts = rt.tokenizer.tokenize_weighted_queries(
                    queries, rt.vocab
                )
            else:
                ids = rt.tokenizer.tokenize_queries(queries, rt.vocab)
                wts = None
            if (rt.stats or {}).get("updatable"):
                # a racing /add grows the vocab BEFORE its engine state
                # swaps in; a query tokenized against the grown vocab must
                # not 400 on "token id out of range" — ids the engine can't
                # see yet have no postings anywhere, so mask them to pad
                oov = ids >= rt.engine.vocab_size
                if oov.any():
                    ids = np.where(oov, np.int32(-1), ids)
                    if wts is not None:
                        wts = np.where(oov, np.float32(0.0), wts)
            search_ids = getattr(rt.engine, "search_ids", None)
            if fmask is not None:
                # per-request masks cannot co-batch (the mask would apply
                # to the neighbors too): dispatch directly, not via the
                # micro-batcher — but under the same wall-clock bound (a
                # first use may build the kernels: nvcc) and the same
                # admission cap (a timed-out worker keeps running, so its
                # rows stay reserved until the device work finishes)
                batcher = self.batcher
                srv = self.server_ref
                if batcher is not None:
                    batcher.admit_rows(len(ids))
                if srv is not None:
                    # the worker outlives a timed-out handler and keeps a
                    # runtime reference; count it against quiescence until
                    # the device work actually finishes
                    srv._inflight_enter()

                def _masked():
                    try:
                        if not include_scores and search_ids is not None:
                            return search_ids(ids, top_k=top_k, weights=wts,
                                              doc_mask=fmask), None
                        return rt.engine.search(ids, top_k=top_k,
                                                weights=wts, doc_mask=fmask)
                    finally:
                        if batcher is not None:
                            batcher.release_rows(len(ids))
                        if srv is not None:
                            srv._inflight_exit()

                docs, scores = _call_with_timeout(
                    _masked, self.limits.request_timeout_s,
                    "filtered search",
                )
            elif self.batcher is not None:
                docs, scores = self.batcher.search(
                    ids, top_k=top_k, weights=wts, engine=rt.engine,
                    timeout=self.limits.request_timeout_s,
                )
            elif not include_scores and search_ids is not None:
                # rankings-only: skip the score transfer entirely
                docs, scores = search_ids(ids, top_k=top_k, weights=wts), None
            elif wts is None:
                docs, scores = rt.engine.search(ids, top_k=top_k)
            else:
                docs, scores = rt.engine.search(ids, top_k=top_k,
                                                weights=wts)
        except QueueFullError as e:
            if self.metrics is not None:
                self.metrics.record_rejected()
            self.send_response(429)
            self.send_header("Retry-After", "1")
            body = json.dumps({"error": str(e)}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        except TimeoutError as e:
            if self.metrics is not None:
                self.metrics.record_rejected()
            self._send(504, {"error": str(e)})
            return
        except ValueError as e:
            # engine-level request validation (e.g. negative weights on a
            # tail-tier engine, out-of-range ids): the client's fault, not
            # a server error — don't pollute the error metrics
            self._send(400, {"error": str(e)})
            return
        except Exception as e:
            if self.metrics is not None:
                self.metrics.record_error()
            self._send(500, {"error": str(e)})
            return
        if self.metrics is not None:
            self.metrics.record(len(queries), time.monotonic() - t0)
        results = []
        for qi in range(len(queries)):
            row = []
            for ri, d in enumerate(docs[qi]):
                if int(d) < 0:
                    # filtered search with fewer eligible docs than top_k:
                    # the row just ends early
                    continue
                item = {"doc": int(d)}
                if scores is not None and include_scores:
                    item["score"] = float(scores[qi][ri])
                if rt.corpus is not None:
                    item["text"] = rt.corpus[int(d)].get("text", "")
                row.append(item)
            results.append(row)
        if cache_keys is not None:
            for key, row in zip(cache_keys, results):
                cache.put(key, row, generation=cache_gen)
        self._send(200, {"results": results})

    def _do_update(self):
        """POST /add | /delete | /compact — live index mutation."""
        rt = self.runtime
        if (self.server_ref is None or rt.engine is None
                or not (rt.stats or {}).get("updatable")):
            self._discard_body()
        if self.server_ref is None:
            self._send(500, {"error": "updates unavailable"})
            return
        if not (rt.stats or {}).get("updatable"):
            self._send(400, {
                "error": "server is not updatable; start with --updatable"
            })
            return
        if rt.engine is None:
            self._send(503, {"error": "index rebuilding; retry shortly"})
            return
        try:
            req = self._read_body()
            if self.path == "/add":
                docs = req.get("docs")
                if (not isinstance(docs, list) or not docs
                        or not all(isinstance(d, str) for d in docs)):
                    raise ValueError(
                        "'docs' must be a non-empty list of strings"
                    )
                if len(docs) > self.limits.max_add_docs:
                    raise ValueError(
                        f"{len(docs)} docs exceeds the per-request cap of "
                        f"{self.limits.max_add_docs}"
                    )
                for d in docs:
                    if len(d) > self.limits.max_doc_chars:
                        raise ValueError(
                            f"doc of {len(d)} chars exceeds the cap of "
                            f"{self.limits.max_doc_chars}"
                        )
                out = self.server_ref.add_documents(docs)
            elif self.path == "/delete":
                ids = req.get("doc_ids")
                if (not isinstance(ids, list) or not ids
                        or not all(isinstance(i, int)
                                   and not isinstance(i, bool)
                                   for i in ids)):
                    # NB bool: isinstance(True, int) is True in Python —
                    # [true, false] would silently tombstone docs 1 and 0
                    raise ValueError(
                        "'doc_ids' must be a non-empty list of integers"
                    )
                out = self.server_ref.delete_documents(ids)
            else:
                save_dir = req.get("save_dir")
                if save_dir is not None and not isinstance(save_dir, str):
                    raise ValueError("'save_dir' must be a string path")
                out = self.server_ref.compact(save_dir=save_dir)
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        except RuntimeError as e:
            if "rebuilding" in str(e):
                # raced the engine-None check above: the same retryable
                # condition, so the same 503 (not a 500)
                self._send(503, {"error": str(e)})
                return
            # any other RuntimeError (torch.OutOfMemoryError subclasses
            # it: device OOM during a compact rebuild, a broken update
            # log, ...) is NOT retryable — a 503 here would put
            # contract-following clients into an infinite retry loop
            # with silent metrics
            if self.metrics is not None:
                self.metrics.record_error()
            self._send(500, {"error": str(e)})
            return
        except Exception as e:
            if self.metrics is not None:
                self.metrics.record_error()
            self._send(500, {"error": str(e)})
            return
        self._send(200, out)

    def _do_reload(self):
        if self.server_ref is None:
            self._discard_body()
            self._send(500, {"error": "reload unavailable"})
            return
        try:
            req = self._read_body()
            index_dir = req.get("index_dir")
            if index_dir is not None and not isinstance(index_dir, str):
                raise ValueError("'index_dir' must be a string path")
            mode = req.get("mode", "auto")
            if mode not in ("auto", "drop", "swap"):
                raise ValueError("'mode' must be 'auto', 'drop' or 'swap'")
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        try:
            stats = self.server_ref.reload(index_dir, mode=mode)
        except FileNotFoundError as e:
            self._send(400, {"error": str(e)})
            return
        except Exception as e:
            if self.metrics is not None:
                self.metrics.record_error()
            self._send(500, {"error": str(e)})
            return
        if self.metrics is not None:
            self.metrics.record_reload()
        self._send(200, {"status": "reloaded", **stats})


# Device bytes per CSC byte assumed for the new engine of an auto-mode
# reload when the served engine's own ratio is unknown: the largest a
# sparse build of the port reached on the card, the three-tier engine
# (h=1024, 2 buckets, tail_cap=512) of chip_smoke.py phase 4b over the
# 524,288-doc corpus, 13.420 (chip_smoke.py phase 13 logs it; NVIDIA H100
# 80GB HBM3, 700.00 W), rounded up.  The explicit h=1024 layout of phase 4
# reads 13.380, the cost model's layout there (h=0, 2 buckets) 1.400.
FALLBACK_DEVICE_CSC_RATIO = 13.421


def _engine_device(engine, engine_kwargs: dict | None = None):
    """The torch device ``engine`` (or the engine an ``UpdatableEngine``
    wraps) holds its index on; else that of the ``session`` in
    ``engine_kwargs``; else None."""
    base = getattr(engine, "base", engine)
    session = getattr(base, "session", None)
    if session is None and engine_kwargs:
        session = engine_kwargs.get("session")
    return None if session is None else session.device


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 overflows when more clients than
    # that connect while the accept loop waits for the interpreter lock
    # (a reload's host work): the overflowing connections are reset
    request_queue_size = 128


class Server:
    """Owns the engine + HTTP server; use as a context manager in tests."""

    def __init__(self, index_dir: str | None, host: str = "127.0.0.1",
                 port: int = 8225,
                 engine_mode: str = "auto", batch_window_ms: float = 0.0,
                 warmup_top_k: int = 0, engine_kwargs: dict | None = None,
                 limits: ServeLimits | None = None,
                 device_checkpoint: str | None = None,
                 updatable: bool = False,
                 auto_compact: bool = False,
                 auto_compact_interval_s: float = 30.0,
                 auto_compact_delta_docs: int = 50_000,
                 auto_compact_deleted_frac: float = 0.2,
                 mmap: bool = False,
                 result_cache: int = 0):
        self._index_dir = index_dir
        self._engine_mode = engine_mode
        # mmap the npy triplet at host load (bm25s load(mmap=True) analog):
        # host RAM stays O(1) in nnz; the engine build streams pages in
        self._mmap = mmap
        # LRU entries for the per-query result cache (0 = off).  Off by
        # default so occupancy/latency metrics keep meaning "device work"
        self._result_cache_entries = int(result_cache)
        self._engine_kwargs = engine_kwargs or {}
        self._warmup_top_k = warmup_top_k
        self._reload_lock = threading.Lock()
        self._updatable = updatable
        self._update_lock = threading.Lock()  # serializes add/delete/compact
        if updatable and device_checkpoint:
            raise ValueError(
                "updatable serving needs the host index (corpus stats for "
                "delta scoring); start from an index dir, not a device "
                "checkpoint"
            )
        if auto_compact and not updatable:
            raise ValueError("auto_compact requires updatable=True")
        self._auto_compact = auto_compact
        self._auto_compact_interval_s = auto_compact_interval_s
        self._auto_compact_delta_docs = auto_compact_delta_docs
        self._auto_compact_deleted_frac = auto_compact_deleted_frac
        self._auto_compact_stop = threading.Event()
        self._auto_compact_thread = None
        # handler threads currently holding a runtime snapshot: drop-mode
        # reload/compact must wait these out (not just the batcher queue)
        # before releasing the old engine, or its device buffers stay alive
        # through local references while the new engine builds
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        limits = limits or ServeLimits()

        self._wal = None  # UpdateLog when updatable (durable live updates)
        self._wal_broken = False  # a failed append poisons updatability
        # first-use attribution of the most recent warmup (logged by
        # _warmup; surfaced on /healthz?deep=1 for operators)
        self.last_warmup_breakdown = None
        if device_checkpoint:
            runtime = self._runtime_from_checkpoint(
                device_checkpoint, index_dir, batch_window_ms
            )
        else:
            if index_dir is None:
                raise ValueError(
                    "provide an index dir or a device_checkpoint"
                )
            runtime = self._build_runtime(index_dir, batch_window_ms)
            if updatable:
                runtime, self._wal = self._open_wal_and_replay(
                    runtime, index_dir, batch_window_ms
                )
        handler = type("Handler", (BM25RequestHandler,), {})
        handler.runtime = runtime
        handler.limits = limits
        # bound per-connection socket I/O: without this a client that
        # stalls mid-body (Content-Length promised, bytes never sent) or
        # stops reading the response parks a non-daemon handler thread in
        # rfile.read/wfile.write forever and blocks graceful shutdown
        handler.timeout = limits.socket_timeout_s
        self.batcher = (
            MicroBatcher(runtime.engine, window_ms=batch_window_ms,
                         max_pending_rows=limits.max_pending_rows)
            if batch_window_ms > 0
            else None
        )
        handler.batcher = self.batcher
        self.metrics = handler.metrics = ServerMetrics()
        handler.server_ref = self
        self._handler = handler
        if warmup_top_k > 0:
            self._warmup(runtime.engine)
        self.httpd = _HTTPServer((host, port), handler)
        # in-flight handler threads must survive process teardown during a
        # drain (they hold admitted requests); per-request timeouts bound
        # how long a hung client can delay exit
        self.httpd.daemon_threads = False
        if self._auto_compact:
            self._auto_compact_thread = threading.Thread(
                target=self._auto_compact_loop, daemon=True,
                name="bm25-auto-compact",
            )
            self._auto_compact_thread.start()

    def _load_host(self, index_dir: str):
        """Host-side index load + validation (no device memory touched).

        Kept separate from the engine build so a mode="drop" reload can
        validate the NEW index before releasing the old engine — a bad
        path must leave the old index serving, not a 503 stub.
        """
        from bm25_tpu_torch.index.io import MMapCorpus, load_index

        index = load_index(index_dir, mmap=self._mmap)
        if index.vocab is None:
            raise ValueError("index has no vocab; cannot serve text queries")
        try:
            corpus = MMapCorpus.open(index_dir)
        except FileNotFoundError:
            corpus = None
        return index, corpus

    def _make_runtime(self, index, corpus, index_dir: str,
                      batch_window_ms: float = 0.0) -> EngineRuntime:
        from bm25_tpu_torch.models.auto import create_engine
        from bm25_tpu_torch.text.tokenizer import Tokenizer

        engine = create_engine(index, mode=self._engine_mode,
                               **self._engine_kwargs)
        stats = {
            "num_docs": index.num_docs,
            "vocab_size": index.vocab_size,
            "engine": type(engine).__name__,
            "batch_window_ms": batch_window_ms,
            "index_dir": index_dir,
            # host CSC footprint of the served index: the unit the auto
            # reload-mode decision projects the NEW engine's footprint in
            "csc_bytes": int(index.indptr.nbytes + index.indices.nbytes
                             + index.data.nbytes),
        }
        if self._updatable:
            from bm25_tpu_torch.index.updates import UpdatableEngine

            engine = UpdatableEngine(engine, index)
            corpus = CorpusView(corpus, base_len=index.num_docs)
            stats["updatable"] = True
        from bm25_tpu_torch.index.io import load_tokenizer_config

        tok = load_tokenizer_config(index_dir) or Tokenizer()
        return EngineRuntime(engine=engine, tokenizer=tok,
                             vocab=index.vocab, corpus=corpus, stats=stats,
                             index=None if self._updatable else index,
                             result_cache=self._new_result_cache())

    def _new_result_cache(self) -> "ResultCache | None":
        if self._result_cache_entries > 0:
            return ResultCache(self._result_cache_entries)
        return None

    def _build_runtime(self, index_dir: str,
                       batch_window_ms: float = 0.0) -> EngineRuntime:
        index, corpus = self._load_host(index_dir)
        return self._make_runtime(index, corpus, index_dir, batch_window_ms)

    # -- write-ahead log (updatable=True durability) ----------------------

    def _open_wal_and_replay(self, runtime: EngineRuntime, index_dir: str,
                             window: float):
        """Open <index_dir>/updates.wal and replay any pending ops.

        Every acked mutation since the last persisted compaction is in the
        log, so restart reproduces the exact pre-kill state: same doc ids,
        same delta segment, same tombstones (a logged in-memory compact is
        re-run — its remap is deterministic, so later ops' ids line up).
        Records whose base-generation signature no longer matches the
        artifacts (a persisted compact folded them before its log reset
        landed) are discarded by ``read_pending``, never replayed.

        Returns ``(runtime, wal)`` WITHOUT touching ``self._wal`` — the
        caller installs the log only after the whole switch succeeds, so
        a failed reload can't leave mutations logging to the wrong dir.
        """
        from bm25_tpu_torch.index.updates import UpdateLog

        wal = UpdateLog(index_dir)
        ops = wal.read_pending()
        if ops:
            print(f"bm25-tpu-torch: replaying {len(ops)} logged update(s) "
                  f"from {wal.path}")
            runtime = self._apply_wal_ops(runtime, ops, index_dir, window,
                                          wal)
            runtime.stats["wal_replayed"] = len(ops)
        return runtime, wal

    def _apply_wal_ops(self, runtime: EngineRuntime, ops: list,
                       index_dir: str, window: float,
                       wal=None) -> EngineRuntime:
        """Apply logged mutations to a freshly built runtime (pre-swap: the
        runtime is not serving yet, so a logged compact is a plain rebuild
        with no 503 window)."""
        from bm25_tpu_torch.index.builder import build_index

        for rec in ops:
            op = rec.get("op")
            if op == "add":
                docs = list(rec["docs"])
                tc = runtime.tokenizer.tokenize_corpus(
                    docs, vocab=runtime.vocab
                )
                runtime.corpus.append_texts(docs)
                runtime.engine.add(tc.ids)
            elif op == "delete":
                runtime.engine.delete(
                    [int(i) for i in rec["doc_ids"]]
                )
            elif op == "compact":
                live = runtime.engine.live_mask()
                if runtime.corpus.base is None and bool(
                    live[: runtime.corpus.base_len].any()
                ):
                    raise ValueError(
                        "update log contains a compact but the base corpus "
                        "texts are unavailable — cannot replay"
                    )
                texts = runtime.corpus.live_texts(live)
                index, _ = build_index(
                    texts, params=runtime.engine.stats.params,
                    tokenizer=runtime.tokenizer,
                )
                runtime = self._make_runtime(
                    index, [{"text": t} for t in texts], index_dir, window
                )
            else:
                path = wal.path if wal is not None else "updates.wal"
                raise ValueError(f"unknown op {op!r} in update log {path}")
        return runtime

    def _runtime_from_checkpoint(
        self, path: str, index_dir: str | None,
        batch_window_ms: float = 0.0,
    ) -> EngineRuntime:
        """Warm-restart the engine straight from a device checkpoint.

        No ScoredIndex load, no ELL/hot rebuild — the vocab rides in the
        checkpoint metadata.  The engine lands on the device of the
        ``session`` in ``engine_kwargs`` (the default CUDA session
        without one); a sharded engine's on ``make_mesh()``, or that
        session's CPU.  ``index_dir`` (optional) only supplies the corpus
        texts for response bodies and a /reload target.
        """
        from bm25_tpu_torch.index.device_checkpoint import (
            load_device_checkpoint)
        from bm25_tpu_torch.index.io import MMapCorpus
        from bm25_tpu_torch.text.tokenizer import Tokenizer

        engine = load_device_checkpoint(
            path, session=self._engine_kwargs.get("session"))
        if engine.vocab is None:
            raise ValueError(
                "checkpoint has no vocab; re-save it from an engine built "
                "with one (build_index keeps the vocab on the index)"
            )
        corpus = None
        if index_dir is not None:
            try:
                corpus = MMapCorpus.open(index_dir)
            except FileNotFoundError:
                corpus = None
        stats = {
            "num_docs": engine.num_docs,
            "vocab_size": engine.vocab_size,
            "engine": type(engine).__name__,
            "batch_window_ms": batch_window_ms,
            "device_checkpoint": path,
        }
        from bm25_tpu_torch.index.io import load_tokenizer_config

        tok = (load_tokenizer_config(index_dir)
               if index_dir is not None else None) or Tokenizer()
        return EngineRuntime(engine=engine, tokenizer=tok,
                             vocab=engine.vocab, corpus=corpus, stats=stats,
                             result_cache=self._new_result_cache())

    def _warmup(self, engine) -> None:
        # run the first query before accepting traffic: its first launch
        # of each kernel of the served path builds the kernel library
        # (nvcc) where no build of its source hash exists, and loads it;
        # T=8 is the engines' floor query width
        from bm25_tpu_torch.runtime.profiling import compile_phase_collector

        t0 = time.monotonic()
        with compile_phase_collector() as phases:
            engine.search(np.full((1, 8), -1, np.int32),
                          top_k=self._warmup_top_k)
        wall = time.monotonic() - t0
        # attribute the warmup bill: nvcc builds and library loads vs
        # everything else (the engine step, transfers, host work)
        accounted = sum(phases.values())
        self.last_warmup_breakdown = {
            "wall_s": round(wall, 1),
            **{k: round(v, 1) for k, v in phases.items()},
            "other_s": round(max(0.0, wall - accounted), 1),
        }
        print(f"bm25-tpu-torch warmup (top_k={self._warmup_top_k}): "
              f"{wall:.1f}s breakdown={self.last_warmup_breakdown}")

    def _needs_compaction(self, engine) -> bool:
        """Compaction pressure judged against the CONFIGURED thresholds."""
        return engine.needs_compaction(self._auto_compact_delta_docs,
                                       self._auto_compact_deleted_frac)

    def _inflight_enter(self) -> None:
        with self._inflight_lock:
            self._inflight += 1

    def _inflight_exit(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def _wait_quiesce(self, timeout_s: float = 60.0) -> None:
        """Wait until no admitted work can still reference the old runtime:
        the batcher queue is empty AND no handler thread holds a snapshot.
        Bounded — a hung client can delay but not block a drop-mode swap."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            pending = (self.batcher.pending_rows
                       if self.batcher is not None else 0)
            with self._inflight_lock:
                inflight = self._inflight
            if pending == 0 and inflight == 0:
                return
            time.sleep(0.05)

    def reload(self, index_dir: str | None = None,
               mode: str = "auto") -> dict:
        """Load the index fresh and swap the runtime atomically.

        ``mode="swap"`` builds the new engine NEXT TO the old one (true
        zero-downtime, but both engines' device memory coexists — only
        safe when two indexes fit the device together).  ``mode="drop"``
        releases the old engine first: a large engine takes most of the
        card, so a side-by-side build would run out of device memory
        mid-traffic; the cost is a window where /search answers 503 while
        the new engine builds.  ``mode="auto"`` (the default) picks swap
        when the modeled footprint of old+new engines fits the device
        budget (``_auto_reload_mode``), else drop — the zero-error path
        whenever headroom allows it.

        In-flight requests already snapshotted the old runtime and finish
        on the old engine either way; the micro-batcher keys batches by
        engine, so a mixed window runs two dispatches rather than mixing
        indices.
        """
        # lock order matches compact(): update first, then reload — a
        # concurrent mutation must not append to the outgoing dir's WAL
        # after its records were read (or miss the new runtime entirely)
        with self._update_lock, self._reload_lock:
            index_dir = index_dir or self._index_dir
            if index_dir is None:
                raise FileNotFoundError(
                    "no index dir to reload from (serving from a device "
                    "checkpoint); pass 'index_dir' in the reload request"
                )
            old_rt = self._handler.runtime
            old_stats = old_rt.stats
            window = old_stats.get("batch_window_ms", 0.0)
            # validate the new index on the HOST before touching the old
            # engine: a bad path must leave the old index serving
            index, corpus = self._load_host(index_dir)
            if self._updatable:
                # ... and the target dir's update log too: a corrupt log
                # surfacing only after the drop window below would strand
                # the server on the 503 stub with the old engine gone
                from bm25_tpu_torch.index.updates import UpdateLog

                UpdateLog(index_dir).read_pending()
            sizing = None
            if mode == "auto":
                mode, sizing = self._auto_reload_mode(old_rt.engine, index)
            if mode == "drop":
                # release the old engine before building: serve 503 from
                # a stub runtime, wait for admitted work to finish, drop
                # the only engine reference so its buffers free
                self._handler.runtime = EngineRuntime(
                    engine=None, tokenizer=old_rt.tokenizer,
                    vocab=old_rt.vocab, corpus=old_rt.corpus,
                    stats=dict(old_stats, reloading=True),
                )
                self._wait_quiesce()
                if self.batcher is not None:
                    self.batcher.engine = None
                del old_rt
                import gc

                gc.collect()
            # on a device-build failure under mode="drop" the old engine
            # is already gone; the stub runtime stays in place (503s)
            # rather than serving wrong answers
            runtime = self._make_runtime(index, corpus, index_dir, window)
            new_wal = None
            if self._updatable:
                # the new dir's log replays into the not-yet-swapped
                # runtime; on any failure self._wal still points at the
                # OLD dir, so acked mutations keep logging consistently
                runtime, new_wal = self._open_wal_and_replay(
                    runtime, index_dir, window
                )
            if self._warmup_top_k > 0:
                self._warmup(runtime.engine)
            self._handler.runtime = runtime  # the atomic swap
            if self.batcher is not None:
                self.batcher.engine = runtime.engine
            if self._updatable:
                if self._wal is not None and self._wal is not new_wal:
                    self._wal.close()
                self._wal = new_wal
                # a reload is a soft restart: the runtime was rebuilt from
                # the target dir's base + replayed log, so in-memory state
                # and the log are consistent again — clear any poison from
                # a failed apply/append
                self._wal_broken = False
            self._index_dir = index_dir
            out = dict(runtime.stats)
            out["mode"] = mode
            if sizing is not None:
                out["sizing"] = sizing
            return out

    def _auto_reload_mode(self, old_engine, new_index) -> tuple[str, dict]:
        """Pick swap vs drop from the modeled old+new device footprint.

        The budget is the served device's memory times the sparse
        engine's usable fraction.  The new engine does not exist yet, so
        its footprint is projected at the OLD engine's measured overhead
        ratio (device bytes per CSC byte — same engine mode, kwargs and
        auto-sizing policy apply to the new build; the ratio is the
        policy's output).  With no old ratio available the projection
        assumes ``FALLBACK_DEVICE_CSC_RATIO``, the largest ratio a sparse
        build of the port was measured at on the card, which errs toward
        drop — the mode that cannot run out of memory.
        """
        from bm25_tpu_torch.eval import engine_device_bytes
        from bm25_tpu_torch.models.sparse import (_USABLE_HBM_FRACTION,
                                                  device_hbm_bytes)

        device = _engine_device(old_engine, self._engine_kwargs)
        if device is None:
            return "drop", {"reason": "served device unknown"}
        budget = int(device_hbm_bytes(device) * _USABLE_HBM_FRACTION)
        new_csc = (new_index.indptr.nbytes + new_index.indices.nbytes
                   + new_index.data.nbytes)
        try:
            old_dev = engine_device_bytes(old_engine)
        except TypeError:
            # unknown engine type (or the stub runtime's None engine mid
            # previous reload): no measured ratio and nothing to size —
            # drop is the conservative path
            return "drop", {"reason": "old engine footprint unknown",
                            "budget_bytes": budget}
        old_csc = self._handler.runtime.stats.get("csc_bytes", 0)
        ratio = (old_dev / old_csc) if old_csc else FALLBACK_DEVICE_CSC_RATIO
        est_new = int(ratio * new_csc)
        fits = old_dev + est_new <= budget
        sizing = {
            "old_device_bytes": int(old_dev),
            "est_new_device_bytes": est_new,
            "budget_bytes": budget,
            "fits": fits,
        }
        return ("swap" if fits else "drop"), sizing

    # -- live updates (updatable=True) -----------------------------------

    def _wal_log(self, record: dict) -> None:
        """Fsync a mutation record BEFORE applying it (true write-ahead).

        An append failure (disk full, EIO) poisons updatability: applying
        further mutations after a lost record would let in-memory state
        and the log diverge — replay after the next restart would then
        resolve later logged ops against the wrong doc ids.  Mutations
        answer 500 until a restart; searches are unaffected.
        """
        if self._wal is None:
            return
        if self._wal_broken:
            raise RuntimeError(
                "update log unavailable (a previous append failed); "
                "mutations are disabled until the server restarts"
            )
        try:
            self._wal.append(record)
        except Exception as e:
            self._wal_broken = True
            raise RuntimeError(
                f"update log append failed ({e}); mutations are disabled "
                "until the server restarts"
            ) from e

    def add_documents(self, texts: list[str]) -> dict:
        """Tokenize + add texts to the live delta segment; returns ids.

        The vocab grows in place (new terms become queryable immediately);
        texts land in the corpus view BEFORE the engine state swaps so a
        racing search never returns a doc id without its text.
        """
        with self._update_lock:
            rt = self._handler.runtime  # snapshot under the lock: compact
            # swaps the runtime and also takes this lock, so rt stays valid
            if rt.engine is None:
                raise RuntimeError("index rebuilding; retry shortly")
            # validate (tokenize) BEFORE the log write; the apply below is
            # pure in-memory appends, so log-then-apply cannot diverge
            tc = rt.tokenizer.tokenize_corpus(list(texts), vocab=rt.vocab)
            self._wal_log({"op": "add", "docs": list(texts)})
            rt.corpus.append_texts(list(texts))
            ids = rt.engine.add(tc.ids)
            if rt.result_cache is not None:
                # cached rows predate the add: clear BEFORE acking so no
                # client ever reads a pre-mutation result after the 200
                rt.result_cache.clear()
            return {
                "status": "added",
                "doc_ids": [int(i) for i in ids],
                "live_docs": rt.engine.live_docs,
                "delta_docs": rt.engine.delta_docs,
                "needs_compaction": self._needs_compaction(rt.engine),
            }

    def delete_documents(self, doc_ids) -> dict:
        """Tombstone doc ids; they stop appearing in results immediately."""
        with self._update_lock:
            rt = self._handler.runtime
            if rt.engine is None:
                raise RuntimeError("index rebuilding; retry shortly")
            # pre-validate so the write-ahead record can't name an op the
            # (infallible-after-validation) apply would reject
            ids_arr = np.atleast_1d(np.asarray(doc_ids, dtype=np.int64))
            if ids_arr.size and (
                int(ids_arr.min()) < 0
                or int(ids_arr.max()) >= rt.engine.num_docs
            ):
                raise ValueError(
                    f"doc id out of range [0, {rt.engine.num_docs}) in "
                    "delete"
                )
            self._wal_log(
                {"op": "delete", "doc_ids": [int(i) for i in doc_ids]}
            )
            n = rt.engine.delete(doc_ids)
            if rt.result_cache is not None:
                rt.result_cache.clear()
            return {
                "status": "deleted",
                "deleted": n,
                "live_docs": rt.engine.live_docs,
                "deleted_docs": rt.engine.deleted_docs,
                "needs_compaction": self._needs_compaction(rt.engine),
            }

    def compact(self, save_dir: str | None = None,
                auto: bool = False) -> dict:
        """Rebuild one fresh base segment from the live corpus and swap it in.

        Doc ids are REASSIGNED (the response reports the live count; clients
        treating ids as stable must re-resolve after compaction — same
        contract as :meth:`UpdatableRetriever.compact`).  The host index is
        rebuilt while the old engine still serves; the device swap uses the
        drop-mode reload sequence (releases the old engine's device memory
        first, a brief 503 window) because a large engine takes most of the
        card.  ``save_dir`` additionally persists the compacted index
        (bm25s artifact set) for restart.  ``auto=True`` (the
        auto-compaction loop's call) counts the compaction in
        ``metrics.compactions``.  The new runtime is published last, after
        the count and the update-log fold, so /healthz never shows the
        delta folded with the count still 0 or the log not yet folded.
        """
        from bm25_tpu_torch.index.builder import build_index
        from bm25_tpu_torch.index.io import save_index

        with self._update_lock, self._reload_lock:
            rt = self._handler.runtime
            if rt.engine is None:
                raise RuntimeError("index rebuilding; retry shortly")
            params = rt.engine.stats.params
            live = rt.engine.live_mask()
            if rt.corpus.base is None and bool(
                live[: rt.corpus.base_len].any()
            ):
                raise ValueError(
                    "cannot compact: the served index has no corpus texts "
                    "for its base docs (save the index with a corpus, or "
                    "delete all base docs first)"
                )
            texts = rt.corpus.live_texts(live)
            if not texts:
                raise ValueError(
                    "compaction would empty the corpus; engines need >= 1 "
                    "live doc"
                )
            window = rt.stats.get("batch_window_ms", 0.0)
            index_dir = rt.stats.get("index_dir")
            tokenizer = rt.tokenizer
            # three WAL cases, keyed on where the compacted base persists:
            #   in-memory (save_dir None): the compact is WRITE-AHEAD
            #     logged to the served dir so replay re-runs it;
            #   fold (save_dir == served dir): the persisted base subsumes
            #     the log, which resets after the swap;
            #   export (save_dir elsewhere): the SERVED dir keeps its WAL
            #     and logs the compact like the in-memory case (restart
            #     from the served dir must reproduce acked post-compact
            #     state — re-homing the WAL to the export dir would strand
            #     those ops where a restart never looks); the export dir
            #     gets its own sig-only log so it also restarts clean.
            import os as _os

            same_dir = (
                save_dir is not None and self._index_dir is not None
                and _os.path.realpath(save_dir)
                == _os.path.realpath(self._index_dir)
            )
            # host rebuild FIRST — a failure here leaves the old engine
            # serving untouched
            index, _ = build_index(texts, params=params, tokenizer=tokenizer)
            if save_dir is not None:
                save_index(save_dir, index, corpus=texts)
                if same_dir:
                    index_dir = save_dir
            if self._wal is not None and not same_dir:
                # write-ahead: the record lands before any state changes;
                # an append failure answers 500 with the old engine intact
                self._wal_log({"op": "compact"})
            corpus_list = [{"text": t} for t in texts]
            # drop-mode swap: stub 503s, wait out admitted work, release
            # the old engine's device buffers, then build the new one
            self._handler.runtime = EngineRuntime(
                engine=None, tokenizer=tokenizer, vocab=rt.vocab,
                corpus=rt.corpus, stats=dict(rt.stats, reloading=True),
            )
            self._wait_quiesce()
            if self.batcher is not None:
                self.batcher.engine = None
            del rt
            import gc

            gc.collect()
            try:
                runtime = self._make_runtime(index, corpus_list, index_dir,
                                             window)
                if self._warmup_top_k > 0:
                    self._warmup(runtime.engine)
            except Exception:
                if self._wal is not None and not same_dir:
                    # the compact record is already durable but was never
                    # applied: later mutations would log against diverged
                    # ids, so disable them — a restart replays the log and
                    # converges to the logged (compacted) state
                    self._wal_broken = True
                raise
            out = {
                "status": "compacted",
                "live_docs": runtime.engine.live_docs,
                "vocab_size": runtime.engine.vocab_size,
            }
            if save_dir is not None:
                out["saved_to"] = save_dir
            if self._wal is not None and save_dir is not None:
                from bm25_tpu_torch.index.updates import UpdateLog

                if same_dir:
                    # fold: the persisted base subsumes the log — reset it
                    # to a sig-only header.  save_index already changed the
                    # base signature, so a crash (or failure) BEFORE the
                    # reset leaves a mismatched log that read_pending
                    # discards rather than replaying folded ops.  Rebind
                    # self._wal only after the reset succeeds: appends
                    # through the OLD object would carry the stale
                    # signature and be discarded wholesale on restart
                    new_wal = UpdateLog(save_dir)
                    try:
                        new_wal.reset()
                    except Exception as e:  # noqa: BLE001 — degrade, warn
                        self._wal_broken = True
                        out["wal_warning"] = (
                            f"update-log reset failed ({e}); mutations are "
                            "disabled until the server restarts"
                        )
                    else:
                        old_wal = self._wal
                        self._wal = new_wal
                        old_wal.close()  # its fd points at the inode the
                        # reset just replaced
                else:
                    # export: the served dir keeps its WAL (the compact is
                    # already logged there); give the export dir a clean
                    # sig-only log.  Best-effort — a stale or missing log
                    # at the export is harmless (sig fencing discards it)
                    try:
                        UpdateLog(save_dir).reset()
                    except Exception as e:  # noqa: BLE001
                        out["wal_warning"] = (
                            f"export-dir update-log reset failed ({e}); "
                            "the export's stale log will be discarded by "
                            "signature fencing on load"
                        )
            # publish last: once /healthz shows the delta folded, the
            # compaction is counted and its update log already folded
            if auto and self.metrics is not None:
                self.metrics.record_compaction()
            self._handler.runtime = runtime
            if self.batcher is not None:
                self.batcher.engine = runtime.engine
            return out

    def _auto_compact_loop(self):
        """Background policy thread: compact when the delta/tombstone load
        crosses the configured thresholds.

        Compacts WITH persistence to the served index dir (folding the
        update log) so restarts stay cheap — the whole point of compacting
        automatically is that nobody is watching /healthz.  A failure
        (e.g. the index was saved without corpus texts) is logged once and
        not retried until a success clears the flag: the condition will
        not fix itself, and retrying would spin the drop-mode 503 window.
        """
        warned = False
        while not self._auto_compact_stop.wait(self._auto_compact_interval_s):
            rt = self._handler.runtime
            eng = rt.engine
            if eng is None or not hasattr(eng, "needs_compaction"):
                continue
            if not eng.needs_compaction(self._auto_compact_delta_docs,
                                        self._auto_compact_deleted_frac):
                warned = False  # a manual compact cleared the condition
                continue
            if warned:
                continue
            try:
                t0 = time.monotonic()
                out = self.compact(save_dir=self._index_dir, auto=True)
                print(f"bm25-tpu-torch: auto-compacted to "
                      f"{out['live_docs']} live docs in "
                      f"{time.monotonic() - t0:.1f}s "
                      f"(saved to {self._index_dir})")
                warned = False
            except Exception as e:  # noqa: BLE001 — policy thread must live
                print(f"bm25-tpu-torch: auto-compaction failed (will not "
                      f"retry until the condition clears, e.g. via a manual "
                      f"/compact): {e}")
                warned = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self, install_signal_handlers: bool = True):
        if install_signal_handlers and (
            threading.current_thread() is threading.main_thread()
        ):
            signal.signal(signal.SIGTERM, lambda *_: self.drain())
            signal.signal(signal.SIGINT, lambda *_: self.drain())
        print(f"bm25-tpu-torch serving on :{self.port}")
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def drain(self):
        """Graceful shutdown: stop accepting, finish queued work, close.

        The worker thread is NON-daemon: after ``serve_forever`` returns
        (the accept loop stops), the interpreter stays alive until the
        batcher has flushed every admitted request and in-flight handler
        threads finished — otherwise a SIGTERM would abandon queued work
        the moment the main thread unblocks (round-3 review finding).
        """
        threading.Thread(target=self.shutdown, daemon=False,
                         name="bm25-drain").start()

    def shutdown(self):
        self._auto_compact_stop.set()
        if self._auto_compact_thread is not None:
            # wait out an in-flight auto-compaction: killing it mid
            # save_index would leave torn base artifacts in the served
            # dir (and it may still touch the WAL we close below)
            self._auto_compact_thread.join(timeout=600)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.batcher is not None:
            self.batcher.drain(timeout=30)
        if self._wal is not None:
            self._wal.close()
