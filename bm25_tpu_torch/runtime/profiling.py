"""Tracing & profiling hooks of the port.

``span(name, **attrs)`` and ``count(name, n=1)`` mark the program's own
layers: the sparse engine's search and set-up call them where the work
happens.  They record only inside ``tracing()`` (or ``capture_trace``),
which yields a ``Trace`` holding the records in memory; outside it
``span`` hands back one shared no-op object and ``count`` returns at
once, with no clock read and no record.

A span records its name, an id, its parent's id, the id of the outermost
span of its thread (a search call's ``search.call``: the call id), its
start and end and its attrs.  Each thread keeps its own stack of open
spans.  A counter adds to the innermost open span of its thread and to
the trace's totals.  Times are Unix-epoch nanoseconds (``time.time_ns``),
the clock ``torch.profiler`` puts its host and device events on
(``kineto_results.trace_start_ns()``, ``event.start_ns()``), so that a
kernel's launch and a program span compare directly.

``capture_trace`` writes a ``torch.profiler`` trace of the host and the
card as a Chrome trace, with the program's spans in it.  The
compile-phase collector reports the port's own first-use work: nvcc
builds and library loads of the CUDA kernels (``ops/_build.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import torch

from bm25_tpu_torch.ops import _build

_clock = time.time_ns
# the trace that span() and count() record into; None while tracing is off
_trace: "Trace | None" = None


class _NoSpan:
    """The span handed out while tracing is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Span:
    """A span while it is open (see the module's docstring); ``counts``
    holds the counters added while it is the innermost open span of its
    thread.  It closes into a tuple of ``Trace.FIELDS``, which holds no
    reference back to the trace."""

    __slots__ = ("trace", "name", "attrs", "id", "parent", "call", "thread",
                 "start_ns", "counts")

    def __init__(self, trace: "Trace", name: str, attrs: dict):
        self.trace, self.name, self.attrs = trace, name, attrs
        self.counts: dict = {}

    def __enter__(self):
        stack, self.thread, _ = self.trace._thread()
        self.id = next(self.trace._ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        end_ns = _clock()
        stack = self.trace._thread()[0]
        if stack and stack[-1] is self:
            stack.pop()
        self.trace.spans.append((self.name, self.id, self.parent, self.call,
                                 self.thread, self.start_ns, end_ns,
                                 self.attrs, self.counts))
        return False


class Trace:
    """The records of one ``tracing()`` block: ``spans`` (closed spans as
    tuples of ``FIELDS``, in the order they closed) and ``counts`` (each
    counter's total)."""

    FIELDS = ("name", "id", "parent", "call", "thread", "start_ns", "end_ns",
              "attrs", "counts")

    def __init__(self):
        self.spans: list[tuple] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._totals: list[dict] = []  # each thread's counter totals

    def _thread(self) -> tuple[list, int, dict]:
        """This thread's stack of open spans, native id and counter
        totals."""
        try:
            return self._local.state
        except AttributeError:
            state = self._local.state = ([], threading.get_native_id(), {})
            with self._lock:
                self._totals.append(state[2])
            return state

    def _count(self, name: str, n) -> None:
        stack, _, totals = self._thread()
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + n
        totals[name] = totals.get(name, 0) + n

    @property
    def counts(self) -> dict:
        """Each counter's total over every thread."""
        out: dict = {}
        for totals in list(self._totals):
            for name, n in list(totals.items()):
                out[name] = out.get(name, 0) + n
        return out

    def records(self) -> list[dict]:
        """Each span as a dict of ``FIELDS``, in start order, with its self
        time (``self_ns``: its duration less the part its children
        cover)."""
        spans = sorted((dict(zip(self.FIELDS, s)) for s in self.spans),
                       key=lambda r: (r["start_ns"], r["id"]))
        children: dict = {}
        for r in spans:
            children.setdefault(r["parent"], []).append(r)
        for r in spans:
            covered, end = 0, r["start_ns"]
            for c in children.get(r["id"], ()):  # in start order
                lo, hi = max(c["start_ns"], end), min(c["end_ns"],
                                                      r["end_ns"])
                if hi > lo:
                    covered += hi - lo
                    end = hi
            r["self_ns"] = r["end_ns"] - r["start_ns"] - covered
        return spans


def span(name: str, **attrs):
    """A context manager that records a span named ``name`` (with
    ``attrs``) while tracing is on; the shared no-op otherwise."""
    if _trace is None:
        return _NO_SPAN
    return Span(_trace, name, attrs)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on: on the
    innermost open span of this thread and in the trace's totals."""
    if _trace is None:
        return
    _trace._count(name, n)


def enabled() -> bool:
    """Whether tracing is on (for a counter whose value costs work)."""
    return _trace is not None


@contextlib.contextmanager
def tracing():
    """Turn the program's spans and counters on for the block; yields the
    ``Trace`` that holds them.  Blocks do not nest: opening one inside
    another raises RuntimeError (``capture_trace`` joins an open one)."""
    global _trace
    if _trace is not None:
        raise RuntimeError("tracing is already on")
    _trace = Trace()
    try:
        yield _trace
    finally:
        _trace = None


def _chrome_events(records: list[dict], base_ns: int = 0) -> list[dict]:
    """Spans (``Trace.records``) as Chrome trace events (``ph`` "X", times
    in µs from ``base_ns``), each with its id, parent, call, attrs and
    counts."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program", "name": r["name"], "pid": pid,
             "tid": r["thread"], "ts": (r["start_ns"] - base_ns) / 1e3,
             "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
             "args": {"id": r["id"], "parent": r["parent"], "call": r["call"],
                      **r["attrs"], **r["counts"]}}
            for r in records]


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a host + CUDA profile of the block into ``log_dir`` as a
    Chrome trace (``trace.json``; open it in Perfetto or
    ``chrome://tracing``), with the program's spans that started inside
    the block on the profiler's own clock.  Tracing is on for the block:
    the trace already open, or one of its own.  The file is written
    when the block raises too.

    Usage:
        with capture_trace("/tmp/bm25_trace"):
            engine.search(queries, top_k=1000)
    """
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    path = os.path.join(log_dir, "trace.json")
    on = contextlib.nullcontext(_trace) if _trace is not None else tracing()
    with on as trace:
        prof.start()
        t0 = _clock()
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
            doc["traceEvents"] += _chrome_events(
                [r for r in trace.records() if r["start_ns"] >= t0],
                int(doc.get("baseTimeNanoseconds", 0)))
            with open(path, "w") as f:
                json.dump(doc, f)


@contextlib.contextmanager
def compile_phase_collector():
    """Collect the seconds of first-use work done inside the with-block.

    Yields a dict that accumulates ``nvcc_build_s`` (compiling a kernel
    library with nvcc, where no library for its source hash exists),
    ``native_build_s`` (compiling the native text library) and
    ``library_load_s`` (``ctypes.CDLL`` of a library not loaded before).
    The caller's wall time minus these is execution, host overhead and
    transfers.  Built for the serve warmup breakdown.  Work done by any
    thread while the block runs counts.
    """
    with _build.collect_phases() as phases:
        yield phases
