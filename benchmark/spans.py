"""The program's own spans and counters read against a device trace.

``bm25_tpu_torch.runtime.profiling.tracing()`` records the program's spans
on the Unix-epoch clock that ``torch.profiler`` puts its events on
(``kineto_results``' ``start_ns``).  This module turns one profiled window
and the spans recorded over it into what the layers' metrics need:

* each device event's launch, matched by its correlation id to the
  runtime call that launched it, and the innermost program span open at
  that launch (``attribute``): a kernel belongs to the span that launched
  it, whenever it ran;
* the card's idle intervals inside the window, split by whether the host
  was inside a ``search.call`` span and by the innermost span it was in
  (``idle_split``);
* the host's time a batch in each span (``per_batch_ms``).

Its functions take plain tuples, so the tests can feed them synthetic
event lists; ``profile_events`` reads them from a ``torch.profiler``
profile.
"""

from __future__ import annotations

import torch

CALL = "search.call"
BATCH = "batch.dispatch"
PRIMER = "sleep"  # the profiled window's primer kernel (trace.py)


def profile_events(prof) -> tuple[list, dict]:
    """``(device, launches)`` of a ``torch.profiler`` profile, times in
    epoch ns: ``device`` the card's kernels and copies as ``(start, end,
    name, correlation)`` (the primer and annotations left out),
    ``launches`` each correlation id's runtime call start."""
    cuda = torch.autograd.DeviceType.CUDA
    device, runtime = [], {}
    for e in prof.profiler.kineto_results.events():
        lo, hi, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == cuda:
            if PRIMER not in name and not e.is_user_annotation():
                device.append((lo, hi, name, e.correlation_id()))
        elif name.startswith("cu"):  # cudaLaunchKernel, cudaMemcpyAsync...
            runtime[e.correlation_id()] = lo
    device.sort()
    launches = {c: runtime[c] for *_, c in device if c in runtime}
    return device, launches


def paths(spans: list) -> dict:
    """Each span id's path of names from its thread's outermost span,
    joined by " > "."""
    by_id = {s["id"]: s for s in spans}
    out: dict = {}

    def path(i):
        if i not in out:
            s = by_id[i]
            up = s["parent"]
            out[i] = s["name"] if up not in by_id \
                else path(up) + " > " + s["name"]
        return out[i]

    for s in spans:
        path(s["id"])
    return out


def innermost(spans: list, times: list) -> list:
    """The id of the innermost span open at each of ``times`` (sorted),
    or None: spans of one thread nest, so a sweep keeps the open ones."""
    order = sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(order) and order[j]["start_ns"] <= t:
            while stack and stack[-1]["end_ns"] < order[j]["start_ns"]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1]["end_ns"] < t:
            stack.pop()
        out.append(stack[-1]["id"] if stack else None)
    return out


def attribute(device: list, launches: dict, spans: list) -> list:
    """Each device event's seconds by the span path open at its launch:
    ``[[event name, span path or None, seconds, events], ...]``, largest
    first.  Events with no recorded launch are left out."""
    hits = sorted((launches[c], hi - lo, name) for lo, hi, name, c in device
                  if c in launches)
    where = innermost(spans, [t for t, _, _ in hits])
    named = paths(spans)
    out: dict = {}
    for (_, ns, name), sid in zip(hits, where):
        k = (name, named.get(sid))
        row = out.setdefault(k, [0.0, 0])
        row[0] += ns / 1e9
        row[1] += 1
    return sorted(([n, p, s, c] for (n, p), (s, c) in out.items()),
                  key=lambda r: -r[2])


def union(intervals: list) -> list:
    """Sorted ``(start, end)`` intervals merged where they overlap."""
    out: list = []
    for lo, hi, *_ in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def gaps(device: list, w0: int, w1: int) -> list:
    """The card's idle intervals inside ``[w0, w1]``: no device event
    runs."""
    out, end = [], w0
    for lo, hi in union([(max(lo, w0), min(hi, w1)) for lo, hi, *_ in device
                         if hi > w0 and lo < w1]):
        if lo > end:
            out.append((end, lo))
        end = max(end, hi)
    if w1 > end:
        out.append((end, w1))
    return out


def overlap_ns(a: list, pieces: list) -> dict:
    """Nanoseconds of the disjoint sorted intervals ``a`` inside each of
    the disjoint sorted ``(start, end, tag)`` ``pieces``, by tag."""
    out: dict = {}
    j = 0
    for lo, hi in a:
        while j < len(pieces) and pieces[j][1] <= lo:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < hi:
            p_lo, p_hi, tag = pieces[k]
            ns = min(hi, p_hi) - max(lo, p_lo)
            if ns > 0:
                out[tag] = out.get(tag, 0) + ns
            k += 1
    return out


def partition(spans: list) -> list:
    """The time the spans cover as disjoint sorted ``(start, end, id)``
    pieces, each piece's id the innermost span open over it."""
    cuts = sorted({t for s in spans for t in (s["start_ns"], s["end_ns"])})
    mids = [(a + b) / 2 for a, b in zip(cuts, cuts[1:])]
    ids = innermost(spans, mids)
    return [(a, b, i) for a, b, i in zip(cuts, cuts[1:], ids)
            if i is not None]


def idle_split(idle: list, spans: list) -> dict:
    """Idle seconds inside and outside ``search.call`` spans, and inside
    them by the innermost span (``by_span``, by name)."""
    calls = [(lo, hi, CALL) for lo, hi in union(
        [(s["start_ns"], s["end_ns"]) for s in spans if s["name"] == CALL])]
    total = sum(hi - lo for lo, hi in idle)
    inside = overlap_ns(idle, calls).get(CALL, 0)
    names = {s["id"]: s["name"] for s in spans}
    by_span: dict = {}
    for sid, ns in overlap_ns(idle, partition(spans)).items():
        by_span[names[sid]] = by_span.get(names[sid], 0) + ns / 1e9
    return {"idle_s": total / 1e9, "inside_s": inside / 1e9,
            "outside_s": (total - inside) / 1e9,
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def seconds_by_name(spans: list, self_time: bool = True) -> dict:
    """Host seconds in each span name, largest first: self time (less the
    children's cover) or whole durations."""
    out: dict = {}
    for s in spans:
        ns = s["self_ns"] if self_time else s["end_ns"] - s["start_ns"]
        out[s["name"]] = out.get(s["name"], 0) + ns / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def per_batch_ms(spans: list, self_time: bool = True) -> dict:
    """Host ms a dispatched batch in each span name (``seconds_by_name``
    over the ``batch.dispatch`` spans); none without a batch."""
    batches = sum(s["name"] == BATCH for s in spans)
    if not batches:
        return {}
    return {k: v / batches * 1e3
            for k, v in seconds_by_name(spans, self_time).items()}


def counts(spans: list) -> dict:
    """Each counter's total over the spans."""
    out: dict = {}
    for s in spans:
        for k, v in s["counts"].items():
            out[k] = out.get(k, 0) + v
    return out


def share(num, den):
    return 100.0 * num / den if den else None


def metrics(spans: list, kernels: list, idle: dict | None,
            build: list) -> dict:
    """The layers' metrics from a window's spans, its kernels by span
    (``attribute``) and idle split (``idle_split``), and the set-up's
    spans; a metric with nothing to read is left out."""
    batches = sum(s["name"] == BATCH for s in spans)
    self_ms = per_batch_ms(spans)
    whole_ms = per_batch_ms(spans, self_time=False)
    c = counts(spans)
    out = {
        "dedup_ms": self_ms.get("plan.dedup"),
        "dedup_use_pct": share(c.get("dedup.applied", 0),
                               c.get("dedup.checked", 0)),
        "chunk_plan_ms": self_ms.get("plan.chunks"),
        "launch_ms": whole_ms.get("step.launch"),
        "fill_pct": share(c.get("plan.cells_real", 0),
                          c.get("plan.cells_padded", 0)),
    }
    selected = [s for name, path, s, _ in kernels
                if path and not name.startswith(("Memcpy", "Memset"))
                and ("step.select" in path or "step.merge" in path)]
    if batches and selected:
        out["select_ms"] = sum(selected) / batches * 1e3
    if batches and idle is not None:
        out["idle_in_call_ms"] = idle["inside_s"] / batches * 1e3
    ell = [s["end_ns"] - s["start_ns"] for s in build
           if s["name"] == "build.ell"]
    if ell:
        out["ell_build_s"] = sum(ell) / 1e9
    return {k: v for k, v in out.items() if v is not None}
