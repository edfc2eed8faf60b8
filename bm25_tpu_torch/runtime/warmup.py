"""Warmers: run a serving engine's dispatch family once before traffic.

The port's copy of ``bm25_tpu/runtime/warmup.py``.  In the JAX package
the first dispatch of each compiled shape pays an XLA compile; the port
runs eagerly and compiles nothing per shape, so what a warm-up pays here
is first-use work: the nvcc build of each kernel library the path loads
(where no library for its source hash is in the build directory,
``ops/_build.py``) and the library's load.  ``warm_engine`` reports them
per task (``nvcc_build_s``, ``native_build_s``, ``library_load_s``, from
``runtime/profiling.py::compile_phase_collector``) beside its wall
seconds, and ``bm25-tpu-torch warm`` runs it at deploy so that a later
``cache export`` ships the built libraries.

``warm_engine`` drives the public dispatch path (``engine.search``), so
exactly the paths traffic would run are the ones warmed.  The plan is
JAX's: a sparse engine that routes (a hot tier beside a scan tier,
``route_cold`` on) warms its routed family, every chunk height the DP can
cut (32 up to the routed batch) at each cold-width class; one built with
``route_cold=False`` warms the unrouted family.
"""

from __future__ import annotations

import time

import numpy as np


def _query_matrix(
    engine, q: int, t: int, cold: int | None, rng: np.random.Generator
) -> np.ndarray:
    """A (q, t) int32 query matrix shaped to hit one compiled shape class.

    ``cold`` pins each row's count of cold (non-hot-tier) tokens so the
    routed planner compiles chunks at that cold-width class.  When the
    engine has no hot table (dense engines, routing off) the ids are
    plain uniform draws and ``cold`` is ignored.
    """
    vocab = int(engine.vocab_size)
    table = getattr(engine, "hot_table_host", None)
    if cold is None or table is None:
        return rng.integers(0, vocab, size=(q, t), dtype=np.int32)
    cold = min(cold, t)
    # the hot table is padded past the real vocab; ids must stay in range
    table = np.asarray(table)[:vocab]
    cold_pool = np.where(table < 0)[0]
    hot_pool = np.where(table >= 0)[0]
    if len(cold_pool) == 0 or len(hot_pool) == 0:
        # degenerate hot split (all-hot or all-cold vocab): routing can't
        # produce mixed widths anyway, fall back to uniform ids
        return rng.integers(0, vocab, size=(q, t), dtype=np.int32)
    ids = np.empty((q, t), dtype=np.int64)
    ids[:, :cold] = rng.choice(cold_pool, size=(q, cold))
    ids[:, cold:] = rng.choice(hot_pool, size=(q, t - cold))
    return ids.astype(np.int32)


def default_plan(
    engine,
    top_ks=(10,),
    batch_sizes=(1, 8, 32),
    routed_batch: int = 512,
    widths=(8,),
    cold_classes=(2, 4, 8),
    weighted: bool = False,
    ids_only: bool = False,
    filtered: bool = False,
) -> list[dict]:
    """Enumerate the warm tasks for a serving deployment.

    Every batch size is warmed in the form production would run it:
    sizes below the engine's ``route_min_queries`` floor warm as plain
    *unrouted* dispatches (each pads to its own 8-row multiple — the
    shapes a lightly-loaded server compiles request by request); sizes
    at or above the floor warm *routed*, once per cold-width class, so
    the dispatch DP emits chunks compiled at exactly the classes a busy
    micro-batched server hits.  ``routed_batch`` is just an extra large
    size appended to ``batch_sizes``.  Engines without a hot tier warm
    every size unrouted (routing never engages for them).

    ``weighted=True`` / ``ids_only=True`` / ``filtered=True`` add those
    path variants (each is its own compiled family; ``filtered`` covers
    ``doc_mask`` / HTTP ``filter_ids`` requests, which bypass the
    micro-batcher and would otherwise pay their cold compile on the
    first production request).  Returns plain dicts so callers (CLI,
    tests) can inspect or edit the plan before running it.
    """
    rm = getattr(engine, "route_min_queries", None)
    # NB not `or 32`: route_min_queries=0 is a legitimate "route always"
    route_min = 32 if rm is None else int(rm)
    has_routing = (
        getattr(engine, "hot_table_host", None) is not None
        and int(getattr(engine, "hot_h", 0) or 0) > 0
        and bool(getattr(engine, "route_cold", True))
        and any("tokT" in b for b in getattr(engine, "buckets", []) or [])
    )
    sizes = sorted(set(batch_sizes) | {routed_batch})
    tasks: list[dict] = []

    def add(q, t, c, k, w, io, f=False):
        tasks.append({
            "q": int(q), "t": int(t), "cold": c, "top_k": int(k),
            "weighted": bool(w), "ids_only": bool(io), "filtered": bool(f),
        })

    # production mixed-cold batches are DP-cut at width boundaries into
    # pow2 chunk heights (models/sparse.py::_chunk_bounds_dp: 32..512,
    # plus _routed_q_pad of the requested sizes), so warming only the
    # full-batch heights would leave every intermediate (class, height)
    # compile for the first live mixed batch — enumerate the whole family
    routed_sizes = [q for q in sizes if q >= route_min]
    routed_heights: list[int] = []
    if has_routing and routed_sizes:
        # the DP can cut any >= route_min batch down to 32-row chunks, so
        # the height family always starts at 32 regardless of route_min
        top = max(routed_sizes)
        h = 32
        while h < top:
            routed_heights.append(h)
            h *= 2
        for q in routed_sizes:
            if q not in routed_heights:
                routed_heights.append(q)
        routed_heights.sort()

    variants = [(False, False, False)]
    if weighted:
        variants.append((True, False, False))
    if ids_only and getattr(engine, "search_ids", None) is not None:
        variants.append((False, True, False))
    if filtered:
        variants.append((False, False, True))
    for k in top_ks:
        for t in widths:
            # a class wider than the query width can't occur — clamp
            # instead of silently dropping the size from the plan
            classes = sorted({min(int(c), int(t)) for c in cold_classes})
            for w, io, f in variants:
                for q in sizes:
                    if has_routing and q >= route_min:
                        continue  # covered by routed_heights below
                    add(q, t, None, k, w, io, f)
                for q in routed_heights:
                    for c in classes:
                        add(q, t, c, k, w, io, f)
    return tasks


def warm_engine(
    engine,
    tasks: list[dict] | None = None,
    *,
    seed: int = 0,
    log=None,
    **plan_kwargs,
) -> list[dict]:
    """Run every task through ``engine.search``, timing each dispatch.

    Returns the task list with a ``seconds`` field added per task, and
    the task's first-use work, ``nvcc_build_s``, ``native_build_s`` (the
    text library's C++ build; a search tokenizes nothing, so 0) and
    ``library_load_s``:
    a task that built or loaded nothing runs in milliseconds.  Safe to
    re-run — idempotent by construction (results are discarded).
    """
    from bm25_tpu_torch.runtime.profiling import compile_phase_collector

    if tasks is None:
        tasks = default_plan(engine, **plan_kwargs)
    rng = np.random.default_rng(seed)
    # one mask for every filtered task, built and uploaded ONCE (half
    # density keeps selection inputs realistic) — rebuilding + re-putting
    # a num_docs-sized array per task would pollute the timings
    mask = None
    if any(t.get("filtered") for t in tasks):
        mask = np.arange(int(engine.num_docs)) % 2 == 0
        put = getattr(getattr(engine, "session", None), "put", None)
        if put is not None:
            mask = put(np.ascontiguousarray(mask))
    report = []
    for task in tasks:
        # .get() throughout: default_plan's docstring invites callers to
        # edit the plan, so older/hand-built task dicts missing newer keys
        # must not KeyError
        ids = _query_matrix(engine, task["q"], task["t"],
                            task.get("cold"), rng)
        weights = None
        if task.get("weighted"):
            # unit weights: tail-tier engines require non-negative weights
            weights = np.ones_like(ids, dtype=np.float32)
        kw = {}
        if task.get("filtered"):
            kw["doc_mask"] = mask
        t0 = time.monotonic()
        with compile_phase_collector() as phases:
            if task.get("ids_only"):
                engine.search_ids(ids, top_k=task["top_k"], weights=weights,
                                  **kw)
            elif weights is not None:
                engine.search(ids, top_k=task["top_k"], weights=weights,
                              **kw)
            else:
                engine.search(ids, top_k=task["top_k"], **kw)
        entry = dict(task, seconds=round(time.monotonic() - t0, 3),
                     **{k: round(v, 3) for k, v in phases.items()})
        report.append(entry)
        if log is not None:
            c = entry.get("cold")
            c = "-" if c is None else c
            flags = "".join(
                f" {name}" for name, on in
                (("weighted", entry.get("weighted", False)),
                 ("ids_only", entry.get("ids_only", False)),
                 ("filtered", entry.get("filtered", False)))
                if on
            )
            log(
                f"warm q={entry['q']:>4} t={entry['t']:>3} cold={c:>2} "
                f"k={entry['top_k']:>5}{flags}: {entry['seconds']:.3f}s "
                f"(nvcc {entry['nvcc_build_s']:.3f}s, load "
                f"{entry['library_load_s']:.3f}s)"
            )
    return report
