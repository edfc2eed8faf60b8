"""The headline corpus and queries of the benchmark (``query_bench``, the
port's copy of the host-only part of ``bm25_tpu/bench/query_bench.py``),
for driving the port at the benchmark shape.  The benchmark harness itself
is not ported yet (ROADMAP.md: the query benchmark harness)."""

from bm25_tpu_torch.bench.query_bench import (BenchConfig, make_queries,
                                              make_synthetic_index)

__all__ = ["BenchConfig", "make_queries", "make_synthetic_index"]
