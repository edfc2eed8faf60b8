"""The port's benchmarks.  ``query_bench`` is the copy of
``bm25_tpu/bench/query_bench.py``: its headline corpus and queries
(exported here, for driving the port at the benchmark shape) and the
query benchmark harness (``python -m bm25_tpu_torch.bench.query_bench``)."""

from bm25_tpu_torch.bench.query_bench import (BenchConfig, make_queries,
                                              make_synthetic_index)

__all__ = ["BenchConfig", "make_queries", "make_synthetic_index"]
