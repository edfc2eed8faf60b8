"""Helpers of the PyTorch port: shape padding and the query-batch contract
(copies of ``bm25_tpu/utils``), device counts and the oracle comparator."""
