"""The benchmark of ``bm25_tpu_torch`` (see ``run.py``)."""
