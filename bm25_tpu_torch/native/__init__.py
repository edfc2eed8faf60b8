"""Native (C++) host-side fast paths: tokenizer, Snowball stemmer and
counting-sort CSC build.

The sources in ``native/src`` compile at first use (``native/_build.py``)
into the kernels' build directory and load via ctypes
(``native/loader.py``); a missing compiler or a failed build raises.
"""
