"""Queries a second of the untraced window that a ``--trace 1`` run makes
before its traced calls: the queries of the window's whole calls over its
whole time, taken as the end-to-end ``qps`` is.  For a cell whose ``qps``
is paced by a shared host and so spreads too widely from run to run to
hold a bound."""

WINDOW = True  # the harness runs the untraced window in the traced run


def read(record: dict):
    w = record.get("window")
    if not w or not w["elapsed_s"]:
        return None
    return w["queries"] / w["elapsed_s"]
