"""Per-layer metric readers, one file a metric: ``<metric>.py`` with
``read(record) -> float | None``."""
