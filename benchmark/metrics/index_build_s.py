"""Host seconds of ``scoring.build_scored_index_flat`` (the host layer)."""


def read(record: dict):
    return record.get("spans_s", {}).get("index_build")
