"""Host seconds of ``create_engine`` (layout and build), ending in a device
synchronize."""


def read(record: dict):
    return record.get("spans_s", {}).get("engine_build")
