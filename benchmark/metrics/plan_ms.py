"""Mean host ms of the host plan (``maybe_dedup``, then ``plan_chunks``) a
dispatched batch, over the batches of one cycle of calls."""


def read(record: dict):
    times = record.get("plan_ms")
    if not times:
        return None
    return sum(times) / len(times)
