"""The steps' share of their roofline in the traced calls, in %: the least
time (the calls' least bytes, counted by the harness from its own
postings, over the card's peak bandwidth in ``peaks.json``) over the time
in which some kernel ran on the card (``torch.profiler``)."""


def read(record: dict):
    busy = record.get("kernel_busy_s")
    peak = record.get("peak_bytes_per_s")
    least = record.get("least_bytes")
    if not busy or not peak or not least:
        return None
    return 100.0 * least / peak / busy
