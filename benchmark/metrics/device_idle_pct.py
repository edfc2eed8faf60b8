"""Share of the traced window in which no kernel or copy ran on the card
(``torch.profiler``), in %."""


def read(record: dict):
    window, busy = record.get("window_s"), record.get("busy_s")
    if not window or not busy:
        return None
    return 100.0 * (1.0 - busy / window)
