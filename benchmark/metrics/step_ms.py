"""Device ms of the step a dispatched batch: the time in which some kernel
ran on the card in the traced calls (``torch.profiler``'s kernel
intervals, copies left out), over the batches those calls dispatched."""


def read(record: dict):
    busy = record.get("kernel_busy_s")
    batches = record.get("traced_batches")
    if not busy or not batches:
        return None
    return busy * 1e3 / batches
