"""Device ms a traced call in B1's scan, table and hot kernels
(``ops/ell_score.py`` → ``csrc/ell_score.cu``), by the name patterns of
``kernel_groups.json``: the program's own kernel names."""

from benchmark.metrics._common import kernel_group_ms


def read(record: dict):
    return kernel_group_ms(record, "scan_ms")
