"""Helpers that the per-layer readers share.  A reader returns None where
the record holds nothing for it; the harness then leaves its metric out."""

from __future__ import annotations

import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_group_ms(record: dict, group: str):
    """Device ms a traced call of the kernels whose names match one of
    ``kernel_groups.json``'s patterns for ``group``; None where no kernel
    matches or nothing was traced."""
    with open(os.path.join(HERE, "kernel_groups.json")) as f:
        patterns = [re.compile(p) for p in json.load(f)[group]]
    calls = record.get("traced_calls")
    hits = [s for name, s, _ in record.get("kernels", [])
            if any(p.search(name) for p in patterns)]
    if not calls or not hits:
        return None
    return sum(hits) / calls * 1e3
