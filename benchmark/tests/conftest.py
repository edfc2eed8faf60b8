"""Shared fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests`` from the root of the repository).  They run on the CPU
at tiny sizes; a test that needs a CUDA device is marked ``cuda`` and
skips inside the test where there is none."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the tiny sizes every CPU test runs a configuration at
TINY = {"num_docs": 2000, "vocab_size": 1024, "num_queries": 96}
SEED = 2**31 + 4097  # above 32 signed bits: seeds may be that large


def tiny_cell(name: str, **traffic) -> dict:
    """The cell ``name`` of BENCHMARK.json at ``TINY`` sizes, with a short
    check and trace."""
    from benchmark import harness

    cell = harness.load_cell(name)
    cell["config"].update(TINY)
    cell["traffic"].update({"check_rows": 48, "trace_calls": 2, **traffic})
    return cell


@pytest.fixture
def sparse_on_cpu(monkeypatch):
    """``create_engine(mode="auto")`` picks the sparse engine on the CPU
    at tiny sizes, as it does on the card at the cells' sizes, and the
    program runs in a CPU session."""
    import bm25_tpu_torch.models.auto as auto
    from bm25_tpu_torch.runtime.session import Session

    monkeypatch.setattr(auto, "device_hbm_bytes", lambda device: 1 << 12)
    return Session("cpu")
