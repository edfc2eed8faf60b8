"""The control: the reference in bfloat16, the precision below the
configurations' float32, put in the program's place, has to come out as
not correct under every cell's limits."""

import pytest
import torch

from benchmark import control, harness
from conftest import SEED, tiny_cell

CELLS = ["msmarco-k1000-b512", "quora-k100-b512"]
SMALL = {"num_docs": 20000, "vocab_size": 4096, "num_queries": 300}


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, seed):
    cell = tiny_cell(name, check_rows=128)
    cell["config"].update(SMALL)
    out = control.control_numbers(cell, seed, torch.device("cpu"))
    assert out["correct"] is False
    assert out["numbers"]["score_gap"] > 3 * out["limits"]["score_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    cell = harness.load_cell(name)
    out = control.control_numbers(cell, SEED, torch.device("cuda", 0))
    assert out["correct"] is False
