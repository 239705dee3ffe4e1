"""On the card: each cell at a small size through the kernels and the CUDA
graphs, its batches held to the reference, and the control refused."""

import pytest

from portbench import control
from portbench.harness import run_cell
from portbench.tests.small import CELLS, small_spec


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    spec = small_spec(cell, n_genes=400, lanes=1 << 16)
    out = run_cell(spec, 2**31 + 5, 1.0, False, card)
    assert out["correct"], out
    traced = run_cell(spec, 2**31 + 6, 1.0, True, card)
    assert traced["correct"] and traced["device"]["busy_s"] > 0
    assert control.control_wrong(spec, 7, card)[0] > 0
