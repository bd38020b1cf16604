"""On the card: sound runs of the program read under every limit of their
cell, and the control (the reference in the precision below the one the
configuration states, put in the program's place) reads over at least one
on every seed. At the published widths, with fewer scenes and samples than
the cells run. Skips without a card; run on the
card with ``python -m pytest portbench/tests -m cuda``."""

import pytest
import torch

from portbench import catalog
from portbench.readings import read_seed
from portbench.tests.conftest import CELL_TESTS

CARD_SIZE = CELL_TESTS.table("CARD_SIZE")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELL_TESTS.card())
def test_program_passes_and_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = catalog.workload(cell)["limits"]
    rows = [read_seed(cell, 2**31 + s, True, "cuda", overrides=CARD_SIZE[cell]) for s in (5, 6, 7)]
    for row in rows:
        assert all(row["program"][k] <= limits[k] for k in limits), row
    assert all(any(row["control"][k] > limits[k] for k in limits) for row in rows), rows
