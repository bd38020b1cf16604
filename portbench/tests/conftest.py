"""The benchmark's CPU tests: each cell's parts (its tiny sizes, card
sizes, faults and span metrics) come from its file under ``cells/``,
found by the cell's name in ``BENCHMARK.json``."""

import pytest
import torch

from portbench.tests.cells import Cells

CELL_TESTS = Cells()
SMALL = CELL_TESTS.table("SMALL")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
