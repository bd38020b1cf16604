"""A run with the program broken underneath reads ``correct`` false: for
each fault a cell can have, planted in the program, the harness's run on
the CPU (past its look for a card) at a tiny size. One card, so no cell
has an exchange between chips to leave out. Each cell's faults and their
plants are in its file under ``cells/``."""

import pytest

from portbench.run import run_cell
from portbench.tests.conftest import CELL_TESTS, SMALL


def _run(cell, monkeypatch, plant):
    plant(monkeypatch)
    return run_cell(cell, 2**31 + 101, 0.3, False, device="cpu", overrides=SMALL[cell])


FAULTS = CELL_TESTS.faults()


@pytest.mark.parametrize("cell,fault,plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_reads_incorrect(cell, fault, plant, monkeypatch):
    out = _run(cell, monkeypatch, plant)
    assert out["correct"] is False
    failing = [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]
    assert failing, out["checks"]
