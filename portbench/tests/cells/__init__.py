"""The tests' parts of each cell, found by name as a run finds a cell's
files: ``cells/<cell>.py`` beside this file, one for each cell of
``BENCHMARK.json``, loaded by path. A cell's file holds

- ``SMALL``: ``{"config": {...}, "traffic": {...}}`` that shrink the cell
  so that a run takes seconds on the CPU (the agreement, fault and span
  runs);
- ``FAULTS``: ``{fault: plant(monkeypatch)}``, each fault the cell can
  have, planted in the program, under which a run must read ``correct``
  false;
- ``CARD_SIZE``: the overrides of the card's control test, at the
  published widths;
- ``SPAN_METRICS``: the cell's per-layer metrics that read the program's
  spans (empty where it has none);
- optionally ``traced_cpu(monkeypatch, overrides)``, which adjusts the
  traced CPU run of the span test.

``SMALL`` and ``FAULTS`` are required and non-empty. Pieces that several
cells share sit here; no cell is named here."""

from __future__ import annotations

import importlib.util
import os

from portbench import catalog

HERE = os.path.dirname(os.path.abspath(__file__))
BASE = os.path.dirname(os.path.dirname(HERE))
REQUIRED = ("SMALL", "FAULTS")

SMALL_NET = {"dims": [128] * 8, "dropout": [], "dropout_prob": 0.2, "norm_layers": [], "latent_in": [4],
             "xyz_in_all": False, "use_tanh": False, "latent_dropout": False, "weight_norm": True}


def path(cell: str, base: str = BASE) -> str:
    return os.path.join(base, "tests", "cells", cell + ".py")


def _load(cell: str, base: str):
    spec = importlib.util.spec_from_file_location(f"portbench.tests.cells.{cell.replace('.', '_')}", path(cell, base))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cells:
    """The cells of ``BENCHMARK.json`` at the root above ``base`` (the
    benchmark's directory, as ``catalog`` takes it), with their test
    files; a cell without one is left out of every parametrization and
    named by ``problems``."""

    def __init__(self, base: str = BASE):
        self.base = base
        self.names = [w["name"] for w in catalog.manifest(os.path.dirname(base))["workloads"]]
        self.modules = {c: _load(c, base) for c in self.names if os.path.isfile(path(c, base))}

    def table(self, key: str) -> dict:
        """``{cell: value}`` of ``key`` over the cells whose file sets it."""
        return {c: getattr(m, key) for c, m in self.modules.items() if hasattr(m, key)}

    def problems(self, cell: str) -> list[str]:
        """What the cell's test file lacks, each naming the file to add or
        complete (empty where nothing)."""
        where = os.path.relpath(path(cell, self.base), os.path.dirname(self.base))
        if cell not in self.modules:
            return [f"cell {cell!r} has no test file: add {where} with {' and '.join(REQUIRED)} "
                    f"(see portbench/tests/cells/__init__.py)"]
        return [f"{where} needs a non-empty {key}" for key in REQUIRED if not getattr(self.modules[cell], key, None)]

    def agreement(self) -> list[str]:
        """Cells of the CPU agreement run."""
        return list(self.table("SMALL"))

    def faults(self) -> list[tuple]:
        """``(cell, fault, plant)`` of every fault of every cell."""
        return [(c, f, plant) for c, table in self.table("FAULTS").items() for f, plant in table.items()]

    def card(self) -> list[str]:
        """Cells of the card's control test."""
        return list(self.table("CARD_SIZE"))

    def spans(self) -> list[str]:
        """Cells with per-layer metrics that read the program's spans."""
        return [c for c, names in self.table("SPAN_METRICS").items() if names]
