"""``BENCHMARK.json`` against the files the harness finds by name, the
characters its names may use, and a tiny run of each cell on the CPU, where
the program's plain paths and the reference agree to float32 round-off."""

import itertools
import json
import os
import re
import shutil
import time
import types

import pytest

from portbench import catalog
from portbench import run as run_module
from portbench.run import run_cell
from portbench.tests import cells
from portbench.tests.conftest import CELL_TESTS, SMALL

BENCH = catalog.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(catalog.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    wl = catalog.workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"] and wl["chips"] == entry["chips"] == 1
    assert hasattr(catalog.driver(wl["driver"]), "Cell")
    cfg = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert catalog.config(cfg["name"])["name"] == cfg["name"]
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    e2e, per_layer = catalog.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_and_moves(metric):
    assert callable(catalog.metric_reader(metric["name"]).read)
    for cell in metric["workloads"]:
        e2e, _ = catalog.cell_metrics(BENCH, cell)
        assert metric["moves"] in {m["name"] for m in e2e}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_has_its_test_file(cell):
    """Each cell's test file is there, with a non-empty ``SMALL`` and
    ``FAULTS``; the message names the file to add."""
    problems = CELL_TESTS.problems(cell)
    assert not problems, "; ".join(problems)


def test_a_cell_added_as_files_is_found(tmp_path):
    base = tmp_path / "bench"
    shutil.copytree(catalog.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    wl = dict(catalog.workload("stage1.flagship"), why="a cell added by files alone")
    (base / "workloads" / "stage1.extra.json").write_text(json.dumps(wl))
    assert catalog.workload("stage1.extra", base=str(base))["why"] == "a cell added by files alone"
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(name="stage1.extra", config=wl["config"], traffic="stage1-extra", chips=1,
                                   why=wl["why"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "stage1.flagship" in m.get("workloads", []):
            m["workloads"].append("stage1.extra")
    e2e, per_layer = catalog.cell_metrics(bench, "stage1.extra")
    assert {m["name"] for m in e2e} == {"train_samples_per_s", "setup_s"}
    assert {m["name"] for m in per_layer} == {m["name"] for m in catalog.cell_metrics(BENCH, "stage1.flagship")[1]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    test_file = cells.path("stage1.extra", str(base))
    shutil.copyfile(cells.path("stage1.flagship", str(base)), test_file)
    added = cells.Cells(str(base))
    assert "stage1.extra" in added.agreement() and "stage1.extra" in added.card()
    assert "stage1.extra" in added.spans() and not added.problems("stage1.extra")
    assert {f for c, f, _ in added.faults() if c == "stage1.extra"} == set(CELL_TESTS.table("FAULTS")["stage1.flagship"])
    os.remove(test_file)
    missing = cells.Cells(str(base))
    problems = missing.problems("stage1.extra")
    assert problems and "tests/cells/stage1.extra.py" in problems[0]
    assert "stage1.extra" not in missing.agreement() + missing.card() + missing.spans()


@pytest.mark.parametrize("cell", CELL_TESTS.agreement())
def test_reference_agrees_with_the_plain_cpu_path(cell):
    """A tiny run on the CPU, where K2 and K1 run their plain float32
    versions: every compared number reads a hundredth of its limit or less
    (float32 round-off, grown through the fit's Adam steps)."""
    out = run_cell(cell, 2**31 + 7, 0.5, False, device="cpu", overrides=SMALL[cell])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    for name, c in out["checks"].items():
        assert c["value"] <= 0.01 * c["limit"], name
    assert set(out["metrics"]) == {m["name"] for m in catalog.cell_metrics(BENCH, cell)[0]}


def test_traced_run_reports_the_cells_per_layer_metrics_it_can_read_on_the_cpu(monkeypatch):
    """The window's clock advances one second at each reading, so the
    traced part is one unit and the untraced rest, over which ``mfu.train``
    is read, two, however loaded the host."""
    monkeypatch.setattr(run_module, "TRACE_SECONDS", 0.2)
    monkeypatch.setattr(run_module, "time", types.SimpleNamespace(perf_counter=itertools.count().__next__,
                                                                  time=time.time))
    out = run_cell("stage1.flagship", 11, 3, True, device="cpu", overrides=SMALL["stage1.flagship"])
    assert "mfu.train" in out["metrics"] and "breakdown" in out and out["device"]["window_s"] > 0
    assert list(out)[-1] == "checks"
