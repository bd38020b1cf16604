"""Everything a run finds by name: ``BENCHMARK.json`` at the checkout's
root, ``workloads/<cell>.json``, ``configs/<config>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``. A later change adds a
cell, a configuration or a metric by adding files and entries; no file
here lists them."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "workloads", name + ".json"))


def config(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "configs", name + ".json"))


def load_cell(name: str, overrides=None) -> tuple[dict, dict]:
    """(workload, configuration) of cell ``name``, with ``overrides``
    ({"config": {...}, "traffic": {...}}, for tests) applied."""
    wl = workload(name)
    cfg = config(wl["config"])
    overrides = overrides or {}
    cfg["specs"].update(overrides.get("config", {}))
    wl["traffic"].update(overrides.get("traffic", {}))
    return wl, cfg


def _module(kind: str, name: str, base: str):
    path = os.path.join(base, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: str = HERE):
    return _module("drivers", name, base)


def metric_reader(name: str, base: str = HERE):
    return _module("metrics", name, base)


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports: those
    that list it under ``workloads``, or, without that key, every cell
    (end-to-end) or every cell reporting the metric they move (per-layer)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer
