"""Readings that the limits of ``correct`` are set from.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3] [--out FILE]

For each seed, in one process: the cell's set-up and as many units of its
traffic as its check needs (``readings_units`` in the cell's traffic: the
window's first epoch for training, a batch for serving), then the numbers
the check compares, for the program; for the control seeds also the
numbers of the control (the reference in the precision below the one the
configuration states, put in the program's place) and of the planted
faults. Prints one JSON line per seed and a summary: per number, the
largest reading of the program (the lower reading) and the smallest of the
control and of each fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def read_seed(name: str, seed: int, control: bool, device: str = "cuda", overrides=None) -> dict:
    from portbench import catalog
    from portbench.run import Context
    from portbench.trace import Tracer

    wl, cfg = catalog.load_cell(name, overrides)
    dev = torch.device(device)
    cell = catalog.driver(wl["driver"]).Cell(Context(name, wl, cfg, seed, dev, Tracer(False, dev.type)))
    t0 = time.perf_counter()
    cell.setup()
    for _ in range(int(wl["traffic"].get("readings_units", 0))):
        cell.unit()
    cell.release()
    out = {"seed": seed, "program": cell.program()}
    if control:
        out["control"] = cell.control()
        out["faults"] = cell.faults()
    out["seconds"] = time.perf_counter() - t0
    del cell
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def summary(rows: list) -> dict:
    names = rows[0]["program"].keys()
    out = {}
    for k in names:
        entry = {"lower": max(r["program"][k] for r in rows), "seeds": len(rows)}
        ctrl = [r["control"][k] for r in rows if "control" in r]
        if ctrl:
            entry["control_min"] = min(ctrl)
        for f in {f for r in rows for f in r.get("faults", {})}:
            vals = [r["faults"][f][k] for r in rows if f in r.get("faults", {})]
            entry[f"{f}_min"] = min(vals)
        out[k] = entry
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        rows.append(read_seed(args.workload, seed, seed in ctrl))
        line = json.dumps(rows[-1])
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
