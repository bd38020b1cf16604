"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It refuses to run without as many CUDA cards
as the cell asks for, and never falls back to the CPU. It makes the cell's
inputs and weights from ``--seed``, sets the program up and warms it (the
set-up, ``setup_s``, counted from the process's start), runs whole units of
the cell's traffic (epochs, batches) until ``--seconds`` have passed, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` a ``breakdown``,
and ``checks``, each number the reference comparison read beside its
limit. The comparison runs after the window has closed, the peak memory
has been read and the program's state is freed; its numbers are also the
last lines of standard error. With ``--trace 0`` the metrics are the
cell's end-to-end ones; with ``--trace 1`` its per-layer ones, read over
the part of the window that ``torch.profiler`` covers (its whole units
until ``TRACE_SECONDS`` have passed) or, where a reader asks, over the
untraced rest of the window, which runs from the profiler's stop.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from dataclasses import dataclass

T_IMPORT = time.time()

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "msd_tpu")
# A traced run profiles the window's whole units until this many seconds
# have passed, then runs the rest of the window untraced: reducing the
# profile of a 50 s window would take the run past its time limit. The
# per-layer metrics are read over the traced part.
TRACE_SECONDS = 25.0


def process_start() -> float:
    """Wall-clock start of this process, from /proc; the import time of
    this module where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
        return start if start <= T_IMPORT else T_IMPORT
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


class PhaseClock:
    """Seconds of the phases of a set-up, printed on standard error."""

    def __init__(self, what: str):
        self.what = what
        self.t = time.perf_counter()
        self.phases = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = round(now - self.t, 3)
        self.t = now

    def report(self) -> None:
        print(f"portbench {self.what} set-up: {json.dumps(self.phases)}", file=sys.stderr, flush=True)


@dataclass
class Context:
    """What a driver's cell is given: the cell's name and file, its
    configuration, the run's seed, the device, the tracer."""

    name: str
    workload: dict
    config: dict
    seed: int
    device: object
    tracer: object


@dataclass
class Run:
    """What a metric reader is given: the cell's readings and seconds at
    the end of the traced part of the window, the reduced trace, and the
    readings at the window's end (``final``) with the seconds of the
    untraced rest of the window (``rest_s``, from the profiler's stop)."""

    config: dict
    workload: dict
    readings: dict
    window_s: float
    trace: object
    final: dict
    rest_s: float


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda", overrides=None,
             t0: float | None = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict. The
    command line passes ``device="cuda"`` only; tests pass the CPU and
    ``overrides`` ({"config": {...}, "traffic": {...}}) that shrink it."""
    import torch

    from portbench import catalog
    from portbench.trace import Tracer

    t0 = process_start() if t0 is None else t0
    wl, cfg = catalog.load_cell(name, overrides)
    e2e_entries, layer_entries = catalog.cell_metrics(catalog.manifest(), name)
    dev = torch.device(device)
    tracer = Tracer(trace, dev.type)
    cell = catalog.driver(wl["driver"]).Cell(Context(name, wl, cfg, int(seed), dev, tracer))
    cell.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t0
    units = 0
    traced_s = traced = None
    tracer.start()
    w0 = time.perf_counter()
    end = w0 + seconds
    while True:
        cell.unit()
        units += 1
        now = time.perf_counter()
        if tracer.active and (now - w0 >= TRACE_SECONDS or now >= end):
            traced_s, traced = now - w0, cell.readings()
            tracer.stop()
            # the rest of the window runs untraced from the profiler's stop
            rest0 = time.perf_counter()
            end = rest0 + max(seconds - traced_s, 0.0)
            now = rest0
        if now >= end:
            break
    w1 = time.perf_counter()
    window_s = w1 - w0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    final = cell.readings()
    tr = tracer.reduce()
    attempted, failed = cell.outcome()
    if trace:
        rest_s = w1 - rest0
        print(f"portbench traced part: {traced_s!r} s, readings {json.dumps(traced)}; untraced rest: {rest_s!r} s, "
              f"readings at the end {json.dumps(final)}", file=sys.stderr, flush=True)
        run = Run(cfg, wl, traced, traced_s, tr, final, rest_s)
        metrics = {}
        for m in layer_entries:
            value = catalog.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(cell.end_to_end(window_s), setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in e2e_entries}
    cell.release()
    checks = cell.check()
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        info["busy_s"] = tr.busy_s if tr is not None else 0.0
        info["window_s"] = tr.window_s if tr is not None else window_s
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": info, "units": units}
    if trace and tr is not None:
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t0 = process_start()

    from portbench import catalog

    chips = catalog.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}; the port must not load JAX or msd_tpu", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
