"""The per-layer metrics that read the program's spans
(``portbench/program_spans.py``): a traced run of each cell on the CPU
reports them, read over the untraced rest of its window; without a span
under the profiler they read nothing."""

import copy
import itertools
import time
import types

import pytest

from portbench import catalog
from portbench import program_spans
from portbench import run as run_module
from portbench.run import Run, run_cell
from portbench.tests.conftest import CELL_TESTS, SMALL

SPAN_METRICS = CELL_TESTS.table("SPAN_METRICS")


@pytest.mark.parametrize("cell", CELL_TESTS.spans())
def test_traced_run_reports_the_span_metrics_on_the_cpu(cell, monkeypatch):
    """The window's clock advances one second at each reading, so the
    traced part is one unit and the untraced rest two, however loaded the
    host. A cell's ``traced_cpu`` adjusts the run (the serve cell streams
    its meshes as on the card)."""
    monkeypatch.setattr(run_module, "TRACE_SECONDS", 0.2)
    monkeypatch.setattr(run_module, "time", types.SimpleNamespace(perf_counter=itertools.count().__next__,
                                                                  time=time.time))
    overrides = copy.deepcopy(SMALL[cell])
    adjust = getattr(CELL_TESTS.modules[cell], "traced_cpu", None)
    if adjust is not None:
        adjust(monkeypatch, overrides)
    out = run_cell(cell, 2**31 + 23, 3, True, device="cpu", overrides=overrides)
    assert out["units"] == 3 and out["correct"]
    for name in SPAN_METRICS[cell]:
        assert out["metrics"][name]["value"] > 0, name
        entry = next(m for m in catalog.manifest()["per_layer"] if m["name"] == name)
        assert entry["source"] == "program_span"
        # the cells with a test file that list the metric are those whose file names it
        listed = {c for c in entry["workloads"] if c in CELL_TESTS.modules}
        assert listed == {c for c, names in SPAN_METRICS.items() if name in names}
        assert out["metrics"][name]["unit"] == entry["unit"]


def test_no_span_under_the_profiler_reads_nothing():
    """Spans that no profiler covered give no rest to read (a ring that
    lost the traced part's last span, or a run with no traced span)."""
    from msd_tpu_torch.utils import spans

    spans.clear()
    with spans.span("stage1.epoch"):
        with spans.span("stage1.step"):
            pass
    run = Run({}, {}, {"shapes": 0}, 1.0, None, {"shapes": 8}, 1.0)
    assert program_spans.rest() is None
    for names in SPAN_METRICS.values():
        for name in names:
            assert catalog.metric_reader(name).read(run) is None
