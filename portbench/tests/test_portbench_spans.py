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
from portbench.tests.conftest import SMALL

SPAN_METRICS = {"stage1.flagship": ("step_host_ms.train", "fetch_wait_ms.train"),
                "serve.flagship-b8": ("mesher_busy_s_per_shape.serve", "mesh_tail_s_per_shape.serve")}


@pytest.mark.parametrize("cell", list(SPAN_METRICS))
def test_traced_run_reports_the_span_metrics_on_the_cpu(cell, monkeypatch):
    """The window's clock advances one second at each reading, so the
    traced part is one unit and the untraced rest two, however loaded the
    host. The serve cell streams its meshes as on the card (``_streams`` on
    for a CPU evaluator, at a resolution that refines in blocks)."""
    from msd_tpu_torch import mesh

    monkeypatch.setattr(run_module, "TRACE_SECONDS", 0.2)
    monkeypatch.setattr(run_module, "time", types.SimpleNamespace(perf_counter=itertools.count().__next__,
                                                                  time=time.time))
    overrides = copy.deepcopy(SMALL[cell])
    if cell.startswith("serve"):
        monkeypatch.setattr(mesh, "_streams", lambda evaluator: True)
        overrides["traffic"]["mesh_resolution"] = 97
        overrides["config"]["NetworkSpecs"] = dict(overrides["config"]["NetworkSpecs"], dims=[32] * 4, latent_in=[2])
    out = run_cell(cell, 2**31 + 23, 3, True, device="cpu", overrides=overrides)
    assert out["units"] == 3 and out["correct"]
    for name in SPAN_METRICS[cell]:
        assert out["metrics"][name]["value"] > 0, name
        entry = next(m for m in catalog.manifest()["per_layer"] if m["name"] == name)
        assert entry["source"] == "program_span" and entry["workloads"] == [cell]
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
