"""``msd_tpu_torch.utils.spans`` on the CPU: nesting, parents and self time,
the ring's bound, a worker thread's spans, the profiler rule (no
``record_function`` without a profiler; with one, the span's start and its
event's on one clock), and the spans of the Stage-1 epoch, the fit, the
streamed ``create_mesh`` and the reconstruct CLI, with the
``LAST_STREAMING_STATS`` seconds they fill."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from msd_tpu_torch import mesh
from msd_tpu_torch import reconstruct as reconstruct_cli
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder, give_surface_
from msd_tpu_torch.train.reconstruct import reconstruct_batch
from msd_tpu_torch.train.stage1 import Stage1Trainer
from msd_tpu_torch.utils import checkpoint as ckpt
from msd_tpu_torch.utils import spans
from msd_tpu_torch.utils.spans import span
from test_torch_dp import STAGE1_SPECS

LATENT = 8
MESH_N = 129
STEP_CHILDREN = {"stage1.sample", "stage1.regularisers", "stage1.backward", "stage1.optimizer"}
STREAM_KEYS = {"t_refine", "t_stream", "t_crossing", "t_fetch", "t_mesher", "t_ply"}


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def named(recs, name):
    return [r for r in recs if r.name == name]


def test_nesting_parents_and_self_time():
    with span("a") as a:
        with span("a.b") as b:
            time.sleep(0.002)
        with span("a.c") as c:
            with span("a.c.d") as d:
                time.sleep(0.001)
    recs = spans.records()
    assert [r.name for r in recs] == ["a.b", "a.c.d", "a.c", "a"]  # in the order they closed
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, a.id, c.id)
    assert a.start_ns <= b.start_ns < b.end_ns <= c.start_ns <= d.start_ns < d.end_ns <= c.end_ns <= a.end_ns
    assert b.ns >= 2_000_000 and d.ns >= 1_000_000
    assert b.seconds == pytest.approx(b.ns * 1e-9)
    s = spans.summary()
    assert {k: v["count"] for k, v in s.items()} == {"a": 1, "a.b": 1, "a.c": 1, "a.c.d": 1}
    assert s["a"]["total_s"] == pytest.approx(a.ns * 1e-9)
    assert s["a"]["self_s"] == pytest.approx((a.ns - b.ns - c.ns) * 1e-9)
    assert s["a.c"]["self_s"] == pytest.approx((c.ns - d.ns) * 1e-9)
    assert s["a.c.d"]["self_s"] == s["a.c.d"]["total_s"]
    assert spans.last("a.c") is c and spans.last("none") is None
    assert all(r.thread == threading.get_ident() and not r.profiled for r in recs)


def test_a_span_closes_on_an_exception():
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError
    assert [r.name for r in spans.records()] == ["inner", "outer"]
    with span("after") as after:
        pass
    assert after.parent is None  # the stack unwound


def test_ring_keeps_the_newest_records():
    n = spans.RING_SIZE + 10
    for _ in range(n):
        with span("x"):
            pass
    recs = spans.records()
    assert len(recs) == spans.RING_SIZE
    ids = [r.id for r in recs]
    assert ids == sorted(ids) and ids[-1] - ids[0] == spans.RING_SIZE - 1


def test_worker_thread_spans_share_the_ring():
    got = {}

    def work():
        with span("worker") as got["w"]:
            with span("worker.inner"):
                pass

    with span("main") as m:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    w = got["w"]
    inner = spans.last("worker.inner")
    assert w.parent is None and inner.parent == w.id  # a thread's own stack
    assert w.thread == inner.thread != m.thread
    assert {r.name for r in spans.records()} == {"main", "worker", "worker.inner"}


def test_many_threads_lose_no_span():
    """More threads than cores open nested spans with a short switch
    interval while the main thread reads the ring: every span is there once,
    each inner one under its own thread's outer one."""
    threads, per = 2 * (os.cpu_count() or 1) + 2, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with span("outer"):
                    with span("inner"):
                        pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        while any(t.is_alive() for t in pool):
            spans.last("outer")
            spans.summary()
        for t in pool:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    recs = spans.records()
    assert len(recs) == 2 * threads * per and len({r.id for r in recs}) == len(recs)
    outer = {r.id: r.thread for r in recs if r.name == "outer"}
    assert all(outer[r.parent] == r.thread for r in recs if r.name == "inner")


@pytest.mark.parametrize("profiled", [False, True], ids=["no_profiler", "profiler"])
def test_record_function_only_while_a_profiler_records(profiled, monkeypatch):
    """Without a profiler a span makes no ``record_function`` (a stand-in
    that raises pins it); the profiler's own Python flag is what it reads."""
    if not profiled:
        def refuse(name):
            raise AssertionError("record_function without a profiler")

        monkeypatch.setattr(autograd_profiler, "record_function", refuse)
        assert autograd_profiler._is_profiler_enabled is False
        with span("quiet") as s:
            pass
        assert not s.profiled
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled is True
        with span("loud") as s:
            torch.ones(8).sum()
    assert s.profiled and autograd_profiler._is_profiler_enabled is False
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "loud"]
    assert len(events) == 1


def test_span_and_its_profiler_event_share_a_clock():
    """A span's ring start and its ``record_function`` event's
    ``start_ns()`` agree within 1 ms, as do their ends."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span("clock"):
                torch.ones(64).sum()
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "clock"),
                    key=lambda e: e.start_ns())
    recs = named(spans.records(), "clock")
    assert len(events) == len(recs) == 3
    for e, r in zip(events, recs):
        assert abs(e.start_ns() - r.start_ns) < 1_000_000
        assert abs(e.end_ns() - r.end_ns) < 1_000_000


def stage1_experiment(tmp_path, **overrides):
    from chip_smoke import write_dataset

    split = write_dataset(str(tmp_path / "data"), 12, 3000, seed=5)
    split_path = str(tmp_path / "split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    exp = str(tmp_path / "exp")
    os.makedirs(exp)
    specs = dict(STAGE1_SPECS, ScenesPerBatch=1, DataSource=str(tmp_path / "data" / "SdfSamples"),
                 TrainSplit=split_path, TestSplit=split_path, **overrides)
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(specs, f)
    return exp


@pytest.mark.parametrize("route", ["fused", "autograd"])
def test_train_epoch_spans(route, tmp_path):
    """An epoch of 12 steps: one ``stage1.epoch``, 12 ``stage1.step`` with
    their children under them, and one ``stage1.fetch``; the loss is
    ``stage1.k2`` on K2's route and ``stage1.loss`` on the autograd one."""
    tr = Stage1Trainer(stage1_experiment(tmp_path, UseFusedTrainKernel=route == "fused"), device="cpu")
    assert tr.use_fused == (route == "fused")
    spans.clear()
    tr.train_epoch(1)
    recs = spans.records()
    (epoch,), (fetch,) = named(recs, "stage1.epoch"), named(recs, "stage1.fetch")
    steps = named(recs, "stage1.step")
    assert len(steps) == 12 and all(s.parent == epoch.id for s in steps) and fetch.parent == epoch.id
    loss = "stage1.k2" if route == "fused" else "stage1.loss"
    by_step = {s.id: [] for s in steps}
    for r in recs:
        if r.parent in by_step:
            by_step[r.parent].append(r.name)
    for names in by_step.values():
        assert sorted(names) == sorted(STEP_CHILDREN | {loss})
    assert steps[0].start_ns >= epoch.start_ns and fetch.end_ns <= epoch.end_ns
    assert fetch.start_ns >= steps[-1].end_ns


def test_reconstruct_batch_spans():
    torch.manual_seed(0)
    dec = DeepSDFDecoder(LATENT, [32, 32, 32], latent_in=[1], weight_norm=True)
    rng = np.random.default_rng(0)
    shapes = [(np.c_[rng.uniform(-1, 1, (200, 3)), rng.uniform(0, 0.1, 200)].astype(np.float32),
               np.c_[rng.uniform(-1, 1, (200, 3)), rng.uniform(-0.1, 0, 200)].astype(np.float32))
              for _ in range(2)]
    reconstruct_batch(dec, 5, LATENT, shapes, 0.01, 0.1, num_samples=64)
    recs = spans.records()
    (fit,) = named(recs, "fit")
    kids = [r for r in recs if r.parent == fit.id]
    assert sorted(r.name for r in kids) == ["fit.fetch", "fit.iterations", "fit.upload"]
    assert [r.name for r in sorted(kids, key=lambda r: r.start_ns)] == ["fit.upload", "fit.iterations", "fit.fetch"]


@pytest.fixture(scope="module")
def surface_decoder():
    torch.manual_seed(3)
    dec = DeepSDFDecoder(LATENT, [64] * 4, latent_in=[2], weight_norm=True).eval()
    with torch.no_grad():
        give_surface_(dec, torch.zeros(LATENT))
    return dec


def test_streamed_create_mesh_spans(surface_decoder, tmp_path, monkeypatch):
    """A streamed mesh (``_streams`` on for a CPU evaluator) with its PLY
    spilled: the ``mesh.*`` spans nest as ``create_mesh`` runs them, the
    mesher's run in the worker, and ``LAST_STREAMING_STATS``' seconds are
    theirs; the keys it no longer has are gone."""
    monkeypatch.setattr(mesh, "_streams", lambda evaluator: True)
    monkeypatch.setenv("MSD_SPILL_TMP", str(tmp_path))
    assert mesh.create_mesh(surface_decoder, torch.zeros(LATENT), str(tmp_path / "m"), N=MESH_N) is True
    recs = spans.records()
    (call,), (refine,), (stream,), (finish,), (ply,) = (named(recs, n) for n in (
        "mesh.create_mesh", "mesh.refine", "mesh.stream", "mesh.finish", "mesh.ply"))
    assert refine.parent == stream.parent == finish.parent == ply.parent == call.id
    waits, mesher = named(recs, "mesh.mesher_wait"), named(recs, "mesh.mesher")
    crossing, fetch = named(recs, "mesh.crossing"), named(recs, "mesh.fetch")
    assert waits and mesher and crossing and fetch
    assert all(r.parent == stream.id for r in waits + crossing + fetch)
    assert all(r.parent is None and r.thread != call.thread for r in mesher)
    stats = mesh.LAST_STREAMING_STATS
    assert stats["t_mesher"] == sum(r.ns for r in waits) * 1e-9
    assert stats["t_refine"] == refine.seconds and stats["t_stream"] == stream.seconds and stats["t_ply"] == ply.seconds
    assert stats["t_crossing"] == pytest.approx(sum(r.seconds for r in crossing))
    assert stats["t_fetch"] == pytest.approx(sum(r.seconds for r in fetch))
    assert {k for k in stats if k.startswith("t_")} == STREAM_KEYS
    assert os.path.getsize(tmp_path / "m.ply") > 0


@pytest.mark.parametrize("batch", [0, 2], ids=["one_at_a_time", "batch2"])
def test_cli_times_are_the_spans(batch, surface_decoder, tmp_path, monkeypatch):
    """The reconstruct CLI's ``t_reconstruct`` is the ``fit`` span (over
    the batch's shapes) and ``t_mesh`` the ``mesh.create_mesh`` span."""
    from chip_smoke import write_dataset

    exp, data = tmp_path / "exp", tmp_path / "data"
    os.makedirs(exp)
    specs = {"NetworkArch": "deep_sdf_decoder", "CodeLength": LATENT,
             "NetworkSpecs": {"dims": [64] * 4, "latent_in": [2], "weight_norm": True}}
    (exp / "specs.json").write_text(json.dumps(specs))
    ckpt.save_model(str(exp), "latest.pth", surface_decoder, 5)
    (tmp_path / "split.json").write_text(json.dumps(write_dataset(str(data), 2, 3000, seed=3)))
    summary = reconstruct_cli.main([
        "-e", str(exp), "-c", "latest", "-d", str(data / "SdfSamples"), "-s", str(tmp_path / "split.json"),
        "--iters", "5", "--mesh_resolution", "65", "--device", "cpu", "--quiet", "--batch", str(batch),
    ])
    recs = spans.records()
    fits, meshes = named(recs, "fit"), named(recs, "mesh.create_mesh")
    assert len(summary) == len(meshes) == 2 and len(fits) == (1 if batch else 2)
    assert [s["t_mesh"] for s in summary] == [r.seconds for r in meshes]
    want = [fits[0].seconds / 2] * 2 if batch else [r.seconds for r in fits]
    assert [s["t_reconstruct"] for s in summary] == want
