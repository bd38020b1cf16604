"""The port's streamed ``create_mesh`` over a group of 3 gloo ranks on the
CPU against one process streaming alone: every rank's mesh bit for bit in
both refinement classes, on the device refinement and on the host route
(the device count made to overflow, so every rank joins the lattice's
``eval_points``), with the corner dedup forced on; the PLY written by the
main rank alone, byte for byte one process's; an empty surface returning
False on every rank; a failure on the main rank, in the stream and in its
lattice share, raising on every rank; each rank's points and the bytes it
broadcast or received.

Streaming is forced on the CPU (``mesh._streams``; on the card it is the
default) inside the rank function, since ``monkeypatch`` does not cross a
spawn. On the CPU a point's float32 value does not depend on its place in
a batch (``mesh.CPU_ROW_ALIGN``), so a lattice split over the ranks gives
one process's bits. This module imports no JAX: the ranks import it again
(tests/test_torch_stream_ranks_jax.py holds the ranks against msd_tpu and
reuses the rank function and decoder here)."""

import copy
import os

import numpy as np
import pytest
import torch

from msd_tpu_torch import mesh
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.models.deepsdf import decode_sdf
from msd_tpu_torch.parallel import run_ranks
from test_torch_dp import TIMEOUT, cpus

LATENT = 16
NET = dict(dims=[32] * 4, dropout=[], dropout_prob=0.0, norm_layers=[], latent_in=[2], xyz_in_all=False,
           use_tanh=False, latent_dropout=False, weight_norm=True)
RANKS = 3
# slabs of 2048 blocks, as in the streaming tests, so a call streams several
CHUNK = 2048
# the refinement classes (mesh._refine_class): one level at N=129 with
# create_mesh's clamp_dist 0.1; two levels from N=385 at 0.1, and from
# N=193 at 0.2, which the two-level cases take (a quarter of N=385's blocks)
TWO_LEVEL = dict(N=193, clamp=0.2)
CASES = [
    dict(name="single_level", N=129, codec="packed"),
    dict(name="two_level", **TWO_LEVEL, codec="int8"),
    dict(name="single_level_host", N=129, codec="f16", host=True),
    dict(name="two_level_host", **TWO_LEVEL, codec="packed", host=True),
    dict(name="two_level_dedup", **TWO_LEVEL, codec="packed", dedup="on"),
    dict(name="ply", N=129, codec="packed", ply=True),
    dict(name="empty", N=129, codec="packed", decoder="empty"),
    dict(name="fail_stream", N=129, codec="packed", fail="stream"),
    dict(name="fail_lattice", N=129, codec="packed", fail="lattice"),
]
MESH_CASES = [c["name"] for c in CASES if not c.get("fail") and c.get("decoder") != "empty" and not c.get("ply")]
BY_NAME = {c["name"]: c for c in CASES}


def fitted_decoder(seed=21, steps=300):
    """A decoder at the tests' width, seeded, then fitted for ``steps`` Adam
    steps of 1024 points to an ellipsoid's distance field at a seeded
    latent, so its surface is closed (as tests/test_torch_streaming_mesh.py
    fits its pair). Returns (decoder, latent)."""
    dec = build_decoder("deep_sdf_decoder", LATENT, NET, generator=torch.Generator().manual_seed(seed))
    latent = (0.05 * np.random.default_rng(seed + 1).standard_normal(LATENT)).astype(np.float32)
    axes = torch.tensor([0.55, 0.4, 0.45])
    g = torch.Generator().manual_seed(0)
    opt = torch.optim.Adam(dec.parameters(), lr=2e-3)
    for _ in range(steps):
        x = torch.rand(1024, 3, generator=g) * 2 - 1
        target = (torch.linalg.norm(x / axes, dim=1) - 1) * axes.min()
        loss = (decode_sdf(dec, torch.from_numpy(latent), x)[:, 0] - target).abs().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    return dec.eval(), latent


def empty_decoder(dec):
    """``dec`` with its output raised by 1 everywhere: no surface."""
    empty = copy.deepcopy(dec)
    with torch.no_grad():
        getattr(empty, f"lin{empty.num_layers - 2}").bias += 1.0
    return empty


def run_case(ev, latent, case, out_dir):
    """``create_mesh`` through ``ev`` as ``case`` asks: its N, clamp_dist and codec,
    ``MSD_STREAM_DEDUP`` set (else unset), the device refinement's cap made
    to overflow (``host``), the PLY written to ``<out_dir>/<name>.ply``
    (``ply``, without ``return_mesh``)."""
    prev = os.environ.pop("MSD_STREAM_DEDUP", None)
    if case.get("dedup"):
        os.environ["MSD_STREAM_DEDUP"] = case["dedup"]
    if case.get("host"):
        refine = ev.refine_active4_device
        ev.refine_active4_device = lambda *a, **kw: refine(*a, **kw, cap4=2)
    try:
        filename = os.path.join(out_dir, case["name"]) if case.get("ply") else None
        return mesh.create_mesh(ev.decoder, torch.from_numpy(latent), filename, N=case["N"],
                                return_mesh=not case.get("ply"), clamp_dist=case.get("clamp", 0.1), evaluator=ev,
                                value_codec=case["codec"])
    finally:
        os.environ.pop("MSD_STREAM_DEDUP", None)
        if prev is not None:
            os.environ["MSD_STREAM_DEDUP"] = prev


def _forced(*args, **kwargs):
    raise RuntimeError("forced failure on the main rank")


def stream_rank(group, decoders, latent, cases, out_dir):
    """Every case on this rank, in order, on one CPU thread with streaming
    forced: {name: {"result", "error", "stats", "n_evaluated"}}. The main
    rank's evaluator fails where a case says so: in the stream after the
    route's broadcast ("stream"), or in its share of the host route's
    lattice ("lattice", the device refinement skipped)."""
    torch.set_num_threads(1)
    mesh._streams = lambda evaluator: True
    mesh.PointEvaluator.A_CHUNK = CHUNK
    rank_dir = os.path.join(out_dir, f"rank{group.rank}")
    os.makedirs(rank_dir, exist_ok=True)
    out = {}
    for case in cases:
        ev = mesh.PointEvaluator(decoders[case.get("decoder", "fitted")], group=group)
        if group.is_main and case.get("fail") == "stream":
            ev.stream_crossing_values = _forced
        elif group.is_main and case.get("fail") == "lattice":
            ev.refine_active4_device = lambda *a, **kw: None
            ev._eval_local = _forced
        result = error = None
        try:
            result = run_case(ev, latent, case, rank_dir)
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
        out[case["name"]] = {"result": result, "error": error, "stats": dict(mesh.LAST_STREAMING_STATS),
                             "n_evaluated": ev.n_evaluated}
    return out


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def decoders(one_thread):
    dec, latent = fitted_decoder()
    return {"fitted": dec, "empty": empty_decoder(dec)}, latent


@pytest.fixture(scope="module")
def ranks(decoders, tmp_path_factory):
    """One spawn of 3 ranks running every case."""
    decs, latent = decoders
    out_dir = str(tmp_path_factory.mktemp("stream_ranks"))
    out = run_ranks(stream_rank, RANKS, (decs, latent, CASES, out_dir), devices=cpus(RANKS), timeout=TIMEOUT)
    return out, out_dir


@pytest.fixture(scope="module")
def one_process(decoders, tmp_path_factory):
    """Every case but the failures in this process, streaming alone."""
    decs, latent = decoders
    out_dir = str(tmp_path_factory.mktemp("stream_one"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh, "_streams", lambda evaluator: True)
        mp.setattr(mesh.PointEvaluator, "A_CHUNK", CHUNK)
        for case in CASES:
            if case.get("fail"):
                continue
            ev = mesh.PointEvaluator(decs[case.get("decoder", "fitted")])
            result = run_case(ev, latent, case, out_dir)
            out[case["name"]] = {"result": result, "stats": dict(mesh.LAST_STREAMING_STATS),
                                 "n_evaluated": ev.n_evaluated}
    return out, out_dir


def lattice_share(case, rank):
    """The points of the host route's lattice that ``rank`` evaluates
    (``DataParallelGroup.row_slice``)."""
    n = mesh._host_lattice(case["N"], 1.3, case.get("clamp", 0.1))[0].shape[0]
    per = -(-n // RANKS)
    return min((rank + 1) * per, n) - min(rank * per, n)


STAT_KEYS = ("refine", "active_blocks", "crossing_blocks", "evaluated", "exact_slabs", "dedup", "dedup_slabs",
             "dedup_retries", "num_verts", "num_faces", "value_codec")


@pytest.mark.parametrize("name", MESH_CASES)
def test_streamed_mesh_on_3_ranks_equals_one_process(ranks, one_process, name):
    """Every rank returns the one-process streamed mesh bit for bit; the
    main rank's statistics are one process's; every rank took the route
    the case asks for."""
    case, ref = BY_NAME[name], one_process[0][name]
    verts, faces = ref["result"]
    assert faces.shape[0] > 1000 and ref["stats"]["exact_slabs"] == 0
    route = "host" if case.get("host") else "device"
    assert ref["stats"]["refine"] == route
    assert mesh._refine_class(case["N"], 1.3, case.get("clamp", 0.1))[2] == name.startswith("two_level")
    assert ref["stats"]["dedup"] == (case.get("dedup") == "on")
    if ref["stats"]["dedup"]:
        assert ref["stats"]["dedup_slabs"] > 0
    for r, out in enumerate(ranks[0]):
        got = out[name]
        assert got["error"] is None, got["error"]
        np.testing.assert_array_equal(got["result"][0], verts, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["result"][1], faces, err_msg=f"rank {r}")
        assert got["stats"]["refine"] == route
    main = ranks[0][0][name]["stats"]
    assert {k: main[k] for k in STAT_KEYS} == {k: ref["stats"][k] for k in STAT_KEYS}


@pytest.mark.parametrize("name", MESH_CASES)
def test_points_and_broadcast_bytes_per_rank(ranks, one_process, name):
    """``n_evaluated`` counts each rank's own points: the other ranks' their
    share of the lattice on the host route and nothing on the device
    route, the main rank the rest of one process's points. Every rank
    counts the same broadcast bytes (route and outcome)."""
    case, ref = BY_NAME[name], one_process[0][name]
    counts = [out[name]["n_evaluated"] for out in ranks[0]]
    for r in range(1, RANKS):
        assert counts[r] == (lattice_share(case, r) if case.get("host") else 0), counts
        assert ranks[0][r][name]["stats"]["evaluated"] == counts[r]
    assert sum(counts) == ref["n_evaluated"]
    nbytes = [out[name]["stats"]["broadcast_bytes"] for out in ranks[0]]
    assert nbytes[0] > ref["result"][0].nbytes + ref["result"][1].nbytes and len(set(nbytes)) == 1, nbytes


def test_main_rank_alone_writes_the_ply(ranks, one_process):
    """Without ``return_mesh`` every rank returns True and only the main rank
    writes, byte for byte the one-process PLY (the mesher's spill)."""
    out, out_dir = ranks
    for r in range(RANKS):
        assert out[r]["ply"]["error"] is None and out[r]["ply"]["result"] is True
        assert sorted(os.listdir(os.path.join(out_dir, f"rank{r}"))) == (["ply.ply"] if r == 0 else [])
    with open(os.path.join(out_dir, "rank0", "ply.ply"), "rb") as f, \
            open(os.path.join(one_process[1], "ply.ply"), "rb") as g:
        assert f.read() == g.read()
    assert "t_ply" in out[0]["ply"]["stats"]


def test_empty_surface_returns_false_on_every_rank(ranks, one_process):
    assert one_process[0]["empty"]["result"] is False
    for out in ranks[0]:
        assert out["empty"]["error"] is None and out["empty"]["result"] is False


@pytest.mark.parametrize("where", ["stream", "lattice"])
def test_main_rank_failure_raises_on_every_rank(ranks, where):
    """A failure on the main rank, after the route's broadcast or inside the
    host route's lattice, raises on every rank (within the spawn's
    timeout), and the later cases ran on the same group."""
    out = ranks[0]
    for r in range(RANKS):
        err = out[r][f"fail_{where}"]["error"]
        assert err is not None and "forced failure on the main rank" in err, (r, err)
        if r:
            assert err.startswith("RuntimeError: create_mesh raised on the main rank"), err
    assert out[1][f"fail_{where}"]["stats"]["refine"] == ("device" if where == "stream" else "host")
