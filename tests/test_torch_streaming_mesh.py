"""msd_tpu_torch's streaming create_mesh against msd_tpu's on the CPU: the
slab encoder and the packed decoder bit for bit, the device refinement row
for row, the streamed meshes per value codec, the overflow routes, the PLY
spill, and the streamed mesh against the port's float32 mesh.

Where both packages stream, ``A_CHUNK`` is 2048 blocks in both (msd_tpu's
own tests shrink it the same way): the slab padding, not the mesh, depends
on it. The two packages' float32 fields sit up to about 1e-6 apart (so do
two of msd_tpu's own programs on the same points), which now and then moves
a value across a float16 or codec step or a refinement threshold: where
the packages differ, the tests show that each difference is such a value.

The decoder (64 wide, 8 layers, latent 16) is seeded, then fitted for 300
Adam steps of 1024 points to an ellipsoid's distance field, so its surface
is closed; both packages get its weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from msd_tpu import mesh as jax_mesh
from msd_tpu_torch import mesh
from msd_tpu_torch import reconstruct as reconstruct_cli
from msd_tpu_torch.data.mesh_io import load_ply, save_ply
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.models.deepsdf import decode_sdf
from msd_tpu_torch.utils import checkpoint as ckpt
from test_torch_decoder import CONFIGS, LATENT, make_pair
from test_torch_slice import SPECS, experiment  # noqa: F401  (fixture)

N = 129
H = 2.0 / (N - 1)
CODECS = ["f16", "int8", "packed"]
# msd_tpu's bounds of a streamed mesh against the float32 mesh
# (tests/test_streaming_mesh.py:35-38, :58-62, :86-131), in voxels h
F16_NEAREST = 0.05
RESIDUAL = {"int8": 0.08, "packed": 0.06}
# how far apart two float32 evaluations of the field may sit (measured:
# 1.1e-6 between two of msd_tpu's own programs)
FIELD_GAP = 2e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one CPU thread: the test runner's workers share the
    cores, and torch's threads beside them oversubscribe (ten times slower).
    The decoder's fit below then gives the same weights on every host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair(one_thread):
    jdec, _, tdec = make_pair(CONFIGS[0], seed=21)
    latent = (0.05 * np.random.default_rng(22).standard_normal(LATENT)).astype(np.float32)
    axes = torch.tensor([0.55, 0.4, 0.45])
    g = torch.Generator().manual_seed(0)
    opt = torch.optim.Adam(tdec.parameters(), lr=2e-3)
    tdec.train()
    for _ in range(300):
        x = torch.rand(1024, 3, generator=g) * 2 - 1
        target = (torch.linalg.norm(x / axes, dim=1) - 1) * axes.min()
        loss = (decode_sdf(tdec, torch.from_numpy(latent), x)[:, 0] - target).abs().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    tdec.eval()
    params = jax.tree.map(jnp.asarray, jdec.params_from_torch_state_dict(tdec.state_dict()))
    return jdec, params, tdec, latent


@pytest.fixture
def streams(monkeypatch):
    """create_mesh streams through CPU evaluators too (on the card it does
    by default)."""
    monkeypatch.setattr(mesh, "_streams", lambda evaluator: True)


@pytest.fixture
def small_chunk(streams, monkeypatch):
    monkeypatch.setattr(jax_mesh.PointEvaluator, "A_CHUNK", 2048)
    monkeypatch.setattr(mesh.PointEvaluator, "A_CHUNK", 2048)
    for var in ("MSD_STREAM_OPT", "MSD_OPT_FUSE_SLAB0", "MSD_OPT_SLABS", "MSD_OPT_CAP_RATIO_MILLI",
                "MSD_STREAM_SLABS", "MSD_VALUE_CODEC", "MSD_STREAM_DEDUP", "MSD_STREAM_HYBRID"):
        monkeypatch.delenv(var, raising=False)


def jax_stream(pair, codec, n=N):
    jdec, params, _, latent = pair
    out = jax_mesh.create_mesh(jdec, params, latent, N=n, return_mesh=True,
                               evaluator=jax_mesh.PointEvaluator(jdec, params), value_codec=codec)
    return out, dict(jax_mesh.LAST_STREAMING_STATS)


def port_stream(ev, latent, codec, n=N):
    """The port's streamed mesh (with the ``streams`` fixture) and stats."""
    out = mesh.create_mesh(ev.decoder, torch.tensor(latent), N=n, return_mesh=True, evaluator=ev, value_codec=codec)
    return out, dict(mesh.LAST_STREAMING_STATS)


def float32_mesh(ev, latent, n=N):
    """create_mesh's float32 sparse route (``_create_mesh_sparse``)."""
    return mesh._create_mesh_sparse(latent, n, 4, 1.3, ev)


def watertight(faces):
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return bool((counts == 2).all())


def slab_rows(seed=0, n=3000, valid_n=2600):
    """Seeded f16 rows of a slab: single-signed rows, crossing rows, exact
    zeros, magnitudes past every codec's range, and crossing padding rows
    at and after ``valid_n``."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.001, 0.2, (n, 125)) * rng.choice([-1.0, 1.0], (n, 1))
    cross = rng.random(n) < 0.4
    plane = rng.normal(size=(n, 3))
    grid = np.stack(np.meshgrid(*[np.arange(5) - 2.0] * 3, indexing="ij"), -1).reshape(125, 3)
    vals[cross] = (grid @ plane[cross].T).T * 0.02
    vals[rng.random((n, 125)) < 0.02] = 0.0
    vals[rng.random((n, 125)) < 0.01] *= 40.0
    vals[valid_n:, :3] = np.abs(vals[valid_n:, :3]) + 0.1
    vals[valid_n:, 3:6] = -np.abs(vals[valid_n:, 3:6]) - 0.1
    return vals.astype(np.float16)


@pytest.mark.parametrize("cap", [4096, 700], ids=["fits", "overflow"])
@pytest.mark.parametrize("use_u16", [True, False], ids=["u16", "i32"])
@pytest.mark.parametrize("codec", CODECS)
def test_encoder_matches_jax(pair, codec, use_u16, cap):
    """_encode_compact_body: every output bit for bit msd_tpu's."""
    jdec, params, tdec, _ = pair
    vals = slab_rows()
    q = mesh.PointEvaluator._codec_q(codec, H)
    ref = jax_mesh.PointEvaluator(jdec, params)._encode_compact_body(jnp.asarray(vals), 2600, cap, codec, q, use_u16)
    count = int(ref[0][0])
    assert (count > cap) == (cap == 700) and count > 500
    out = mesh.PointEvaluator(tdec)._encode_compact_body(torch.from_numpy(vals), 2600, cap, codec, q, use_u16)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_decode_packed_matches_jax(pair, use_native):
    """The port's packed decoder (C++ and numpy routes) gives msd_tpu's
    values bit for bit on msd_tpu's encoded slab; a short magnitude stream
    raises."""
    jdec, params, _, _ = pair
    q = mesh.PointEvaluator._codec_q("packed", H)
    header, bitmaps, mags = jax_mesh.PointEvaluator(jdec, params)._encode_compact_body(
        jnp.asarray(slab_rows(1)), 2600, 4096, "packed", q, True)
    header, bitmaps, mags = np.asarray(header), np.asarray(bitmaps), np.asarray(mags)
    K, Km = int(header[0]), int(header[1]) | int(header[2]) << 16
    ref = jax_mesh._decode_packed_host(bitmaps, mags[:Km], K, q)
    out = mesh._decode_packed_host(bitmaps, mags[:Km], K, q, use_native=use_native)
    assert out.dtype == np.float32 and out.shape == (K, 125)
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(RuntimeError, match="stream mismatch"):
        mesh._decode_packed_host(bitmaps, mags[:Km - 1], K, q, use_native=use_native)


def test_eval_blocks_rounds_like_jax(pair):
    """eval_blocks returns its float32 values rounded to float16, as
    msd_tpu's does: within one float16 step and 2e-6 of msd_tpu's. (msd_tpu's
    own block program and its eval_points differ by up to 1.1e-6 in float32
    on this field, so no two programs agree bit for bit after rounding.)"""
    jdec, params, tdec, latent = pair
    abi = np.stack(np.nonzero(np.ones((32, 32, 32), bool)), axis=1)[::37]
    ref = np.asarray(jax_mesh.PointEvaluator(jdec, params).eval_blocks(jnp.asarray(latent), abi, 4, N))
    ev = mesh.PointEvaluator(tdec)
    own = ev.eval_blocks(latent, abi, 4, N)
    f32 = ev.eval_points(latent, ev._block_points(ev._abi_tensor(abi), H)).numpy().reshape(own.shape)
    assert own.shape == ref.shape and own.dtype == np.float32
    np.testing.assert_array_equal(own, f32.astype(np.float16).astype(np.float32))
    step = np.spacing(np.abs(ref).astype(np.float16)).astype(np.float32)
    assert (np.abs(own - ref) <= step + FIELD_GAP).all()


def corner_values(jev, latent, blocks, stride):
    """msd_tpu's float32 values at the 8 corners of each stride-``stride``
    block of ``blocks`` [n, 3] (block units), at N=513."""
    corners = np.stack(np.meshgrid(*[[0, 1]] * 3, indexing="ij"), -1).reshape(8, 3)
    pts = ((blocks[:, None, :] + corners[None]) * stride).reshape(-1, 3).astype(np.float32) * np.float32(2.0 / 512) - 1
    return np.asarray(jev.eval_points(jnp.asarray(latent), pts)).reshape(-1, 8)


@pytest.mark.parametrize("n", [N, 513], ids=["single_level", "two_level"])
def test_refinement_matches_jax(pair, n):
    """The host route (_sparse_active4) and the device route
    (refine_active4_device) give the same rows in the same order, None on
    a cap overflow, and msd_tpu's rows: all of them at the single level
    (a float32 criterion); at two levels, where the second level reads
    float16 values, all but a block or two whose nearest corner sits within
    a float16 step of the threshold (msd_tpu's own two routes may differ
    there too)."""
    jdec, params, tdec, latent = pair
    jev, ev = jax_mesh.PointEvaluator(jdec, params), mesh.PointEvaluator(tdec)
    ref, ref_evals = jax_mesh._sparse_active4(latent, n, jev, 1.3, 0.1)
    host, host_evals = mesh._sparse_active4(latent, n, ev, 1.3, 0.1)
    dev, dev_evals = ev.refine_active4_device(latent, n, 1.3, 0.1)
    assert ref.shape[0] > 1000 and host_evals == dev_evals
    np.testing.assert_array_equal(dev, host)
    if n == 513:
        assert ev.refine_active4_device(latent, n, 1.3, 0.1, cap16=64) is None
        assert ev.refine_active4_device(latent, n, 1.3, 0.1, cap4=host.shape[0] - 1) is None
        ours, theirs = set(map(tuple, host)), set(map(tuple, ref))
        only = np.array(sorted(ours ^ theirs)).reshape(-1, 3)
        print(f"two levels: {len(only)} of {len(theirs)} blocks in one package's set only: {only.tolist()}")
        assert len(only) <= 1e-4 * len(theirs)
        # the differing blocks' superblocks are active in both, so only
        # their own 8 corners at the threshold can differ
        diag4 = np.float32(4 * (2.0 / 512) * np.sqrt(3.0) / 2.0 * 1.3)
        nearest = np.abs(corner_values(jev, latent, only, 4)).min(axis=1)
        assert (np.abs(nearest - diag4) <= np.spacing(np.float16(diag4)) + FIELD_GAP).all(), nearest - diag4
        keep = lambda rows: rows[[tuple(r) not in set(map(tuple, only)) for r in rows]]  # noqa: E731
        np.testing.assert_array_equal(keep(host), keep(ref))
        assert abs(host_evals - ref_evals) <= len(only) * 125
        return
    np.testing.assert_array_equal(host, ref)
    assert host_evals == ref_evals
    assert ev.refine_active4_device(latent, n, 1.3, 0.1, cap4=2 * (host.shape[0] - 1)) is None
    assert ev.refine_active4_device(latent, n, 1.3, 0.01) is None


def test_crossing_blocks_equal_host_sign_check(pair):
    _, _, tdec, latent = pair
    ev = mesh.PointEvaluator(tdec)
    abi4, _ = mesh._sparse_active4(latent, N, ev, 1.3, 0.1)
    got = ev.crossing_blocks(latent, abi4, N)
    neg = (ev.eval_blocks(latent, abi4, 4, N) < 0).reshape(abi4.shape[0], -1)
    np.testing.assert_array_equal(got, abi4[neg.any(1) & ~neg.all(1)])
    assert 0 < got.shape[0] < abi4.shape[0]


@pytest.mark.parametrize("codec", CODECS)
def test_streamed_mesh_matches_jax(pair, small_chunk, codec):
    """The port's streamed mesh against msd_tpu's (its device refinement;
    its optimistic route, not ported, is off on the CPU): the same vertex,
    face, active and crossing counts and points evaluated; every vertex more than 1e-4 from msd_tpu's
    lies within a voxel of a lattice value whose codec value differs
    between the packages, and each such value differs by one codec step
    (float16: one step plus the float32 gap of the two fields)."""
    jdec, params, tdec, latent = pair
    (rv, rf), rstats = jax_stream(pair, codec)
    ev = mesh.PointEvaluator(tdec)
    (v, f), stats = port_stream(ev, latent, codec)
    assert v.shape == rv.shape and f.shape == rf.shape
    for key in ("active_blocks", "crossing_blocks", "evaluated", "num_verts", "num_faces"):
        assert stats[key] == rstats[key], key
    assert stats["exact_slabs"] == 0 and "overflow_tail_slabs" not in stats
    # the crossing blocks' values as each package encodes them
    abi4, _ = mesh._sparse_active4(latent, N, ev, 1.3, 0.1)
    abi_x = ev.crossing_blocks(latent, abi4, N)
    ours = ev.eval_blocks(latent, abi_x, 4, N).reshape(abi_x.shape[0], 125)
    jev = jax_mesh.PointEvaluator(jdec, params)
    theirs = np.asarray(jev.eval_blocks(jnp.asarray(latent), abi_x, 4, N)).reshape(abi_x.shape[0], 125)
    if codec == "f16":
        code_o, code_t = ours, theirs
        step = np.spacing(np.abs(theirs).astype(np.float16)).astype(np.float32) + FIELD_GAP
    else:
        q, top = mesh.PointEvaluator._codec_q(codec, H), 127 if codec == "int8" else 255
        code_o, code_t = (np.where(x == 0, 0, np.sign(x) * np.clip(np.round(np.abs(x) / q), 1, top))
                          for x in (ours, theirs))
        step = np.ones_like(ours)
    differ = code_o != code_t
    assert (np.abs(code_o - code_t)[differ] <= step[differ]).all()
    local = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"), -1).reshape(125, 3)
    where = (((abi_x * 4)[:, None, :] + local[None]) * H - 1.0)[differ]
    dist = cKDTree(rv).query(v)[0]
    far = v[dist > 1e-4]
    print(f"{codec}: {int(differ.sum())} of {differ.size} values encode differently; "
          f"{far.shape[0]} of {v.shape[0]} vertices beyond 1e-4, at most {dist.max():.3g}")
    if far.shape[0]:
        assert (cKDTree(where).query(far, p=np.inf)[0] <= H + 1e-7).all()


@pytest.mark.parametrize("codec", CODECS)
def test_streamed_mesh_against_float32_mesh(pair, codec, streams):
    """The port's streamed mesh against its own float32 (non-streaming)
    mesh, within msd_tpu's bounds per codec. The two give the same faces
    (same topology, vertices in the same order); f16: every vertex within
    0.05 h of the float32 mesh; int8 / packed: the decoder's value at each
    vertex within 0.08 h / 0.06 h of its value at the float32 vertex (the
    decoder residual msd_tpu bounds, less the float32 mesh's own, which
    marching tetrahedra's linear interpolation leaves at about 0.11 h on
    this field). Both meshes watertight."""
    _, _, tdec, latent = pair
    ev = mesh.PointEvaluator(tdec)
    pv, pf = float32_mesh(ev, latent)
    (v, f), _ = port_stream(ev, latent, codec)
    assert watertight(pf) and watertight(f) and pv.shape[0] > 10000
    np.testing.assert_array_equal(f, pf)
    if codec == "f16":
        assert cKDTree(pv).query(v)[0].max() < F16_NEAREST * H
        return
    with torch.no_grad():
        at = lambda x: decode_sdf(tdec, torch.tensor(latent), torch.from_numpy(x))[:, 0].numpy()  # noqa: E731
        resid = np.abs(at(v) - at(pv)).max()
    assert resid < RESIDUAL[codec] * H, resid / H


def test_ply_spill_matches_posthoc_write(pair, tmp_path, monkeypatch, streams):
    """The PLY the mesher spills while it meshes equals save_ply of the
    returned mesh byte for byte, and its temps are gone; without
    ``return_mesh`` the spill alone writes the same file."""
    _, _, tdec, latent = pair
    spill = tmp_path / "spill"
    spill.mkdir()
    monkeypatch.setenv("MSD_SPILL_TMP", str(spill))
    out = str(tmp_path / "m")
    v, f = mesh.create_mesh(tdec, torch.tensor(latent), out, N=N, return_mesh=True, value_codec="packed")
    assert "t_ply" in mesh.LAST_STREAMING_STATS
    save_ply(str(tmp_path / "posthoc.ply"), v, f)
    assert (tmp_path / "m.ply").read_bytes() == (tmp_path / "posthoc.ply").read_bytes()
    assert mesh.create_mesh(tdec, torch.tensor(latent), str(tmp_path / "n"), N=N, value_codec="packed") is True
    assert (tmp_path / "n.ply").read_bytes() == (tmp_path / "posthoc.ply").read_bytes()
    assert os.listdir(spill) == []


def test_overflow_routes_give_the_exact_mesh(pair, small_chunk, monkeypatch):
    """Each fallback gives the mesh of the route without it, bit for bit:
    a compaction cap overflow (every slab exact), a magnitude budget
    overflow (exact f16 rows, so the f16 mesh), and a device refinement cap
    overflow (the host refinement, ``refine == "host"``). At N=193, with
    one slab and with five."""
    _, _, tdec, latent = pair
    n = 193

    def run(codec, cap4=None, **attrs):
        ev = mesh.PointEvaluator(tdec)
        for k, val in attrs.items():
            setattr(ev, k, val)
        if cap4 is not None:
            refine = ev.refine_active4_device
            monkeypatch.setattr(ev, "refine_active4_device", lambda *a, **kw: refine(*a, **kw, cap4=cap4))
        return port_stream(ev, latent, codec, n)

    def same(a, b):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])

    for slabs in ("1", "5"):
        monkeypatch.setenv("MSD_STREAM_SLABS", slabs)
        f16, stats = run("f16")
        assert stats["refine"] == "device" and stats["exact_slabs"] == 0
        capped, stats = run("f16", compact_cap_min_blocks=0, compact_cap_ratio=0.0)
        same(capped, f16)
        assert stats["exact_slabs"] >= 1
        packed, _ = run("packed")
        mags, stats = run("packed", compact_cap_min_blocks=0, packed_mag_bytes_per_block=1)
        same(mags, f16)
        assert stats["exact_slabs"] >= 1
        for codec, ref in (("packed", packed), ("f16", f16)):
            host, stats = run(codec, cap4=2)
            same(host, ref)
            assert stats["refine"] == "host" and stats["exact_slabs"] == 0


def test_cpu_default_keeps_the_float32_route(pair):
    """Without ``stream`` a CPU evaluator meshes on the float32 sparse route
    (as the reconstruct CLI does with --device cpu), and no streaming
    statistics."""
    _, _, tdec, latent = pair
    mesh.LAST_STREAMING_STATS.clear()
    ev = mesh.PointEvaluator(tdec)
    assert not mesh._streams(ev)
    got = mesh.create_mesh(tdec, torch.tensor(latent), N=N, return_mesh=True, evaluator=ev)
    ref = float32_mesh(ev, latent)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert mesh.LAST_STREAMING_STATS == {}


def test_cli_on_cpu_meshes_as_before(experiment):  # noqa: F811
    """The reconstruct CLI with --device cpu hands its evaluator to
    create_mesh and meshes on the float32 sparse route as before: each PLY
    is the float32 route's mesh of the saved code, and nothing streamed."""
    exp, data, split_path, names = experiment
    mesh.LAST_STREAMING_STATS.clear()
    summary = reconstruct_cli.main([
        "-e", exp, "-c", "latest", "-d", os.path.join(data, "SdfSamples"), "-s", split_path,
        "--iters", "20", "--mesh_resolution", "129", "--device", "cpu", "--quiet",
    ])
    assert sorted(s["shape"] for s in summary) == names and mesh.LAST_STREAMING_STATS == {}
    decoder = build_decoder(SPECS["NetworkArch"], SPECS["CodeLength"], SPECS["NetworkSpecs"])
    ckpt.load_model(exp, "latest", decoder)
    out = os.path.join(exp, "Reconstructions", "5")
    for s in summary:
        code = torch.load(os.path.join(out, "Codes", s["shape"] + ".pth")).reshape(-1)
        ev = mesh.PointEvaluator(decoder.eval())
        ref = float32_mesh(ev, code, 129)
        got = load_ply(os.path.join(out, "Meshes", s["shape"] + ".ply"))
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert s["n_evaluated"] == ev.n_evaluated and s["verts"] == ref[0].shape[0] > 0


@pytest.mark.parametrize("knob", ["MSD_STREAM_HYBRID"])
def test_unported_knobs_raise(pair, knob, monkeypatch, streams):
    _, _, tdec, latent = pair
    monkeypatch.setenv(knob, "on")
    with pytest.raises(NotImplementedError, match=f"{knob}=on: .* not ported"):
        mesh.create_mesh(tdec, torch.tensor(latent), N=N)
