"""msd_tpu_torch's preprocessing (mesh -> SdfSamples) against msd_tpu's on
the same small meshes and seeds: the quality gate and winding repair, the
kNN sign vote on both routes, preprocess_mesh and sample_visible_surface,
bit for bit where both run the same numpy and C++ code; the tiled route on
CPU tensors against msd_tpu's device route (exact top_k on the CPU)."""

import os

import numpy as np
import pytest

import msd_tpu.preprocess.mesh_to_sdf as jm
import msd_tpu.workspace as jws
import msd_tpu_torch.preprocess.mesh_to_sdf as tm
import msd_tpu_torch.workspace as tws
from conftest import make_sphere_mesh
from msd_tpu_torch import native


def _mesh(kind, rng):
    """A sphere (its UV seam leaves a few boundary edges), the same wound
    inward, with 20% of faces flipped, or with 5% of faces removed."""
    v, f = make_sphere_mesh(radius=0.5)
    if kind == "inward":
        f = f[:, ::-1].copy()
    elif kind == "flipped":
        flip = rng.random(len(f)) < 0.2
        f = f.copy()
        f[flip] = f[flip][:, ::-1]
    elif kind == "hole":
        f = f[rng.random(len(f)) > 0.05]
    return v, np.ascontiguousarray(f)


@pytest.mark.parametrize("kind", ["sphere", "inward", "flipped", "hole"])
def test_quality_repair_signed_volume_equal(kind, rng):
    v, f = _mesh(kind, rng)
    assert tm.signed_volume(v, f) == jm.signed_volume(v, f)
    assert tm.mesh_quality(v, f) == jm.mesh_quality(v, f)
    ft, nt = tm.repair_mesh_winding(v, f)
    fj, nj = jm.repair_mesh_winding(v, f)
    assert nt == nj
    np.testing.assert_array_equal(ft, fj)


def _vote_inputs(n_surf, n_queries, seed=0):
    v, f = make_sphere_mesh(radius=0.6)
    surf, norms = tm.sample_surface_points(v, f, n_surf, np.random.default_rng(seed))
    queries = np.random.default_rng(seed + 1).uniform(-0.9, 0.9, (n_queries, 3)).astype(np.float32)
    return queries, surf, norms


@pytest.mark.parametrize("k", [11, 1])
def test_knn_host_route_equal_bits(k):
    """device="cpu" takes the host cKDTree route, as msd_tpu does off the TPU."""
    q, s, n = _vote_inputs(20000, 3000)
    sdf_t, keep_t = tm.knn_sign_vote(q, s, n, num_votes=k, device="cpu")
    sdf_j, keep_j = jm.knn_sign_vote(q, s, n, num_votes=k)
    assert sdf_t.tobytes() == sdf_j.tobytes()
    np.testing.assert_array_equal(keep_t, keep_j)


@pytest.mark.parametrize("k", [11, 1])
def test_knn_tiled_route_on_cpu_matches_device_route(k):
    """The tiled route on CPU tensors against msd_tpu's force_device=True
    (its jitted chunk with exact top_k on the CPU) at 2048 x 4096."""
    q, s, n = _vote_inputs(4096, 2048, seed=2)
    sdf_t, keep_t = tm.knn_sign_vote(q, s, n, num_votes=k, q_chunk=512, device="cpu", force_device=True)
    sdf_j, keep_j = jm.knn_sign_vote(q, s, n, num_votes=k, q_chunk=512, force_device=True)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_allclose(sdf_t, sdf_j, rtol=0, atol=1e-6)
    assert keep_t.mean() > 0.9


def test_knn_routes_and_agreement():
    """force_device picks the route; the tiled and host routes agree within
    VOTE_AGREEMENT; a CUDA device without a GPU raises (no host fallback)."""
    q, s, n = _vote_inputs(4096, 2048, seed=3)
    sdf_h, keep_h, st_h = tm._vote(q, s, n, 11, np.sqrt(0.005), 8192, "cpu", None)
    sdf_f, keep_f, st_f = tm._vote(q, s, n, 11, np.sqrt(0.005), 8192, "cpu", False)
    sdf_t, keep_t, st_t = tm._vote(q, s, n, 11, np.sqrt(0.005), 1000, "cpu", True)
    assert (st_h["route"], st_f["route"], st_t["route"]) == ("host", "host", "tiled")
    assert st_t["chunks"] == 3
    assert sdf_h.tobytes() == sdf_f.tobytes()
    agree = tm.vote_agreement(sdf_t, keep_t, sdf_h, keep_h)
    assert agree["ok"], agree
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.knn_sign_vote(q, s, n, device="cuda")


def _case(name, rng):
    """(verts, faces, preprocess_mesh kwargs) of tests/test_preprocess.py's
    drives."""
    v, f = make_sphere_mesh(radius=0.5)
    if name == "end_to_end":
        return v, f, dict(num_samples=20000, surface_vote_points=20000, seed=1)
    if name == "inward":
        return v, np.ascontiguousarray(f[:, ::-1]), dict(num_samples=8000, surface_vote_points=8000, seed=3)
    if name == "test_mode":
        return v, f, dict(num_samples=300000, test=True, surface_vote_points=10000, seed=2)
    if name == "repair":
        return (*_mesh("flipped", rng), dict(num_samples=20000, surface_vote_points=20000, seed=3))
    if name == "watertight":
        return v, f, dict(num_samples=8000, surface_vote_points=8000, seed=4, visibility="watertight")
    if name == "render_open":
        vo, fo = make_sphere_mesh(32, 64, radius=0.7)
        vi, fi = make_sphere_mesh(16, 32, radius=0.25)
        verts = np.concatenate([vo, vi])
        faces = np.concatenate([fo[:, ::-1], fi[:, ::-1] + len(vo)])
        faces = faces[rng.random(len(faces)) > 0.03]  # holes
        return verts, faces, dict(num_samples=20000, visibility="render", repair=False, seed=5)
    if name == "auto_open":
        return (*_mesh("hole", rng), dict(num_samples=8000, surface_vote_points=8000, seed=6))
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["end_to_end", "inward", "test_mode", "repair", "watertight", "render_open", "auto_open"]
)
def test_preprocess_mesh_equal_bits(name, rng):
    v, f, kw = _case(name, rng)
    pos_t, neg_t, info_t = tm.preprocess_mesh(v, f, knn_device="cpu", **kw)
    pos_j, neg_j, info_j = jm.preprocess_mesh(v, f, **kw)
    assert pos_t.tobytes() == pos_j.tobytes()
    assert neg_t.tobytes() == neg_j.tobytes()
    assert info_t["quality"] == info_j["quality"]
    for key in ("num_queries", "num_kept", "rejected_fraction", "rejected"):
        assert info_t[key] == info_j[key], key
    assert info_t["vote"]["route"] == "host"
    assert set(info_t["seconds"]) == {"quality_repair", "render", "sampling", "vote", "total"}
    renders = kw.get("visibility") == "render" or (
        kw.get("visibility", "auto") == "auto" and info_t["quality"]["boundary_edge_ratio"] > 0
    )
    assert ("covered_pixels" in info_t["quality"]) == renders


@pytest.mark.parametrize("visibility", ["auto", "watertight", "render"])
@pytest.mark.parametrize("kind", ["sphere", "hole"])
def test_sample_visible_surface_equal_bits(kind, visibility, rng):
    v, f = _mesh(kind, rng)
    v = v + np.float32([1.0, 2.0, 3.0])
    pts_t, off_t, scale_t = tm.sample_visible_surface(v, f, num_points=3000, seed=7, visibility=visibility)
    pts_j, off_j, scale_j = jm.sample_visible_surface(v, f, num_points=3000, seed=7, visibility=visibility)
    assert pts_t.tobytes() == pts_j.tobytes()
    np.testing.assert_array_equal(off_t, off_j)
    assert scale_t == scale_j


def test_failed_native_build_raises(tmp_path, monkeypatch, rng):
    """A compiler that does not exist: load_native raises, and so does
    preprocess_mesh on an open mesh in "auto" (msd_tpu would fall back to
    all-face sampling); no library is left behind."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        native.load_native()
    v, f = _mesh("hole", rng)
    with pytest.raises(RuntimeError, match="native build failed"):
        tm.preprocess_mesh(v, f, num_samples=2000, surface_vote_points=2000, knn_device="cpu")
    assert native._LIB is None
    assert not os.path.exists(native.library_path())


def test_native_build_failure_reports_compiler_errors(tmp_path, monkeypatch):
    """A compiler that runs and fails: its stderr is in the error."""
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'raster.cpp: error: nope' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="error: nope"):
        native.load_native()


@pytest.mark.parametrize("getter", [
    "get_reconstructed_code_filename", "get_data_source_map_filename",
    "get_normalization_params_filename", "get_surface_samples_filename", "get_sdf_samples_filename",
])
def test_workspace_getters_equal(getter):
    args = {"get_reconstructed_code_filename": ("/exp", 100, "ds", "cls", "shape_0"),
            "get_data_source_map_filename": ("/data",)}.get(getter, ("/data", "ds", "cls", "shape_0"))
    assert getattr(tws, getter)(*args) == getattr(jws, getter)(*args)
