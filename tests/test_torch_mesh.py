"""msd_tpu_torch's mesh extraction against msd_tpu's on the same weights
(seeded, given a surface by give_surface_), float32 on the CPU."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from msd_tpu import mesh as jax_mesh
from msd_tpu.data import mesh_io as jax_io
from msd_tpu.ops import marching_cubes as jax_mc
from msd_tpu_torch import mesh
from msd_tpu_torch.data import mesh_io
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder
from msd_tpu_torch.ops import marching_cubes
from test_torch_decoder import CONFIGS, LATENT, make_pair


@pytest.fixture(scope="module")
def pair():
    jdec, params, tdec = make_pair(CONFIGS[0], seed=21, surface=True)
    latent = (0.05 * np.random.default_rng(22).standard_normal(LATENT)).astype(np.float32)
    return jdec, jax.tree.map(jnp.asarray, params), tdec, latent


def _same_mesh(a, b):
    (av, af), (bv, bf) = a, b
    assert av.shape == bv.shape and af.shape == bf.shape, (av.shape, bv.shape, af.shape, bf.shape)
    d, _ = cKDTree(av).query(bv)
    assert d.max() < 1e-4, d.max()


@pytest.mark.parametrize("N,sparse", [(129, True), (65, True), (33, False)], ids=["sparse129", "dense65", "dense33"])
def test_create_mesh_matches_jax(pair, N, sparse, tmp_path):
    jdec, params, tdec, latent = pair
    assert (mesh._pick_block(N, 0.1, 1.3) == 4) == (N == 129)
    ref = jax_mesh.create_mesh(jdec, params, latent, N=N, return_mesh=True, sparse=sparse)
    out = mesh.create_mesh(tdec, torch.tensor(latent), str(tmp_path / "m"), N=N, return_mesh=True, sparse=sparse)
    assert ref is not False and out is not False
    assert out[0].shape[0] > 100
    _same_mesh(ref, out)
    pv, pf = mesh_io.load_ply(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(pv, out[0])
    np.testing.assert_array_equal(pf, out[1])


def test_eval_grid_dense_matches_jax(pair):
    jdec, params, tdec, latent = pair
    ref = jax_mesh.eval_grid_dense(jdec, params, jnp.asarray(latent), 33)
    out = mesh.eval_grid_dense(tdec, torch.tensor(latent), 33, max_batch=5000)
    assert out.shape == (33, 33, 33)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_eval_grid_sparse_matches_jax(pair):
    """Neither package handed an evaluator: float32 block values."""
    jdec, params, tdec, latent = pair
    ref, ref_stats = jax_mesh.eval_grid_sparse(jdec, params, jnp.asarray(latent), 129)
    out, stats = mesh.eval_grid_sparse(tdec, torch.tensor(latent), 129)
    assert stats == ref_stats and stats["evaluated"] < stats["total"]
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_eval_grid_sparse_evaluator_rounds_as_jax(pair):
    """Both packages handed an evaluator: the block values rounded to
    float16 (msd_tpu/mesh.py:2284-2285), the corner lattice float32. Within
    1e-5 of msd_tpu's, except where the two float32 fields (1e-5 apart, the
    test above) round to neighbouring float16 values: there the port's
    float32 value sits within 1e-5 of the rounding step between them."""
    jdec, params, tdec, latent = pair
    ref, ref_stats = jax_mesh.eval_grid_sparse(jdec, params, jnp.asarray(latent), 129,
                                               evaluator=jax_mesh.PointEvaluator(jdec, params))
    ev = mesh.PointEvaluator(tdec)
    out, stats = mesh.eval_grid_sparse(tdec, torch.tensor(latent), 129, evaluator=ev)
    assert stats == ref_stats and ev.n_evaluated == stats["evaluated"]
    f32, _ = mesh.eval_grid_sparse(tdec, torch.tensor(latent), 129)
    refined = out != f32
    assert refined.any() and np.array_equal(out[refined], f32[refined].astype(np.float16).astype(np.float32))
    apart = np.abs(out - ref) > 1e-5
    step = np.spacing(np.abs(out[apart]).astype(np.float16)).astype(np.float32)
    assert apart.mean() < 0.01 and (np.abs(out[apart] - ref[apart]) <= step).all()
    np.testing.assert_allclose(f32[apart], (out[apart] + ref[apart]) / 2, atol=1e-5)


def test_linear_to_coords_order():
    idx = np.arange(0, 9**3, 7)
    ref = np.asarray(jax_mesh._linear_to_coords(jnp.asarray(idx), 9))
    out = mesh._linear_to_coords(torch.tensor(idx), 9).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[1].tolist() == [-1.0, -1.0, -1.0 + 7 * 0.25]  # z fastest


@pytest.mark.parametrize("N", [17, 33, 64, 65, 128, 129, 256, 257, 512])
def test_snap_and_pick_block_match(N):
    assert mesh._snap_n(N) == jax_mesh._snap_n(N)
    for clamp in (0.05, 0.1):
        assert mesh._pick_block(N, clamp, 1.3) == jax_mesh._pick_block(N, clamp, 1.3)


def test_unsupported_config_uses_plain_decoder(caplog):
    jdec, params, tdec = make_pair(CONFIGS[4], seed=23)
    with caplog.at_level(logging.WARNING):
        ev = mesh.PointEvaluator(tdec)
    assert not ev.fused and "xyz_in_all" in caplog.text
    pts = np.random.default_rng(0).uniform(-1, 1, (50, 3)).astype(np.float32)
    latent = np.zeros(LATENT, np.float32)
    ref = np.asarray(jax_mesh._eval_points(jdec, jax.tree.map(jnp.asarray, params), jnp.asarray(latent), jnp.asarray(pts)))
    np.testing.assert_allclose(ev.eval_points(latent, pts).numpy(), ref, atol=1e-5)


def test_wide_config_is_fused_and_foreign_dtype_raises(caplog):
    """Only xyz_in_all and weights over 10 MB take the plain decoder: a
    1024-wide decoder goes through K1, and an operand type that is not
    ported raises instead of falling back."""
    wide = DeepSDFDecoder(LATENT, dims=[1024, 1024], generator=torch.Generator().manual_seed(1))
    with caplog.at_level(logging.WARNING):
        ev = mesh.PointEvaluator(wide)
    assert ev.fused and "unavailable" not in caplog.text
    with pytest.raises(ValueError, match="not ported"):
        mesh.PointEvaluator(wide, dtype=torch.float16)


def test_marching_tets_copy_matches():
    g = np.linspace(-1, 1, 20, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(x**2 + (1.3 * y) ** 2 + z**2) - 0.6
    ref = jax_mc.marching_tetrahedra(sdf, spacing=(0.1,) * 3, origin=(-1, -1, -1))
    out = marching_cubes.marching_tetrahedra(sdf, spacing=(0.1,) * 3, origin=(-1, -1, -1))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    blocks = np.stack([sdf[i:i + 5, j:j + 5, k:k + 5] for i in (0, 4, 8) for j in (4, 8) for k in (8,)])
    bases = np.array([[i, j, k] for i in (0, 4, 8) for j in (4, 8) for k in (8,)])
    ref = jax_mc.marching_tetrahedra_blocks(blocks, bases, 20, use_native=False)
    out = marching_cubes.marching_tetrahedra_blocks(blocks, bases, 20, use_native=False)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)


def sphere_blocks(n=65, b=4, r=0.6):
    """The (b + 1)^3 blocks tiling an [n]^3 grid of a sphere's SDF (as
    tests/test_native_mt.py's ``_sphere_blocks``), and their bases."""
    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    sdf = (np.sqrt(X**2 + Y**2 + Z**2) - r).astype(np.float32)
    bases = np.array([(i, j, k) for i in range(0, n - 1, b) for j in range(0, n - 1, b) for k in range(0, n - 1, b)])
    vals = np.stack([sdf[i:i + b + 1, j:j + b + 1, k:k + b + 1] for i, j, k in bases])
    return vals, bases


@pytest.mark.parametrize("level,r", [(0.0, 0.6), (0.05, 0.45)])
def test_native_mesher_equals_jax_native(level, r):
    """The port's C++ mesher (its copy of marching_tets.cpp, the same g++
    flags) gives msd_tpu's native mesher's vertices and faces bit for bit."""
    n = 65
    vals, bases = sphere_blocks(n, 4, r)
    kw = dict(level=level, spacing=(2.0 / (n - 1),) * 3, origin=(-1, -1, -1))
    ref = jax_mc.marching_tetrahedra_blocks(vals, bases, n, use_native=True, **kw)
    out = marching_cubes.marching_tetrahedra_blocks(vals, bases, n, **kw)
    assert out[0].shape[0] > 1000
    for a, b in zip(ref, out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_native_mesher_against_numpy_route():
    """The native route against the numpy route (tests/test_native_mt.py's
    checks): equal vertex and face counts, the same vertex set within 1e-5,
    a watertight mesh with every face wound outwards."""
    n = 65
    h = 2.0 / (n - 1)
    vals, bases = sphere_blocks(n, 4)
    v_np, f_np = marching_cubes.marching_tetrahedra_blocks(vals, bases, n, 0.0, (h,) * 3, (-1, -1, -1),
                                                           use_native=False)
    v, f = marching_cubes.marching_tetrahedra_blocks(vals, bases, n, 0.0, (h,) * 3, (-1, -1, -1))
    assert len(v) == len(v_np) and len(f) == len(f_np)
    d, _ = cKDTree(v_np).query(v)
    assert d.max() < 1e-5
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    normals = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    assert (np.einsum("ij,ij->i", normals, v[f].mean(axis=1)) > 0).all()


def test_wide_blocks_take_the_numpy_route(monkeypatch):
    """Blocks of b + 1 > 64 samples a side exceed the mesher's uint64 row
    masks and take the numpy route, as in msd_tpu, without loading the
    library; b + 1 = 64 still meshes natively."""
    n = 129

    def no_library():
        raise AssertionError("the native mesher was loaded")

    vals, bases = sphere_blocks(n, 64)
    assert vals.shape[1:] == (65, 65, 65)
    monkeypatch.setattr(marching_cubes, "load_native", no_library)
    out = marching_cubes.marching_tetrahedra_blocks(vals, bases, n)
    ref = marching_cubes.marching_tetrahedra_blocks(vals, bases, n, use_native=False)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    vals, bases = sphere_blocks(n - 2, 63)
    assert vals.shape[1:] == (64, 64, 64)
    with pytest.raises(AssertionError, match="native mesher was loaded"):
        marching_cubes.marching_tetrahedra_blocks(vals, bases, n - 2)


def test_native_mesher_failure_raises(monkeypatch):
    """A nonzero return code of mt_blocks raises (msd_tpu re-meshes in
    numpy), after freeing the outputs; so does a failed build."""
    freed = []

    class Library:
        @staticmethod
        def mt_blocks(*args):
            return -1

        @staticmethod
        def mt_free(p):
            freed.append(p)

    vals, bases = sphere_blocks(17, 4)
    monkeypatch.setattr(marching_cubes, "load_native", Library)
    with pytest.raises(RuntimeError, match="mt_blocks returned -1"):
        marching_cubes.marching_tetrahedra_blocks(vals, bases, 17)
    assert len(freed) == 2

    def failed_build():
        raise RuntimeError("native build failed")

    monkeypatch.setattr(marching_cubes, "load_native", failed_build)
    with pytest.raises(RuntimeError, match="native build failed"):
        marching_cubes.marching_tetrahedra_blocks(vals, bases, 17)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_ply_byte_compatible(tmp_path, binary):
    rng = np.random.default_rng(1)
    verts = rng.standard_normal((40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (60, 3)).astype(np.int32)
    jax_io.save_ply(str(tmp_path / "a.ply"), verts, faces, binary=binary)
    mesh_io.save_ply(str(tmp_path / "b.ply"), verts, faces, binary=binary)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    for got, ref in zip(mesh_io.load_ply(str(tmp_path / "a.ply")), jax_io.load_ply(str(tmp_path / "a.ply"))):
        np.testing.assert_array_equal(got, ref)


def test_ply_polygon_faces_fan(tmp_path):
    """Non-triangle binary faces take the row-by-row reader."""
    path = tmp_path / "quad.ply"
    header = (
        "ply\nformat binary_little_endian 1.0\nelement vertex 4\nproperty float x\n"
        "property float y\nproperty float z\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    body = np.eye(4, 3, dtype="<f4").tobytes() + bytes([4]) + np.arange(4, dtype="<i4").tobytes()
    path.write_bytes(header.encode() + body)
    for got, ref in zip(mesh_io.load_ply(str(path)), jax_io.load_ply(str(path))):
        np.testing.assert_array_equal(got, ref)
