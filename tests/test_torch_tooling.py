"""The port's workspace loaders, EMD and Hausdorff metrics,
``generate_training_meshes`` and ``check_experiment_inputs`` against
msd_tpu's on the same checkpoint, arrays and files, on the CPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import generate_training_meshes as jax_gtm
import msd_tpu.workspace as jax_ws
import msd_tpu_torch.workspace as ws
from conftest import make_sphere_mesh
from msd_tpu.metrics import compute_emd as jax_emd
from msd_tpu.metrics import compute_metric as jax_metric
from msd_tpu.utils import checkpoint as jax_ckpt
from msd_tpu_torch import generate_training_meshes as gtm
from msd_tpu_torch.check_experiment_inputs import main as check_inputs
from msd_tpu_torch.data.mesh_io import load_ply
from msd_tpu_torch.metrics import compute_emd, compute_metric
from msd_tpu_torch.models.deepsdf import decode_sdf
from msd_tpu_torch.utils import checkpoint as ckpt
from test_torch_decoder import CONFIGS, LATENT, make_pair
from test_torch_streaming_mesh import FIELD_GAP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"NetworkArch": "deep_sdf_decoder", "CodeLength": 8,
         "NetworkSpecs": {"dims": [16, 16], "latent_in": [1], "weight_norm": True, "norm_layers": [0]}}


def test_workspace_loaders_match_jax(tmp_path):
    """A checkpoint msd_tpu writes (tests/test_geometry_and_workspace.py:38-65)
    read by the port's loaders: the same layers, decoder outputs within
    1e-6 of msd_tpu's ``load_decoder``, the epoch, and the latent table
    bit for bit as a float32 numpy array."""
    exp = str(tmp_path)
    jax_ws.save_experiment_specifications(exp, SMALL)
    jdec = jax_ws.build_decoder(exp)
    params = jdec.init(jax.random.PRNGKey(0))
    jax_ckpt.save_model(exp, "latest.pth", jdec, params, 7)
    table = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    jax_ckpt.save_latent_vectors(exp, "latest.pth", table, 7)

    assert ws.build_decoder(exp).layer_shapes == jdec.layer_shapes
    dec, epoch = ws.load_decoder(exp, "latest")
    jdec2, jparams, jepoch = jax_ws.load_decoder(exp, "latest")
    assert epoch == jepoch == 7 and next(dec.parameters()).device.type == "cpu"
    x = np.random.default_rng(4).uniform(-1, 1, (64, 11)).astype(np.float32)
    with torch.no_grad():
        ours = dec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jdec2.apply(jparams, jnp.asarray(x))), atol=1e-6)
    lat = ws.load_latent_vectors(exp, "latest")
    assert isinstance(lat, np.ndarray) and lat.dtype == np.float32
    np.testing.assert_array_equal(lat, jax_ws.load_latent_vectors(exp, "latest"))
    np.testing.assert_array_equal(lat, table)


def test_emd_matches_jax():
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(64, 3)), rng.normal(size=(48, 3))
    assert compute_emd(a, b) == jax_emd(a, b)
    assert compute_emd(a, a + [0.1, 0, 0]) == pytest.approx(0.1, rel=1e-5)


@pytest.mark.parametrize("metric", ["hausdorff", "chamfer", "normal_consistency"])
def test_compute_metric_matches_jax(metric, tmp_path):
    """``compute_metric`` on two meshes, one given as a path: the same value
    as msd_tpu's (the same seeded surface samples)."""
    gv, gf = make_sphere_mesh(24, 48, radius=0.7)
    rv, rf = make_sphere_mesh(20, 40, radius=0.68, center=(0.01, 0.0, -0.02))
    from msd_tpu_torch.data.mesh_io import save_ply

    path = str(tmp_path / "gen.ply")
    save_ply(path, rv, rf)
    ours = compute_metric((gv, gf), path, num_mesh_samples=3000, metric=metric)
    ref = jax_metric((gv, gf), path, num_mesh_samples=3000, metric=metric)
    if metric == "chamfer":
        assert ours[0] == ref[0]
        np.testing.assert_array_equal(ours[1], ref[1])
    else:
        assert ours == ref and ours > 0
    with pytest.raises(ValueError, match="unknown metric"):
        compute_metric((gv, gf), path, metric="emd")


NORMALIZATION = {"s1": (np.array([0.1, -0.2, 0.05]), 0.8), "s2": (np.array([-0.3, 0.0, 0.2]), 1.25)}


def training_experiment(root, decoder):
    """An experiment with ``decoder`` as epoch 3, 3 seeded training latents
    of instances s0-s2 (dataset "ds", class "c"), and normalization
    parameters for s1 and s2."""
    data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
    os.makedirs(data)
    split = os.path.join(root, "split.json")
    with open(split, "w") as f:
        json.dump({"ds": {"c": ["s0", "s1", "s2"]}}, f)
    for name, (offset, scale) in NORMALIZATION.items():
        norm = ws.get_normalization_params_filename(data, "ds", "c", name)
        os.makedirs(os.path.dirname(norm), exist_ok=True)
        np.savez(norm, offset=offset, scale=scale)
    specs = {"NetworkArch": "deep_sdf_decoder", "CodeLength": LATENT, "NetworkSpecs": CONFIGS[1],
             "DataSource": data, "TrainSplit": split}
    ws.save_experiment_specifications(exp, specs)
    ckpt.save_model(exp, "latest.pth", decoder, 3)
    latents = 0.05 * torch.from_numpy(np.random.default_rng(22).standard_normal((3, LATENT)).astype(np.float32))
    ckpt.save_latent_vectors(exp, "latest.pth", latents, 3)
    return exp


def test_generate_training_meshes_matches_jax(tmp_path):
    """``python -m msd_tpu_torch.generate_training_meshes --device cpu``
    against the root CLI's ``code_to_mesh`` on a copy of the same
    experiment at N=129 (the sparse route): every TrainingMeshes/3 file,
    the same vertex and face counts, vertices within
    tests/test_torch_mesh.py's 1e-4 in the normalized frame or on an edge
    where the two fields' float32 gap moves them that far
    (``assert_far_vertices_on_flat_edges``); offset and scale applied where
    the instance has them; and each mesh the port's ``create_mesh`` of its
    latent, transformed, bit for bit."""
    _, _, tdec = make_pair(CONFIGS[1], seed=21, surface=True)
    ours_exp = training_experiment(str(tmp_path / "ours"), tdec)
    ref_exp = training_experiment(str(tmp_path / "ref"), tdec)
    summary = gtm.main(["-e", ours_exp, "--resolution", "129", "--device", "cpu", "--quiet"])
    jax_gtm.code_to_mesh(ref_exp, "latest", resolution=129)
    assert [s["instance"] for s in summary] == ["s0", "s1", "s2"]
    assert [s["normalized_back"] for s in summary] == [False, True, True]
    latents = ws.load_latent_vectors(ours_exp, "latest")
    for i, s in enumerate(summary):
        rel = os.path.join(ws.training_meshes_subdir, "3", "ds", "c", s["instance"] + ".ply")
        assert s["path"] == os.path.join(ours_exp, rel)
        (v, f), (rv, rf) = load_ply(s["path"]), load_ply(os.path.join(ref_exp, rel))
        assert v.shape == rv.shape and f.shape == rf.shape and v.shape[0] > 100
        offset, scale = NORMALIZATION.get(s["instance"], (np.zeros(3), 1.0))
        assert_far_vertices_on_flat_edges(tdec, latents[i], (v + offset) * scale, (rv + offset) * scale, 129)
        direct = gtm.mesh.create_mesh(tdec, torch.from_numpy(latents[i]), None, N=129, return_mesh=True)
        want = direct[0] if s["instance"] == "s0" else (direct[0].astype(np.float64) / scale - offset).astype(np.float32)
        np.testing.assert_array_equal(v, want)
        np.testing.assert_array_equal(f, direct[1])
    # the field is the decoder's: a vertex of s0 sits on its zero level
    with torch.no_grad():
        at = decode_sdf(tdec, torch.from_numpy(latents[0]), torch.from_numpy(load_ply(summary[0]["path"])[0]))
    assert float(at.abs().max()) < 2.0 / 128


def assert_far_vertices_on_flat_edges(decoder, latent, v, rv, n):
    """Every vertex of ``v`` more than 1e-4 from ``rv`` lies in a voxel with a
    sign-changing pair of corners (a, b) along which ``FIELD_GAP``, the
    float32 gap of the two packages' fields, moves a linearly interpolated
    vertex that far: sqrt(3) h * FIELD_GAP / (|a| + |b|) >= the distance
    (marching tetrahedra interpolates along voxel edges and diagonals)."""
    h = 2.0 / (n - 1)
    d, _ = cKDTree(rv).query(v)
    far, dist = v[d > 1e-4], d[d > 1e-4]
    print(f"{far.shape[0]} of {v.shape[0]} vertices beyond 1e-4, at most {d.max():.3g}")
    if not far.shape[0]:
        return
    corners = np.stack(np.meshgrid(*[[0, 1]] * 3, indexing="ij"), -1).reshape(8, 3)
    cells = (np.floor((far.astype(np.float64) + 1) / h)[:, None, :] + corners[None]) * h - 1
    with torch.no_grad():
        vals = decode_sdf(decoder, torch.from_numpy(latent), torch.from_numpy(cells.reshape(-1, 3).astype(np.float32)))
    vals = vals.numpy().reshape(-1, 8).astype(np.float64)
    a, b = vals[:, :, None], vals[:, None, :]
    reach = np.where(a * b < 0, np.sqrt(3) * h * FIELD_GAP / (np.abs(a) + np.abs(b)), 0.0).max(axis=(1, 2))
    assert (reach >= dist).all(), (dist, reach)


def experiment_inputs(tmp_path, pretrained):
    """tests/test_tooling.py:116's fixture; ``pretrained`` adds a Stage-2
    spec's latent files (an embedding table, an id -> code map missing one
    id) and decoder path, the test latents' file left missing."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    names = ["a.obj", "b.obj"]
    for n in names:
        np.savez(str(data_dir / (n[:-4] + ".npz")), pos=np.ones((4, 4), np.float32), neg=np.ones((4, 4), np.float32))
    split = tmp_path / "split.json"
    json.dump(names, open(split, "w"))
    torch.save({"a": torch.tensor([1.0, 60.0]), "b": torch.tensor([0.0, 70.0])}, str(data_dir / "labels.pt"))
    exp = tmp_path / "exp"
    exp.mkdir()
    specs = {"DataSource": str(data_dir), "TrainSplit": str(split), "TestSplit": str(split), "LabelsFile": "labels.pt",
             "CodeLength": 8}
    if pretrained:
        torch.save({"epoch": 1, "latent_codes": {"weight": torch.zeros(2, 8)}}, str(exp / "train_latents.pth"))
        torch.save({"a": torch.zeros(8)}, str(exp / "val_latents.pth"))
        specs.update(PretrainedLatentPath="train_latents.pth", TestLatentPath="missing.pth",
                     ValSplit=str(split), ValLatentPath="val_latents.pth", PretrainedSDFDecoderPath="train_latents.pth",
                     SAPLabelIndices=[0, 1, 4])
    json.dump(specs, open(exp / "specs.json", "w"))
    return str(exp)


@pytest.mark.parametrize("pretrained", [False, True], ids=["labels", "pretrained"])
def test_check_experiment_inputs_prints_the_root_scripts_lines(tmp_path, capsys, pretrained):
    exp = experiment_inputs(tmp_path, pretrained)
    ref = subprocess.run([sys.executable, os.path.join(REPO, "check_experiment_inputs.py"), "-e", exp],
                         capture_output=True, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert ref.returncode == 0, ref.stderr
    check_inputs(["-e", exp])
    ours = capsys.readouterr().out.splitlines()
    assert ours == ref.stdout.splitlines()
    assert "[split] train count=2 path=" + str(tmp_path / "split.json") in ours
    assert "[labels] LabelsFile split=train missing=0 total=2" in ours
    if pretrained:
        assert any(line.startswith("[latents] train: embedding table shape=(2, 8)") for line in ours)
        assert any("[latents] test: file not found" in line for line in ours)
        assert any(line.startswith("[latents] val: total=1 missing=1") for line in ours)
