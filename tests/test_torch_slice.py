"""The port's serving slice end to end on the CPU: msd_tpu_torch's
reconstruct CLI (--device cpu) on a checkpoint saved by msd_tpu, then its
evaluate CLI, whose CSV must equal msd_tpu.eval_chamfer.evaluate's on the
same meshes."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CSV_HEADER, write_dataset
from msd_tpu.eval_chamfer import evaluate as jax_evaluate
from msd_tpu.utils import checkpoint as jax_ckpt
from msd_tpu_torch import evaluate as evaluate_cli
from msd_tpu_torch import reconstruct as reconstruct_cli
from msd_tpu_torch.data.mesh_io import load_ply
from test_torch_decoder import CONFIGS, LATENT, make_pair

SPECS = {
    "NetworkArch": "deep_sdf_decoder",
    "CodeLength": LATENT,
    "NetworkSpecs": dict(CONFIGS[0], dropout=[], dropout_prob=0.2, xyz_in_all=False,
                         use_tanh=False, latent_dropout=False),
}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    exp, data = str(root / "exp"), str(root / "data")
    os.makedirs(exp)
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(SPECS, f)
    jdec, params, _ = make_pair(CONFIGS[0], seed=31, surface=True)
    jax_ckpt.save_model(exp, "latest.pth", jdec, jax.tree.map(jnp.asarray, params), 5)
    split = write_dataset(data, 2, 20000, seed=3)
    split_path = str(root / "slice_test_split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    return exp, data, split_path, split["smoke"]["ellipsoid"]


def _reconstruct(experiment, *extra):
    exp, data, split_path, _ = experiment
    return reconstruct_cli.main([
        "-e", exp, "-c", "latest", "-d", os.path.join(data, "SdfSamples"), "-s", split_path,
        "--iters", "30", "--mesh_resolution", "65", "--device", "cpu", "--quiet", *extra,
    ])


def test_reconstruct_then_evaluate_matches_jax(experiment):
    exp, data, split_path, names = experiment
    summary = _reconstruct(experiment)
    assert sorted(s["shape"] for s in summary) == names
    out = os.path.join(exp, "Reconstructions", "5")
    for s in summary:
        code = torch.load(os.path.join(out, "Codes", s["shape"] + ".pth"))
        assert code.shape == (1, 1, LATENT)
        verts, faces = load_ply(os.path.join(out, "Meshes", s["shape"] + ".ply"))
        assert verts.shape[0] == s["verts"] > 0 and faces.shape[0] == s["faces"] > 0
        assert s["n_grid"] == 65**3 and s["n_evaluated"] == 65**3  # N=65 meshes dense
        assert s["k1_launches"] == 0  # the CPU runs K1's plain version

    csv = os.path.join(exp, "Evaluation", "5", "chamfer.csv")
    ours = evaluate_cli.main(["-e", exp, "-c", "5", "-d", data, "-s", split_path, "--quiet"])
    with open(csv) as f:
        our_text = f.read()
    theirs = jax_evaluate(exp, "5", data, split_path)
    with open(csv) as f:
        their_text = f.read()
    assert our_text.splitlines()[0] == CSV_HEADER
    assert len(our_text.splitlines()) == 3
    assert our_text == their_text
    assert [r[0] for r in ours] == [r[0] for r in theirs]
    assert all(np.isfinite(r[1][0]) for r in ours)


def test_batch_mode_writes_outputs(experiment):
    exp, _, _, names = experiment
    summary = _reconstruct(experiment, "--batch", "2")
    assert sorted(s["shape"] for s in summary) == names
    for s in summary:
        assert os.path.isfile(os.path.join(exp, "Reconstructions", "5", "Meshes", s["shape"] + ".ply"))


def test_cuda_without_gpu_raises(experiment):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    exp, data, split_path, _ = experiment
    with pytest.raises(RuntimeError, match="--device cpu"):
        reconstruct_cli.main(["-e", exp, "-d", data, "-s", split_path])
