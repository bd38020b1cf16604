"""The port's Stage-1 CLI end to end on the CPU:
``python -m msd_tpu_torch.train_deep_sdf --device cpu`` on a tiny spec
writes the four checkpoint families, ``-c latest`` resumes at the right
epoch, the port's reconstruct CLI reads the trained decoder, and the
test-set eval hook writes its meshes and scalars."""

import json
import os

import numpy as np
import pytest
import torch

import msd_tpu_torch.workspace as ws
from chip_smoke import write_dataset
from conftest import make_sphere_mesh
from msd_tpu_torch import reconstruct as reconstruct_cli
from msd_tpu_torch import train_deep_sdf
from msd_tpu_torch.train.stage1 import Stage1Trainer

SPECS = {
    "Description": "tiny Stage-1 CLI test",
    "NetworkArch": "deep_sdf_decoder",
    "NetworkSpecs": {"dims": [32, 32, 32], "dropout": [], "dropout_prob": 0.0, "norm_layers": [],
                     "latent_in": [2], "xyz_in_all": False, "use_tanh": False, "latent_dropout": False,
                     "weight_norm": True},
    "CodeLength": 8,
    "NumEpochs": 3,
    "SnapshotFrequency": 2,
    "AdditionalSnapshots": [1],
    "LearningRateSchedule": [{"Type": "Step", "Initial": 0.0005, "Interval": 500, "Factor": 0.5},
                             {"Type": "Step", "Initial": 0.001, "Interval": 500, "Factor": 0.5}],
    "SamplesPerScene": 256,
    "ScenesPerBatch": 2,
    "UseEikonal": True,
    "ClampingDistance": 0.1,
    "CodeRegularization": True,
    "CodeRegularizationLambda": 0.0001,
    "CodeBound": 1.0,
    "GradientClipNorm": 1.0,
    "EvalTrainFrequency": 0,
    "EvalTestFrequency": 0,
    "LogFrequency": 10,
}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    data = str(root / "data")
    split = write_dataset(data, 4, 2000, seed=5)
    split_path = str(root / "train_split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    exp = str(root / "exp")
    ws.save_experiment_specifications(exp, dict(SPECS, DataSource=os.path.join(data, "SdfSamples"),
                                                TrainSplit=split_path, TestSplit=split_path))
    trainer = train_deep_sdf.main(["-e", exp, "--device", "cpu", "--quiet"])
    return exp, data, split_path, trainer


def test_cli_writes_checkpoint_families(experiment):
    exp, _, _, trainer = experiment
    assert trainer.epoch == 3 and trainer.use_fused
    for sub in (ws.model_params_subdir, ws.optimizer_params_subdir, ws.latent_codes_subdir):
        for name in ("1.pth", "2.pth", "latest.pth"):
            assert os.path.isfile(os.path.join(exp, sub, name)), (sub, name)
    logs = torch.load(os.path.join(exp, ws.logs_filename), weights_only=False)
    assert logs["epoch"] == 3 and len(logs["loss"]) == 6 and len(logs["learning_rate"]) == 3
    assert sorted(logs["param_magnitude"]) == sorted(
        f"lin{i}.{k}" for i in range(4) for k in ("b", "w"))
    assert all(np.isfinite(logs["loss"]))


def test_cli_resumes_from_latest(experiment, tmp_path):
    exp, _, _, _ = experiment
    specs = ws.load_experiment_specifications(exp)
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    for sub in (ws.model_params_subdir, ws.optimizer_params_subdir, ws.latent_codes_subdir):
        os.makedirs(os.path.join(resumed, sub))
        src = os.path.join(exp, sub, "latest.pth")
        with open(src, "rb") as f, open(os.path.join(resumed, sub, "latest.pth"), "wb") as g:
            g.write(f.read())
    with open(os.path.join(exp, ws.logs_filename), "rb") as f, open(os.path.join(resumed, ws.logs_filename), "wb") as g:
        g.write(f.read())
    ws.save_experiment_specifications(resumed, dict(specs, NumEpochs=5))
    trainer = train_deep_sdf.main(["-e", resumed, "-c", "latest", "--device", "cpu", "--quiet"])
    assert trainer.start_epoch == 4 and trainer.epoch == 5 and trainer.global_batch_idx == 10
    assert len(trainer.lr_log) == 5 and len(trainer.loss_log) == 10
    assert os.path.isfile(os.path.join(resumed, ws.model_params_subdir, "4.pth"))


def test_reconstruct_cli_reads_trained_decoder(experiment):
    exp, data, split_path, _ = experiment
    summary = reconstruct_cli.main(["-e", exp, "-c", "latest", "-d", os.path.join(data, "SdfSamples"),
                                    "-s", split_path, "--iters", "10", "--mesh_resolution", "33",
                                    "--device", "cpu", "--quiet"])
    assert len(summary) == 4
    assert os.path.isdir(os.path.join(exp, "Reconstructions", "3_on_train_set", "Meshes"))


def test_eval_test_writes_meshes_and_scalars(experiment, tmp_path):
    exp, data, split_path, _ = experiment
    gt_dir = str(tmp_path / "gt")
    os.makedirs(gt_dir)
    verts, faces = make_sphere_mesh(n_theta=12, n_phi=24, radius=0.5)
    names = json.load(open(split_path))["smoke"]["ellipsoid"]
    for name in names[:2]:
        with open(os.path.join(gt_dir, name + ".obj"), "w") as f:
            f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
            f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
    specs = dict(ws.load_experiment_specifications(exp), TorusPath=gt_dir, EvalTestSceneNumber=2,
                 EvalTestOptimizationSteps=5, EvalGridResolution=33)
    trainer = Stage1Trainer(exp, specs=specs, device="cpu")
    trainer.resume("latest")
    out = trainer._eval_test(3)
    assert out["names"] == names[:2] and len(out["chamfer"]) == 2
    assert all(np.isfinite(out["errors"])) and all(np.isfinite(out["chamfer"]))
    for name in out["names"]:
        assert os.path.isfile(os.path.join(exp, ws.tb_logs_dir, ws.tb_logs_test_reconstructions, name, "epoch=3.ply"))
    trainer.writer.flush()
    assert any(f.startswith("events") for f in os.listdir(os.path.join(exp, ws.tb_logs_dir)))


@pytest.mark.parametrize("dataset", ["ADNI", "OAI-ZIB"])
def test_cli_trains_shipped_gmm_config(experiment, tmp_path, dataset):
    """A shipped minimal_eikonal_gmm specs.json through the CLI: its data
    paths, widths and epochs cut to the tiny experiment's, warm-started from
    that experiment's decoder (PretrainedSDFDecoderDir). It trains on K2 with
    the GMM prior as a third optimizer group, whose moments the optimizer
    file carries first."""
    from chip_smoke import ROOT

    exp, data, split_path, _ = experiment
    with open(os.path.join(ROOT, "examples", dataset, "minimal_eikonal_gmm", "specs.json")) as f:
        specs = json.load(f)
    assert specs["UseGMMPriorLoss"] and specs["UsePretrainedSDFDecoder"]
    changes = dict(DataSource=os.path.join(data, "SdfSamples"), TrainSplit=split_path, TestSplit=split_path,
                   NetworkSpecs=SPECS["NetworkSpecs"], CodeLength=SPECS["CodeLength"], SamplesPerScene=256,
                   ScenesPerBatch=2, NumEpochs=2, SnapshotFrequency=2, AdditionalSnapshots=[], EvalTrainFrequency=0,
                   EvalTestFrequency=0, PretrainedSDFDecoderDir=exp)
    gmm_exp = str(tmp_path / "gmm")
    ws.save_experiment_specifications(gmm_exp, dict(specs, **changes))
    trainer = train_deep_sdf.main(["-e", gmm_exp, "--device", "cpu", "--quiet"])
    assert trainer.use_fused and trainer.epoch == 2 and set(trainer.optimizer.groups) == {"gmm", "lat", "net"}
    assert len(trainer.loss_log) == 4 and np.all(np.isfinite(trainer.loss_log))
    opt = torch.load(os.path.join(gmm_exp, ws.optimizer_params_subdir, "latest.pth"), weights_only=False)
    flat = opt["optimizer_state_dict"]["msd_tpu_adam"]
    n_net = len(list(trainer.decoder.parameters()))
    assert len(flat) == 1 + 2 * (3 + 1 + n_net)
    K, L = specs["GMMK"], SPECS["CodeLength"]
    assert [tuple(t.shape) for t in flat[1:5]] == [(K, L), (K,), (K, L), (4, L)]  # log_sigma, logits, mu, lat
    torch.testing.assert_close(flat[1:4], [trainer.optimizer.mu["gmm"][k].cpu() for k in ("log_sigma", "logits", "mu")])
