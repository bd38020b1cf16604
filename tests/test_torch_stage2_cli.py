"""The port's Stage-2 CLI end to end on the CPU, on top of a Stage-1
experiment trained by the port's Stage-1 CLI: ``python -m
msd_tpu_torch.train_MLP_VAE_deep_sdf --device cpu`` with the flagship
Stage-2 switches at a small width writes the checkpoint families, the
log file, the eval tables, SAP and a mesh; ``-c latest`` resumes at the
right epoch."""

import json
import os

import numpy as np
import pytest
import torch

import msd_tpu_torch.workspace as ws
from chip_smoke import write_dataset, write_labels
from msd_tpu_torch import train_deep_sdf, train_MLP_VAE_deep_sdf
from test_torch_stage2 import flagship_overrides
from test_torch_train_cli import SPECS as STAGE1_SPECS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage2_cli")
    data = str(root / "data")
    split = write_dataset(data, 8, 2000, seed=3)
    split_path = str(root / "split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    source = os.path.join(data, "SdfSamples")
    stage1 = dict(STAGE1_SPECS, NetworkSpecs=dict(STAGE1_SPECS["NetworkSpecs"], dims=[64] * 4),
                  CodeLength=16, ScenesPerBatch=4, NumEpochs=2, DataSource=source, TrainSplit=split_path)
    ws.save_experiment_specifications(str(root / "stage1"), stage1)
    train_deep_sdf.main(["-e", str(root / "stage1"), "--device", "cpu", "--quiet"])
    labels = write_labels(source, split, seed=4)

    exp = str(root / "stage2")
    specs = flagship_overrides(
        DataSource=source, TrainSplit=split_path, NetworkSpecs=stage1["NetworkSpecs"], ScenesPerBatch=4,
        PretrainedLatentPath="../stage1/LatentCodes/latest.pth",
        PretrainedSDFDecoderPath="../stage1/ModelParameters/latest.pth",
        NumEpochs=2, SnapshotFrequency=1, LogFrequency=1, TrainLatentHoldoutFraction=0.25,
        EvalTrainFrequency=2, EvalGridResolution=32, EvalMeshTrainSceneNumber=1,
        EvalGTMeshDir=os.path.join(data, "SurfaceSamples", "smoke", "ellipsoid"), EvalGTMeshExt=".ply",
        EvalGTMeshSamples=2000,
    )
    ws.save_experiment_specifications(exp, specs)
    first = train_MLP_VAE_deep_sdf.main(["-e", exp, "--device", "cpu", "--quiet"])
    ws.save_experiment_specifications(exp, dict(specs, NumEpochs=3))
    resumed = train_MLP_VAE_deep_sdf.main(["-e", exp, "-c", "latest", "--device", "cpu", "--quiet"])
    return exp, labels, first, resumed


def test_checkpoints_logs_and_resume(runs):
    exp, labels, first, resumed = runs
    assert first.fused_ok and first.epoch == 2 and first.start_epoch == 1
    assert resumed.start_epoch == 3 and resumed.epoch == 3 and resumed.global_batch_idx == 3
    for sub in (ws.model_params_subdir, ws.optimizer_params_subdir, ws.latent_codes_subdir):
        for name in ("1.pth", "2.pth", "3.pth", "latest.pth"):
            assert os.path.isfile(os.path.join(exp, sub, name)), (sub, name)
    model = torch.load(os.path.join(exp, ws.model_params_subdir, "latest.pth"), weights_only=False)
    assert model["epoch"] == 3 and "encoder.mu_head.weight" in model["vae_state_dict"]
    lat = torch.load(os.path.join(exp, ws.latent_codes_subdir, "latest.pth"), weights_only=False)
    assert tuple(lat["latent_codes"]["weight"].shape) == (8, 8)
    logs = torch.load(ws.get_logs_filename(exp), weights_only=False)
    assert logs["epoch"] == 3 and len(logs["loss_epoch"]) == 3 and len(logs["loss"]) == 3
    for family in ("snnl_epoch", "snnl_age_epoch", "cov_epoch", "corr_leak_epoch", "cross_cov_epoch",
                   "rank_epoch", "matchstd_epoch", "sens_epoch", "sdf_loss_epoch"):
        assert len(logs[family]) == 3 and all(np.isfinite(logs[family])), family
    assert os.path.getsize(os.path.join(exp, "train.log")) > 0


def test_eval_epoch_outputs(runs):
    exp, labels, first, _ = runs
    assert len(first.holdout_indices) == 2
    assert first.last_train_sap is not None and 0.0 <= first.last_train_sap <= 1.0
    assert first.last_eval_metrics["epoch"] == 2 and np.isfinite(first.last_eval_metrics["eval_sdf_loss"])
    with open(os.path.join(exp, ws.tb_logs_dir, "AgeTables", "age_table_train_epoch_2.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0] == "dim,corr,sap_r2,pred_mean,pred_std" and len(rows) == 1 + 8
    meshes = [os.path.join(dp, n) for dp, _, names in os.walk(os.path.join(exp, ws.tb_logs_dir)) for n in names
              if n == "epoch=2.ply"]
    assert len(meshes) == 1
    assert sorted(labels) == sorted(first.dataset.instance_ids)
    np.testing.assert_array_equal(first.dataset.labels[:, 0], [float(labels[i][0]) for i in first.dataset.instance_ids])
