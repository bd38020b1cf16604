"""The port's Stage-2 hyper-parameter search against the root
``hparams_optuna_vae_sdf.py`` on the CPU: the sampler's parameters bit for
bit over the random start, the TPE phase and failed trials; the trial
specs; a trial's objective on msd_tpu's weights to 1e-4; a real trial of
the port; and the CLI (resume, ``best.json``, the refused base spec, a
failed trial recorded, a fault of the card ending the search)."""

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import hparams_optuna_vae_sdf as root_hpo
from msd_tpu.train.stage2 import Stage2Trainer as JaxTrainer
from msd_tpu_torch import hparams_optuna_vae_sdf as hpo
from msd_tpu_torch.ops import _build
from msd_tpu_torch.ops._build import KernelError
from msd_tpu_torch.train import stage2_eval as ev
from msd_tpu_torch.train.stage2 import Stage2Trainer
from test_stage2_trainer import _setup
from test_torch_stage2 import FLAGSHIP2, experiment, flagship_overrides, port_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def toy_objective(p):
    """tests/test_hpo.py's toy objective (optimum at VAEReconWeight 0.05,
    SNNLWeight 0.6, KLWarmupEpochs 40, AgeSNNLRegThreshold 0.2)."""
    return (
        -((np.log(p["VAEReconWeight"]) - np.log(0.05)) ** 2)
        - 8.0 * (p["SNNLWeight"] - 0.6) ** 2
        - (p["KLWarmupEpochs"] - 40.0) ** 2 / 900.0
        + (0.5 if p["AgeSNNLRegThreshold"] == 0.2 else 0.0)
    )


@pytest.mark.parametrize("history_kind", ["toy", "failed"])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_sampler_matches_root_script(seed, history_kind):
    """60 trials from one seed, each sampled by both from generators in the
    same state and the same history: the random start (10 trials), then
    TPE; "failed" makes every third trial's value None."""
    ours, ref = np.random.default_rng(seed), np.random.default_rng(seed)
    history = []
    for i in range(60):
        p, r = hpo.sample_params(ours, history), root_hpo.sample_params(ref, history)
        assert p == r and [type(v) for v in p.values()] == [type(v) for v in r.values()], i
        value = None if history_kind == "failed" and i % 3 == 0 else toy_objective(p)
        history.append({"trial": i, "params": p, "value": value})
    assert ours.bit_generator.state == ref.bit_generator.state
    assert hpo.SEARCH_SPACE == root_hpo.SEARCH_SPACE and hpo.WEIGHTS == root_hpo.WEIGHTS
    assert (hpo.N_STARTUP, hpo.N_EI_CANDIDATES, hpo.DEFAULT_NUM_EPOCHS) == (
        root_hpo.N_STARTUP, root_hpo.N_EI_CANDIDATES, root_hpo.DEFAULT_NUM_EPOCHS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trial_specs_match_root_script(seed):
    with open(FLAGSHIP2) as f:
        base = json.load(f)
    params = hpo.sample_params(np.random.default_rng(seed), [])
    kept = copy.deepcopy(base)
    ours = hpo.build_trial_specs(base, params, 7)
    assert ours == root_hpo.build_trial_specs(base, params, 7)
    assert base == kept and ours["LearningRateSchedule"][0]["Initial"] == params["LrInitial"]


def capture_jax_and_feed_port(monkeypatch, weights=(0.5, 0.3)):
    """msd_tpu's ``train`` stands still and keeps its trainer; the port's
    takes that trainer's weights, epoch and last KL and code-reg weights,
    and its VAE takes msd_tpu's reparameterisation noise for each holdout
    eval batch of the "hpo_holdout" split. Returns the dict that holds both
    trainers."""
    seen = {}

    def jax_train(self, start_epoch=1, num_epochs=None, batch_split=1):
        self.epoch = num_epochs
        self._last_kl_weight, self._last_code_reg_weight = weights
        seen["jax"] = self

    def port_train(self, start_epoch=1, num_epochs=None, batch_split=1):
        jt = seen["jax"]
        port_from_jax(self, jt)
        self.epoch, self._last_kl_weight, self._last_code_reg_weight = jt.epoch, *weights
        holdout, B = jt.holdout_indices, min(jt.scene_per_batch, len(jt.holdout_indices))
        split_key = jax.random.fold_in(jax.random.fold_in(jt.base_key, 777),
                                       int(hashlib.sha256(b"hpo_holdout").hexdigest()[:8], 16))
        epoch_key = jax.random.fold_in(split_key, jt.epoch)
        noise = []
        for bi, start in enumerate(range(0, len(holdout), B)):
            k_rep = jax.random.split(jax.random.fold_in(epoch_key, bi), 4)[2]
            shape = (len(holdout[start:start + B]), jt.vae_latent_dim)
            noise.append(torch.tensor(np.asarray(jax.random.normal(k_rep, shape))))
        forward = self.vae.forward

        def vae_from_jax(x, noise_=None, generator=None):
            return forward(x, noise=noise.pop(0))

        self.vae.forward = vae_from_jax
        seen["port"], seen["noise_left"] = self, noise

    monkeypatch.setattr(JaxTrainer, "train", jax_train)
    monkeypatch.setattr(Stage2Trainer, "train", port_train)
    return seen


def test_objective_matches_jax_on_the_same_weights(tmp_path, monkeypatch):
    """Both ``run_trial``s on msd_tpu's weights, the port handed msd_tpu's
    eval noise: the same holdout, SAP, correlation and recon, and the same
    value, to 1e-4 (``test_eval_tables_match_jax``'s limit for these eval
    functions; the mu differ by float32 rounding). 40 scenes, half held
    out: the classification SAP's 5-fold cross-validation scores 0 unless
    each class has 5 holdout scenes, which 16 scenes at 0.25 never give."""
    _, specs, _ = _setup(tmp_path, num_scenes=40, latent_size=16,
                         **flagship_overrides(TrainLatentHoldoutFraction=0.5, ComputeSAP=True))
    seen = capture_jax_and_feed_port(monkeypatch)
    ref, ref_detail = root_hpo.run_trial(str(tmp_path / "jax_trial"), specs, train_epochs=2)
    ours, detail = hpo.run_trial(str(tmp_path / "port_trial"), specs, train_epochs=2, device="cpu")
    assert seen["noise_left"] == []
    np.testing.assert_array_equal(seen["port"].holdout_indices, seen["jax"].holdout_indices)
    assert len(seen["port"].holdout_indices) == 20 and detail["sap"] > 0
    assert sorted(detail) == ["corr", "recon", "sap"]
    for k in detail:
        np.testing.assert_allclose(detail[k], ref_detail[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_real_trial_of_the_port(tmp_path):
    """A 2-epoch trial, unmocked: finite value and parts, its specs saved,
    its checkpoints written."""
    exp = experiment(tmp_path, TrainLatentHoldoutFraction=0.25, ComputeSAP=True)
    with open(os.path.join(exp, "specs.json")) as f:
        specs = json.load(f)
    trial = str(tmp_path / "trial")
    value, detail = hpo.run_trial(trial, dict(specs, NumEpochs=2), device="cpu")
    assert np.isfinite(value) and all(np.isfinite(v) for v in detail.values())
    np.testing.assert_allclose(value, 0.6 * detail["sap"] + 0.3 * detail["corr"] - 0.1 * detail["recon"])
    with open(os.path.join(trial, "specs.json")) as f:
        assert json.load(f)["NumEpochs"] == 2
    assert os.path.isfile(os.path.join(trial, "ModelParameters", "latest.pth"))


def base_specs(tmp_path, **extra):
    exp = experiment(tmp_path, TrainLatentHoldoutFraction=0.25, ComputeSAP=True, **extra)
    return os.path.join(exp, "specs.json")


def cli(base, out, n, *more):
    return hpo.main(["-b", base, "-o", str(out), "-n", str(n), "--epochs", "1", "--device", "cpu", "--quiet",
                     *more])


def test_cli_resumes_and_writes_best(tmp_path):
    """2 trials, then 1 more from trials.json: trial 2 draws from
    default_rng(seed + 2) with the first two as history, as the root
    script resumes."""
    base, out = base_specs(tmp_path), tmp_path / "search"
    cli(base, out, 2, "--seed", "5")
    history = cli(base, out, 1, "--seed", "5")
    with open(out / "trials.json") as f:
        assert json.load(f) == history
    assert [t["trial"] for t in history] == [0, 1, 2]
    assert all(t["value"] is not None and np.isfinite(t["value"]) for t in history)
    assert history[2]["params"] == root_hpo.sample_params(np.random.default_rng(7), history[:2])
    with open(out / "best.json") as f:
        assert json.load(f) == max(history, key=lambda t: t["value"])
    for i in range(3):
        with open(out / f"trial_{i:04d}" / "specs.json") as f:
            assert json.load(f)["NumEpochs"] == 1


def test_cli_refuses_a_base_spec_without_holdout(tmp_path):
    base = base_specs(tmp_path)
    with open(base) as f:
        specs = json.load(f)
    specs["TrainLatentHoldoutFraction"] = 0.0
    with open(base, "w") as f:
        json.dump(specs, f)
    with pytest.raises(SystemExit, match="TrainLatentHoldoutFraction"):
        cli(base, tmp_path / "search", 1)
    assert not os.path.exists(tmp_path / "search" / "trials.json")


def test_cli_records_a_failed_trial(tmp_path, monkeypatch):
    """A non-finite holdout recon fails the trial (value None, its error
    kept) as in the root script, and the search goes on to the end."""
    base, out = base_specs(tmp_path), tmp_path / "search"
    monkeypatch.setattr(ev, "run_eval", lambda *a, **k: {"eval_vae_recon": float("nan")})
    history = cli(base, out, 2)
    assert [t["value"] for t in history] == [None, None]
    assert all("non-finite" in t["error"] for t in history)
    assert not os.path.exists(out / "best.json")


def failing_build(tmp_path, monkeypatch):
    """K2's first build, with no nvcc to be found (the real raise site)."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    _build.load_library("fused_train")


FAULTS = {
    "kernel_build": (failing_build, KernelError),
    "cuda_error": (lambda *_: (_ for _ in ()).throw(torch.AcceleratorError("CUDA error: an illegal memory access")),
                   torch.AcceleratorError),
    "out_of_memory": (lambda *_: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError("CUDA out of memory")),
                      torch.cuda.OutOfMemoryError),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_cli_ends_on_a_fault_of_the_card(tmp_path, monkeypatch, fault):
    """Trial 0 trains; trial 1 meets a fault of the card in training: the
    search raises it (a nonzero exit) after writing trials.json with trial
    0 alone, and records no failed trial."""
    raise_fault, kind = FAULTS[fault]
    base, out = base_specs(tmp_path), tmp_path / "search"
    inner, calls = Stage2Trainer.train, []

    def train(self, *args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise_fault(tmp_path, monkeypatch)
        return inner(self, *args, **kw)

    monkeypatch.setattr(Stage2Trainer, "train", train)
    with pytest.raises(kind):
        cli(base, out, 3)
    with open(out / "trials.json") as f:
        history = json.load(f)
    assert [t["trial"] for t in history] == [0] and history[0]["value"] is not None
    assert len(calls) == 2


def test_cli_defaults_to_the_card(tmp_path):
    """Without ``--device`` the search asks for the card and, on a host
    without one, exits nonzero before its first trial."""
    base, out = base_specs(tmp_path), tmp_path / "search"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, "-m", "msd_tpu_torch.hparams_optuna_vae_sdf", "-b", base, "-o", str(out),
                          "-n", "1", "--epochs", "1"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0 and "CUDA device requested" in run.stderr
    assert not os.path.exists(out / "trials.json")
