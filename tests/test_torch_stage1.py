"""msd_tpu_torch's Stage-1 trainer against msd_tpu's, in float32 on the CPU:
one step from the same parameters, latents, scene ids and batch (the batch
msd_tpu drew, handed to the port), the LR schedules, checkpoints crossing
both ways, and a short training run on the sphere dataset of
tests/test_stage1_trainer.py."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msd_tpu.lr_schedules as jax_lr
from msd_tpu.data.sdf_samples import sample_sdf_batch as jax_sample
from msd_tpu.train.stage1 import Stage1Trainer as JaxTrainer
from msd_tpu_torch import lr_schedules as port_lr
from msd_tpu_torch.models.deepsdf import params_from_jax
from msd_tpu_torch.train.stage1 import Stage1Trainer
from msd_tpu_torch.utils import checkpoint as ckpt
from test_stage1_trainer import BASE_SPECS, make_sphere_dataset

SPECS = dict(BASE_SPECS, UseEikonal=True, NumEpochs=4, SnapshotFrequency=2, AdditionalSnapshots=[],
             LogFrequency=2, EvalTrainFrequency=0, EvalTestFrequency=0)


def _experiment(tmp_path, **overrides):
    data_dir = str(tmp_path / "data")
    names = make_sphere_dataset(data_dir, [0.3, 0.4, 0.5, 0.6, 0.7, 0.8], n_pos=1000, n_neg=1000)
    split_path = str(tmp_path / "train_split.json")
    with open(split_path, "w") as f:
        json.dump(names, f)
    specs = dict(SPECS, DataSource=data_dir, TrainSplit=split_path, TestSplit=split_path, **overrides)
    exp = str(tmp_path / "exp")
    os.makedirs(exp, exist_ok=True)
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(specs, f)
    return exp


def _port_from_jax(port, jt):
    """Copy msd_tpu's parameters, latents, GMM parameters and Adam state
    into the port."""
    params = jax.tree.map(np.asarray, jt.state["net"])
    port.decoder.load_state_dict(params_from_jax(port.decoder, params))
    with torch.no_grad():
        port.latents.copy_(torch.tensor(np.asarray(jt.state["lat"])))
        for k, v in jt.state.get("gmm", {}).items():
            port.gmm[k].copy_(torch.tensor(np.asarray(v)))
    port.optimizer.count = int(jt.opt_state.count)
    for moments, jm in ((port.optimizer.mu, jt.opt_state.mu), (port.optimizer.nu, jt.opt_state.nu)):
        moments["lat"]["weight"].copy_(torch.tensor(np.asarray(jm["lat"])))
        for k, v in jm.get("gmm", {}).items():
            moments["gmm"][k].copy_(torch.tensor(np.asarray(v)))
        for path, name, transposed in ckpt.msd_tpu_names(port.decoder):
            mod, leaf = path.split(".")
            v = torch.tensor(np.asarray(jm["net"][mod][leaf]))
            moments["net"][name].copy_((v.t() if transposed else v).reshape(moments["net"][name].shape))


def _jax_batch(jt, idx, key):
    """The batch msd_tpu's step draws from ``key``, as [4, B, P]."""
    pos, pc, neg, nc = jt.dataset.device_arrays()
    rows = jax_sample(pos, pc, neg, nc, jnp.asarray(idx), jt.num_samp_per_scene, jax.random.split(key)[0])
    return torch.tensor(np.asarray(rows)).permute(2, 0, 1).contiguous()


def _jax_step(jt, idx, key, epoch, lrs, batch_split=1):
    pos, pc, neg, nc = jt.dataset.device_arrays()
    step = jax.jit(jt._build_step(batch_split))
    state, opt, aux = step(jt.state, jt.opt_state, pos, pc, neg, nc, jnp.asarray(idx), key,
                           jnp.float32(epoch), jnp.float32(lrs[0]), jnp.float32(lrs[1]))
    return state, opt, {k: float(v) for k, v in aux.items()}


def _assert_state_matches(port, state, opt, tol=1e-5):
    np.testing.assert_allclose(port.latents.detach().numpy(), np.asarray(state["lat"]), rtol=tol, atol=tol)
    params = dict(port.decoder.named_parameters())
    assert port.optimizer.count == int(opt.count)
    for path, name, transposed in ckpt.msd_tpu_names(port.decoder):
        mod, leaf = path.split(".")

        def ours(t):
            t = t.detach()
            return (t.t() if transposed else t.reshape(-1) if t.dim() == 2 else t).numpy()

        np.testing.assert_allclose(ours(params[name]), np.asarray(state["net"][mod][leaf]), rtol=tol, atol=tol,
                                   err_msg=path)
        for moments, jm in ((port.optimizer.mu, opt.mu), (port.optimizer.nu, opt.nu)):
            np.testing.assert_allclose(ours(moments["net"][name]), np.asarray(jm["net"][mod][leaf]),
                                       rtol=tol, atol=tol, err_msg=path)
    for moments, jm in ((port.optimizer.mu, opt.mu), (port.optimizer.nu, opt.nu)):
        np.testing.assert_allclose(moments["lat"]["weight"].numpy(), np.asarray(jm["lat"]), rtol=tol, atol=tol)
    assert ("gmm" in state) == (port.gmm is not None)
    for k, v in state.get("gmm", {}).items():
        np.testing.assert_allclose(port.gmm[k].detach().numpy(), np.asarray(v), rtol=tol, atol=tol, err_msg=k)
        for moments, jm in ((port.optimizer.mu, opt.mu), (port.optimizer.nu, opt.nu)):
            np.testing.assert_allclose(moments["gmm"][k].numpy(), np.asarray(jm["gmm"][k]), rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("batch_split", [1, 2])
def test_step_matches_jax(tmp_path, batch_split):
    """K2's plain version (float32 on the CPU) against msd_tpu's XLA step:
    loss parts, new parameters, latents and Adam moments to 1e-5. With
    batch_split=2 both sum the two chunks' eikonal means."""
    exp = _experiment(tmp_path)
    jt, port = JaxTrainer(exp), Stage1Trainer(exp, device="cpu")
    assert port.use_fused and port.k2_dtype == torch.float32
    _port_from_jax(port, jt)
    idx = np.array([4, 1, 5, 2])
    key = jax.random.PRNGKey(7)
    state, opt, aux = _jax_step(jt, idx, key, 3.0, (1e-3, 5e-3), batch_split)
    ours = port.step(torch.tensor(idx), _jax_batch(jt, idx, key), 3.0, 1e-3, 5e-3, batch_split)
    for k in ("sdf", "eikonal", "reg", "total", "net_grad_norm"):
        np.testing.assert_allclose(float(ours[k]), aux[k], rtol=1e-5, atol=1e-8, err_msg=k)
    _assert_state_matches(port, state, opt)


def test_autograd_path_equals_k2_plain(tmp_path):
    exp = _experiment(tmp_path)
    k2 = Stage1Trainer(exp, device="cpu")
    ag = Stage1Trainer(exp, specs=dict(k2.specs, UseFusedTrainKernel=False), device="cpu")
    assert k2.use_fused and not ag.use_fused
    rng = np.random.default_rng(0)
    batch = torch.tensor(rng.uniform(-0.5, 0.5, (4, 4, 512)), dtype=torch.float32)
    idx = torch.tensor([0, 3, 2, 5])
    a = k2.step(idx, batch, 50, 1e-3, 5e-3)
    b = ag.step(idx, batch, 50, 1e-3, 5e-3)
    for k in a:
        np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(k2.latents.detach().numpy(), ag.latents.detach().numpy(), rtol=1e-5, atol=1e-7)
    for (n, p), (_, q) in zip(k2.decoder.named_parameters(), ag.decoder.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=1e-5, atol=1e-7, err_msg=n)


def test_code_bound_projection(tmp_path):
    exp = _experiment(tmp_path, CodeBound=0.05, CodeInitStdDev=10.0, UseEikonal=False)
    trainer = Stage1Trainer(exp, device="cpu")
    before = torch.linalg.vector_norm(trainer.latents.detach(), dim=1)
    assert float(before.min()) > 1.0
    idx = torch.tensor([0, 1, 2, 3])
    batch = torch.zeros(4, 4, 512)
    trainer.step(idx, batch, 1, 0.0, 0.0)  # zero learning rates: only the projection moves rows
    after = torch.linalg.vector_norm(trainer.latents.detach(), dim=1)
    np.testing.assert_allclose(after[:4].numpy(), 0.05, rtol=1e-5)
    np.testing.assert_allclose(after[4:].numpy(), before[4:].numpy())


SCHEDULES = [
    {"Type": "Step", "Initial": 5e-4, "Interval": 3, "Factor": 0.5},
    {"Type": "Warmup", "Initial": 1e-4, "Final": 1e-3, "Length": 4},
    {"Type": "Constant", "Value": 2e-3},
    {"Type": "StepOnPlateau", "Initial": 1e-3, "Factor": 0.5, "Patience": 2, "Threshold": 1e-3,
     "MinLR": 1e-5, "Cooldown": 1},
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=[s["Type"] for s in SCHEDULES])
def test_lr_schedules_match_jax(sched):
    specs = {"LearningRateSchedule": [sched, sched]}
    ours, theirs = port_lr.get_learning_rate_schedules(specs)[0], jax_lr.get_learning_rate_schedules(specs)[0]
    losses = [1.0, 0.9, 0.9, 0.9, 0.9, 0.85, 0.85, 0.85, 0.85, 0.85, 0.8]
    for epoch in range(1, 12):
        log = losses[:epoch]
        assert ours.get_learning_rate(epoch, log) == theirs.get_learning_rate(epoch, log)
    if hasattr(ours, "set_state"):
        ours.set_state(3e-4)
        theirs.set_state(3e-4)
        assert ours.get_learning_rate(12, losses) == theirs.get_learning_rate(12, losses)
    with pytest.raises(Exception, match="no known"):
        port_lr.get_learning_rate_schedules({"LearningRateSchedule": [{"Type": "Cosine"}]})


def test_training_reduces_loss(tmp_path):
    exp = _experiment(tmp_path, UseEikonal=False)
    trainer = Stage1Trainer(exp, device="cpu")
    first = trainer.train_epoch(1)
    for e in range(2, 26):
        last = trainer.train_epoch(e)
    assert last["total"] < first["total"] * 0.6, (first, last)
    assert len(trainer.loss_log) == 25 and len(trainer.lr_log) == 25


def test_checkpoints_cross_both_ways(tmp_path):
    """A checkpoint (model, latents, optimizer, logs) written by msd_tpu
    resumes in the port, and one written by the port resumes in msd_tpu;
    the next step then agrees."""
    exp = _experiment(tmp_path)
    jt = JaxTrainer(exp)
    jt.train_epoch(1)
    jt.epoch = 1
    jt.save_checkpoint("1")
    jt.save_logs()

    port = Stage1Trainer(exp, device="cpu")
    assert port.resume("1") == 2
    assert port.loss_log == jt.loss_log and port.lr_log == jt.lr_log
    idx = np.array([3, 0, 4, 1])
    key = jax.random.PRNGKey(11)
    batch = _jax_batch(jt, idx, key)
    state, opt, aux = _jax_step(jt, idx, key, 2.0, (1e-3, 5e-3))
    ours = port.step(torch.tensor(idx), batch, 2.0, 1e-3, 5e-3)
    np.testing.assert_allclose(float(ours["total"]), aux["total"], rtol=1e-5)
    _assert_state_matches(port, state, opt)

    # the port writes epoch 2; msd_tpu resumes from it and both step again
    port.epoch = 2
    port.save_checkpoint("2")
    port.save_logs()
    jt2 = JaxTrainer(exp)
    assert jt2.resume("2") == 3
    _assert_state_matches(port, jt2.state, jt2.opt_state, tol=0)
    key = jax.random.PRNGKey(12)
    state, opt, aux = _jax_step(jt2, idx, key, 3.0, (1e-3, 5e-3))
    ours = port.step(torch.tensor(idx), _jax_batch(jt2, idx, key), 3.0, 1e-3, 5e-3)
    np.testing.assert_allclose(float(ours["total"]), aux["total"], rtol=1e-5)
    _assert_state_matches(port, state, opt)


REGULARIZERS = {
    "UseCovarianceLoss": ("covariance",),
    "UseGMMPriorLoss": ("gmm", "gmm_nll", "gmm_entropy"),
    "UseIsometryLoss": ("iso", "iso_g1", "iso_g2"),
    "UseGradMetricIsotropyLoss": ("grad_metric_iso",),
}


@pytest.mark.parametrize("key", list(REGULARIZERS))
def test_regularizer_builds_and_steps(tmp_path, key):
    """Each Stage-1 regularizer builds and steps: finite metrics that the
    total includes; isometry and grad-metric isotropy take the autograd
    path, covariance and the GMM prior keep K2. The isometry terms run with
    mixup and on a random 2 of each batch's 4 scenes."""
    exp = _experiment(tmp_path, IsometryNumPoints=64, UseIsometryMixup=True, IsometryMixupProb=0.5,
                      IsometryScenesPerBatch=2, **{key: True})
    trainer = Stage1Trainer(exp, device="cpu")
    assert trainer.use_fused == (key in ("UseCovarianceLoss", "UseGMMPriorLoss"))
    assert ("gmm" in trainer.optimizer.groups) == (key == "UseGMMPriorLoss")
    mean = trainer.train_epoch(1)
    for k in REGULARIZERS[key]:
        assert np.isfinite(mean[k]), (k, mean)
    extra = mean[REGULARIZERS[key][0]]
    assert extra != 0.0
    np.testing.assert_allclose(mean["total"], mean["sdf"] + mean["eikonal"] + mean["reg"] + extra, rtol=1e-5)


def test_stage1_refuses_other_decoders(tmp_path):
    exp = _experiment(tmp_path, NetworkArch="siren_decoder", NetworkSpecs={"dims": [32, 32]})
    with pytest.raises(NotImplementedError, match="cannot checkpoint"):
        Stage1Trainer(exp, device="cpu")


@pytest.mark.parametrize("batch_split,learn_pi", [(1, False), (2, True)])
def test_latent_batch_losses_step_matches_jax(tmp_path, monkeypatch, batch_split, learn_pi):
    """Covariance and the GMM prior on K2 (its plain version; msd_tpu's
    fused step through the Pallas interpreter), from the same parameters,
    GMM and Adam state: loss parts, parameters, latents, GMM parameters and
    every Adam moment to 1e-5."""
    exp = _experiment(tmp_path, UseGMMPriorLoss=True, UseCovarianceLoss=True, GMMLearnPi=learn_pi,
                      GMMLambda=1e-2, CovarianceLossLambda=1e-1, GMMK=3, GMMMinSigma=0.1)
    monkeypatch.setenv("MSD_FUSED_FORCE", "interpret")
    jt, port = JaxTrainer(exp), Stage1Trainer(exp, device="cpu")
    assert port.use_fused and port.gmm is not None
    _port_from_jax(port, jt)
    idx = np.array([4, 1, 5, 2])
    key = jax.random.PRNGKey(7)
    state, opt, aux = _jax_step(jt, idx, key, 3.0, (1e-3, 5e-3), batch_split)
    assert jt._fused_active
    ours = port.step(torch.tensor(idx), _jax_batch(jt, idx, key), 3.0, 1e-3, 5e-3, batch_split)
    for k in ("sdf", "eikonal", "reg", "covariance", "gmm", "gmm_nll", "gmm_entropy", "total", "net_grad_norm"):
        np.testing.assert_allclose(float(ours[k]), aux[k], rtol=1e-5, atol=1e-8, err_msg=k)
    _assert_state_matches(port, state, opt)


def test_grad_metric_isotropy_step_matches_jax(tmp_path):
    """Grad-metric isotropy on the autograd path against msd_tpu's XLA step.
    IsometryNumPoints is every point of a scene and there is no mixup, so
    the selection only permutes the points and the loss does not depend on
    the draws: loss parts, parameters, latents and Adam moments to 1e-4."""
    exp = _experiment(tmp_path, UseGradMetricIsotropyLoss=True, IsometryNumPoints=512, GradMetricIsoAlpha=0.5)
    jt, port = JaxTrainer(exp), Stage1Trainer(exp, device="cpu")
    assert not port.use_fused
    _port_from_jax(port, jt)
    idx = np.array([2, 5, 0, 3])
    key = jax.random.PRNGKey(4)
    state, opt, aux = _jax_step(jt, idx, key, 3.0, (1e-3, 5e-3))
    assert not jt._fused_active
    ours = port.step(torch.tensor(idx), _jax_batch(jt, idx, key), 3.0, 1e-3, 5e-3)
    assert aux["grad_metric_iso"] > 0
    for k in ("sdf", "eikonal", "reg", "grad_metric_iso", "total", "net_grad_norm"):
        np.testing.assert_allclose(float(ours[k]), aux[k], rtol=1e-4, atol=1e-8, err_msg=k)
    _assert_state_matches(port, state, opt, tol=1e-4)


def test_gmm_optimizer_file_crosses_both_ways(tmp_path):
    """An optimizer file with the GMM prior's moments, written by msd_tpu,
    resumes in the port and back; neither package saves the GMM parameters,
    so a resumed run starts them afresh from the seed, and only their Adam
    moments carry over."""
    exp = _experiment(tmp_path, UseGMMPriorLoss=True, GMMLearnPi=True, GMMLambda=1e-2)
    jt = JaxTrainer(exp)
    jt.train_epoch(1)
    jt.epoch = 1
    jt.save_checkpoint("1")
    jt.save_logs()
    port = Stage1Trainer(exp, device="cpu")
    fresh = {k: v.detach().clone() for k, v in port.gmm.items()}
    assert port.resume("1") == 2
    assert all(torch.equal(port.gmm[k], fresh[k]) for k in fresh)
    for moments, jm in ((port.optimizer.mu, jt.opt_state.mu), (port.optimizer.nu, jt.opt_state.nu)):
        for k, v in jm["gmm"].items():
            assert np.any(np.asarray(v)), k
            np.testing.assert_array_equal(moments["gmm"][k].numpy(), np.asarray(v), err_msg=k)
    port.train_epoch(2)
    port.epoch = 2
    port.save_checkpoint("2")
    port.save_logs()
    jt2 = JaxTrainer(exp)
    assert jt2.resume("2") == 3
    for moments, jm in ((port.optimizer.mu, jt2.opt_state.mu), (port.optimizer.nu, jt2.opt_state.nu)):
        for k in ("log_sigma", "logits", "mu"):
            np.testing.assert_array_equal(moments["gmm"][k].numpy(), np.asarray(jm["gmm"][k]), err_msg=k)
    assert int(jt2.opt_state.count) == port.optimizer.count
    # a file without a GMM does not load into a trainer with one
    plain = Stage1Trainer(exp, specs=dict(port.specs, UseGMMPriorLoss=False), device="cpu")
    plain.epoch = 3
    plain.save_checkpoint("3")
    with pytest.raises(Exception, match="structure mismatch"):
        ckpt.load_optimizer(exp, "3.pth", port.decoder, port.optimizer)


@pytest.mark.parametrize("fused", [True, False], ids=["k2_c", "autograd"])
def test_eikonal_num_points_step_matches_jax(tmp_path, monkeypatch, fused):
    """EikonalNumPoints = 200 of 512 points: K2 variant c gates on the
    kernel's tiled count (256), as msd_tpu's fused step (run here through
    the Pallas interpreter); the autograd path on the first 200 points, as
    msd_tpu's XLA step. Loss parts, parameters, latents and Adam moments to
    1e-5."""
    exp = _experiment(tmp_path, EikonalNumPoints=200, UseFusedTrainKernel=fused)
    if fused:
        monkeypatch.setenv("MSD_FUSED_FORCE", "interpret")
    jt, port = JaxTrainer(exp), Stage1Trainer(exp, device="cpu")
    assert port.use_fused == fused and port.eikonal_num_points == 200
    _port_from_jax(port, jt)
    idx = np.array([2, 5, 0, 3])
    key = jax.random.PRNGKey(9)
    state, opt, aux = _jax_step(jt, idx, key, 3.0, (1e-3, 5e-3))
    assert jt._fused_active == fused
    ours = port.step(torch.tensor(idx), _jax_batch(jt, idx, key), 3.0, 1e-3, 5e-3)
    for k in ("sdf", "eikonal", "reg", "total", "net_grad_norm"):
        np.testing.assert_allclose(float(ours[k]), aux[k], rtol=1e-5, atol=1e-8, err_msg=k)
    _assert_state_matches(port, state, opt)
