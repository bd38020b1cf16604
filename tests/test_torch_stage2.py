"""msd_tpu_torch's Stage-2 trainer against msd_tpu's, in float32 on the CPU,
with every loss of the flagship Stage-2 config switched on
(examples/ADNI/MLP_VAE_SDF_disentangle_all_true_label_age/specs.json at a
small width): one step from the same parameters, scene ids, labels, point
batch and noise (msd_tpu's draws, handed to the port) against msd_tpu's XLA
step and its interpret-mode fused step, for the frozen decoder (K2 variant
d), a trained decoder (variant a) and batch_split 2; label mixing on the
same numpy draws; the holdout split and the exported latents; checkpoints
crossing both ways."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.data.sdf_samples import sample_sdf_batch as jax_sample
from msd_tpu.train.stage2 import Stage2Trainer as JaxTrainer
from msd_tpu_torch.models.deepsdf import params_from_jax
from msd_tpu_torch.models.residual_mlp_vae import vae_params_from_jax
from msd_tpu_torch.train.stage2 import Stage2Trainer
from msd_tpu_torch.utils import checkpoint as ckpt
from conftest import make_sphere_mesh
from msd_tpu_torch.data.mesh_io import save_obj
from test_stage2_trainer import _setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP2 = os.path.join(ROOT, "examples", "ADNI", "MLP_VAE_SDF_disentangle_all_true_label_age", "specs.json")
_PATH_KEYS = ("Description", "DataSource", "DataSourceMesh", "TrainSplit", "TestSplit", "PretrainedLatentPath",
              "PretrainedSDFDecoderPath", "EvalGTMeshDir")


def flagship_overrides(**extra):
    """The flagship Stage-2 spec's switches at a small width: decoder 4 x 64,
    latent 16, VAE latent 8, 8 scenes x 256 points, evals off."""
    with open(FLAGSHIP2) as f:
        specs = json.load(f)
    out = {k: v for k, v in specs.items() if k not in _PATH_KEYS}
    out.update(
        NetworkSpecs=dict(specs["NetworkSpecs"], dims=[64] * 4, latent_in=[2]),
        CodeLength=16, VAEInputDim=16, VAELatentDim=8, VAEEncoderHiddenDims=[16, 8], VAEDecoderHiddenDims=[8, 16, 16],
        SamplesPerScene=256, ScenesPerBatch=8, NumEpochs=4, SnapshotFrequency=2, LogFrequency=2,
        EvalTrainFrequency=0, EvalTestFrequency=0, AgeSNNLRegThreshold=0.05,
    )
    out.update(extra)
    return out


def experiment(tmp_path, **extra):
    exp, specs, _ = _setup(tmp_path, num_scenes=16, latent_size=16, **flagship_overrides(**extra))
    return exp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_from_jax(port, jt):
    """The port's VAE and decoder with msd_tpu's weights (fresh Adam on both)."""
    port.vae.load_state_dict(vae_params_from_jax(_np(jt.state["vae"])))
    port.sdf_decoder.load_state_dict(params_from_jax(port.sdf_decoder, _np(jt.sdf_params())))


def jax_draws(jt, idx, key):
    """The point batch [4, B, P] and the two noise tensors msd_tpu's step
    draws from ``key`` (msd_tpu/train/stage2.py:559-566, :631)."""
    k_batch, k_vae, _, k_cov = jax.random.split(key, 4)
    pos, pc, neg, nc = jt.dataset.device_arrays()
    rows = jax_sample(pos, pc, neg, nc, jnp.asarray(idx), jt.num_samp_per_scene, k_batch)
    shape = (len(idx), jt.vae_latent_dim)
    noise = jax.random.normal(jax.random.split(k_vae, 4)[2], shape)
    cov = jax.random.normal(k_cov, shape)
    return (torch.tensor(np.asarray(rows)).permute(2, 0, 1).contiguous(), torch.tensor(np.asarray(noise)),
            torch.tensor(np.asarray(cov)))


def jax_step(jt, idx, labels, key, weights, batch_split=1):
    kl_w, crw, lr_vae, lr_sdf = weights
    teacher, surface, frozen = jt._epoch_static_inputs()
    pos, pc, neg, nc = jt.dataset.device_arrays()
    step = jax.jit(jt._build_step(batch_split))
    state, opt, aux = step(jt.state, jt.opt_state, frozen, teacher, surface, pos, pc, neg, nc, jnp.asarray(idx),
                           *[jnp.asarray(a) for a in labels], key, jnp.float32(kl_w), jnp.float32(crw),
                           jnp.float32(lr_vae), jnp.float32(lr_sdf))
    return state, opt, {k: float(v) for k, v in aux.items()}


def close(ours, ref, what, rtol=1e-5, scale=None):
    """rtol 1e-5, with an absolute floor of 1e-5 of ``scale`` (default: the
    tensor's largest entry)."""
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale + 1e-30, err_msg=what)


def _groups(port, tree):
    out = {"vae": vae_params_from_jax(_np(tree["vae"]))}
    if port.train_sdf_decoder:
        out["sdf"] = params_from_jax(port.sdf_decoder, _np(tree["sdf"]))
    return {g: {k: v.numpy() for k, v in d.items()} for g, d in out.items()}


def assert_state_matches(port, state, opt, old=None, lrs=None):
    """Adam count and moments, then parameters. The moments (so the
    gradients) to 1e-5 of their group's largest entry: float32 sums that
    cancel (a bias gradient sums its batch; the sensitivity loss
    differences the VAE decoder at z +- 0.02) lose digits against the
    terms summed, not against the result. With the state ``old`` before a
    single step, the parameters to 1e-5 where the gradient is above 1e-3
    of its group's largest (100 times the gradient tolerance); Adam's
    first step moves every parameter by lr * g / (|g| + 1e-8), which
    magnifies float32 noise in a gradient near zero, so the rest move by
    at most ``lrs[group]`` in both (plus two float32 ulps of the
    parameter)."""
    assert port.optimizer.count == int(opt.count)
    for moments, jm in ((port.optimizer.mu, opt.mu), (port.optimizer.nu, opt.nu)):
        for group, ref in _groups(port, jm).items():
            scale = max(float(np.abs(v).max()) for v in ref.values())
            for name, r in ref.items():
                close(moments[group][name].numpy(), r, f"moment {group} {name}", scale=scale)
    params = {"vae": port.vae.state_dict(), "sdf": port.sdf_decoder.state_dict()}
    grads = _groups(port, opt.mu)
    before = _groups(port, old) if old is not None else None
    for group, ref in _groups(port, state).items():
        g_max = max(float(np.abs(v).max()) for v in grads[group].values())
        for name, r in ref.items():
            ours = params[group][name].numpy()
            if before is None:
                close(ours, r, f"{group} {name}")
                continue
            big = np.abs(grads[group][name]) > 1e-3 * g_max
            close(ours[big], r[big], f"{group} {name}", scale=float(np.abs(r).max()))
            bound = lrs[group] + 2 * np.spacing(np.abs(before[group][name]))
            for moved in (ours - before[group][name], r - before[group][name]):
                assert np.all(np.abs(moved) <= bound), (group, name)


STEP_CASES = {
    "d_xla": dict(),
    "d_interpret": dict(force=True),
    "a_xla": dict(TrainSDFDecoder=True),
    "a_interpret": dict(TrainSDFDecoder=True, force=True),
    "batch_split_2": dict(batch_split=2),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_jax(tmp_path, monkeypatch, case):
    """Every aux entry, the new VAE (and decoder) parameters and the Adam
    moments to 1e-5. The port takes K2 (plain, float32) whenever
    batch_split is 1, msd_tpu its XLA or its interpret-mode fused path."""
    kw = dict(STEP_CASES[case])
    force, batch_split = kw.pop("force", False), kw.pop("batch_split", 1)
    if force:
        monkeypatch.setenv("MSD_FUSED_FORCE", "interpret")
    exp = experiment(tmp_path, **kw)
    jt, port = JaxTrainer(exp), Stage2Trainer(exp, device="cpu")
    assert port.fused_ok and port.k2_dtype == torch.float32
    port_from_jax(port, jt)
    idx = jt.train_indices[[3, 0, 7, 1, 9, 12, 4, 10]]
    labels = jt._batch_labels(idx, np.random.default_rng(1))
    assert labels[1].sum() >= 4 and labels[3].all()
    key = jax.random.PRNGKey(11)
    weights = (0.004, 0.3, 1e-3, 5e-4)  # kl weight, code-reg weight, lr_vae, lr_sdf
    state, opt, aux = jax_step(jt, idx, labels, key, weights, batch_split)
    assert jt._fused_sdf_active == (force and batch_split == 1)
    batch, noise, cov = jax_draws(jt, idx, key)
    old = jt.state
    ours = port.step(torch.tensor(idx), labels, *weights, batch_split=batch_split, batch=batch, noise=noise,
                     cov_noise=cov)
    assert sorted(aux) == sorted(ours)
    for k, v in aux.items():
        np.testing.assert_allclose(float(ours[k]), v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert_state_matches(port, state, opt, old, {"vae": weights[2], "sdf": weights[3]})


def test_fused_and_autograd_paths_agree(tmp_path):
    """K2 (plain, float32) against the port's own autograd path."""
    exp = experiment(tmp_path)
    fused = Stage2Trainer(exp, device="cpu")
    plain = Stage2Trainer(exp, specs=dict(fused.specs, UseFusedSDFKernel=False), device="cpu")
    assert fused.fused_ok and not plain.fused_ok
    plain.vae.load_state_dict(fused.vae.state_dict())
    plain.sdf_decoder.load_state_dict(fused.sdf_decoder.state_dict())
    idx = fused.train_indices[:8]
    labels = fused._batch_labels(idx, np.random.default_rng(0))
    gen = torch.Generator().manual_seed(5)
    batch = torch.rand(4, 8, 256, generator=gen) * 0.4 - 0.2
    noise, cov = torch.randn(8, 8, generator=gen), torch.randn(8, 8, generator=gen)
    a = fused.step(torch.tensor(idx), labels, 0.01, 1.0, 1e-3, 5e-4, batch=batch, noise=noise, cov_noise=cov)
    b = plain.step(torch.tensor(idx), labels, 0.01, 1.0, 1e-3, 5e-4, batch=batch, noise=noise, cov_noise=cov)
    for k in a:
        np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for (n, x), (_, y) in zip(fused.vae.state_dict().items(), plain.vae.state_dict().items()):
        close(x.numpy(), y.numpy(), n)


@pytest.mark.parametrize("stratified", [True, False])
def test_label_mixing_matches_jax(tmp_path, stratified):
    """Pseudo/real label mixing from the same numpy draws: label and age
    arrays and their masks equal (msd_tpu/train/stage2.py:760-803)."""
    exp = experiment(tmp_path, LabelMixing=True, LabelMixStratified=stratified, LabelMixPseudoRatioStart=0.5,
                     LabelMixUnlabeledRatioStart=0.25)
    specs = json.load(open(os.path.join(exp, "specs.json")))
    real = torch.load(os.path.join(specs["DataSource"], "labels.pt"), weights_only=False)
    pseudo = {k: torch.tensor([1.0 - float(v[0]), float(v[1])]) for k, v in real.items()}
    pseudo[sorted(pseudo)[0]] = torch.tensor([float("nan"), 0.5])  # one unlabelled id
    torch.save(pseudo, os.path.join(specs["DataSource"], "pseudo_label.pt"))
    jt, port = JaxTrainer(exp), Stage2Trainer(exp, device="cpu")
    for seed in range(3):
        idx = jt.train_indices[np.random.default_rng(seed).permutation(len(jt.train_indices))[:8]]
        ours = port._batch_labels(idx, np.random.default_rng(seed))
        ref = jt._batch_labels(idx, np.random.default_rng(seed))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_holdout_latents_and_schedules_match_jax(tmp_path):
    exp = experiment(tmp_path)
    jt, port = JaxTrainer(exp), Stage2Trainer(exp, device="cpu")
    np.testing.assert_array_equal(port.holdout_indices, jt.holdout_indices)
    np.testing.assert_array_equal(port.train_indices, jt.train_indices)
    assert len(port.holdout_indices) == 2  # TrainLatentHoldoutFraction 0.1 of 16
    port_from_jax(port, jt)
    close(port.compute_vae_latents(), np.asarray(jt.compute_vae_latents()), "mu")
    for epoch in (1, 50, 150):
        lr_vae, lr_sdf, kl_w, crw = port.epoch_weights(epoch)
        assert lr_vae == jt.lr_schedules[0].get_learning_rate(epoch) and lr_sdf == jt.lr_schedules[1].get_learning_rate(epoch)
        assert kl_w == pytest.approx(0.01 * min(1.0, epoch / 100)) and crw == min(1.0, epoch / 100)


def test_unported_options_raise(tmp_path):
    """A point encoder builds (EncoderType "pointnet" is ResnetPointnet) and
    its mode refuses what msd_tpu cannot do or the port does not: a
    checkpoint ("cannot checkpoint"), ``group=`` (per-rank BatchNorm
    statistics), and, as msd_tpu (tests/test_stage2_points_mode.py:77), a
    run without meshes to sample clouds from."""
    exp = experiment(tmp_path)
    with open(os.path.join(exp, "specs.json")) as f:
        specs = json.load(f)
    with pytest.raises(RuntimeError, match="data_source_mesh"):
        Stage2Trainer(exp, specs=dict(specs, EncoderType="pointnet"), device="cpu")
    mesh_dir = tmp_path / "meshes"
    mesh_dir.mkdir()
    for i in range(16):
        save_obj(str(mesh_dir / f"sphere_{i}.obj"), *make_sphere_mesh(8, 16, radius=0.3 + 0.02 * i))
    points = dict(specs, EncoderType="pointnet", DataSourceMesh=str(mesh_dir), SurfacePointCount=64)
    port = Stage2Trainer(exp, specs=points, device="cpu")
    assert port.vae_input_mode == "points" and type(port.vae.encoder).__name__ == "ResnetPointnet"
    assert port.dataset.surface_points.shape == (16, 64, 3)
    with pytest.raises(NotImplementedError, match="cannot checkpoint"):
        port.save_checkpoint("latest")

    class Group:
        device, is_main, world_size = "cpu", True, 2

    with pytest.raises(NotImplementedError, match="BatchNorm statistics"):
        Stage2Trainer(exp, specs=points, device="cpu", group=Group())


def test_checkpoints_cross_both_ways(tmp_path):
    """The port's files resume in msd_tpu's Stage2Trainer.resume, and msd_tpu's
    in the port's: epoch, VAE and decoder weights, Adam count and moments,
    the exported mu and the log histories."""
    exp = experiment(tmp_path, TrainSDFDecoder=True)
    port = Stage2Trainer(exp, device="cpu")
    port.train(num_epochs=2)
    jt = JaxTrainer(exp)
    assert jt.resume("latest") == 3 and jt.epoch == 2
    assert_state_matches(port, jt.state, jt.opt_state)
    assert jt.logs_history["loss_epoch"] == pytest.approx(port.logs_history["loss_epoch"])
    lat, epoch = ckpt.load_latent_vectors(exp, "latest.pth")
    assert epoch == 2
    close(lat.numpy(), port.compute_vae_latents(), "LatentCodes")

    jt.train(start_epoch=3, num_epochs=4)  # msd_tpu writes; the port reads
    back = Stage2Trainer(exp, device="cpu")
    assert back.resume("latest") == 5 and back.epoch == 4
    assert_state_matches(back, jt.state, jt.opt_state)
    assert back.logs_history["loss_epoch"] == pytest.approx(jt.logs_history["loss_epoch"])
    assert len(back.loss_log) == 4 and back.global_batch_idx == 4


def test_frozen_decoder_optimizer_file_is_vae_only(tmp_path):
    """With TrainSDFDecoder false the optimizer tree is {"vae": ...} only."""
    exp = experiment(tmp_path)
    port = Stage2Trainer(exp, device="cpu")
    assert set(port.optimizer.groups) == {"vae"}
    assert not any(p.requires_grad for p in port.sdf_decoder.parameters())
    port.train(num_epochs=1)
    jt = JaxTrainer(exp)
    assert jt.resume("latest") == 2
    assert_state_matches(port, jt.state, jt.opt_state)
