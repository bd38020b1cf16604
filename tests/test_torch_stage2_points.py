"""msd_tpu_torch's Stage 2 in points mode against msd_tpu's, in float32 on
the CPU: surface clouds in SdfDataset and the mesh helpers, one training
step per point encoder with every loss of the flagship Stage-2 config
(examples/ADNI/MLP_VAE_SDF_disentangle_all_true_label_age/specs.json at a
small width), ``compute_vae_latents`` and ``run_eval``. msd_tpu's params go
into the port through ``PointNetLatentVAE.params_from_jax``; msd_tpu's
draws (point batch, noise, FPS starts) are handed to the port. PointNet++'s
widths are fixed, so 4 scenes of 256 surface points per batch."""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msd_tpu.workspace as jws
from msd_tpu.data import mesh_io as jmesh_io
from msd_tpu.data.sdf_samples import SdfDataset as JaxDataset
from msd_tpu.data.splits import load_split
from msd_tpu.train import stage2_eval as jev
from msd_tpu.train.stage2 import Stage2Trainer as JaxTrainer
from msd_tpu_torch.data import mesh_io
from msd_tpu_torch.data import sdf_samples
from msd_tpu_torch.data.sdf_samples import SdfDataset
from msd_tpu_torch.models.deepsdf import params_from_jax
from msd_tpu_torch.train import stage2_eval as ev
from msd_tpu_torch.train.stage2 import Stage2Trainer
from chip_smoke import ScalarRecorder
from conftest import make_sphere_mesh
from test_stage2_trainer import _setup
from test_torch_pointnet import PN2_TRAIN_RTOL, fps_starts
from test_torch_stage2 import close, flagship_overrides, jax_draws, jax_step

ENCODERS = ["resnet_pointnet", "pointnet_encoder", "pointnet2"]
SURFACE = 256


def write_meshes(mesh_dir, n):
    """UV spheres of growing radius as ``sphere_{i}.obj`` (the dataset's
    ids), written by the port's ``save_obj``."""
    os.makedirs(mesh_dir, exist_ok=True)
    for i in range(n):
        v, f = make_sphere_mesh(12, 24, radius=0.4 + 0.04 * i, center=(0.02 * i, 0.0, -0.01 * i))
        mesh_io.save_obj(os.path.join(mesh_dir, f"sphere_{i}.obj"), v, f)


def experiment(tmp_path, enc, **extra):
    mesh_dir = str(tmp_path / "meshes")
    write_meshes(mesh_dir, 8)
    exp, _, _ = _setup(tmp_path, num_scenes=8, latent_size=16, **flagship_overrides(
        EncoderType=enc, DataSourceMesh=mesh_dir, SurfacePointCount=SURFACE, ScenesPerBatch=4, **extra))
    return exp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_from_jax(port, jt):
    port.vae.load_state_dict(port.vae.params_from_jax(_np(jt.state["vae"])))
    port.sdf_decoder.load_state_dict(params_from_jax(port.sdf_decoder, _np(jt.sdf_params())))


def vae_fps(jt, key, b):
    """PointNet++'s FPS starts in msd_tpu's step from ``key``: k_vae, then
    the VAE's k_enc (msd_tpu/train/stage2.py:559, pointnet_vae.py:60)."""
    k_vae = jax.random.split(key, 4)[1]
    return fps_starts(jax.random.split(k_vae, 4)[1], b, jt.dataset.surface_points.shape[1])


# ---------------------------------------------------------------------------
# data


def test_surface_clouds_equal_jax(tmp_path):
    """SdfDataset's clouds bit for bit: one default_rng(0) over the kept ids
    in order, .obj then .ply then the bare id, a missing mesh a zero cloud."""
    exp = experiment(tmp_path, "pointnet2")
    mesh_dir = str(tmp_path / "meshes")
    os.remove(os.path.join(mesh_dir, "sphere_3.obj"))
    v, f = make_sphere_mesh(10, 20, radius=0.5)
    mesh_io.save_ply(os.path.join(mesh_dir, "sphere_5.ply"), v, f)
    os.remove(os.path.join(mesh_dir, "sphere_5.obj"))
    specs = jws.load_experiment_specifications(exp)
    split = load_split(specs["TrainSplit"])
    kw = dict(data_source_mesh=mesh_dir, return_surface_points=True, surface_point_count=300)
    ours = SdfDataset.from_split(specs["DataSource"], split, 256, **kw).surface_points
    ref = JaxDataset.from_split(specs["DataSource"], split, 256, **kw).surface_points
    assert ours.shape == (8, 300, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert not ours[3].any() and ours[5].any()
    with pytest.raises(RuntimeError, match="data_source_mesh"):
        SdfDataset.from_split(specs["DataSource"], split, 256, return_surface_points=True)


def test_mesh_helpers_equal_jax(tmp_path):
    """save_obj and save_mesh write msd_tpu's bytes; find_mesh_in_directory
    and get_surface_points return what msd_tpu's do, errors included."""
    v, f = make_sphere_mesh(8, 16, radius=0.6)
    for ext in (".obj", ".ply"):
        mesh_io.save_mesh(str(tmp_path / ("ours" + ext)), v, f)
        jmesh_io.save_mesh(str(tmp_path / ("ref" + ext)), v, f)
        assert (tmp_path / ("ours" + ext)).read_bytes() == (tmp_path / ("ref" + ext)).read_bytes()
    shape_dir = tmp_path / "shape"
    (shape_dir / "sub").mkdir(parents=True)
    with pytest.raises(mesh_io.NoMeshFileError):
        mesh_io.find_mesh_in_directory(str(shape_dir))
    mesh_io.save_obj(str(shape_dir / "sub" / "m.obj"), v, f)
    assert mesh_io.find_mesh_in_directory(str(shape_dir)) == jmesh_io.find_mesh_in_directory(str(shape_dir))
    mesh_io.save_obj(str(shape_dir / "n.obj"), v, f)
    with pytest.raises(mesh_io.MultipleMeshFileError):
        mesh_io.find_mesh_in_directory(str(shape_dir))
    for seed in (0, 3):
        np.testing.assert_array_equal(mesh_io.get_surface_points(str(tmp_path / "ours.obj"), 500, seed),
                                      jmesh_io.get_surface_points(str(tmp_path / "ref.obj"), 500, seed))


# ---------------------------------------------------------------------------
# trainer


def assert_points_state_matches(port, jt, old, lr, tol):
    """Adam moments, then VAE parameters and BatchNorm statistics, as
    test_torch_stage2's ``assert_state_matches``, with ``tol`` from
    ``STEP_TOL``: the moments (the step's gradients) to ``tol["moments"]``
    of the group's largest entry; the parameters to ``tol["values"]`` where
    the gradient is above ``tol["big"]`` of its largest, the rest moved by
    at most lr (plus two float32 ulps) in both. msd_tpu's moments of the
    running statistics are zero (zero gradients), and the port keeps the
    statistics as buffers outside Adam: both sets of statistics must agree
    after the step, to ``tol["values"]``."""
    conv = port.vae.params_from_jax
    assert port.optimizer.count == int(jt.opt_state.count)
    params = dict(port.vae.named_parameters())
    for moments, jm in ((port.optimizer.mu["vae"], jt.opt_state.mu["vae"]),
                        (port.optimizer.nu["vae"], jt.opt_state.nu["vae"])):
        ref = {k: v.numpy() for k, v in conv(_np(jm)).items()}
        assert sorted(moments) == sorted(k for k in ref if "running_" not in k)
        assert all(not ref[k].any() for k in ref if "running_" in k)
        scale = max(float(np.abs(v).max()) for v in ref.values())
        for name, m in moments.items():
            close(m.numpy(), ref[name], f"moment {name}", rtol=tol["moments"], scale=scale)
    grads = {k: v.numpy() for k, v in conv(_np(jt.opt_state.mu["vae"])).items()}
    g_max = max(float(np.abs(v).max()) for v in grads.values())
    before = {k: v.numpy() for k, v in conv(_np(old)).items()}
    sd = port.vae.state_dict()
    for name, r in ((k, v.numpy()) for k, v in conv(_np(jt.state["vae"])).items()):
        ours = sd[name].numpy()
        if name not in params:  # running statistics
            close(ours, r, name, rtol=tol["values"])
            continue
        big = np.abs(grads[name]) > tol["big"] * g_max
        close(ours[big], r[big], name, rtol=tol["values"], scale=float(np.abs(r).max()))
        bound = lr + 2 * np.spacing(np.abs(before[name]))
        for moved in (ours - before[name], r - before[name]):
            assert np.all(np.abs(moved) <= bound), name


# Tolerances of one step against msd_tpu: loss terms, parameters and
# statistics ("values"), the Adam moments ("moments", of the group's largest
# entry) and the share of the largest gradient above which a parameter's
# new value is compared ("big"; below it Adam's first step, about lr times
# the gradient's sign, may go either way on float32 noise). 1e-5 where
# test_torch_stage2 holds the residual VAE to it. PointNetEncoder's moments:
# its heads' BatchNorm normalises over the batch's 4 rows and the backward
# subtracts the rows' mean gradient, so fc_mu's and fc_logvar's first-layer
# gradients cancel, 7 of 131072 entries 2.8e-5 apart (measured): 1e-4.
# PointNet++: PN2_TRAIN_RTOL (test_torch_pointnet.py) for the values, and
# for the gradients its "grad_jax": msd_tpu's SA1 gradients sit up to
# 1.02e-1 of the largest gradient from a float64 evaluation, the port's
# 2.1e-3 (test_pointnet2_train_gradients), so a parameter is compared only
# where its gradient is above 2e-1 of the largest, where no sign can flip.
STEP_TOL = {
    "resnet_pointnet": dict(values=1e-5, moments=1e-5, big=1e-3),
    "pointnet_encoder": dict(values=1e-5, moments=1e-4, big=1e-3),
    "pointnet2": dict(values=PN2_TRAIN_RTOL["jax"], moments=PN2_TRAIN_RTOL["grad_jax"],
                      big=PN2_TRAIN_RTOL["grad_jax"]),
}


@pytest.mark.parametrize("enc", ENCODERS)
def test_points_step_matches_jax(tmp_path, enc):
    """One step from msd_tpu's state, scene ids, labels, point batch, noise
    and FPS starts: every loss term, the Adam moments, the new VAE
    parameters and the BatchNorm statistics (once, after the step), within
    ``STEP_TOL``. The frozen decoder's term goes through K2 d's plain
    version here and msd_tpu's XLA path there."""
    exp = experiment(tmp_path, enc)
    jt, port = JaxTrainer(exp), Stage2Trainer(exp, device="cpu")
    assert port.vae_input_mode == jt.vae_input_mode == "points" and port.fused_ok
    np.testing.assert_array_equal(port.dataset.surface_points, jt.dataset.surface_points)
    port_from_jax(port, jt)
    idx = jt.train_indices[[3, 0, 5, 1]]
    labels = jt._batch_labels(idx, np.random.default_rng(1))
    key = jax.random.PRNGKey(11)
    weights = (0.004, 0.3, 1e-3, 5e-4)
    old = jt.state["vae"]
    state, opt, aux = jax_step(jt, idx, labels, key, weights)
    jt.state, jt.opt_state = state, opt
    batch, noise, cov = jax_draws(jt, idx, key)
    fps = vae_fps(jt, key, len(idx)) if enc == "pointnet2" else None
    ours = port.step(torch.tensor(idx), labels, *weights, batch=batch, noise=noise, cov_noise=cov, fps_start=fps)
    assert sorted(aux) == sorted(ours)
    tol = STEP_TOL[enc]
    for k, v in aux.items():
        if enc == "pointnet2" and k == "matchstd":
            # (std0 - std_ref)^2 of two stds 0.1% apart turns mu's 1e-3
            # into 6% (measured): held through its two stds instead
            std0, stdref = float(ours["matchstd_std0"]), float(ours["matchstd_stdref"])
            np.testing.assert_allclose(float(ours[k]), (std0 - stdref) ** 2, rtol=1e-5, err_msg=k)
            continue
        np.testing.assert_allclose(float(ours[k]), v, rtol=tol["values"], atol=1e-7, err_msg=k)
    assert_points_state_matches(port, jt, old, weights[2], tol)
    if enc == "pointnet_encoder":
        assert not torch.equal(port.vae.encoder.bns[0].running_mean, torch.tensor(old["encoder"]["bns"][0]["mean"]))


def jax_compute_latents_inputs(jt, enc):
    """The FPS starts msd_tpu's compute_vae_latents uses (PRNGKey(0),
    msd_tpu/train/stage2.py:1058) for its one chunk."""
    if enc != "pointnet2":
        return None
    return fps_starts(jax.random.split(jax.random.PRNGKey(0), 4)[1], *jt.dataset.surface_points.shape[:2])


@pytest.mark.parametrize("enc", ENCODERS)
def test_compute_vae_latents_points_mode(tmp_path, enc):
    """mu of the surface clouds in eval mode: twice bit-equal, the running
    statistics untouched, and equal to msd_tpu's (PointNet++: with
    msd_tpu's PRNGKey(0) starts handed to the port's encoder; the port's
    own export draws its starts from a generator seeded 0)."""
    exp = experiment(tmp_path, enc)
    jt, port = JaxTrainer(exp), Stage2Trainer(exp, device="cpu")
    port_from_jax(port, jt)
    stats = {k: v.clone() for k, v in port.vae.state_dict().items() if "running_" in k}
    a, b = port.compute_vae_latents(), port.compute_vae_latents()
    np.testing.assert_array_equal(a, b)
    assert a.shape == (8, port.vae_latent_dim) and port.vae.training
    assert all(torch.equal(v, port.vae.state_dict()[k]) for k, v in stats.items())
    ref = np.asarray(jt.compute_vae_latents())
    fps = jax_compute_latents_inputs(jt, enc)
    if fps is None:
        close(a, ref, "mu")
        return
    with torch.no_grad():
        fed = port.vae.eval().encode(torch.tensor(port.dataset.surface_points), fps_start=fps)[0].numpy()
        own = port.vae.encode(torch.tensor(port.dataset.surface_points),
                              generator=torch.Generator().manual_seed(0))[0].numpy()
    close(fed, ref, "mu with msd_tpu's starts")
    np.testing.assert_array_equal(a, own)


@pytest.mark.parametrize("enc", ["pointnet2", "pointnet_encoder"])
def test_run_eval_points_mode_matches_jax(tmp_path, monkeypatch, enc):
    """run_eval on the train split: the VAE encodes the clouds and
    reconstructs the teacher latents. msd_tpu's per-batch draws (the point
    batch, the noise and the FPS starts from fold_in(..., batch)) are handed
    to the port, and every metric agrees to 1e-5; the statistics stay. A
    split loaded without clouds (as val and test are) gives None."""
    exp = experiment(tmp_path, enc)
    jt, port = JaxTrainer(exp), Stage2Trainer(exp, device="cpu")
    port_from_jax(port, jt)
    idx = jt.train_indices
    ref = jev.run_eval(jt, 3, "eval_train", scene_indices=idx, kl_weight=0.5, code_reg_weight=0.3,
                       writer=ScalarRecorder())
    split_key = jax.random.fold_in(jax.random.fold_in(jt.base_key, 777),
                                   int(hashlib.sha256(b"eval_train").hexdigest()[:8], 16))
    epoch_key = jax.random.fold_in(split_key, 3)
    B, P = jt.scene_per_batch, jt.num_samp_per_scene
    draws = []
    for bi, start in enumerate(range(0, len(idx), B)):
        key = jax.random.fold_in(epoch_key, bi)
        sel = idx[start:start + B]
        pos, pc, neg, nc = jt.dataset.device_arrays()
        rows = sdf_jax_rows(pos, pc, neg, nc, sel, P, key)
        _, k_enc, k_rep, _ = jax.random.split(key, 4)
        noise = torch.tensor(np.asarray(jax.random.normal(k_rep, (len(sel), jt.vae_latent_dim))))
        fps = fps_starts(k_enc, len(sel), SURFACE) if enc == "pointnet2" else None
        draws.append((rows, noise, fps))
    calls = {"batch": 0, "vae": 0}

    def batch_from_jax(*args, **kwargs):
        calls["batch"] += 1
        return draws[calls["batch"] - 1][0]

    forward = port.vae.forward

    def vae_from_jax(x, noise=None, fps_start=None, generator=None):
        calls["vae"] += 1
        _, n, f = draws[calls["vae"] - 1]
        return forward(x, noise=n, fps_start=f)

    monkeypatch.setattr(sdf_samples, "sample_sdf_batch", batch_from_jax)
    monkeypatch.setattr(port.vae, "forward", vae_from_jax)
    stats = {k: v.clone() for k, v in port.vae.state_dict().items() if "running_" in k}
    ours = ev.run_eval(port, 3, "eval_train", scene_indices=idx, kl_weight=0.5, code_reg_weight=0.3,
                       writer=ScalarRecorder())
    assert calls == {"batch": len(draws), "vae": len(draws)} and len(draws) == 2
    assert sorted(ours) == sorted(ref) and np.isfinite(ours["eval_vae_recon"])
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert all(torch.equal(v, port.vae.state_dict()[k]) for k, v in stats.items())
    val = SdfDataset.from_split(port.data_source, load_split(port.specs["TrainSplit"]), port.num_samp_per_scene)
    assert ev.run_eval(port, 3, "eval_val", dataset=val, eval_latents=port.teacher_latents) is None
    assert port.eval_split(3, "val", port.teacher_latents, val) == {}


def sdf_jax_rows(pos, pc, neg, nc, sel, P, key):
    """msd_tpu's point batch for ``sel`` as the port's [4, B, P] tensor."""
    from msd_tpu.data.sdf_samples import sample_sdf_batch

    rows = sample_sdf_batch(pos, pc, neg, nc, jnp.asarray(sel), P, key)
    return torch.tensor(np.asarray(rows)).permute(2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# what points mode refuses


def test_points_mode_stops_at_first_snapshot(tmp_path):
    """As msd_tpu's: train() runs to its first snapshot and stops there,
    since a point-encoder VAE cannot be checkpointed, and PretrainedVAEPath
    is refused for the same reason (test_torch_stage2's
    test_unported_options_raise covers save_checkpoint and group=)."""
    exp = experiment(tmp_path, "pointnet_encoder", NumEpochs=2, SnapshotFrequency=1, LogFrequency=1)
    port = Stage2Trainer(exp, device="cpu")
    before = port.vae.encoder.bns[0].running_mean.clone()
    with pytest.raises(NotImplementedError, match="cannot checkpoint"):
        port.train(num_epochs=2)
    assert port.epoch == 1 and len(port.loss_log) == 1 and np.isfinite(port.loss_log[0])
    assert not torch.equal(before, port.vae.encoder.bns[0].running_mean)
    assert not os.path.isdir(os.path.join(exp, jws.model_params_subdir))
    specs = jws.load_experiment_specifications(exp)
    with pytest.raises(NotImplementedError, match="cannot checkpoint"):
        Stage2Trainer(exp, specs=dict(specs, PretrainedVAEPath="vae.pth"), device="cpu")
