"""The port's data-parallel training over ranks on the CPU (gloo): a
Stage-1 step on 3 ranks, whose batch of 4 scenes pads to 6 (K2 variant e
on every rank), and a Stage-2 step on 2 ranks equal the one-process steps
on the same batch. This module imports no JAX: the ranks are spawned
processes that import it again (tests/test_torch_dp_jax.py holds the
comparisons with msd_tpu and reuses the rank functions here)."""

import json
import os

import numpy as np
import pytest
import torch

from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
from msd_tpu_torch.parallel import run_ranks
from msd_tpu_torch.train.stage1 import Stage1Trainer
from msd_tpu_torch.train.stage2 import Stage2Trainer

# every spawn gets this long; a hung collective fails its test
TIMEOUT = 240


def cpus(n):
    """``run_ranks``'s devices for ``n`` ranks on the CPU (the default is the card)."""
    return ["cpu"] * n

NET = {"dims": [64, 64, 64], "dropout": [], "dropout_prob": 0.0, "norm_layers": [0, 1, 2], "latent_in": [2],
       "xyz_in_all": False, "use_tanh": False, "latent_dropout": False, "weight_norm": True}
STAGE1_SPECS = {
    "Description": "data-parallel test", "NetworkArch": "deep_sdf_decoder", "NetworkSpecs": NET, "CodeLength": 8,
    "NumEpochs": 2, "SnapshotFrequency": 2, "AdditionalSnapshots": [],
    "LearningRateSchedule": [{"Type": "Constant", "Value": 1e-3}, {"Type": "Constant", "Value": 5e-3}],
    "SamplesPerScene": 256, "ScenesPerBatch": 4, "ClampingDistance": 0.1, "CodeRegularization": True,
    "CodeRegularizationLambda": 1e-4, "CodeBound": 1.0, "GradientClipNorm": 1.0, "LogFrequency": 2,
    "UseEikonal": True, "EvalTrainFrequency": 0, "EvalTestFrequency": 0,
}


def stage1_experiment(tmp_path, **overrides):
    """A Stage-1 experiment on 6 seeded ellipsoids (chip_smoke's data)."""
    from chip_smoke import write_dataset

    split = write_dataset(str(tmp_path / "data"), 6, 3000, seed=5)
    split_path = str(tmp_path / "split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    exp = str(tmp_path / "exp")
    os.makedirs(exp, exist_ok=True)
    specs = dict(STAGE1_SPECS, DataSource=str(tmp_path / "data" / "SdfSamples"), TrainSplit=split_path,
                 TestSplit=split_path, **overrides)
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(specs, f)
    return exp


def trainer_state(tr):
    """Parameters, pre-clip gradients, latents and Adam state of a Stage-1
    trainer, on the CPU; the GMM prior's parameters and gradients among the
    decoder's, as "gmm.<name>"."""
    def cpu(d):
        return {k: v.detach().cpu().clone() for k, v in d.items()}

    params = dict(tr.decoder.named_parameters())
    params.update({"gmm." + k: v for k, v in (tr.gmm or {}).items()})
    return {
        "params": cpu(params),
        "grads": {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().clone()
                  for n, p in params.items()},
        "latents": tr.latents.detach().cpu().clone(),
        "lat_grad": tr.latents.grad.detach().cpu().clone(),
        "count": tr.optimizer.count,
        "mu": {g: cpu(m) for g, m in tr.optimizer.mu.items()},
        "nu": {g: cpu(m) for g, m in tr.optimizer.nu.items()},
    }


def load_trainer_state(tr, state):
    """Copy ``trainer_state``'s parameters, latents and Adam state into a
    Stage-1 trainer."""
    with torch.no_grad():
        for n, p in tr.decoder.named_parameters():
            p.copy_(state["params"][n])
        for k, p in (tr.gmm or {}).items():
            p.copy_(state["params"]["gmm." + k])
        tr.latents.copy_(state["latents"])
        tr.optimizer.count = state["count"]
        for moments, src in ((tr.optimizer.mu, state["mu"]), (tr.optimizer.nu, state["nu"])):
            for g in moments:
                for k in moments[g]:
                    moments[g][k].copy_(src[g][k])


def stage1_rank(group, exp, state, idx, batch, epoch, lrs, resume_from=None, save_as=None):
    """One Stage-1 step on this rank: from ``state`` (or a checkpoint),
    then rank 0 writes ``save_as``. Returns the step's metrics and the
    trainer's state."""
    tr = Stage1Trainer(exp, group=group)
    if resume_from is not None:
        tr.resume(resume_from)
    if state is not None:
        load_trainer_state(tr, state)
    aux = tr.step(torch.as_tensor(idx), batch.to(tr.device), epoch, *lrs)
    if save_as is not None:  # a checkpoint named by its epoch
        tr.epoch = int(save_as)
        tr.save_checkpoint(save_as)
        tr.save_logs()
    return {k: float(v) for k, v in aux.items()}, trainer_state(tr)


def sharded_k2_rank(group, decoder, lat, xyz, gt, cases, clamp):
    """``fused_point_grads_sharded`` on this rank for each case (name:
    (real scenes, EikonalNumPoints)); returns numpy (dW, db, this rank's
    dlat rows, sdf, eikonal) per case."""
    from msd_tpu_torch.ops.fused_train import fused_point_grads_sharded

    n = decoder.num_layers - 1
    weights = [decoder.layer_weight(i).detach() for i in range(n)]
    biases = [getattr(decoder, f"lin{i}").bias.detach() for i in range(n)]
    B, P = xyz.shape[:2]
    out = {}
    for name, (n_real, eik_points) in cases.items():
        kw = {} if n_real == B else dict(scene_weights=(torch.arange(B) < n_real).float(), n_real=n_real)
        dW, db, dlat, sdf, eik = fused_point_grads_sharded(
            decoder, weights, biases, torch.as_tensor(lat), torch.as_tensor(xyz), torch.as_tensor(gt), clamp, True,
            n_real * P, group, dtype=torch.float32, eik_points=eik_points, **kw)
        out[name] = ([w.numpy() for w in dW], [b.numpy() for b in db], dlat.numpy(), float(sdf), float(eik))
    return out


# Share of the largest decoder gradient above which a parameter's new value
# is held to ``tol`` after a first step (``assert_states_close(before=...)``),
# as tests/test_torch_stage2_points.py's STEP_TOL "big".
BIG_GRAD = 1e-3


def assert_states_close(a, b, tol=1e-5, before=None, lr=None):
    """Two trainer states alike to ``tol``. With the parameters ``before``
    a first step at learning rate ``lr``, a parameter is held to ``tol``
    only where its gradient is above ``BIG_GRAD`` of the largest: Adam's
    first step moves it by lr * g / (|g| + 1e-8), which turns the float32
    noise of a sum taken in another order into up to lr where g is near
    1e-8 (lin2.weight_v[49, 49] of the padded step: a gradient of 6e-9 of
    the largest, 0.2% apart over ranks, moves the entry 1.9e-5 apart
    relative, measured). The rest must have moved by at most lr, plus two
    float32 ulps, in both states."""
    assert a["count"] == b["count"]
    g_max = max(float(g.abs().max()) for g in b["grads"].values())
    for n in b["params"]:
        ours, ref = a["params"][n].numpy(), b["params"][n].numpy()
        if before is None:
            np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol * 1e-2, err_msg=f"params {n}")
            continue
        big = np.abs(b["grads"][n].numpy()) > BIG_GRAD * g_max
        np.testing.assert_allclose(ours[big], ref[big], rtol=tol, atol=tol * 1e-2, err_msg=f"params {n}")
        old = before[n].numpy()
        bound = lr + 2 * np.spacing(np.abs(old))
        for moved in (ours - old, ref - old):
            assert np.all(np.abs(moved) <= bound), f"params {n} moved more than lr"
    for n in b["grads"]:
        np.testing.assert_allclose(a["grads"][n].numpy(), b["grads"][n].numpy(), rtol=tol, atol=tol * 1e-2,
                                   err_msg=f"grads {n}")
    for k in ("latents", "lat_grad"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=tol, atol=tol * 1e-2, err_msg=k)
    for k in ("mu", "nu"):
        for g in b[k]:
            for n in b[k][g]:
                np.testing.assert_allclose(a[k][g][n].numpy(), b[k][g][n].numpy(), rtol=tol, atol=tol * 1e-4,
                                           err_msg=f"{k} {g} {n}")


@pytest.mark.parametrize("fused", [True, False], ids=["k2", "autograd"])
def test_stage1_padded_step_on_3_ranks_equals_one_process(tmp_path, fused):
    """4 scenes on 3 ranks pad to 6 (two pad scenes, on the last rank):
    losses, pre-clip gradients, latents and Adam state equal the
    one-process step's to 1e-5, and the decoder's parameters do where
    their gradient is above ``BIG_GRAD`` of the largest (the rest moved by
    at most the decoder's lr in both); every rank holds the same state. With
    EikonalNumPoints the K2 path runs variants c and e together."""
    exp = stage1_experiment(tmp_path, UseFusedTrainKernel=fused, EikonalNumPoints=128, SamplesPerScene=384)
    one = Stage1Trainer(exp, device="cpu")
    assert one.use_fused == fused and one.gmm is None
    before = {n: p.detach().clone() for n, p in one.decoder.named_parameters()}
    idx = np.array([4, 1, 5, 2])
    pos, pc, neg, nc = one.dataset.device_arrays(one.device)
    batch = sample_sdf_batch(pos, pc, neg, nc, torch.as_tensor(idx), 384, torch.Generator().manual_seed(3))
    ref = one.step(torch.as_tensor(idx), batch, 3.0, 1e-3, 5e-3)
    ref = ({k: float(v) for k, v in ref.items()}, trainer_state(one))
    ranks = run_ranks(stage1_rank, 3, (exp, None, idx, batch, 3.0, (1e-3, 5e-3)), devices=cpus(3),
                      timeout=TIMEOUT)
    for aux, state in ranks:
        for k in ref[0]:
            np.testing.assert_allclose(aux[k], ref[0][k], rtol=1e-5, atol=1e-9, err_msg=k)
        assert_states_close(state, ref[1], before=before, lr=1e-3)
    # the ranks agree with each other bit for bit
    for _, state in ranks[1:]:
        assert all(torch.equal(state["params"][n], ranks[0][1]["params"][n]) for n in state["params"])
        assert torch.equal(state["latents"], ranks[0][1]["latents"])


@pytest.mark.parametrize("fused", [True, False], ids=["k2", "autograd"])
def test_stage1_latent_batch_losses_on_3_ranks_equal_one_process(tmp_path, fused):
    """Covariance and the GMM prior over 3 ranks (4 scenes padded to 6):
    each rank adds their gradient once, after the sum over ranks, so
    losses, gradients (the GMM's too), parameters and Adam state equal the
    one-process step's to 1e-5."""
    exp = stage1_experiment(tmp_path, UseFusedTrainKernel=fused, UseCovarianceLoss=True, UseGMMPriorLoss=True,
                            GMMLearnPi=True, GMMLambda=1e-2, CovarianceLossLambda=1e-1)
    one = Stage1Trainer(exp, device="cpu")
    assert one.use_fused == fused and one.gmm is not None
    idx = np.array([4, 1, 5, 2])
    pos, pc, neg, nc = one.dataset.device_arrays(one.device)
    batch = sample_sdf_batch(pos, pc, neg, nc, torch.as_tensor(idx), 256, torch.Generator().manual_seed(3))
    ref = one.step(torch.as_tensor(idx), batch, 3.0, 1e-3, 5e-3)
    ref = ({k: float(v) for k, v in ref.items()}, trainer_state(one))
    assert ref[0]["gmm"] != 0 and ref[0]["covariance"] != 0
    assert float(ref[1]["grads"]["gmm.mu"].abs().max()) > 0
    ranks = run_ranks(stage1_rank, 3, (exp, None, idx, batch, 3.0, (1e-3, 5e-3)), devices=cpus(3),
                      timeout=TIMEOUT)
    for aux, state in ranks:
        for k in ref[0]:
            np.testing.assert_allclose(aux[k], ref[0][k], rtol=1e-5, atol=1e-9, err_msg=k)
        assert_states_close(state, ref[1])


def test_batch_split_with_padded_chunks_raises(tmp_path):
    exp = stage1_experiment(tmp_path)

    class Group:  # the rank count is all the check reads
        world_size, rank, is_main, device = 3, 0, True, torch.device("cpu")

    tr = Stage1Trainer(exp, group=Group())
    with pytest.raises(NotImplementedError, match="batch_split"):
        tr.step(torch.arange(4), torch.zeros(4, 4, 256), 1, 1e-3, 5e-3, batch_split=2)


def failing_rank(group):
    if group.rank == 1:
        raise RuntimeError("rank 1 fails")
    group.all_reduce_([torch.ones(3)])  # rank 0 waits here for a peer that never comes
    return group.rank


def test_failed_rank_ends_the_run():
    """A failing rank ends every rank at once, and the caller raises with
    its error (the peer's failed collective may be named beside it)."""
    with pytest.raises(RuntimeError, match=r"rank 1: RuntimeError: rank 1 fails"):
        run_ranks(failing_rank, 2, devices=cpus(2), timeout=TIMEOUT)


def test_rank_defaults_to_the_card(monkeypatch):
    """A rank whose device is not given runs on the card, and raises
    where there is none rather than fall back to the CPU."""
    from msd_tpu_torch.parallel import init_group

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_group("file:///nonexistent/rendezvous", 2, 0)


# ---- Stage 2 ----

STAGE2_CHANGES = dict(SamplesPerScene=256, ScenesPerBatch=4, TrainLatentHoldoutFraction=0.0, EvalTrainFrequency=0,
                      EvalTestFrequency=0, NumEpochs=2, SnapshotFrequency=2)


def stage2_experiment(tmp_path):
    """The flagship Stage-2 specs on 6 seeded ellipsoids with labels and
    seeded teacher latents (the small decoder of STAGE1_SPECS)."""
    from chip_smoke import FLAGSHIP_STAGE2, write_dataset, write_labels

    split = write_dataset(str(tmp_path / "data"), 6, 3000, seed=6)
    split_path = str(tmp_path / "split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    source = str(tmp_path / "data" / "SdfSamples")
    write_labels(source, split, seed=1)
    with open(FLAGSHIP_STAGE2) as f:
        specs = json.load(f)
    for key in ("DataSourceMesh", "TestSplit", "PretrainedLatentPath", "PretrainedSDFDecoderPath", "EvalGTMeshDir"):
        specs.pop(key)
    specs.update(STAGE2_CHANGES, DataSource=source, TrainSplit=split_path, NetworkSpecs=NET, CodeLength=8,
                 VAEInputDim=8)
    teacher = (0.1 * np.random.default_rng(0).standard_normal((6, 8))).astype(np.float32)
    return str(tmp_path / "s2"), specs, teacher


def stage2_step(tr, inputs):
    idx, labels, weights, batch, noise, cov = inputs
    dev = tr.device
    aux = tr.step(torch.as_tensor(idx, device=dev), labels, *weights, batch=batch.to(dev), noise=noise.to(dev),
                  cov_noise=cov.to(dev))
    return ({k: float(v) for k, v in aux.items()},
            {n: p.grad.detach().cpu().clone() for n, p in tr.vae.named_parameters()},
            {n: p.detach().cpu().clone() for n, p in tr.vae.named_parameters()})


def stage2_rank(group, exp, specs, teacher, inputs):
    tr = Stage2Trainer(exp, specs=specs, teacher_latents=teacher, group=group)
    return stage2_step(tr, inputs)


def test_stage2_step_on_2_ranks_equals_one_process(tmp_path):
    """The 4-scene batch splits 2 + 2 over the ranks for the
    SDF-consistency term (K2 d); the VAE runs on both. Every loss, VAE
    gradient and parameter equals the one-process step's to 1e-5."""
    exp, specs, teacher = stage2_experiment(tmp_path)
    one = Stage2Trainer(exp, specs=specs, teacher_latents=teacher, device="cpu")
    assert one.fused_ok and not one.train_sdf_decoder
    idx = np.array([3, 0, 5, 1])
    rng = np.random.default_rng(4)
    labels = one._batch_labels(idx, rng)
    lr_vae, lr_sdf, kl_w, crw = one.epoch_weights(5)
    pos, pc, neg, nc = one.dataset.device_arrays(one.device)
    g = torch.Generator().manual_seed(2)
    batch = sample_sdf_batch(pos, pc, neg, nc, torch.as_tensor(idx), 256, g)
    noise, cov = torch.randn(4, one.vae_latent_dim, generator=g), torch.randn(4, one.vae_latent_dim, generator=g)
    inputs = (idx, labels, (kl_w, crw, lr_vae, lr_sdf), batch, noise, cov)
    ref = stage2_step(one, inputs)
    ranks = run_ranks(stage2_rank, 2, (exp, specs, teacher, inputs), devices=cpus(2), timeout=TIMEOUT)
    for aux, grads, params in ranks:
        for k in ref[0]:
            np.testing.assert_allclose(aux[k], ref[0][k], rtol=1e-5, atol=1e-8, err_msg=k)
        for n in ref[1]:
            np.testing.assert_allclose(grads[n].numpy(), ref[1][n].numpy(), rtol=1e-5, atol=1e-9, err_msg=n)
            np.testing.assert_allclose(params[n].numpy(), ref[2][n].numpy(), rtol=1e-5, atol=1e-7, err_msg=n)
