"""The port's points-mode Stage-2 step over 2 gloo ranks against msd_tpu's
``Stage2Trainer(mesh=)`` on 2 of the 8 virtual CPU devices, float32, for
each point encoder: msd_tpu's state, scene ids, labels and draws (point
batch, noise, FPS starts) go to both, the 4-scene batch splits 2 + 2 in
both (msd_tpu shards it over its mesh and XLA takes BatchNorm over the
global batch). Held to PR 10's limits for one step against msd_tpu
(test_torch_stage2_points's ``STEP_TOL``, ``assert_points_state_matches``).
The ranks run ``loaded_step_rank`` of tests/test_torch_stage2_points_ranks.py,
which imports no JAX."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from msd_tpu.train.stage2 import Stage2Trainer as JaxTrainer
from msd_tpu_torch.models.deepsdf import params_from_jax
from msd_tpu_torch.parallel import run_ranks
from msd_tpu_torch.train.stage2 import Stage2Trainer
from test_torch_dp import TIMEOUT, cpus
from test_torch_stage2 import jax_draws, jax_step
from test_torch_stage2_points import ENCODERS, SNNL_TERMS, STEP_TOL, _np, assert_points_state_matches, \
    experiment, vae_fps
from test_torch_stage2_points_ranks import loaded_step_rank

WEIGHTS = (0.004, 0.3, 1e-3, 5e-4)
# cross_cov (sum over j of cov(mu_target, mu_j)^2, terms that nearly
# cancel) moves by the batch's split alone: msd_tpu's own 2-device step
# moves it 4.87e-6 from its one-device step, the port's 2 ranks 4.60e-6
# from its one process, in opposite directions (PointNetEncoder, measured;
# ResNet-PointNet's does not move).
# So the 2-rank step is held to msd_tpu's 2-device step at the one-process
# limit plus that movement on each side: 1e-5 + 2 * 5e-6 (measured 1.29e-5).
CROSS_COV_SPLIT = 5e-6


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """msd_tpu's mesh step and the port's 2 ranks for every encoder, the
    ranks from one spawn."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    ref, cases = {}, {}
    for enc in ENCODERS:
        exp = experiment(tmp_path_factory.mktemp(enc), enc)
        jt = JaxTrainer(exp, mesh=mesh)
        port = Stage2Trainer(exp, device="cpu")
        vae_sd = port.vae.params_from_jax(_np(jt.state["vae"]))
        sdf_sd = params_from_jax(port.sdf_decoder, _np(jt.sdf_params()))
        idx = jt.train_indices[[3, 0, 5, 1]]
        labels = jt._batch_labels(idx, np.random.default_rng(1))
        key = jax.random.PRNGKey(11)
        old = jt.state["vae"]
        state, opt, aux = jax_step(jt, idx, labels, key, WEIGHTS)
        jt.state, jt.opt_state = state, opt
        fps = vae_fps(jt, key, len(idx)) if enc == "pointnet2" else None
        cases[enc] = (exp, vae_sd, sdf_sd, idx, labels, WEIGHTS, *jax_draws(jt, idx, key), fps)
        ref[enc] = jt, old, aux
    ranks = run_ranks(loaded_step_rank, 2, (cases,), devices=cpus(2), timeout=TIMEOUT)
    return ref, ranks


@pytest.mark.parametrize("enc", ENCODERS)
def test_points_step_on_2_ranks_matches_jax_mesh(both, enc):
    """Every loss term, the Adam moments, the new VAE parameters and the
    BatchNorm statistics of each rank against msd_tpu's 2-device mesh step,
    within ``STEP_TOL`` (PointNet++: 1e-2 on values, 2e-1 on gradients,
    ROADMAP §C); both ranks' states equal bit for bit."""
    ref, ranks = both
    jt, old, aux = ref[enc]
    tol = STEP_TOL[enc]
    port = Stage2Trainer(jt.experiment_directory, device="cpu")
    for r in ranks:
        ours = r[enc]
        assert sorted(ours["aux"]) == sorted(aux)
        for k, v in aux.items():
            if k == "matchstd":
                # (std0 - std_ref)^2 of two stds 7-20% apart: held through
                # its two stds, as test_points_step_matches_jax holds
                # PointNet++'s; msd_tpu's own 2-device step moves it 7.5e-5
                # from its one-device step (PointNetEncoder, measured)
                std0, stdref = ours["aux"]["matchstd_std0"], ours["aux"]["matchstd_stdref"]
                np.testing.assert_allclose(ours["aux"][k], (std0 - stdref) ** 2, rtol=1e-5, err_msg=k)
                continue
            rtol = tol["snnl"] if k in SNNL_TERMS and tol.get("snnl") else tol["values"]
            if k == "cross_cov" and enc == "pointnet_encoder":
                rtol = tol["values"] + 2 * CROSS_COV_SPLIT
            np.testing.assert_allclose(ours["aux"][k], v, rtol=rtol, atol=1e-7, err_msg=k)
        port.vae.load_state_dict(ours["state"])
        port.optimizer.count, port.optimizer.mu, port.optimizer.nu = ours["count"], ours["mu"], ours["nu"]
        assert_points_state_matches(port, jt, old, WEIGHTS[2], tol)
    assert all(torch.equal(v, ranks[1][enc]["state"][k]) for k, v in ranks[0][enc]["state"].items())
