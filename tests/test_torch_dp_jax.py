"""The port's data-parallel K2 and Stage-1 step against msd_tpu's mesh
versions on the CPU: ``fused_point_grads_sharded`` on 4 gloo ranks
against msd_tpu's on the 8-device CPU mesh (Pallas interpret mode,
float32), unpadded, padded and padded with EikonalNumPoints
(tests/test_fused_train.py:267-315); and a padded Stage-1 step on 3 ranks
against msd_tpu's padded mesh step on 3 devices, with checkpoints crossing
both ways. The ranks run functions of tests/test_torch_dp.py, which
imports no JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from msd_tpu.ops import fused_train as jax_ft
from msd_tpu.train.stage1 import Stage1Trainer as JaxTrainer
from msd_tpu_torch.parallel import run_ranks
from msd_tpu_torch.train.stage1 import Stage1Trainer
from test_torch_dp import TIMEOUT, cpus, load_trainer_state, sharded_k2_rank, stage1_rank
from test_torch_fused_train import CLAMP, make_case
from test_torch_stage1 import _assert_state_matches, _experiment, _jax_batch, _jax_step

B, P = 8, 384
# name: (real scenes, EikonalNumPoints)
SHARDED_CASES = {"unpadded": (8, None), "padded": (6, None), "padded_gated": (6, 100)}


@pytest.fixture(scope="module")
def sharded():
    """msd_tpu's results on the 8-device mesh and the port's on 4 ranks,
    for every case, from one spawn."""
    jdec, params, tdec, lat, xyz, gt = make_case(seed=31, B=B, P=P, width=32)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    xyzgt_t = jnp.asarray(np.concatenate([xyz, gt[..., None]], axis=2).transpose(2, 0, 1))
    ref = {}
    for name, (n_real, E) in SHARDED_CASES.items():
        kw = {} if n_real == B else dict(weights=(jnp.arange(B) < n_real).astype(jnp.float32), n_real=n_real)
        g_net, dlat, aux = jax_ft.fused_point_grads_sharded(
            jdec, jax.tree.map(jnp.asarray, params), jnp.asarray(lat), xyzgt_t, CLAMP, True, n_real * P, mesh,
            dtype=jnp.float32, interpret=True, eik_points=E, **kw)
        ref[name] = (jax.tree.map(np.asarray, g_net), np.asarray(dlat), float(aux["sdf"]), float(aux["eikonal"]))
    ranks = run_ranks(sharded_k2_rank, 4, (tdec.cpu(), lat, xyz, gt, SHARDED_CASES, CLAMP), devices=cpus(4),
                      timeout=TIMEOUT)
    return ref, ranks


@pytest.mark.parametrize("name", list(SHARDED_CASES))
def test_sharded_k2_matches_jax_mesh(sharded, name):
    """Loss sums 1e-6 relative, every gradient 1e-5 relative / 1e-8
    absolute (float32, summation order only), as tests/test_fused_train.py
    holds msd_tpu's sharded kernel against its single-device one; pad
    scenes' latent rows exactly zero; every rank holds the same sums."""
    ref, ranks = sharded
    g_net, dlat_ref, sdf_ref, eik_ref = ref[name]
    n_real = SHARDED_CASES[name][0]
    dlat = np.concatenate([r[name][2] for r in ranks])
    np.testing.assert_allclose(dlat, dlat_ref, rtol=1e-5, atol=1e-8)
    assert np.all(dlat[n_real:] == 0.0)
    for dW, db, _, sdf, eik in (r[name] for r in ranks):
        np.testing.assert_allclose([sdf, eik], [sdf_ref, eik_ref], rtol=1e-6)
        for layer, (w, b) in enumerate(zip(dW, db)):
            np.testing.assert_allclose(w.T, g_net[f"lin{layer}"]["w"], rtol=1e-5, atol=1e-8, err_msg=f"w{layer}")
            np.testing.assert_allclose(b, g_net[f"lin{layer}"]["b"], rtol=1e-5, atol=1e-8, err_msg=f"b{layer}")
    for r in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(r[name][0], ranks[0][name][0]))


def test_stage1_padded_step_matches_jax_mesh_and_checkpoints_cross(tmp_path):
    """4 scenes on msd_tpu's 3-device mesh and on the port's 3 ranks both
    pad to 6. msd_tpu writes checkpoint 1; the ranks resume it, take one
    step on the batch msd_tpu drew and rank 0 writes checkpoint 2, which
    msd_tpu resumes. Loss parts, parameters, latents and Adam moments match
    msd_tpu's mesh step to 1e-5, and its resume of 2 exactly."""
    exp = _experiment(tmp_path)
    jt = JaxTrainer(exp, mesh=Mesh(np.array(jax.devices()[:3]), ("data",)))
    assert jt._batch_pad == 6
    jt.epoch = 1
    jt.save_checkpoint("1")
    jt.save_logs()
    idx = np.array([4, 1, 5, 2])
    idx_pad = np.concatenate([idx, [0, 0]])
    key = jax.random.PRNGKey(13)
    batch = _jax_batch(jt, idx_pad, key)[:, :4]  # the real scenes' rows of msd_tpu's padded draw
    state, opt, aux = _jax_step(jt, idx_pad, key, 3.0, (1e-3, 5e-3))

    ranks = run_ranks(stage1_rank, 3, (exp, None, idx, batch, 3.0, (1e-3, 5e-3), "1", "2"), devices=cpus(3),
                      timeout=TIMEOUT)
    port = Stage1Trainer(exp, device="cpu")
    for ours, rank_state in ranks:
        for k in ("sdf", "eikonal", "reg", "total", "net_grad_norm"):
            np.testing.assert_allclose(ours[k], aux[k], rtol=1e-5, atol=1e-8, err_msg=k)
        load_trainer_state(port, rank_state)
        _assert_state_matches(port, state, opt)

    back = JaxTrainer(exp)
    assert back.resume("2") == 3
    load_trainer_state(port, ranks[0][1])
    _assert_state_matches(port, back.state, back.opt_state, tol=0)
