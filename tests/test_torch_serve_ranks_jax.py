"""The port's serving over ranks against msd_tpu's over devices, float32 on
the CPU: ``reconstruct_batch(mesh=)`` and ``PointEvaluator(mesh=)`` on
msd_tpu's 8 virtual CPU devices against ``reconstruct_batch(group=)`` and
``PointEvaluator(group=)`` on 3 gloo ranks (the rank function of
tests/test_torch_serve_ranks.py, which imports no JAX), and msd_tpu's
query-sharded kNN vote against the port's, the same weights
(``params_from_jax``) and numpy-made inputs going through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from msd_tpu import mesh as jax_mesh
from msd_tpu.preprocess import mesh_to_sdf as jm
from msd_tpu.train.reconstruct import reconstruct_batch as jax_reconstruct_batch
from msd_tpu_torch.parallel import run_ranks
from msd_tpu_torch.preprocess import mesh_to_sdf as tm
from test_torch_decoder import make_pair
from test_torch_dp import TIMEOUT, cpus
from test_torch_serve_ranks import FIT, ITERS, LATENT, MESH_N, N_POINTS, serve_rank, sphere_shapes, \
    sphere_vote_inputs

CFG = dict(dims=[32] * 4, latent_in=[2], weight_norm=True, norm_layers=[])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """msd_tpu's decoder and params, the port's with the same weights, the
    inputs, and one spawn of 3 port ranks on them."""
    jdec, params, tdec = make_pair(CFG, seed=41, surface=True)
    shapes = sphere_shapes(4, seed=2)
    rng = np.random.default_rng(6)
    latent = (0.05 * rng.standard_normal(LATENT)).astype(np.float32)
    pts = rng.uniform(-1, 1, (N_POINTS, 3)).astype(np.float32)
    out_dir = str(tmp_path_factory.mktemp("serve_ranks_jax"))
    # make_pair's params may be views of the port decoder's tensors, whose
    # storage moves to shared memory when the spawn pickles it: copy first
    params = jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)), params)
    ranks = run_ranks(serve_rank, 3, (tdec, shapes, ITERS, FIT, latent, pts, MESH_N, out_dir), devices=cpus(3),
                      timeout=TIMEOUT)
    return jdec, params, shapes, latent, pts, ranks


def data_mesh():
    assert len(jax.devices()) == 8
    return Mesh(np.array(jax.devices()), ("data",))


def test_reconstruct_batch_ranks_against_jax_mesh(both):
    """4 shapes: msd_tpu over 8 devices (padded to 8), the port over 3 ranks.
    Their draws differ (JAX keys against torch generators), so both are held
    to the quality bounds of tests/test_reconstruct_and_mesh.py (finite
    latents, every loss under 0.1), and each port loss to 1.5 times
    msd_tpu's plus 5e-3."""
    jdec, params, shapes, _, _, ranks = both
    losses, latents = jax_reconstruct_batch(jdec, params, ITERS, LATENT, shapes, 0.01, 0.1,
                                            num_samples=FIT["num_samples"], lr=FIT["lr"], l2reg=True,
                                            mesh=data_mesh())
    ours = ranks[0]["losses"][:, -1]
    assert losses.shape == ours.shape == (4,) and latents.shape == ranks[0]["latents"].shape
    for lat, loss in ((latents, losses), (ranks[0]["latents"], ours)):
        assert np.isfinite(lat).all() and np.all(loss < 0.1), loss
    assert np.all(ours < 1.5 * losses + 5e-3), (ours, losses)


def test_point_evaluator_ranks_against_jax_mesh(both):
    """The port's PointEvaluator over 3 ranks against msd_tpu's over its 8
    devices on the same 1000 points, to tests/test_torch_mesh.py's 1e-5."""
    jdec, params, _, latent, pts, ranks = both
    ref = np.asarray(jax_mesh.PointEvaluator(jdec, params, mesh=data_mesh()).eval_points(latent, pts))
    assert ref.shape == ranks[0]["vals"].shape == (N_POINTS,)
    np.testing.assert_allclose(ranks[0]["vals"], ref, atol=1e-5)


def test_knn_sign_vote_sharded_against_jax_devices():
    """msd_tpu's vote sharded over its 8 devices against the port's over 3
    devices: keep, sign and |sdf| agree on ``VOTE_AGREEMENT``'s shares."""
    q, s, n = sphere_vote_inputs()
    ref = jm.knn_sign_vote(q, s, n, num_votes=11, q_chunk=256, s_tile=1024, devices=jax.devices(),
                           force_device=True)
    ours = tm.knn_sign_vote(q, s, n, num_votes=11, q_chunk=512, devices=["cpu"] * 3, force_device=True)
    agree = tm.vote_agreement(*ours, *ref)
    assert agree["ok"], agree
