"""msd_tpu_torch's Stage-1 latent regularizers against msd_tpu's
(``losses/stage1.py``), in float32 on the CPU: the same inputs, made with
numpy, and the same random draws (msd_tpu's probes and selection noise,
handed to the port) go through both packages; values and gradients.
Covariance and GMM to rtol 1e-5, the isometry family to rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.losses import stage1 as jl
from msd_tpu.models.deepsdf import DeepSDFDecoder as JaxDecoder
from msd_tpu_torch.losses import stage1 as tl
from msd_tpu_torch.models.deepsdf import DeepSDFDecoder, params_from_jax
from msd_tpu_torch.utils.checkpoint import msd_tpu_names

LATENT = 16
NET = dict(dims=[64, 64, 64], latent_in=[2], weight_norm=True, norm_layers=[0, 1, 2])


def _close(a, b, rtol, atol=1e-7, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("shape", [(8, 16), (3, 5), (1, 4)])
def test_covariance_loss_matches_jax(shape):
    z = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jv, jg = jax.value_and_grad(jl.covariance_loss)(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    tv = tl.covariance_loss(zt)
    _close(tv.detach(), jv, 1e-5)
    if tv.requires_grad:
        tv.backward()
        _close(zt.grad, jg, 1e-5)
    else:  # one row: the constant zero of msd_tpu, no gradient
        assert shape[0] == 1 and float(tv) == 0.0 and not np.any(np.asarray(jg))


def test_gmm_prior_init_matches_jax():
    ours = tl.gmm_prior_init(torch.Generator().manual_seed(0), 3, LATENT, 0.6)
    theirs = jax.tree.map(np.asarray, jl.gmm_prior_init(jax.random.PRNGKey(0), 3, LATENT, 0.6))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}
    for k in ("log_sigma", "logits"):  # deterministic
        _close(ours[k], theirs[k], 1e-6, msg=k)
    assert ours["mu"].dtype == torch.float32
    assert 0.004 < float(ours["mu"].std()) < 0.02  # 0.01 * N(0, 1), as msd_tpu's
    again = tl.gmm_prior_init(torch.Generator().manual_seed(0), 3, LATENT, 0.6)
    assert torch.equal(ours["mu"], again["mu"])


@pytest.mark.parametrize("learn_pi", [False, True])
def test_gmm_prior_loss_matches_jax(learn_pi):
    rng = np.random.default_rng(1)
    params = {"mu": 0.5 * rng.standard_normal((3, LATENT)), "log_sigma": 0.3 * rng.standard_normal((3, LATENT)),
              "logits": rng.standard_normal(3)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    z = (0.4 * rng.standard_normal((8, LATENT))).astype(np.float32)

    def jfn(p, zz):
        return jl.gmm_prior_loss(p, zz, min_sigma=0.05, learn_pi=learn_pi)

    (jv, jaux), (jgp, jgz) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(z))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    zt = torch.tensor(z, requires_grad=True)
    tv, taux = tl.gmm_prior_loss(tp, zt, min_sigma=0.05, learn_pi=learn_pi)
    tv.backward()
    _close(tv.detach(), jv, 1e-5)
    for k in ("gmm_nll", "gmm_entropy"):
        assert not taux[k].requires_grad
        _close(taux[k], jaux[k], 1e-5, msg=k)
    _close(zt.grad, jgz, 1e-5, msg="z")
    for k in ("mu", "log_sigma"):
        _close(tp[k].grad, jgp[k], 1e-5, msg=k)
    if learn_pi:
        _close(tp["logits"].grad, jgp["logits"], 1e-5, msg="logits")
    else:  # uniform weights: logits never enter the loss
        assert tp["logits"].grad is None and not np.any(np.asarray(jgp["logits"]))


def _pair(seed=0):
    """(msd_tpu decoder, its params, the port's decoder with the same weights)."""
    jdec = JaxDecoder(LATENT, **NET)
    params = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(seed)))
    tdec = DeepSDFDecoder(LATENT, **NET)
    tdec.load_state_dict(params_from_jax(tdec, params))
    return jdec, params, tdec


def _iso_inputs(n=64, seed=3):
    rng = np.random.default_rng(seed)
    lat = (0.3 * rng.standard_normal(LATENT)).astype(np.float32)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return np.broadcast_to(lat, (n, LATENT)).copy(), pts


def _param_grads_close(tdec, jgrads, rtol, atol):
    params = dict(tdec.named_parameters())
    for path, name, transposed in msd_tpu_names(tdec):
        mod, leaf = path.split(".")
        g = params[name].grad
        ours = g.t() if transposed else (g.reshape(-1) if g.dim() == 2 else g)
        _close(ours, jgrads[mod][leaf], rtol, atol, msg=path)


def test_input_grads_match_jax():
    jdec, params, tdec = _pair()
    lat, pts = _iso_inputs()
    jg = jl._input_grads(lambda inp: jdec.apply(jax.tree.map(jnp.asarray, params), inp), jnp.asarray(lat),
                         jnp.asarray(pts))
    tg = tl._input_grads(tdec, torch.tensor(lat), torch.tensor(pts))
    assert tg.shape == (pts.shape[0], LATENT + 3)
    _close(tg.detach(), jg, 1e-4, 1e-6)
    # leading axes: each slice is its own set of points
    tg2 = tl._input_grads(tdec, torch.tensor(np.stack([lat, lat])), torch.tensor(np.stack([pts, pts[::-1]])))
    _close(tg2[0].detach(), tg.detach(), 1e-6, 1e-8)
    _close(tg2[1].detach(), tg.detach().flip(0), 1e-6, 1e-8)


def _loss_and_grads(kind, num_probes=2):
    """(msd_tpu's loss, aux, param grads, latent grad), (the port's)."""
    jdec, params, tdec = _pair()
    lat, pts = _iso_inputs()
    key = jax.random.PRNGKey(5)

    def jfn(p, z):
        fn = lambda inp: jdec.apply(p, inp)  # noqa: E731
        if kind == "isometry":
            return jl.isometry_loss(fn, z, jnp.asarray(pts), LATENT, key, num_probes)
        return jl.grad_metric_isotropy_loss(fn, z, jnp.asarray(pts), LATENT, 0.7, True)

    (jv, jaux), (jgp, jgz) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(lat))
    zt = torch.tensor(lat, requires_grad=True)
    if kind == "isometry":  # msd_tpu's probe draws (losses/stage1.py:117-118)
        probes = np.concatenate([np.asarray(jax.random.normal(k, (1, LATENT)))
                                 for k in jax.random.split(key, num_probes)])
        tv, taux = tl.isometry_loss(tdec, zt, torch.tensor(pts), LATENT, torch.tensor(probes))
    else:
        tv, taux = tl.grad_metric_isotropy_loss(tdec, zt, torch.tensor(pts), LATENT, 0.7, True)
    tv.backward()
    return (jv, jaux, jgp, jgz), (tv, taux, tdec, zt.grad)


@pytest.mark.parametrize("kind", ["isometry", "grad_metric_isotropy"])
def test_isometry_family_matches_jax(kind):
    (jv, jaux, jgp, jgz), (tv, taux, tdec, tgz) = _loss_and_grads(kind)
    assert tv.dim() == 0
    _close(tv.detach(), jv, 1e-4)
    for k in jaux:
        assert not taux[k].requires_grad
        _close(taux[k], jaux[k], 1e-4, 1e-9, msg=k)
    scale = max(float(np.abs(np.asarray(jgz)).max()), 1e-12)
    _close(tgz, jgz, 1e-4, 1e-5 * scale, msg="latent")
    _param_grads_close(tdec, jgp, 1e-4, 1e-5 * max(float(np.abs(np.asarray(x)).max())
                                                   for x in jax.tree.leaves(jgp)))


def test_isometry_family_batches_over_scenes():
    """[S, N, *] inputs give each scene's loss, as S calls on [N, *] would."""
    _, _, tdec = _pair()
    rng = np.random.default_rng(7)
    lat = torch.tensor(np.repeat((0.3 * rng.standard_normal((2, 1, LATENT))).astype(np.float32), 32, axis=1))
    pts = torch.tensor(rng.uniform(-1, 1, (2, 32, 3)).astype(np.float32))
    probes = torch.tensor(rng.standard_normal((2, 1, LATENT)).astype(np.float32))
    iso, _ = tl.isometry_loss(tdec, lat, pts, LATENT, probes)
    gmi, _ = tl.grad_metric_isotropy_loss(tdec, lat, pts, LATENT)
    for s in range(2):
        one, _ = tl.isometry_loss(tdec, lat[s], pts[s], LATENT, probes[s])
        _close(iso[s].detach(), one.detach(), 1e-6)
        one, _ = tl.grad_metric_isotropy_loss(tdec, lat[s], pts[s], LATENT)
        _close(gmi[s].detach(), one.detach(), 1e-6)


@pytest.mark.parametrize("n_iso", [16, 200])
def test_select_near_surface_points_matches_jax(n_iso):
    """msd_tpu's uniform noise handed to the port: the same points in the
    same order; with 100 near points of 200, 16 are all near."""
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    sdf = np.where(np.arange(200) % 2 == 0, 0.05, 0.5).astype(np.float32) * rng.choice([-1, 1], 200)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jl.select_near_surface_points(key, jnp.asarray(xyz), jnp.asarray(sdf[:, None]), 0.1, n_iso))
    noise = np.asarray(jax.random.uniform(key, (200,)))
    ours = tl.select_near_surface_points(torch.tensor(noise), torch.tensor(xyz), torch.tensor(sdf[:, None]), 0.1,
                                         n_iso)
    np.testing.assert_array_equal(ours.numpy(), ref)
    if n_iso == 16:
        near = {tuple(p) for p in xyz[np.abs(sdf) < 0.1]}
        assert all(tuple(p) in near for p in ours.numpy())
