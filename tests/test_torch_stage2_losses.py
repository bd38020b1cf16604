"""msd_tpu_torch's Stage-2 model and losses against msd_tpu's, in float32 on
the CPU: the residual MLP-VAE forward with given noise and its state-dict
names, and every VAE and disentanglement loss that Stage2Trainer reaches, in
value and input gradient, on numpy-made inputs (1e-5 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.losses import disentangle as jdl
from msd_tpu.losses import vae as jvl
from msd_tpu.losses.sdf import deep_sdf_loss as j_deep_sdf_loss
from msd_tpu.models.residual_mlp_vae import ResidualMLPVAE as JaxVAE
from msd_tpu_torch.losses import disentangle as dl
from msd_tpu_torch.losses import vae as vl
from msd_tpu_torch.losses.sdf import deep_sdf_loss
from msd_tpu_torch.models.residual_mlp_vae import ResidualMLPVAE, expand_latent_to_points, vae_params_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)
VAE_CONFIGS = {
    "flagship_shape": dict(input_dim=16, latent_dim=8, encoder_hidden_dims=[16, 8], decoder_hidden_dims=[8, 16, 16]),
    "two_blocks_relu_no_ln": dict(input_dim=16, latent_dim=4, encoder_hidden_dims=[12], decoder_hidden_dims=[12, 16],
                                  num_blocks=2, activation="relu", use_layernorm=False),
    "no_kl": dict(input_dim=16, latent_dim=4, encoder_hidden_dims=[16, 8], decoder_hidden_dims=[8, 16], use_kl=False),
}


def vae_pair(cfg, seed=0):
    jv = JaxVAE(**cfg)
    params = jax.tree.map(np.asarray, jv.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for stack in (params["encoder"]["backbone"], params["decoder"]["backbone"]):
        for stage in stack["stages"]:
            for block in stage["blocks"]:
                if "norm" in block:  # non-trivial LayerNorm affine
                    block["norm"]["scale"] = (1 + 0.1 * rng.standard_normal(block["norm"]["scale"].shape)).astype(np.float32)
                    block["norm"]["bias"] = (0.1 * rng.standard_normal(block["norm"]["bias"].shape)).astype(np.float32)
    tv = ResidualMLPVAE(**cfg)
    tv.load_state_dict(vae_params_from_jax(params))
    return jv, params, tv


@pytest.mark.parametrize("name", list(VAE_CONFIGS))
def test_vae_forward_matches_jax(name):
    cfg = VAE_CONFIGS[name]
    jv, params, tv = vae_pair(cfg)
    assert set(tv.state_dict()) == set(jv.params_to_torch_state_dict(jax.tree.map(jnp.asarray, params)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, cfg["input_dim"])).astype(np.float32)
    key = jax.random.PRNGKey(5)
    out_j = jv.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), rng=key, train=True)
    noise = np.asarray(jax.random.normal(jax.random.split(key, 4)[2], (6, cfg["latent_dim"])))
    out_t = tv(torch.tensor(x), noise=torch.tensor(noise))
    for k in ("mu", "logvar", "z", "z_hat"):
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]), err_msg=k, **TOL)
    z = torch.tensor(noise)
    np.testing.assert_allclose(tv.decode(z).detach().numpy(),
                               np.asarray(jv.decode(jax.tree.map(jnp.asarray, params), jnp.asarray(noise))), **TOL)


def test_state_dict_loads_both_ways():
    cfg = VAE_CONFIGS["flagship_shape"]
    jv, params, tv = vae_pair(cfg, seed=2)
    back = jv.params_from_torch_state_dict(tv.state_dict())
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tv2 = ResidualMLPVAE(**cfg)
    tv2.load_state_dict(jv.params_to_torch_state_dict(jax.tree.map(jnp.asarray, params)))
    for (k, a), (_, b) in zip(tv.state_dict().items(), tv2.state_dict().items()):
        assert torch.equal(a, b), k


def test_expand_latent_to_points():
    lat = np.arange(6, dtype=np.float32).reshape(2, 3)
    xyz = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    lp, xp = expand_latent_to_points(torch.tensor(lat), torch.tensor(xyz))
    from msd_tpu.models.residual_mlp_vae import expand_latent_to_points as jexp

    jl, jx = jexp(jnp.asarray(lat), jnp.asarray(xyz))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jx))


# ---------------------------------------------------------------------------
# losses: value and gradient with respect to the latent inputs


def _check(jfn, tfn, arrays, grad_argnums=(0,), tol=TOL):
    """jfn/tfn take the arrays (numpy -> jnp / torch) and return a scalar;
    value and the gradients with respect to ``grad_argnums`` must agree."""
    jargs = [jnp.asarray(a) for a in arrays]
    v_j, g_j = jax.value_and_grad(jfn, argnums=grad_argnums)(*jargs)
    targs = [torch.tensor(a, requires_grad=i in grad_argnums and a.dtype.kind == "f") for i, a in enumerate(arrays)]
    v_t = tfn(*targs)
    v_t.backward()
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), **tol)
    for i, g in zip(grad_argnums, g_j):
        ours = targs[i].grad if targs[i].grad is not None else torch.zeros_like(targs[i])  # unused input
        np.testing.assert_allclose(ours.numpy(), np.asarray(g), err_msg=f"grad {i}", **tol)


def _batch(seed, b=12, d=6, ties=False):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((b, d)).astype(np.float32)
    logvar = (0.3 * rng.standard_normal((b, d))).astype(np.float32)
    cls = rng.integers(0, 2, b).astype(np.float32)
    age = rng.uniform(60, 80, b).astype(np.float32)
    if ties:
        age = np.round(age / 5) * 5  # tied ages
    return mu, logvar, cls, age


MASKS = {
    "all": lambda cls: np.ones(len(cls), bool),
    "partial": lambda cls: np.arange(len(cls)) % 3 != 1,
    "one_class_absent": lambda cls: cls == cls[0],
}


@pytest.mark.parametrize("mask", list(MASKS))
def test_snn_loss_cls(mask):
    mu, _, cls, _ = _batch(0)
    valid = MASKS[mask](cls)
    for adaptive in (True, False):
        _check(lambda x, y, v: jdl.snn_loss_cls(x, y, T=10.0, valid=v, use_adaptive_T=adaptive),
               lambda x, y, v: dl.snn_loss_cls(x, y, T=10.0, valid=v, use_adaptive_T=adaptive),
               [mu, cls, valid])


@pytest.mark.parametrize("pos_mode", ["threshold", "topk"])
@pytest.mark.parametrize("mask", list(MASKS))
def test_snn_reg_loss_exact_tied_ages(pos_mode, mask):
    mu, _, cls, age = _batch(1, ties=True)
    valid = MASKS[mask](cls)
    kw = dict(T=10.0, target_dim=1, threshold=2.0, pos_mode=pos_mode, topk_frac=0.25)
    _check(lambda x, y, v: jdl.snn_reg_loss_exact(x, y, valid=v, **kw),
           lambda x, y, v: dl.snn_reg_loss_exact(x, y, valid=v, **kw), [mu, age, valid])


def test_snn_reg_loss_exact_no_normalize():
    mu, _, _, age = _batch(2)
    kw = dict(T=5.0, normalize_z=False, use_adaptive_T=False)
    _check(lambda x, y: jdl.snn_reg_loss_exact(x, y, **kw), lambda x, y: dl.snn_reg_loss_exact(x, y, **kw),
           [mu, age / 80])


@pytest.mark.parametrize("mask", list(MASKS))
def test_snn_reg_loss(mask):
    mu, _, cls, age = _batch(3)
    valid = MASKS[mask](cls)
    _check(lambda x, y, v: jdl.snn_reg_loss(x, y, 2.0, 3.0, valid=v),
           lambda x, y, v: dl.snn_reg_loss(x, y, 2.0, 3.0, valid=v), [mu, age, valid])


@pytest.mark.parametrize("mask", list(MASKS))
def test_label_penalties(mask):
    mu, _, cls, age = _batch(4)
    valid = MASKS[mask](cls)
    arrays = [mu, cls, valid]
    _check(lambda x, y, v: jdl.attribute_loss(x[:, 0], y, valid=v),
           lambda x, y, v: dl.attribute_loss(x[:, 0], y, valid=v), arrays)
    _check(lambda x, y, v: jdl.corr_leakage_penalty(x, y, 0, valid=v),
           lambda x, y, v: dl.corr_leakage_penalty(x, y, 0, valid=v), [mu, age, valid])
    _check(lambda x, v: jdl.cross_cov_penalty(x, 1, valid=v), lambda x, v: dl.cross_cov_penalty(x, 1, valid=v),
           [mu, valid])
    for cn in (0, 1):
        _check(lambda x, y, v: jdl.rank_loss_z0(x, y, cn_label=cn, valid=v),
               lambda x, y, v: dl.rank_loss_z0(x, y, cn_label=cn, valid=v), arrays)


def test_masked_median_even_count():
    """An even count takes the lower middle value, with masked entries
    pushed past the maximum."""
    x = np.array([5.0, -1.0, 3.0, 9.0, 2.0, 7.0], np.float32)
    m = np.array([True, True, True, False, True, False])
    ours = float(dl._masked_median(torch.tensor(x), torch.tensor(m)))
    assert ours == float(jdl._masked_median(jnp.asarray(x), jnp.asarray(m))) == 2.0


def test_match_std_and_sensitivity():
    mu, _, _, _ = _batch(5)
    _check(lambda x: jdl.match_std_z0(x, 0)[0], lambda x: dl.match_std_z0(x, 0)[0], [mu])
    j_ms, t_ms = jdl.match_std_z0(jnp.asarray(mu), 2), dl.match_std_z0(torch.tensor(mu), 2)
    for a, b in zip(t_ms, j_ms):
        np.testing.assert_allclose(float(a), float(b), **TOL)
    jv, params, tv = vae_pair(dict(input_dim=16, latent_dim=6, encoder_hidden_dims=[16], decoder_hidden_dims=[8, 16]))
    jp = jax.tree.map(jnp.asarray, params)
    for eta in (0.0025, 0.5):  # hinge active and not
        _check(lambda x: jdl.sensitivity_loss(x, lambda z: jv.decode(jp, z), eta=eta)[0],
               lambda x: dl.sensitivity_loss(x, tv.decode, eta=eta)[0], [mu])


@pytest.mark.parametrize("objective", ["beta_vae", "dip_ii", "dip_i", "beta_tcvae", "l1_recon"])
def test_vae_objectives(objective):
    mu, logvar, _, _ = _batch(6)
    rng = np.random.default_rng(7)
    z = (mu + rng.standard_normal(mu.shape)).astype(np.float32)
    z_hat = rng.standard_normal((12, 10)).astype(np.float32)
    target = rng.standard_normal((12, 10)).astype(np.float32)
    arrays = [z_hat, target, z, mu, logvar]
    if objective in ("beta_vae", "l1_recon"):
        rl = "l1" if objective == "l1_recon" else "mse"
        j = lambda zh, t, zz, m, lv: jvl.vae_loss(zh, t, m, lv, 0.1, 0.01, rl)[0]  # noqa: E731
        t = lambda zh, t, zz, m, lv: vl.vae_loss(zh, t, m, lv, 0.1, 0.01, rl)[0]  # noqa: E731
    elif objective.startswith("dip"):
        kind = objective[-2:].strip("_")
        j = lambda zh, t, zz, m, lv: jvl.dip_vae_loss(zh, t, m, lv, dip_type=kind)[0]  # noqa: E731
        t = lambda zh, t, zz, m, lv: vl.dip_vae_loss(zh, t, m, lv, dip_type=kind)[0]  # noqa: E731
    else:
        j = lambda zh, t, zz, m, lv: jvl.beta_tcvae_loss(zh, t, zz, m, lv, dataset_size=50)[0]  # noqa: E731
        t = lambda zh, t, zz, m, lv: vl.beta_tcvae_loss(zh, t, zz, m, lv, dataset_size=50)[0]  # noqa: E731
    _check(j, t, arrays, grad_argnums=(0, 2, 3, 4))


def test_dip_vae_ii_loss_with_given_noise():
    mu, logvar, _, _ = _batch(8)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, mu.shape))
    _check(lambda m, lv: jvl.dip_vae_ii_loss(key, m, lv, beta=0.2),
           lambda m, lv: vl.dip_vae_ii_loss(torch.tensor(noise), m, lv, beta=0.2), [mu, logvar], grad_argnums=(0, 1))
    for step, warm in ((0, 0), (3, 10), (20, 10)):
        assert vl.linear_warmup(step, warm) == jvl.linear_warmup(step, warm)


def test_deep_sdf_loss():
    rng = np.random.default_rng(9)
    pred = rng.uniform(-0.1, 0.1, (40, 1)).astype(np.float32)
    gt = rng.uniform(-0.1, 0.1, (40, 1)).astype(np.float32)
    lat = rng.standard_normal((40, 16)).astype(np.float32)
    for i, (a, b) in enumerate(zip(deep_sdf_loss(torch.tensor(pred), torch.tensor(gt), torch.tensor(lat), 1e-4, 0.5),
                                   j_deep_sdf_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(lat), 1e-4, 0.5))):
        np.testing.assert_allclose(float(a), float(b), err_msg=str(i), **TOL)
