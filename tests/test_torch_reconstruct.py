"""Latent reconstruction in msd_tpu_torch against msd_tpu's semantics
(train/reconstruct.py:_reconstruct_scan_impl), float32 on the CPU. Random
draws cannot match across the packages, so both get the same batches,
built from numpy index arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.utils.optim import project_code_bound as jax_project
from msd_tpu_torch.train.reconstruct import (
    ReconstructConfig, reconstruct, reconstruct_batch, reconstruct_step,
)
from test_torch_decoder import make_pair

CFG = dict(dims=[32, 32, 32, 32], latent_in=[2], weight_norm=True, norm_layers=[])
LATENT = 16

REGS = {
    "l2reg": dict(l2reg=True),
    "code_reg_norm_bound": dict(l2reg=False, code_reg_lambda=1e-2, code_reg_type="l2_norm", code_bound=0.05),
    "code_reg_sq_dist_l1": dict(l2reg=False, code_reg_lambda=1e-3, dist_weight=1e-2, dist_type="l1"),
    "dist_zscore": dict(l2reg=True, dist_weight=5e-2),
}


def sphere_samples(n, radius, seed):
    """(pos, neg) [n, 4] samples of a sphere SDF near its surface."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((2 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius + rng.uniform(-0.15, 0.15, 2 * n)
    pts = d * r[:, None]
    sdf = r - radius
    s = np.concatenate([pts, sdf[:, None]], axis=1).astype(np.float32)
    return s[sdf > 0][:n], s[sdf <= 0][:n]


def jax_loop(jdec, params, cfg, init, batches, dm, ds):
    """msd_tpu's scan step, written out, on the given batches."""
    params = jax.tree.map(jnp.asarray, params)
    adjust = max(1, cfg.num_iterations // 2)

    def loss_fn(latent, batch):
        xyz = batch[:, 0:3]
        gt = jnp.clip(batch[:, 3:4], -cfg.clamp_dist, cfg.clamp_dist)
        inputs = jnp.concatenate([jnp.broadcast_to(latent, (batch.shape[0], LATENT)), xyz], axis=1)
        pred = jnp.clip(jdec.apply(params, inputs), -cfg.clamp_dist, cfg.clamp_dist)
        loss = jnp.mean(jnp.abs(pred - gt))
        if cfg.code_reg_lambda is not None and cfg.code_reg_lambda > 0.0:
            if cfg.code_reg_type == "l2_norm":
                loss += cfg.code_reg_lambda * jnp.mean(jnp.sqrt(jnp.maximum(jnp.sum(latent**2, axis=1), 1e-24)))
            else:
                loss += cfg.code_reg_lambda * jnp.mean(latent**2)
        elif cfg.l2reg:
            loss += 1e-4 * jnp.mean(latent**2)
        if cfg.dist_weight > 0.0:
            diff = (latent - dm) / ds
            loss += cfg.dist_weight * (jnp.mean(jnp.abs(diff)) if cfg.dist_type == "l1" else jnp.mean(diff**2))
        return loss

    latent, m, v = jnp.asarray(init), jnp.zeros_like(init), jnp.zeros_like(init)
    lats, losses = [], []
    for it, batch in enumerate(batches):
        lr = cfg.lr * (1.0 / 10.0) ** (it // adjust)
        loss, g = jax.value_and_grad(loss_fn)(latent, jnp.asarray(batch))
        t = jnp.float32(it + 1)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * (g * g)
        latent = latent - lr * (m / (1 - 0.9**t)) / (jnp.sqrt(v / (1 - 0.999**t)) + 1e-8)
        if cfg.code_bound is not None and cfg.code_bound > 0:
            latent = jax_project(latent, cfg.code_bound)
        lats.append(np.asarray(latent))
        losses.append(float(loss))
    return lats, losses


@pytest.mark.parametrize("reg", list(REGS), ids=list(REGS))
def test_step_matches_jax_over_20_steps(reg):
    jdec, params, tdec = make_pair(CFG, seed=11, latent_size=LATENT)
    for p in tdec.parameters():
        p.requires_grad_(False)
    cfg = ReconstructConfig(
        num_iterations=20, latent_size=LATENT, clamp_dist=0.1, num_samples=256, lr=5e-2, **REGS[reg]
    )
    pos, neg = sphere_samples(2000, 0.5, seed=1)
    rng = np.random.default_rng(3)
    batches = [
        np.concatenate([pos[rng.integers(0, len(pos), 128)], neg[rng.integers(0, len(neg), 128)]])
        for _ in range(20)
    ]
    init = (0.01 * rng.standard_normal((1, LATENT))).astype(np.float32)
    dm = (0.01 * rng.standard_normal((1, LATENT))).astype(np.float32)
    ds = (0.5 + rng.uniform(size=(1, LATENT))).astype(np.float32)
    ref_lats, ref_losses = jax_loop(jdec, params, cfg, init, batches, dm, ds)

    latent = torch.tensor(init)[None]
    m, v = torch.zeros_like(latent), torch.zeros_like(latent)
    for it, batch in enumerate(batches):
        latent, m, v, loss = reconstruct_step(
            tdec, cfg, latent, m, v, it, torch.tensor(batch)[None], torch.tensor(dm)[None], torch.tensor(ds)[None]
        )
        np.testing.assert_allclose(float(loss[0]), ref_losses[it], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(latent[0].numpy(), ref_lats[it], atol=1e-5, rtol=1e-5)
    if cfg.code_bound:
        assert float(latent.norm()) <= cfg.code_bound + 1e-6


def _fit_setup():
    return make_pair(CFG, seed=12, latent_size=LATENT, surface=True)[2]


def test_reconstruct_lowers_loss():
    tdec = _fit_setup()
    hist, latent = reconstruct(
        tdec, 150, LATENT, sphere_samples(3000, 0.4, seed=2), 0.01, 0.1,
        num_samples=512, lr=5e-3, l2reg=True, return_loss_hist=True,
    )
    assert latent.shape == (1, LATENT) and len(hist) == 150
    assert np.mean(hist[-15:]) < 0.8 * np.mean(hist[:15]), (hist[:5], hist[-5:])
    assert all(p.requires_grad for p in tdec.parameters())  # restored after the fit


def test_batch_matches_per_shape():
    tdec = _fit_setup()
    shapes = [sphere_samples(1500, 0.4, seed=4), sphere_samples(1200, 0.55, seed=5)]
    kw = dict(num_samples=256, lr=5e-2, l2reg=True)
    losses, latents = reconstruct_batch(tdec, 30, LATENT, shapes, 0.01, 0.1, seed=7, **kw)
    assert losses.shape == (2,) and latents.shape == (2, LATENT)
    for i, shape in enumerate(shapes):
        loss, latent = reconstruct(tdec, 30, LATENT, shape, 0.01, 0.1, seed=7 + i, **kw)
        np.testing.assert_allclose(latents[i].numpy(), latent[0].numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(losses[i], loss, atol=1e-5, rtol=1e-5)


def test_needs_both_signs():
    tdec = _fit_setup()
    pos, _ = sphere_samples(100, 0.5, seed=1)
    with pytest.raises(ValueError, match="both sample signs"):
        reconstruct(tdec, 2, LATENT, (pos, pos[:0]), 0.01, 0.1, num_samples=16)
