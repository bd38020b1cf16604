"""SDF regression losses of Stage 1 and Stage 2 (counterpart of ``msd_tpu/losses/sdf.py``).

ref: train_deep_sdf.py:443,566-616 (clamped L1 with sum reduction divided by
the total sample count, code-norm regularizer with a 100-epoch ramp) and
:724-728 (eikonal).
"""

from __future__ import annotations

import torch


def safe_l2norm(x: torch.Tensor, dim: int = -1, tiny: float = 1e-24) -> torch.Tensor:
    """L2 norm with a zero (not NaN) gradient at the origin. Needed because
    clamped predictions give exactly-zero xyz gradients outside the
    truncation band."""
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim), min=tiny))


def clamped_l1_sum(pred_sdf, sdf_gt, clamp_dist, num_sdf_samples=None):
    """sum |clamp(pred) - clamp(gt)| / num_samples
    (ref: train_deep_sdf.py:566-567,604-606)."""
    if num_sdf_samples is None:
        num_sdf_samples = pred_sdf.shape[0]
    pred = pred_sdf.clamp(-clamp_dist, clamp_dist)
    gt = sdf_gt.clamp(-clamp_dist, clamp_dist)
    return (pred - gt).abs().sum() / num_sdf_samples


def code_regularization(batch_vecs, num_sdf_samples, code_reg_lambda, epoch):
    """lambda * min(1, epoch/100) * sum(||z_i||_2) / num_samples
    (ref: train_deep_sdf.py:609-616) over the rows of ``batch_vecs``."""
    ramp = min(1.0, float(epoch) / 100.0)
    return code_reg_lambda * ramp * safe_l2norm(batch_vecs, dim=1).sum() / num_sdf_samples


def eikonal_loss(grad_xyz, weight=0.002):
    """weight * mean((1 - ||grad f||)^2) (ref: train_deep_sdf.py:724-728).
    ``grad_xyz`` [N, 3] is d(clamped pred)/d(xyz)."""
    return weight * ((1.0 - safe_l2norm(grad_xyz, dim=1)) ** 2).mean()


def deep_sdf_loss(pred_sdf, sdf_gt, latent_vecs, code_reg_lambda=1e-4, code_reg_weight=1.0):
    """Stage-2 SDF-consistency loss, (total, sdf, reg) with sdf =
    sum|pred - gt| / N and reg = lambda * w * sum||z|| / N over the N
    per-point latent rows (ref: networks/residual_mlp_vae.py:405-417). No
    clamping here: callers clamp first."""
    num = pred_sdf.shape[0]
    sdf_loss = (pred_sdf - sdf_gt).abs().sum() / num
    reg = code_reg_lambda * code_reg_weight * safe_l2norm(latent_vecs, dim=1).sum() / num
    return sdf_loss + reg, sdf_loss, reg
