"""VAE objectives: beta-VAE, DIP-VAE-I/II, beta-TCVAE, and the Stage-2
DIP-VAE-II covariance penalty (counterpart of ``msd_tpu/losses/vae.py``;
ref: networks/residual_mlp_vae.py:278-423, deep_sdf/loss.py:1081-1124).
"""

from __future__ import annotations

import math

import torch


def kl_divergence(mu, logvar):
    """-0.5 * mean(1 + logvar - mu^2 - e^logvar) (ref: residual_mlp_vae.py:278-279)."""
    return -0.5 * torch.mean(1 + logvar - mu**2 - torch.exp(logvar))


def log_density_gaussian(z, mu, logvar):
    log2pi = math.log(2.0 * math.pi)
    return -0.5 * (log2pi + logvar + (z - mu) ** 2 / torch.exp(logvar))


def _recon(z_hat, z_target, recon_loss):
    if recon_loss == "l1":
        return torch.mean(torch.abs(z_hat - z_target))
    if recon_loss == "mse":
        return torch.mean((z_hat - z_target) ** 2)
    raise ValueError(f"Unsupported recon_loss: {recon_loss}")


def vae_loss(z_hat, z_target, mu, logvar, recon_weight=1.0, kl_weight=1.0, recon_loss="mse"):
    """(total, recon, kl) (ref: residual_mlp_vae.py:287-304)."""
    recon = _recon(z_hat, z_target, recon_loss)
    kl = kl_divergence(mu, logvar)
    return recon_weight * recon + kl_weight * kl, recon, kl


def _covariance_matrix(x):
    n = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    return (xc.t() @ xc) / max(float(n - 1), 1.0)


def dip_vae_loss(z_hat, z_target, mu, logvar, recon_weight=1.0, kl_weight=1.0, dip_lambda_od=1.0,
                 dip_lambda_d=1.0, dip_type="ii", recon_loss="mse"):
    """(total, recon, kl, dip, off, diag) (ref: residual_mlp_vae.py:317-353)."""
    recon = _recon(z_hat, z_target, recon_loss)
    kl = kl_divergence(mu, logvar)
    cov_z = _covariance_matrix(mu)
    if str(dip_type).lower() in ("ii", "2", "dip_vae_ii", "dip_vae2", "dip_ii", "dip2"):
        cov_z = cov_z + torch.diag(torch.exp(logvar).mean(dim=0))
    diag = torch.diagonal(cov_z)
    off_loss = torch.sum((cov_z - torch.diag(diag)) ** 2)
    diag_loss = torch.sum((diag - 1.0) ** 2)
    dip = dip_lambda_od * off_loss + dip_lambda_d * diag_loss
    total = recon_weight * recon + kl_weight * kl + dip
    return total, recon, kl, dip, off_loss, diag_loss


def beta_tcvae_loss(z_hat, z_target, z, mu, logvar, recon_weight=1.0, kl_weight=1.0, tc_alpha=1.0, tc_beta=6.0,
                    tc_gamma=1.0, recon_loss="mse", dataset_size=None):
    """beta-TCVAE MI/TC/DWKL decomposition with minibatch logsumexp
    (ref: residual_mlp_vae.py:356-402). Returns
    (total, recon, total_kl, mi, tc, dwkl)."""
    recon = _recon(z_hat, z_target, recon_loss)
    dataset_size = max(int(z.shape[0] if dataset_size is None else dataset_size), 1)
    log_n = math.log(dataset_size)
    log_qz_condx = log_density_gaussian(z, mu, logvar).sum(dim=1)
    log_qz_x = log_density_gaussian(z[:, None, :], mu[None, :, :], logvar[None, :, :])
    log_qz = torch.logsumexp(log_qz_x.sum(dim=2), dim=1) - log_n
    log_prod_qz = (torch.logsumexp(log_qz_x, dim=1) - log_n).sum(dim=1)
    log_pz = log_density_gaussian(z, torch.zeros_like(z), torch.zeros_like(z)).sum(dim=1)
    mi = torch.mean(log_qz_condx - log_qz)
    tc = torch.mean(log_qz - log_prod_qz)
    dwkl = torch.mean(log_prod_qz - log_pz)
    total_kl = mi + tc + dwkl
    total = recon_weight * recon + kl_weight * (tc_alpha * mi + tc_beta * tc + tc_gamma * dwkl)
    return total, recon, total_kl, mi, tc, dwkl


def dip_vae_ii_loss(noise, mu, logvar, lambda_off=1.0, lambda_diag=1.0, beta=0.01):
    """Stage-2 auxiliary DIP-VAE-II penalty on z = mu + std * ``noise``
    (ref: deep_sdf/loss.py:1081-1124); ``noise`` [B, D] standard normal,
    drawn by the caller (``msd_tpu`` draws it from its own key)."""
    b, d = mu.shape
    z = mu + torch.exp(0.5 * logvar) * noise
    zc = z - z.mean(dim=0, keepdim=True)
    c_z = (zc.t() @ zc) / max(b - 1, 1)
    eye = torch.eye(d, dtype=mu.dtype, device=mu.device)
    loss_off = lambda_off * torch.sum((c_z * (1 - eye)) ** 2)
    loss_diag = lambda_diag * torch.sum((torch.diagonal(c_z) - 1) ** 2)
    return beta * (loss_off + loss_diag)


def linear_warmup(step, warmup_steps):
    """ref: residual_mlp_vae.py:420-423."""
    if warmup_steps <= 0:
        return 1.0
    return min(1.0, float(step) / float(warmup_steps))
