"""Stage-1 latent-space regularizers (counterpart of
``msd_tpu/losses/stage1.py``; ref: deep_sdf/loss.py:89-539).

The latent-batch losses (covariance, GMM prior) act on the batch's latent
rows. The isometry family takes per-point input gradients from one
``torch.autograd.grad`` of the summed decoder output with
``create_graph=True``, so the loss differentiates on into the decoder and
the latents. Its random draws are arguments: ``isometry_loss`` takes its
probe vectors and ``select_near_surface_points`` its uniform noise, so a
caller (the trainer, or a test feeding ``msd_tpu``'s draws) decides them.

The isometry functions take ``[..., N, *]`` inputs and reduce over the
point axis N, so the trainer evaluates every scene of a chunk in one
decoder call; with ``[N, *]`` inputs they return scalars, as ``msd_tpu``'s.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F


def covariance_loss(z: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Mean squared off-diagonal covariance of the rows of ``z`` [B, D],
    normalized by D(D-1) (ref: deep_sdf/loss.py:89-107)."""
    b, d = z.shape
    if b <= 1 or d <= 1:
        return z.new_zeros(())
    zc = z - z.mean(dim=0, keepdim=True)
    cov = (zc.t() @ zc) / (float(b - 1) + eps)
    offdiag = cov - torch.diag(torch.diag(cov))
    return (offdiag**2).sum() / (d * (d - 1))


def gmm_prior_init(generator: torch.Generator, K: int, latent_dim: int, init_sigma: float = 0.5) -> dict:
    """Learnable diagonal-GMM parameters {"mu" [K, D], "log_sigma" [K, D],
    "logits" [K]} on the CPU, ``mu`` drawn from ``generator``."""
    return {
        "mu": 0.01 * torch.randn(K, latent_dim, generator=generator),
        "log_sigma": torch.full((K, latent_dim), math.log(float(init_sigma))),
        "logits": torch.zeros(K),
    }


def gmm_prior_loss(gmm_params: dict, z: torch.Tensor, min_sigma: float = 0.05, learn_pi: bool = False,
                   eps: float = 1e-6):
    """(nll, aux) of ``z`` [B, D] under the diagonal GMM; aux carries the
    NLL and the responsibilities' entropy for logging, without gradient
    (ref: deep_sdf/loss.py:186-209). Without ``learn_pi`` the weights are
    uniform and ``logits`` does not enter the loss (its gradient stays
    None, which the optimizer takes as zero)."""
    K, D = gmm_params["mu"].shape
    sigma = min_sigma + F.softplus(gmm_params["log_sigma"])  # [K, D]
    var = (sigma * sigma)[None]  # [1, K, D]
    mahal = (((z[:, None, :] - gmm_params["mu"][None]) ** 2) / (var + eps)).sum(dim=2)  # [B, K]
    log_det = torch.log(var + eps).sum(dim=2)  # [1, K]
    log_n = -0.5 * (mahal + log_det + D * math.log(2.0 * math.pi))
    if learn_pi:
        log_pi = torch.log_softmax(gmm_params["logits"], dim=0)
    else:
        log_pi = torch.full((K,), -math.log(K), dtype=z.dtype, device=z.device)
    log_num = log_n + log_pi[None]
    logp = torch.logsumexp(log_num, dim=1)  # [B]
    nll = -logp.mean()
    with torch.no_grad():
        r = torch.exp(log_num - logp[:, None])
        entropy = -(r * torch.log(r + eps)).sum(dim=1).mean()
    return nll, {"gmm_nll": nll.detach(), "gmm_entropy": entropy}


def _input_grads(decoder_fn, latent_codes: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Per-point gradient of the scalar SDF with respect to the [z || xyz]
    input, [..., N, m + 3], differentiable on (``create_graph``). Rows are
    independent, so the gradient of the summed output is every row's."""
    inp = torch.cat([latent_codes, points], dim=-1)
    if not inp.requires_grad:
        inp.requires_grad_(True)
    out = decoder_fn(inp.reshape(-1, inp.shape[-1]))
    (g,) = torch.autograd.grad(out.sum(), inp, create_graph=True)
    return g


def isometry_loss(decoder_fn, latent_codes, iso_points, latent_size: int, probes: torch.Tensor,
                  eps: float = 1e-8):
    """Hutchinson-probe isometric regularization G2 / G1
    (ref: deep_sdf/loss.py:339-417). ``latent_codes`` [..., N, m],
    ``iso_points`` [..., N, 3], ``probes`` [..., num_probes, m] (each a
    direction in latent space, shared by the N points). Returns (loss,
    {"iso_g1", "iso_g2"}), each [...]; the aux without gradient."""
    m = latent_size
    n = iso_points.shape[-2]
    gz = _input_grads(decoder_fn, latent_codes, iso_points)[..., :m]  # [..., N, m]
    jvp = gz @ probes.transpose(-1, -2)  # [..., N, K]
    g1 = (jvp**2).mean(dim=-2).mean(dim=-1)
    dz_mean = (jvp.transpose(-1, -2) @ gz) / n  # [..., K, m]
    g2 = (dz_mean**2).sum(dim=-1).mean(dim=-1)
    return g2 / (g1 + eps), {"iso_g1": g1.detach(), "iso_g2": g2.detach()}


def grad_metric_isotropy_loss(decoder_fn, latent_codes, iso_points, latent_size: int, alpha: float = 1.0,
                              normalize: bool = True, eps: float = 1e-12):
    """||offdiag(H)||^2 (over m(m - 1) with ``normalize``) + alpha Var(diag H),
    H = Gz^T Gz / N, Gz = grad_z f(z, x) (ref: deep_sdf/loss.py:420-494).
    Inputs as ``isometry_loss``; returns (loss, {"gmi_offdiag",
    "gmi_diag_var", "gmi_diag_mean"}), each [...]."""
    m = latent_size
    n = iso_points.shape[-2]
    gz = _input_grads(decoder_fn, latent_codes, iso_points)[..., :m]
    H = (gz.transpose(-1, -2) @ gz) / (float(n) + eps)  # [..., m, m]
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    off = ((H - torch.diag_embed(diag)) ** 2).sum(dim=(-2, -1))
    diag_var = diag.var(dim=-1, unbiased=False)
    if normalize:
        off = off / (m * (m - 1) + eps)
    return off + alpha * diag_var, {"gmi_offdiag": off.detach(), "gmi_diag_var": diag_var.detach(),
                                    "gmi_diag_mean": diag.mean(dim=-1).detach()}


def select_near_surface_points(noise: torch.Tensor, xyz: torch.Tensor, sdf_gt: torch.Tensor, clamp_dist: float,
                               num_iso_points: int) -> torch.Tensor:
    """The reference's near-surface point selection (ref:
    deep_sdf/loss.py:497-539) as ``msd_tpu`` computes it: the top
    ``num_iso_points`` of near * 2 + noise, near = |sdf| < clamp_dist, so
    points inside the band come first, in random order, topped up with
    random far points. ``xyz`` [..., P, 3], ``sdf_gt`` [..., P] (or
    [..., P, 1]), ``noise`` [..., P] uniform in [0, 1). Returns
    [..., num_iso_points, 3]."""
    near = (sdf_gt.reshape(noise.shape).abs() < clamp_dist).to(noise.dtype)
    idx = torch.topk(near * 2.0 + noise, num_iso_points, dim=-1).indices
    return torch.gather(xyz, -2, idx[..., None].expand(*idx.shape, 3))
