"""Multi-dimensional ("group") disentanglement losses (counterpart of
``msd_tpu/losses/subset.py``; ref: deep_sdf/loss_subset.py:7-519): the
single-target-dim losses of ``losses/disentangle.py`` over lists of target
dims, and PCA-1 subset variants. Public loss API that no trainer calls, as
in ``msd_tpu`` and the reference.

As there, the supervised losses take an optional boolean ``valid`` mask,
and ``stop_gradient`` points are ``.detach()``. ``covariance_subset_loss``
takes its noise as a tensor, where ``msd_tpu`` draws it from a key.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from msd_tpu_torch.losses.disentangle import _mask_or_ones, _masked_mean, _masked_median, _masked_std


def _validate_target_dims(target_dims, total_dim):
    if target_dims is None or len(target_dims) == 0:
        raise ValueError("target_dims must be a non-empty list of indices.")
    if any(d < 0 or d >= total_dim for d in target_dims):
        raise ValueError(f"target_dims out of range for D={total_dim}: {target_dims}")
    if len(set(target_dims)) != len(target_dims):
        raise ValueError(f"target_dims has duplicates: {target_dims}")


def _in_dims(total_dim, target_dims, like):
    """1.0 on the target dims, 0.0 elsewhere."""
    return torch.as_tensor(np.isin(np.arange(total_dim), list(target_dims)), dtype=like.dtype, device=like.device)


def _other_dims(total_dim, target_dims):
    return list(np.nonzero(~np.isin(np.arange(total_dim), list(target_dims)))[0])


def _std1(x, eps):
    return torch.clamp(x.std(), min=eps)  # torch's std is unbiased (ddof 1), as msd_tpu's std(ddof=1)


def pca1_scores(x):
    """Per-sample scores along the first principal component, which is
    itself detached (ref: loss_subset.py:23-42)."""
    b, d = x.shape
    xc = x - x.mean(dim=0, keepdim=True)
    if d == 1:
        return xc[:, 0]
    cov = (xc.T @ xc) / float(max(b - 1, 1))
    _, eigvecs = torch.linalg.eigh(cov.detach())
    return xc @ eigvecs[:, -1]


def corr_leakage_penalty_group(x, y, target_dims: Sequence[int], eps: float = 1e-6, valid=None):
    """sum over non-target dims of corr(x_d, y)^2 (ref: :45-85)."""
    b, d = x.shape
    _validate_target_dims(target_dims, d)
    m = _mask_or_ones(b, valid, x.device)
    y = y.reshape(-1).to(x.dtype)
    y_std = (y - _masked_mean(y, m)) / torch.clamp(_masked_std(y, m), min=eps)
    x_std = (x - _masked_mean(x, m)[None, :]) / torch.clamp(_masked_std(x, m)[None, :], min=eps)
    corr = _masked_mean(x_std * y_std[:, None], m)
    return torch.sum((corr**2) * (1 - _in_dims(d, target_dims, x)))


def corr_leakage_penalty_pca_subsets(x, y, other_subsets, eps: float = 1e-6):
    """sum over subsets of corr(pca1(x_subset), y)^2 (ref: :88-119)."""
    y = y.reshape(-1).to(x.dtype)
    y = (y - y.mean()) / _std1(y, eps)
    total = 0.0
    for dims in other_subsets:
        if not dims:
            continue
        s = pca1_scores(x[:, list(dims)])
        s = (s - s.mean()) / _std1(s, eps)
        total = total + torch.mean(s * y) ** 2
    return total


def cross_cov_penalty_group(x, target_dims: Sequence[int], eps: float = 1e-6, valid=None):
    """sum_{i in T} sum_{j not in T} cov(x_i, x_j)^2, divided by B (not
    B - 1) as the reference (ref: :146)."""
    b, d = x.shape
    _validate_target_dims(target_dims, d)
    m = _mask_or_ones(b, valid, x.device)
    x0 = (x - _masked_mean(x, m)[None, :]) * m.to(x.dtype)[:, None]
    cov = (x0[:, list(target_dims)].T @ x0[:, _other_dims(d, target_dims)]) / (m.sum().to(x.dtype) + eps)
    return torch.sum(cov**2)


def cross_cov_penalty_pca_subsets(x, target_dims, other_subsets, eps: float = 1e-6):
    """sum over subsets of cov(pca1(x_T), pca1(x_subset))^2 (ref: :150-177)."""
    _validate_target_dims(target_dims, x.shape[1])
    s_t = pca1_scores(x[:, list(target_dims)])
    s_t = s_t - s_t.mean()
    total = 0.0
    for dims in other_subsets:
        if not dims:
            continue
        s_o = pca1_scores(x[:, list(dims)])
        total = total + torch.mean(s_t * (s_o - s_o.mean())) ** 2
    return total


def _group_snnl(x, same, offdiag, target_dims, T, lam1, lam2, use_adaptive_T, eps, clamp_ratio):
    """The grouped SNNL's shared tail: the target subset's mean squared
    distance kernel over positive pairs against all pairs (lam1) and the
    other dims' over positive pairs (lam2)."""
    b, d = x.shape
    t_mask = _in_dims(d, target_dims, x)
    diff2 = (x[:, None, :] - x[None, :, :]) ** 2
    d2_t = (diff2 * t_mask[None, None, :]).sum(dim=2) / len(target_dims)
    if use_adaptive_T:
        t_med = torch.clamp(_masked_median(d2_t.reshape(-1), same.reshape(-1)), min=1e-6).detach()
        T_eff = torch.where(same.any(), t_med, torch.full_like(t_med, T))
    else:
        T_eff = torch.tensor(T, dtype=x.dtype, device=x.device)
    same_f = same.to(x.dtype)
    Kt = torch.exp(-d2_t / T_eff)
    num = (Kt * same_f).sum(dim=1)
    den1 = (Kt * offdiag.to(x.dtype)).sum(dim=1)
    n_other = d - len(target_dims)
    if n_other > 0:
        sq_mean = (diff2 * (1.0 - t_mask)[None, None, :]).sum(dim=2) / n_other
        den2 = (torch.exp(-sq_mean / T_eff) * same_f).sum(dim=1)
    else:
        den2 = torch.zeros(b, dtype=x.dtype, device=x.device)
    frac = num / (lam1 * den1 + lam2 * den2 + eps)
    if clamp_ratio:
        frac = torch.clamp(frac, 1e-12, 1.0 - 1e-7)
    has_pos = same.any(dim=1)
    loss = -torch.sum(torch.log(frac) * has_pos.to(x.dtype)) / torch.clamp(has_pos.sum(), min=1)
    return torch.where(has_pos.any(), loss, torch.zeros_like(loss))


def _normalized(x, m, normalize_z):
    if not normalize_z:
        return x
    mean = _masked_mean(x, m).detach()
    std = torch.clamp(_masked_std(x, m), min=1e-6).detach()
    return (x - mean[None, :]) / std[None, :]


def snn_loss_cls_group(x, y, target_dims: Sequence[int], T: float = 2.0, lam1: float = 1.0, lam2: float = 2.0,
                       normalize_z: bool = True, use_adaptive_T: bool = True, eps: float = 1e-8,
                       clamp_ratio: bool = True, valid=None):
    """Grouped classification SNNL (ref: :180-267)."""
    b, d = x.shape
    _validate_target_dims(target_dims, d)
    m = _mask_or_ones(b, valid, x.device)
    y = y.reshape(-1)
    x = _normalized(x, m, normalize_z)
    offdiag = (m[:, None] & m[None, :]) & ~torch.eye(b, dtype=torch.bool, device=x.device)
    same = (y[:, None] == y[None, :]) & offdiag
    return _group_snnl(x, same, offdiag, target_dims, T, lam1, lam2, use_adaptive_T, eps, clamp_ratio)


def snn_reg_loss_exact_group(x, y, target_dims: Sequence[int], T: float = 2.0, lam1: float = 1.0,
                             lam2: float = 0.5, threshold: float = 0.05, normalize_z: bool = True,
                             use_adaptive_T: bool = True, pos_mode: str = "threshold", topk_frac: float = 0.1,
                             eps: float = 1e-8, clamp_ratio: bool = True, valid=None):
    """Grouped regression SNNL with threshold/top-k positive bands
    (ref: :270-371)."""
    b, d = x.shape
    _validate_target_dims(target_dims, d)
    m = _mask_or_ones(b, valid, x.device)
    y = y.reshape(-1).to(x.dtype)
    x = _normalized(x, m, normalize_z)
    offdiag = (m[:, None] & m[None, :]) & ~torch.eye(b, dtype=torch.bool, device=x.device)
    abs_dy = torch.abs(y[:, None] - y[None, :])
    if pos_mode == "topk":
        masked_dy = torch.where(offdiag, abs_dy, torch.full_like(abs_dy, float("inf")))
        k = max(1, int(round(topk_frac * (b - 1))))
        thr = torch.sort(masked_dy, dim=1).values[:, k - 1][:, None]
        same = (masked_dy <= thr) & offdiag
    else:
        same = (abs_dy <= threshold) & offdiag
    return _group_snnl(x, same, offdiag, target_dims, T, lam1, lam2, use_adaptive_T, eps, clamp_ratio)


def match_std_group(z, target_dims: Sequence[int], eps: float = 1e-6, valid=None):
    """Match the target subset's mean std to the other dims' (ref:
    :374-404). Returns (loss, std_target, std_ref), the last two detached."""
    b, d = z.shape
    _validate_target_dims(target_dims, d)
    stds = _masked_std(z, _mask_or_ones(b, valid, z.device), ddof=0)
    std_target = torch.clamp(stds[list(target_dims)].mean(), min=eps)
    other = _other_dims(d, target_dims)
    if not other:
        return torch.zeros((), dtype=z.dtype, device=z.device), std_target.detach(), std_target.detach()
    std_ref = torch.clamp(stds[other].mean(), min=eps)
    return (std_target - std_ref) ** 2, std_target.detach(), std_ref.detach()


def sensitivity_group_loss(z, decode_fn, target_dims: Sequence[int], eps: float = 0.02, eta: float = 0.0025):
    """Hinge-floor sensitivity of the decoder to a subset of dims
    (ref: :407-440). Returns (loss, delta)."""
    _validate_target_dims(target_dims, z.shape[1])
    shift = torch.zeros_like(z)
    shift[:, list(target_dims)] = eps
    delta = torch.mean(torch.linalg.vector_norm(decode_fn(z + shift) - decode_fn(z - shift), dim=1))
    return (torch.relu(eta - delta) / eta) ** 2, delta


def rank_loss_group(z, y, target_dims: Sequence[int], margin: float = 0.5, cn_label: int = 1, valid=None):
    """Pairwise hinge on the mean of the target dims (ref: :443-472)."""
    b, d = z.shape
    _validate_target_dims(target_dims, d)
    m = _mask_or_ones(b, valid, z.device)
    zt = z[:, list(target_dims)].mean(dim=1)
    y = y.reshape(-1)
    pair = (((y == cn_label) & m)[:, None] & ((y != cn_label) & m)[None, :]).to(z.dtype)
    n_pairs = pair.sum()
    loss = torch.sum(torch.relu(margin - (zt[:, None] - zt[None, :])) * pair) / torch.clamp(n_pairs, min=1)
    return torch.where(n_pairs > 0, loss, torch.zeros_like(loss))


def covariance_subset_loss(noise, mu, logvar, subsets: dict, lambda_off: float = 1.0, beta: float = 0.01):
    """Cross-subset covariance of z = mu + exp(logvar / 2) * ``noise``
    (ref: :475-519); ``noise`` [B, D] is the standard normal draw."""
    b, d = mu.shape
    z = mu + torch.exp(0.5 * logvar) * noise
    items = [list(v) for v in subsets.values() if v]
    for dims in items:
        if any(x < 0 or x >= d for x in dims):
            raise ValueError(f"subset dims out of range for D={d}: {dims}")
    total = 0.0
    for i in range(len(items)):
        zi = z[:, items[i]]
        zi = zi - zi.mean(dim=0, keepdim=True)
        for j in range(i + 1, len(items)):
            zj = z[:, items[j]]
            zj = zj - zj.mean(dim=0, keepdim=True)
            total = total + lambda_off * torch.sum(((zi.T @ zj) / max(b - 1, 1)) ** 2)
    return beta * total
