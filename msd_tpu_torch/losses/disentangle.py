"""Stage-2 disentanglement losses that ``Stage2Trainer`` reaches
(counterpart of part of ``msd_tpu/losses/disentangle.py``; ref:
deep_sdf/loss.py:11-87, :212-314, :543-829, :833-857).

As in ``msd_tpu``, every supervised loss takes an optional boolean
``valid`` mask instead of the reference's filtered (dynamic-shape) batch,
and computes masked statistics over the whole batch; with ``valid=None``
it equals the reference's filtered call. The ``stop_gradient`` points of
``msd_tpu`` are ``.detach()`` here, in the same places. Not ported yet
(ROADMAP M8): ``snn_loss``, ``cls_correlation_loss``,
``reg_correlation_loss``, ``wasserstein_loss``, ``snnl_cross_entropy``.
"""

from __future__ import annotations

import torch

STABILITY_EPS = 1e-5  # reference's 0.00001


def _mask_or_ones(rows, valid, device):
    if valid is None:
        return torch.ones(rows, dtype=torch.bool, device=device)
    return valid.reshape(-1).to(torch.bool)


def _expand(m, x):
    m = m.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    return m


def _masked_mean(x, m):
    m_ = _expand(m, x)
    return (x * m_).sum(dim=0) / torch.clamp(m_.sum(dim=0), min=1.0)


def _masked_std(x, m, ddof=1):
    m_ = _expand(m, x)
    count = m_.sum(dim=0)
    mean = (x * m_).sum(dim=0) / torch.clamp(count, min=1.0)
    var = (((x - mean[None]) ** 2) * m_).sum(dim=0) / torch.clamp(count - ddof, min=1.0)
    return torch.sqrt(var)


def _masked_median(x, m):
    """Median of x over mask m, the lower middle value for an even count
    (torch.Tensor.median's rule), taken as ``msd_tpu`` takes it: masked
    entries pushed to max|x| + 1, one sort, index (count - 1) // 2."""
    big = torch.max(torch.abs(x)) + 1.0
    sorted_x = torch.sort(torch.where(m, x, big)).values
    k = torch.clamp(m.sum() - 1, min=0) // 2
    return sorted_x[k]


def _without(d, target_dim, like):
    mask = torch.ones(d, dtype=like.dtype, device=like.device)
    mask[target_dim] = 0.0
    return mask


# ---------------------------------------------------------------------------
# correlation penalties (ref: deep_sdf/loss.py:11-87)


def corr_leakage_penalty(x, y, target_dim: int, eps: float = 1e-6, valid=None):
    """sum_{d != target} corr(x_d, y)^2 (ref: loss.py:11-52)."""
    b, d = x.shape
    m = _mask_or_ones(b, valid, x.device)
    y = y.reshape(-1).to(x.dtype)
    y_std = (y - _masked_mean(y, m)) / torch.clamp(_masked_std(y, m), min=eps)
    x_std = (x - _masked_mean(x, m)[None, :]) / torch.clamp(_masked_std(x, m)[None, :], min=eps)
    corr = _masked_mean(x_std * y_std[:, None], m)
    return torch.sum((corr**2) * _without(d, target_dim, x))


def cross_cov_penalty(x, target_dim: int, eps: float = 1e-6, valid=None):
    """sum_j cov(x_target, x_j)^2 over j != target (ref: loss.py:55-87)."""
    b, d = x.shape
    m = _mask_or_ones(b, valid, x.device)
    x0 = x - _masked_mean(x, m)[None, :]
    cov = _masked_mean(x0 * x0[:, target_dim][:, None], m)
    return torch.sum((cov**2) * _without(d, target_dim, x))


# ---------------------------------------------------------------------------
# sensitivity / rank / match-std (ref: deep_sdf/loss.py:212-314)


def sensitivity_loss(z, decode_fn, eps: float = 0.02, eta: float = 0.0025, target_dim: int = 0):
    """Hinge-floor sensitivity of the decoder to a target dim
    (ref: loss.py:212-246). decode_fn: [B, D] -> [B, out].
    Returns (loss, delta)."""
    shift = torch.zeros_like(z)
    shift[:, target_dim] = eps
    delta = torch.mean(torch.linalg.vector_norm(decode_fn(z + shift) - decode_fn(z - shift), dim=1))
    loss = (torch.relu(eta - delta) / eta) ** 2
    return loss, delta


def rank_loss_z0(z, y, margin: float = 0.5, target_dim: int = 0, cn_label: int = 1, valid=None):
    """Pairwise hinge: z[target] larger for CN than AD (ref: loss.py:249-281)."""
    m = _mask_or_ones(z.shape[0], valid, z.device)
    z0 = z[:, target_dim]
    y = y.reshape(-1)
    is_cn = (y == cn_label) & m
    is_ad = (y != cn_label) & m
    pair = (is_cn[:, None] & is_ad[None, :]).to(z.dtype)
    n_pairs = pair.sum()
    loss = torch.sum(torch.relu(margin - (z0[:, None] - z0[None, :])) * pair) / torch.clamp(n_pairs, min=1)
    return torch.where(n_pairs > 0, loss, torch.zeros_like(loss))


def match_std_z0(z, target_dim: int = 0, eps: float = 1e-6, valid=None):
    """Match target-dim std to the mean std of other dims
    (ref: loss.py:284-314). Returns (loss, std0, std_ref), the last two
    detached."""
    b, d = z.shape
    stds = _masked_std(z, _mask_or_ones(b, valid, z.device), ddof=0)
    std0 = torch.clamp(stds[target_dim], min=eps)
    std_ref = torch.clamp(torch.sum(stds * _without(d, target_dim, z)) / max(d - 1, 1), min=eps)
    return (std0 - std_ref) ** 2, std0.detach(), std_ref.detach()


# ---------------------------------------------------------------------------
# SNNL family (ref: deep_sdf/loss.py:586-829)


def _snnl_ratio(x, same, offdiag, T, target_dim, lam1, lam2, use_adaptive_T, eps, clamp_ratio):
    """Shared tail of the classification and regression SNNL: the target
    dim's kernel over positive pairs against all pairs (lam1) and the
    other dims' kernel over positive pairs (lam2)."""
    b, d = x.shape
    zt = x[:, target_dim]
    d2 = (zt[:, None] - zt[None, :]) ** 2
    if use_adaptive_T:
        t_med = torch.clamp(_masked_median(d2.reshape(-1), same.reshape(-1)), min=1e-6).detach()
        T_eff = torch.where(same.any(), t_med, torch.full_like(t_med, T))
    else:
        T_eff = torch.tensor(T, dtype=x.dtype, device=x.device)
    same_f, offdiag_f = same.to(x.dtype), offdiag.to(x.dtype)
    K = torch.exp(-d2 / T_eff)
    num = (K * same_f).sum(dim=1)
    den1 = (K * offdiag_f).sum(dim=1)
    if d > 1:
        diff = x[:, None, :] - x[None, :, :]
        sq_mean = ((diff**2) * _without(d, target_dim, x)[None, None, :]).sum(dim=2) / max(d - 1, 1)
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


def snn_loss_cls(x, y, T: float = 2.0, lam1: float = 1.0, lam2: float = 2.0, target_dim: int = 0,
                 normalize_z: bool = True, use_adaptive_T: bool = True, eps: float = 1e-8,
                 clamp_ratio: bool = True, valid=None):
    """Classification SNNL on a target latent dim (ref: loss.py:586-671)."""
    b = x.shape[0]
    m = _mask_or_ones(b, valid, x.device)
    y = y.reshape(-1)
    x = _normalized(x, m, normalize_z)
    offdiag = (m[:, None] & m[None, :]) & ~torch.eye(b, dtype=torch.bool, device=x.device)
    same = (y[:, None] == y[None, :]) & offdiag
    return _snnl_ratio(x, same, offdiag, T, target_dim, lam1, lam2, use_adaptive_T, eps, clamp_ratio)


def snn_reg_loss_exact(x, y, T: float = 2.0, lam1: float = 1.0, lam2: float = 0.5, threshold: float = 0.05,
                       target_dim: int = 1, normalize_z: bool = True, use_adaptive_T: bool = True,
                       pos_mode: str = "threshold", topk_frac: float = 0.1, eps: float = 1e-8,
                       clamp_ratio: bool = True, valid=None):
    """Regression (age) SNNL with threshold/topk positive bands
    (ref: loss.py:725-829). The top-k band takes every pair whose label gap
    is at most the k-th smallest gap of its row, ties included."""
    b = x.shape[0]
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
    return _snnl_ratio(x, same, offdiag, T, target_dim, lam1, lam2, use_adaptive_T, eps, clamp_ratio)


def snn_reg_loss(x, y, T: float, threshold: float, valid=None):
    """Legacy regression SNNL on dim 1 (ref: deep_sdf/loss.py:675-722)."""
    b, d = x.shape
    m = _mask_or_ones(b, valid, x.device)
    y = y.reshape(-1).to(x.dtype)
    pair_valid = m[:, None] & m[None, :]
    no_diag = (1.0 - torch.eye(b, dtype=x.dtype, device=x.device)) * pair_valid.to(x.dtype)
    same = ((torch.abs(y[:, None] - y[None, :]) <= threshold) & pair_valid).to(x.dtype)

    def exp_d(col):
        return torch.exp(-((col[:, None] - col[None, :]) ** 2) / T) * no_diag

    e1 = exp_d(x[:, 1])
    rest = exp_d(x[:, 0]) * same
    for i in range(2, d):
        rest = rest + exp_d(x[:, i]) * same
    frac = (e1 * same).sum(dim=1) / (
        STABILITY_EPS + 0.5 * e1.sum(dim=1) + 0.5 * (rest / float(max(d - 1, 1))).sum(dim=1)
    )
    return _masked_mean(-torch.log(STABILITY_EPS + frac), m)


# ---------------------------------------------------------------------------
# attribute loss (ref: deep_sdf/loss.py:833-857)


def attribute_loss(latent_code, attribute, factor: float = 1.0, valid=None):
    """tanh latent-distance vs sign of attribute-distance, L1
    (ref: loss.py:833-857). latent_code: [B] (one dim)."""
    lc = latent_code.reshape(-1)
    m = _mask_or_ones(lc.shape[0], valid, lc.device)
    attr = attribute.reshape(-1).to(lc.dtype)
    pair = (m[:, None] & m[None, :]).to(lc.dtype)
    diff = torch.abs(torch.tanh((lc[:, None] - lc[None, :]) * factor) - torch.sign(attr[:, None] - attr[None, :]))
    return torch.sum(diff * pair) / torch.clamp(pair.sum(), min=1.0)
