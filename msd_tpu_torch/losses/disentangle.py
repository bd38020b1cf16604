"""Stage-2 disentanglement losses (counterpart of
``msd_tpu/losses/disentangle.py``; ref: deep_sdf/loss.py:11-87, :212-314,
:543-1076).

As in ``msd_tpu``, every supervised loss takes an optional boolean
``valid`` mask instead of the reference's filtered (dynamic-shape) batch,
and computes masked statistics over the whole batch; with ``valid=None``
it equals the reference's filtered call. The ``stop_gradient`` points of
``msd_tpu`` are ``.detach()`` here, in the same places. ``Stage2Trainer``
reaches the SNNL family, the attribute, leakage, cross-covariance, rank,
match-std and sensitivity losses; ``snn_loss``, the correlation losses,
``wasserstein_loss`` and ``snnl_cross_entropy`` are public API no trainer
calls, as in ``msd_tpu``.
"""

from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# losses no trainer reaches (ref: deep_sdf/loss.py:543-583, :862-974, :976-1076)


def snn_loss(x, y, T: float, valid=None):
    """Legacy SNNL: dim-0 similarity over same-class pairs, the other dims
    in the denominator (ref: deep_sdf/loss.py:543-583)."""
    b, d = x.shape
    m = _mask_or_ones(b, valid, x.device)
    y = y.reshape(-1)
    pair_valid = m[:, None] & m[None, :]
    no_diag = (1.0 - torch.eye(b, dtype=x.dtype, device=x.device)) * pair_valid.to(x.dtype)
    same = ((y[:, None] == y[None, :]) & pair_valid).to(x.dtype)

    def exp_d(col):
        return torch.exp(-((col[:, None] - col[None, :]) ** 2) / T) * no_diag

    e0 = exp_d(x[:, 0])
    rest = torch.zeros_like(e0)
    for i in range(1, d):
        rest = rest + exp_d(x[:, i]) * same
    frac = (e0 * same).sum(dim=1) / (
        STABILITY_EPS + 0.5 * e0.sum(dim=1) + 0.5 * (rest / float(max(d - 1, 1))).sum(dim=1)
    )
    return _masked_mean(-torch.log(STABILITY_EPS + frac), m)


def cls_correlation_loss(z_batch, y_batch, valid=None):
    """Point-biserial correlation loss (ref: loss.py:889-923): 1 - |r| of
    dim 0 plus the other dims' |r| summed over the valid batch size, the
    reference's batch-length buffer (:912-918), as ``msd_tpu``."""
    b, d = z_batch.shape
    m = _mask_or_ones(b, valid, z_batch.device)
    y = y_batch.reshape(-1)
    m1 = m & (y == 1.0)
    m0 = m & (y == 0.0)
    n1, n0 = m1.sum(), m0.sum()
    n = n1 + n0
    mlt = torch.sqrt((n1 * n0) / torch.clamp(n**2, min=1))
    stds = torch.clamp(_masked_std(z_batch, m), min=1e-12)
    r = (_masked_mean(z_batch, m1) - _masked_mean(z_batch, m0)) / stds * mlt
    return 1.0 - torch.abs(r[0]) + torch.abs(r[1:]).sum() / torch.clamp(m.sum(), min=1)


def reg_correlation_loss(z_batch, y_batch, valid=None):
    """Pearson correlation loss on target dim 1 (ref: loss.py:927-974),
    with the same batch-length divisor (:953-969)."""
    b, d = z_batch.shape
    m = _mask_or_ones(b, valid, z_batch.device)
    y = y_batch.reshape(-1).to(z_batch.dtype)
    mf = m.to(z_batch.dtype)

    def corr(col):
        dz = (col - _masked_mean(col, m)) * mf
        dy = (y - _masked_mean(y, m)) * mf
        return (dz * dy).sum() / torch.clamp(torch.sqrt((dz**2).sum() * (dy**2).sum()), min=1e-12)

    others = torch.stack([corr(z_batch[:, i]) for i in range(d) if i != 1])
    return 1.0 - torch.abs(corr(z_batch[:, 1])) + torch.abs(others).sum() / torch.clamp(m.sum(), min=1)


def wasserstein_loss(x, delta: float = 1.0, rng=None):
    """Sliced-permutation Wasserstein with Hungarian matching (ref:
    loss.py:862-886): each column of x permuted on its own by ``rng`` (a
    numpy Generator or seed, where ``msd_tpu`` derives the seed from a JAX
    key), the rows matched to x by scipy's ``linear_sum_assignment`` on
    Euclidean distances, then the Huber loss of x against the match. The
    matching runs on the host; the gradient flows through x."""
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial.distance import cdist

    rng = np.random.default_rng(rng)
    x_np = x.detach().cpu().numpy()
    bsize, dim = x_np.shape
    u = np.stack([x_np[rng.permutation(bsize), i] for i in range(dim)], axis=1)
    ind = linear_sum_assignment(cdist(x_np, u))[1]
    diff = x - torch.as_tensor(u[ind], device=x.device, dtype=x.dtype)
    abs_d = torch.abs(diff)
    return torch.where(abs_d <= delta, 0.5 * diff**2, delta * (abs_d - 0.5 * delta)).mean()


def pairwise_euclid_distance(A, B):
    """[i, j] = |A_j|^2 + |B_i|^2 - 2 B_i . A_j (msd_tpu/losses/disentangle.py:384)."""
    return (A**2).sum(dim=1)[None, :] + (B**2).sum(dim=1)[:, None] - 2 * B @ A.T


def pairwise_cos_distance(A, B):
    """1 - cosine similarity of the rows of A and B (msd_tpu/losses/disentangle.py:391)."""
    a = A / torch.clamp(torch.linalg.vector_norm(A, dim=1, keepdim=True), min=1e-12)
    b = B / torch.clamp(torch.linalg.vector_norm(B, dim=1, keepdim=True), min=1e-12)
    return 1 - a @ b.T


def snnl_cross_entropy(x, y, temp: float = 100.0, cos_distance: bool = True):
    """Soft nearest-neighbour cross entropy (ref: deep_sdf/loss.py:1065-1076)."""
    dm = pairwise_cos_distance(x, x) if cos_distance else pairwise_euclid_distance(x, x)
    f = torch.exp(-(dm / temp)) - torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    pick = f / (STABILITY_EPS + f.sum(dim=1, keepdim=True))
    same = (y.reshape(-1)[None, :] == y.reshape(-1)[:, None]).to(x.dtype)
    return -torch.mean(torch.log(STABILITY_EPS + (pick * same).sum(dim=1)))
