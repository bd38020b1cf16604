"""2-D embeddings of latent codes in numpy, scipy and torch (counterpart of
the scikit-learn calls in ``msd_tpu/plotting.py:342-355`` and
``latent_manifold.py:23-47``, which the port may not import).

What scikit-learn 1.9 does there is written out here, so that the same
latents give the same embedding:

* ``pca``: ``PCA(n_components).fit_transform``: the data centred by its
  column means, ``scipy.linalg.svd`` of the centred data (in its own float
  type), and ``svd_flip``'s sign rule (``u_based_decision=False``: each
  component's entry of largest magnitude made positive); the scores are
  ``U * S``. scikit-learn takes this "full" solver for up to 500 samples
  and features; above that it may take its randomized solver, or the
  covariance matrix's eigenvectors for 10 times as many samples as
  features. Both give the same components to their own accuracy; here it
  is always the exact SVD.
* ``fast_ica``: ``FastICA(n_components, random_state, max_iter)``:
  ``whiten="unit-variance"`` by an SVD of the centred data (signs set by
  the first row of U), the logcosh contrast, the parallel (symmetric
  decorrelation) algorithm to ``tol`` 1e-4, ``w_init`` drawn from
  ``np.random.RandomState(seed).normal``, and the sources scaled to unit
  variance.
* ``hessian_lle``: ``LocallyLinearEmbedding(method="hessian",
  eigen_solver="auto")``: each point's ``n_neighbors`` nearest others, the
  local Hessian estimator from the top eigenvectors of their Gram matrix
  and a QR factorisation, summed into M; the null space of M by
  ``scipy.linalg.eigh`` up to 200 points, else by
  ``scipy.sparse.linalg.eigsh`` in shift-invert mode about 0 with ``v0``
  drawn from ``RandomState(seed).uniform(-1, 1, N)``.
* ``tsne``: ``TSNE(n_components=2, perplexity, random_state)`` with its
  defaults: P from the squared Euclidean distances by the per-point binary
  search for the perplexity (``_binary_search_perplexity``), symmetrised
  and normalised; the start is the PCA scores rescaled so that the first
  column's standard deviation is 1e-4; gradient descent with momentum 0.5
  and P exaggerated 12 times for 250 iterations, then momentum 0.8 to
  ``max_iter`` 1000, per-coordinate gains (+0.2, x0.8, at least 0.01),
  ``learning_rate="auto"`` (max(S / 12 / 4, 50)), the error checked every
  50 iterations, stopping after 300 without progress or at a gradient norm
  of 1e-7. One deliberate difference: the gradient is the exact one
  (``_kl_divergence``, sklearn/manifold/_t_sne.py:128, over every pair), where
  ``TSNE``'s default method is Barnes-Hut (``_kl_divergence_bh`` with angle
  0.5 over a quadtree, and P only over 3 x perplexity neighbours). It runs
  in torch, on the card when asked: a cohort of hundreds to a few thousand
  latents makes the S x S matrices small for the card.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
from scipy import linalg, sparse
from scipy.sparse.linalg import eigsh

MACHINE_EPSILON = np.finfo(np.double).eps
# _binary_search_perplexity's C float constants (sklearn/manifold/_utils.pyx)
_PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
_EPSILON_DBL = float(np.float32(1e-8))
_PERPLEXITY_STEPS = 100
# TSNE's defaults and schedule (sklearn/manifold/_t_sne.py: _EXPLORATION_MAX_ITER,
# _N_ITER_CHECK)
EARLY_EXAGGERATION = 12.0
MAX_ITER = 1000
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
EXPLORATION_ITERS = 250
ITER_CHECK = 50
# FastICA's tolerance; LocallyLinearEmbedding's (eigsh's tolerance and
# iteration cap, the Hessian estimator's column-sum floor)
ICA_TOL = 1e-4
LLE_TOL = 1e-6
LLE_MAX_ITER = 100
HESSIAN_TOL = 1e-4


def _as_float(x) -> np.ndarray:
    """A float32 array stays float32 (as scikit-learn keeps it); anything
    else becomes float64. Always a C-ordered copy."""
    x = np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)
    return np.array(x, dtype=x.dtype if x.dtype in (np.float32, np.float64) else np.float64, order="C")


def _svd_flip_v(u, vt):
    """``svd_flip(u, vt, u_based_decision=False)``: each row of vt has its
    entry of largest magnitude made positive, u's columns follow."""
    signs = np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    if u is not None:
        u *= signs[np.newaxis, :]
    vt *= signs[:, np.newaxis]
    return u, vt


def pca(x, n_components: int = 2) -> np.ndarray:
    """[S, L] -> [S, n_components] principal component scores
    (``PCA(n_components).fit_transform``)."""
    x = _as_float(x)
    centred = x - np.mean(x, axis=0)
    u, s, vt = linalg.svd(centred, full_matrices=False)
    u, vt = _svd_flip_v(u, vt)
    u = u[:, :n_components]
    u *= s[:n_components]
    return u


def _sym_decorrelation(w):
    """W <- (W W^T)^(-1/2) W (sklearn/decomposition/_fastica.py)."""
    s, u = linalg.eigh(np.dot(w, w.T))
    s = np.clip(s, a_min=np.finfo(w.dtype).tiny, a_max=None)
    return np.linalg.multi_dot([u * (1.0 / np.sqrt(s)), u.T, w])


def _logcosh(x):
    gx = np.tanh(x, x)  # in place, as scikit-learn (alpha 1)
    g_x = np.empty(x.shape[0], dtype=x.dtype)
    for i, gx_i in enumerate(gx):
        g_x[i] = (1.0 * (1 - gx_i**2)).mean()
    return gx, g_x


def fast_ica(x, n_components: int = 2, seed: int = 0, max_iter: int = 200) -> np.ndarray:
    """[S, L] -> [S, n_components] independent sources of unit variance
    (``FastICA(n_components, random_state=seed, max_iter).fit_transform``)."""
    xt = _as_float(x).T
    n_features, n_samples = xt.shape
    n_components = min(n_components, n_samples, n_features)
    x_mean = xt.mean(axis=-1)
    xt -= x_mean[:, np.newaxis]
    u, d = linalg.svd(xt, full_matrices=False, check_finite=False)[:2]
    u *= np.sign(u[0])
    k = (u / d).T[:n_components]
    x1 = np.dot(k, xt)
    x1 *= np.sqrt(n_samples)
    w_init = np.asarray(np.random.RandomState(seed).normal(size=(n_components, n_components)), dtype=x1.dtype)

    w = _sym_decorrelation(w_init)
    p_ = float(x1.shape[1])
    for _ in range(max_iter):
        gwtx, g_wtx = _logcosh(np.dot(w, x1))
        w1 = _sym_decorrelation(np.dot(gwtx, x1.T) / p_ - g_wtx[:, np.newaxis] * w)
        lim = max(abs(abs(np.einsum("ij,ij->i", w1, w)) - 1))
        w = w1
        if lim < ICA_TOL:
            break
    else:
        logging.warning("FastICA did not converge in %d iterations", max_iter)

    sources = np.linalg.multi_dot([w, k, xt]).T
    sources /= np.std(sources, axis=0, keepdims=True)
    return sources


def _kneighbors(x: np.ndarray, k: int) -> np.ndarray:
    """Indices of each row's ``k`` nearest rows, nearest first and the row
    itself among them (``NearestNeighbors(k).kneighbors(X)`` on its own fit
    data; squared distances as ||a||^2 - 2 a.b + ||b||^2, as its brute
    search)."""
    xx = np.einsum("ij,ij->i", x, x)
    d = xx[:, None] - 2.0 * (x @ x.T) + xx[None, :]
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def hessian_lle(x, n_neighbors: int, n_components: int = 2, seed: int = 0) -> np.ndarray:
    """[S, L] -> [S, n_components] Hessian eigenmaps
    (``LocallyLinearEmbedding(n_neighbors, n_components, method="hessian",
    random_state=seed).fit_transform``, ``eigen_solver="auto"``)."""
    x = _as_float(x).astype(np.float64, copy=False)
    n, d_in = x.shape
    if n_components > d_in:
        raise ValueError("output dimension must be less than or equal to input dimension")
    if n_neighbors >= n:
        raise ValueError(f"Expected n_neighbors < n_samples, but n_samples = {n}, n_neighbors = {n_neighbors}")
    dp = n_components * (n_components + 1) // 2
    if n_neighbors <= n_components + dp:
        raise ValueError("for method='hessian', n_neighbors must be greater than "
                         "[n_components * (n_components + 3) / 2]")
    neighbors = _kneighbors(x, n_neighbors + 1)[:, 1:]
    yi = np.empty((n_neighbors, 1 + n_components + dp), dtype=np.float64)
    yi[:, 0] = 1
    m = np.zeros((n, n), dtype=np.float64)
    use_svd = n_neighbors > d_in
    for i in range(n):
        gi = x[neighbors[i]]
        gi -= gi.mean(0)
        if use_svd:
            u = linalg.svd(gi, full_matrices=0)[0]
        else:
            u = linalg.eigh(np.dot(gi, gi.T))[1][:, ::-1]
        yi[:, 1 : 1 + n_components] = u[:, :n_components]
        j = 1 + n_components
        for c in range(n_components):
            yi[:, j : j + n_components - c] = u[:, c : c + 1] * u[:, c:n_components]
            j += n_components - c
        q, _ = linalg.qr(yi)
        w = q[:, n_components + 1 :]
        s = w.sum(0)
        s[np.where(abs(s) < HESSIAN_TOL)] = 1
        w /= s
        nbrs_x, nbrs_y = np.meshgrid(neighbors[i], neighbors[i])
        m[nbrs_x, nbrs_y] += np.dot(w, w.T)

    k, k_skip = n_components, 1
    if n > 200 and k + k_skip < 10:  # eigen_solver "auto": ARPACK
        v0 = np.random.RandomState(seed).uniform(-1, 1, n)
        try:
            _, vectors = eigsh(sparse.csr_array(m), k + k_skip, sigma=0.0, tol=LLE_TOL, maxiter=LLE_MAX_ITER, v0=v0)
        except RuntimeError as e:
            raise ValueError(
                f"Error in determining null-space with ARPACK. Error message: '{e}'. Note that eigen_solver='arpack' "
                "can fail when the weight matrix is singular or otherwise ill-behaved. In that case, "
                "eigen_solver='dense' is recommended. See online documentation for more information.") from e
        return vectors[:, k_skip:]
    values, vectors = linalg.eigh(m, subset_by_index=(k_skip, k + k_skip - 1), overwrite_a=True)
    return vectors[:, np.argsort(np.abs(values))]


# ---------------------------------------------------------------------------
# t-SNE, exact gradient


def _device(x, device):
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _squared_distances(x, device=None) -> torch.Tensor:
    """[S, S] float32 squared Euclidean distances as TSNE hands them to the
    perplexity search: ``euclidean_distances(X, squared=True)`` in float64
    (||a||^2 - 2 a.b + ||b||^2, clipped at 0, zero diagonal), then float32."""
    dev = _device(x, device)
    x = torch.as_tensor(_as_float(x), device=dev).double()
    xx = (x * x).sum(1)
    d = -2.0 * (x @ x.T)
    d += xx[:, None]
    d += xx[None, :]
    d.clamp_(min=0.0).fill_diagonal_(0.0)
    return d.float()


def _conditional_probabilities(sqd: torch.Tensor, perplexity: float) -> torch.Tensor:
    """[S, S] float64 p_(j|i) (``_binary_search_perplexity`` on every pair):
    for each row, the Gaussian precision beta found by bisection (doubling
    or halving until bracketed) until the entropy is within 1e-5 of
    log(perplexity), at most 100 steps. Every row's search runs at once; a
    row keeps the probabilities of its last step."""
    n = sqd.shape[0]
    d = sqd.double()
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)
    desired = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    p = torch.zeros_like(d)
    rows = torch.arange(n, device=d.device)
    for _ in range(_PERPLEXITY_STEPS):
        b, dr = beta[rows], d[rows]
        pr = torch.where(off[rows], torch.exp(-dr * b[:, None]), 0.0)
        s = pr.sum(1)
        s = torch.where(s == 0.0, _EPSILON_DBL, s)
        pr /= s[:, None]
        diff = torch.log(s) + b * (dr * pr).sum(1) - desired
        p[rows] = pr
        done = diff.abs() <= _PERPLEXITY_TOLERANCE
        up = diff > 0.0
        lo_r, hi_r = torch.where(up, b, lo[rows]), torch.where(up, hi[rows], b)
        grown = torch.where(torch.isinf(hi_r), b * 2.0, (b + hi_r) / 2.0)
        shrunk = torch.where(torch.isinf(lo_r), b / 2.0, (b + lo_r) / 2.0)
        beta[rows], lo[rows], hi[rows] = torch.where(up, grown, shrunk), lo_r, hi_r
        rows = rows[~done]
        if rows.numel() == 0:
            break
    return p


def joint_probabilities(x, perplexity: float, device=None) -> torch.Tensor:
    """[S, S] float64 symmetric P with a zero diagonal (``_joint_probabilities``:
    (p_(j|i) + p_(i|j)) / their sum, at least machine epsilon off the
    diagonal)."""
    cond = _conditional_probabilities(_squared_distances(x, device), perplexity)
    p = cond + cond.T
    p /= max(float(p.sum()), MACHINE_EPSILON)
    return p.clamp_(min=MACHINE_EPSILON).fill_diagonal_(0.0)


def kl_divergence(p: torch.Tensor, y: torch.Tensor, compute_error: bool = True):
    """(KL(P || Q), gradient [S, 2] float32) at the float32 [S, 2] embedding ``y``,
    with Student-t Q of one degree of freedom (``_kl_divergence``; the KL is
    NaN when not asked for). As scikit-learn: the distances in float64, the
    gradient's y_i - y_j in float32, its sum in float64, stored in float32
    and scaled by 4."""
    yd = y.double()
    num = 1.0 / (((yd[:, None, :] - yd[None, :, :]) ** 2).sum(-1) + 1.0)
    num.fill_diagonal_(0.0)
    q = (num / num.sum()).clamp_(min=MACHINE_EPSILON).fill_diagonal_(0.0)
    kl = float("nan")
    if compute_error:
        kl = float((p * torch.log(p.clamp(min=MACHINE_EPSILON) / q.clamp(min=MACHINE_EPSILON))).sum())
    pqd = (p - q) * num
    grad = torch.einsum("ij,ijk->ik", pqd, (y[:, None, :] - y[None, :, :]).double()).float()
    return kl, grad * 4.0


def _gradient_descent(p, y, it, max_iter, momentum, learning_rate, n_iter_without_progress):
    """``_gradient_descent``: momentum and per-coordinate gains, the error
    and the gradient norm checked every ``ITER_CHECK`` iterations. Returns
    (y, error, last iteration)."""
    y = y.clone()
    update = torch.zeros_like(y, dtype=torch.float64)
    gains = torch.ones_like(y)
    error = best_error = np.finfo(float).max
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % ITER_CHECK == 0
        error, grad = kl_divergence(p, y, compute_error=check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=0.01)
        grad *= gains
        update = momentum * update - learning_rate * grad.double()
        y = (y.double() + update).float()
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if float(torch.linalg.vector_norm(grad)) <= MIN_GRAD_NORM:
                break
    return y, error, i


def tsne(x, perplexity: float = 30.0, device=None, init=None, return_info: bool = False):
    """[S, L] -> [S, 2] float32 t-SNE embedding (``TSNE(n_components=2,
    perplexity=perplexity).fit_transform`` with the exact gradient; see the
    module's docstring; Student-t of one degree of freedom, as
    scikit-learn's for 2 components). Runs on ``device``, by default the
    device of ``x`` when it is a tensor, else the CPU. ``init`` replaces the
    PCA start with a given [S, 2] array. The PCA start draws no random
    numbers, so TSNE's ``random_state`` has no counterpart here. With
    ``return_info``, also {"kl_divergence", "n_iter"}, TSNE's
    ``kl_divergence_`` and ``n_iter_``."""
    dev = _device(x, device)
    xf = _as_float(x)
    n = xf.shape[0]
    if perplexity >= n:
        raise ValueError("perplexity must be less than n_samples")
    learning_rate = max(n / EARLY_EXAGGERATION / 4, 50.0)
    if init is None:
        y0 = pca(xf, 2).astype(np.float32, copy=False)
        y0 = y0 / np.std(y0[:, 0]) * 1e-4
    else:
        y0 = np.asarray(init, np.float32)
    p = joint_probabilities(xf, perplexity, dev)
    y = torch.as_tensor(y0, device=dev)
    # 250 iterations with momentum 0.5 and P exaggerated, then momentum 0.8
    p_exaggerated = p * EARLY_EXAGGERATION
    y, error, it = _gradient_descent(p_exaggerated, y, 0, EXPLORATION_ITERS, 0.5, learning_rate, EXPLORATION_ITERS)
    y, error, it = _gradient_descent(p_exaggerated / EARLY_EXAGGERATION, y, it + 1, MAX_ITER, 0.8, learning_rate,
                                     N_ITER_WITHOUT_PROGRESS)
    emb = y.cpu().numpy()
    if return_info:
        return emb, {"kl_divergence": error, "n_iter": it}
    return emb

