"""SAP disentanglement metrics in numpy and scipy (counterpart of
``msd_tpu/metrics/sap.py``, which calls scikit-learn).

Kumar et al.'s SAP (ICLR 2018) and the Locatello-protocol variant: per
(factor, latent) score matrices from 1-D predictors, the score being the
mean gap between the two best latents per factor (ref: sdf_utils/sap.py).

* regression: per-cell least-squares R^2, clipped at 0 (ref: :84-132);
* classification: per-cell decision trees on one feature with depth 1-9
  chosen by 5-fold cross-validation (ref: :135-234), with an optional
  80/20 holdout (ref: :285-393);
* Locatello: per-cell linear-SVM test error (ref: :423-525).

What scikit-learn does there is written out here, so that the same inputs
give the same scores (held against ``msd_tpu`` to 1e-12 in
tests/test_torch_sap.py):

* ``DecisionTreeClassifier(max_depth=d)`` on one feature: the feature cast
  to float32; at each node the Gini proxy ``-n_R g_R - n_L g_L`` over the
  split positions between sorted values more than 1e-7 apart (float32),
  the first best position winning ties; threshold the float64 mean of the
  two float32 neighbours; a node is a leaf at depth d, below 2 samples or
  at Gini <= machine epsilon; a leaf predicts its most frequent class, the
  lowest on ties.
* ``cross_val_score(cv=5)``: ``StratifiedKFold(5)`` without shuffling
  (classes in order of first appearance, the sorted labels dealt round
  robin to the folds), accuracy per fold, their mean; a split that cannot
  be made raises ValueError, which scores 0 (ref: sap.py:89-92).
* ``train_test_split(..., random_state=0, stratify=y)``:
  ``StratifiedShuffleSplit`` on ``np.random.RandomState(0)``, replayed
  draw for draw; without stratification ``ShuffleSplit``.
* ``StandardScaler`` then ``LinearSVC(C)``: squared hinge loss with an L2
  penalty that covers the intercept too (intercept_scaling 1), one-vs-rest
  for more than two classes. On one feature each problem is a strictly
  convex function of two parameters, solved by scipy to the last digits
  and finished by an exact Newton step on its active set (liblinear stops
  at tolerance 1e-4, so a test point on the boundary could in principle
  fall on the other side).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import optimize

# sklearn's FEATURE_THRESHOLD (float32) and EPSILON (float64 epsilon)
_FEATURE_THRESHOLD = np.float32(1e-7)
_EPSILON = np.finfo(np.float64).eps


def get_bin_index(x, nb_bins):
    """Discretize a [0,1]-scaled variable into nb_bins (ref: sap.py:26-36)."""
    bins = np.linspace(0, 1, nb_bins + 1)
    return np.digitize(x, bins[:-1], right=False).astype(int)


def _value_counts(values):
    """{value: count} summary of a prediction vector (ref: sap.py:39-43)."""
    if values is None:
        return {}
    vals, counts = np.unique(values, return_counts=True)
    return {float(v): int(n) for v, n in zip(vals, counts)}


def _minmax_scale(x):
    x = np.asarray(x, np.float64)
    lo = np.nanmin(x, axis=0, keepdims=True)
    hi = np.nanmax(x, axis=0, keepdims=True)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    return (x - lo) / span


def _as_2d(a):
    a = np.asarray(a)
    return a.reshape(-1, 1) if a.ndim == 1 else a


def _accuracy(y_true, y_pred):
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


# ---------------------------------------------------------------------------
# regression SAP


def _linreg_r2(x, y):
    """R^2 of the 1-D least-squares fit y ~ a*x + b."""
    x = x.reshape(-1).astype(np.float64)
    y = y.reshape(-1).astype(np.float64)
    xm, ym = x.mean(), y.mean()
    vx = np.sum((x - xm) ** 2)
    a = 0.0 if vx <= 0 else np.sum((x - xm) * (y - ym)) / vx
    pred = a * (x - xm) + ym
    ss_res = np.sum((y - pred) ** 2)
    ss_tot = np.sum((y - ym) ** 2)
    if ss_tot <= 0:
        return 0.0
    return 1.0 - ss_res / ss_tot


def _sap_regression_matrix(factors, codes):
    nf, nc = factors.shape[1], codes.shape[1]
    s = np.zeros((nf, nc))
    for f in range(nf):
        for c in range(nc):
            s[f, c] = max(0.0, _linreg_r2(codes[:, c], factors[:, f]))
    return s


# ---------------------------------------------------------------------------
# decision trees on one feature


class _Tree:
    """A fitted depth-limited Gini tree on one float32 feature."""

    def __init__(self, x, y, max_depth):
        x = np.asarray(x, np.float64).reshape(-1).astype(np.float32)
        self.classes, y_idx = np.unique(np.asarray(y).reshape(-1), return_inverse=True)
        self.k = len(self.classes)
        self.root = self._build(x, y_idx, 0, max_depth)

    def _gini(self, counts, n):
        sq = 0.0
        for c in range(self.k):
            sq += counts[..., c] * counts[..., c]
        return 1.0 - sq / (n * n)

    def _build(self, x, y, depth, max_depth):
        counts = np.bincount(y, minlength=self.k).astype(np.float64)
        n = float(len(y))
        if depth >= max_depth or len(y) < 2 or self._gini(counts, n) <= _EPSILON:
            return int(np.argmax(counts))
        order = np.argsort(x, kind="stable")
        xs, ys = x[order], y[order]
        pos = np.nonzero(xs[1:] > xs[:-1] + _FEATURE_THRESHOLD)[0] + 1
        if len(pos) == 0:
            return int(np.argmax(counts))
        left = np.cumsum(np.eye(self.k)[ys], axis=0)[pos - 1]  # class counts left of each split
        n_left = pos.astype(np.float64)
        n_right = n - n_left
        proxy = -n_right * self._gini(counts - left, n_right) - n_left * self._gini(left, n_left)
        p = int(pos[np.argmax(proxy)])  # the first best split
        thr = np.float64(xs[p - 1]) / 2.0 + np.float64(xs[p]) / 2.0
        return (thr, self._build(xs[:p], ys[:p], depth + 1, max_depth),
                self._build(xs[p:], ys[p:], depth + 1, max_depth))

    def predict(self, x):
        x = np.asarray(x, np.float64).reshape(-1).astype(np.float32).astype(np.float64)
        out = np.empty(len(x), np.int64)

        def walk(node, idx):
            if isinstance(node, int):
                out[idx] = node
                return
            thr, lo, hi = node
            go_left = x[idx] <= thr
            walk(lo, idx[go_left])
            walk(hi, idx[~go_left])

        walk(self.root, np.arange(len(x)))
        return self.classes[out]


def _stratified_kfold(y, n_splits=5):
    """Test folds of ``StratifiedKFold(n_splits)`` without shuffling."""
    y = np.asarray(y).reshape(-1)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than the number of samples")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(n_splits > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members in each class.")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype=int)
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(allocation[:, k])
    return [(np.nonzero(test_folds != f)[0], np.nonzero(test_folds == f)[0]) for f in range(n_splits)]


def _cv_accuracy(x, y, max_depth, cv=5):
    scores = [_accuracy(y[te], _Tree(x[tr], y[tr], max_depth).predict(x[te])) for tr, te in _stratified_kfold(y, cv)]
    return np.asarray(scores).mean()


def _best_tree(x, y, max_depths=range(1, 10), cv=5):
    x = np.asarray(x).reshape(-1)
    y = np.asarray(y).reshape(-1)
    best_score, best_sp = 0.0, 0
    for sp in max_depths:
        try:
            score = _cv_accuracy(x, y, sp, cv)
        except ValueError:
            score = 0.0
        if score > best_score:
            best_score, best_sp = score, sp
    return _Tree(x, y, best_sp if best_sp else 1)


def _sap_classification_matrix(factors, codes):
    nf, nc = factors.shape[1], codes.shape[1]
    s = np.zeros((nf, nc))
    for f in range(nf):
        for c in range(nc):
            x, y = codes[:, c], factors[:, f].reshape(-1)
            s[f, c] = _accuracy(_best_tree(x, y).predict(x), y)
    return s


def _mean_top2_gap(s_matrix):
    gaps = []
    for f in range(s_matrix.shape[0]):
        row = np.sort(s_matrix[f, :])
        gaps.append(row[-1] - row[-2])
    return float(np.mean(gaps))


def sap(factors, codes, continuous_factors=True, nb_bins=10, regression=True):
    """SAP score (ref: sdf_utils/sap.py:46-81)."""
    factors = _as_2d(factors)
    codes = _as_2d(codes)
    if regression:
        if not continuous_factors:
            raise ValueError("Cannot perform SAP regression with discrete factors.")
        return _mean_top2_gap(_sap_regression_matrix(factors, codes))
    if continuous_factors:
        factors = get_bin_index(_minmax_scale(factors), nb_bins)
    codes = _minmax_scale(codes)
    return _mean_top2_gap(_sap_classification_matrix(factors, codes))


def sap_score_matrix(factors, codes, continuous_factors=True, nb_bins=10, regression=True):
    """Per-(factor, latent) score matrix (ref: sap.py:237-258)."""
    factors = _as_2d(factors)
    codes = _as_2d(codes)
    if regression:
        if not continuous_factors:
            raise ValueError("Cannot perform SAP regression with discrete factors.")
        return _sap_regression_matrix(factors, codes)
    if continuous_factors:
        factors = get_bin_index(_minmax_scale(factors), nb_bins)
    codes = _minmax_scale(codes)
    return _sap_classification_matrix(factors, codes)


def sap_classification_predictions(factors, codes, continuous_factors=True, nb_bins=10, pred_sample_n=0):
    """Prediction summaries ({pred,true}_counts per (factor, latent) cell)
    from the whole-data Kumar decision trees (ref: sap.py:177-282)."""
    factors = _as_2d(factors)
    codes = _as_2d(codes)
    if continuous_factors:
        factors = get_bin_index(_minmax_scale(factors), nb_bins)
    codes = _minmax_scale(codes)
    nf, nc = factors.shape[1], codes.shape[1]
    pred_info = [[None for _ in range(nc)] for _ in range(nf)]
    for f in range(nf):
        for c in range(nc):
            y_pred = _best_tree(codes[:, c], factors[:, f]).predict(codes[:, c])
            info = {"pred_counts": _value_counts(y_pred), "true_counts": _value_counts(factors[:, f])}
            if pred_sample_n and pred_sample_n > 0:
                info["pred_sample"] = y_pred[:pred_sample_n].tolist()
            pred_info[f][c] = info
    return pred_info


def sap_regression_predictions(factors, codes, pred_sample_n=0):
    """Per-cell linear-regression prediction summaries (mean/std[/sample])
    (ref: sap.py:396-420)."""
    factors = _as_2d(factors)
    codes = _as_2d(codes)
    nf, nc = factors.shape[1], codes.shape[1]
    pred_info = [[None for _ in range(nc)] for _ in range(nf)]
    for f in range(nf):
        y = factors[:, f].reshape(-1).astype(np.float64)
        ym = y.mean()
        for c in range(nc):
            x = codes[:, c].reshape(-1).astype(np.float64)
            xm = x.mean()
            vx = np.sum((x - xm) ** 2)
            a = 0.0 if vx <= 0 else np.sum((x - xm) * (y - ym)) / vx
            y_pred = a * (x - xm) + ym
            info = {
                "pred_mean": float(np.mean(y_pred)) if y_pred.size else float("nan"),
                "pred_std": float(np.std(y_pred)) if y_pred.size else float("nan"),
            }
            if pred_sample_n and pred_sample_n > 0:
                info["pred_sample"] = y_pred[:pred_sample_n].tolist()
            pred_info[f][c] = info
    return pred_info


# ---------------------------------------------------------------------------
# holdout splits


def _split_sizes(n, test_size, train_size):
    """``_validate_shuffle_split`` for integer sizes."""
    if test_size >= n or test_size <= 0:
        raise ValueError(f"test_size={test_size} should be positive and smaller than the number of samples {n}")
    if train_size >= n or train_size <= 0:
        raise ValueError(f"train_size={train_size} should be positive and smaller than the number of samples {n}")
    if train_size + test_size > n:
        raise ValueError(f"The sum of train_size and test_size = {train_size + test_size}, should be smaller "
                         f"than the number of samples {n}.")


def _approximate_mode(class_counts, n_draws, rng):
    """sklearn.utils.extmath._approximate_mode."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _holdout_indices(y, test_size, train_size, random_state, stratify):
    """(train, test) indices of ``train_test_split(..., test_size=,
    train_size=, random_state=, stratify=y if stratify else None)``."""
    y = np.asarray(y).reshape(-1)
    n = len(y)
    _split_sizes(n, test_size, train_size)
    rng = np.random.RandomState(random_state)
    if not stratify:
        perm = rng.permutation(n)
        return perm[test_size:test_size + train_size], perm[:test_size]
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated class in y has only 1 member, which is too few.")
    if train_size < len(classes) or test_size < len(classes):
        raise ValueError("train_size and test_size must each be at least the number of classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, train_size, rng)
    t_i = _approximate_mode(class_counts - n_i, test_size, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _train_test_split(x, y, test_size, train_size, random_state):
    """Stratified split, or a plain shuffled one where stratifying raises
    (the fallback of msd_tpu/metrics/sap.py:233-242)."""
    try:
        tr, te = _holdout_indices(y, test_size, train_size, random_state, True)
    except ValueError:
        tr, te = _holdout_indices(y, test_size, train_size, random_state, False)
    return x[tr], x[te], y[tr], y[te]


def sap_classification_holdout_predictions(factors, codes, continuous_factors=True, nb_bins=10, train_frac=0.8,
                                           random_state=0, pred_sample_n=0):
    """Train/test accuracy matrices + per-cell prediction summaries with an
    80/20 holdout (ref: sap.py:285-393)."""
    factors = _as_2d(factors)
    codes = _as_2d(codes)
    nf, nc = factors.shape[1], codes.shape[1]
    train_acc = np.full((nf, nc), np.nan)
    test_acc = np.full((nf, nc), np.nan)
    pred_info = [[None for _ in range(nc)] for _ in range(nf)]
    if factors.shape[0] < 4:
        return train_acc, test_acc, pred_info
    if continuous_factors:
        factors = get_bin_index(_minmax_scale(factors), nb_bins)
    codes = _minmax_scale(codes)
    for f in range(nf):
        y_all = factors[:, f].reshape(-1)
        for c in range(nc):
            x_all = codes[:, c]
            mask = np.isfinite(y_all.astype(float)) & np.isfinite(x_all)
            y, x = y_all[mask], x_all[mask]
            if y.size < 4 or np.unique(y).size < 2:
                continue
            test_size = max(1, int(round((1.0 - train_frac) * y.size)))
            train_size = y.size - test_size
            if train_size < 2:
                continue
            xt, xs, yt, ys = _train_test_split(x, y, test_size, train_size, random_state)
            clf = _best_tree(xt, yt)
            yp_t, yp_s = clf.predict(xt), clf.predict(xs)
            train_acc[f, c] = _accuracy(yt, yp_t)
            test_acc[f, c] = _accuracy(ys, yp_s)
            info = {
                "train_pred_counts": _value_counts(yp_t),
                "train_true_counts": _value_counts(yt),
                "test_pred_counts": _value_counts(yp_s),
                "test_true_counts": _value_counts(ys),
            }
            if pred_sample_n and pred_sample_n > 0:
                info["train_pred_sample"] = yp_t[:pred_sample_n].tolist()
                info["test_pred_sample"] = yp_s[:pred_sample_n].tolist()
            pred_info[f][c] = info
    return train_acc, test_acc, pred_info


def sap_classification_holdout(factors, codes, continuous_factors=True, nb_bins=10, train_frac=0.8,
                               random_state=0) -> Tuple[np.ndarray, np.ndarray]:
    """Train/test accuracy matrices with an 80/20 holdout (ref: sap.py:285-393)."""
    train_acc, test_acc, _ = sap_classification_holdout_predictions(
        factors, codes, continuous_factors=continuous_factors, nb_bins=nb_bins,
        train_frac=train_frac, random_state=random_state,
    )
    return train_acc, test_acc


# ---------------------------------------------------------------------------
# Locatello SAP: linear SVMs on one standardised feature


def _squared_hinge_svm(x, s, C):
    """argmin over (w, b) of 0.5 (w^2 + b^2) + C sum max(0, 1 - s (w x + b))^2
    for labels s in {-1, +1}."""
    A = np.stack([x, np.ones_like(x)], axis=1) * s[:, None]

    def fg(v):
        r = np.maximum(0.0, 1.0 - A @ v)
        return 0.5 * v @ v + C * r @ r, v - 2.0 * C * (A.T @ r)

    v = optimize.minimize(fg, np.zeros(2), jac=True, method="BFGS", options={"gtol": 1e-13, "maxiter": 500}).x
    # exact minimiser of the quadratic on the active set, if it keeps that set
    act = 1.0 - A @ v > 0
    Aa = A[act]
    exact = np.linalg.solve(np.eye(2) + 2.0 * C * Aa.T @ Aa, 2.0 * C * Aa.sum(axis=0))
    return exact if np.array_equal(1.0 - A @ exact > 0, act) else v


class _LinearSVC:
    """``StandardScaler`` + ``LinearSVC(C)`` on one feature."""

    def __init__(self, x, y, C):
        x = np.asarray(x, np.float64).reshape(-1)
        self.mean = x.mean()
        std = x.std()
        self.scale = std if std != 0.0 else 1.0
        xz = (x - self.mean) / self.scale
        self.classes = np.unique(y)
        if len(self.classes) < 2:
            raise ValueError("This solver needs samples of at least 2 classes in the data")
        positive = self.classes[1:] if len(self.classes) == 2 else self.classes
        self.coef = np.stack([_squared_hinge_svm(xz, np.where(y == k, 1.0, -1.0), C) for k in positive])

    def predict(self, x):
        xz = (np.asarray(x, np.float64).reshape(-1) - self.mean) / self.scale
        scores = xz[:, None] * self.coef[:, 0] + self.coef[:, 1]
        if len(self.classes) == 2:
            return self.classes[(scores[:, 0] > 0).astype(int)]
        return self.classes[np.argmax(scores, axis=1)]


def sap_binary_classification_locatello(factors, codes, train_frac=0.8, C=0.01, random_state=0,
                                        return_predictions=False, pred_sample_n=0):
    """Locatello-protocol SAP: per-cell linear-SVM test errors; score =
    mean gap between the two lowest errors per factor (ref: sap.py:423-525).
    With ``return_predictions`` also per-cell prediction summaries."""
    factors = _as_2d(factors)
    codes = _as_2d(codes)
    n = factors.shape[0]
    nf, nc = factors.shape[1], codes.shape[1]
    error_matrix = np.full((nf, nc), np.nan)
    pred_info = [[None for _ in range(nc)] for _ in range(nf)] if return_predictions else None

    def result(score):
        return (score, error_matrix, pred_info) if return_predictions else (score, error_matrix)

    if n < 4:
        return result(float("nan"))
    test_size = max(1, int(round((1.0 - train_frac) * n)))
    train_size = n - test_size
    if train_size < 2:
        return result(float("nan"))
    for f in range(nf):
        y_all = factors[:, f].reshape(-1)
        for c in range(nc):
            x_all = codes[:, c].reshape(-1)
            mask = np.isfinite(y_all.astype(float)) & np.isfinite(x_all)
            y, x = y_all[mask], x_all[mask]
            if y.size < 4 or np.unique(y).size < 2:
                continue
            xt, xs, yt, ys = _train_test_split(x, y, test_size, train_size, random_state)
            y_pred = _LinearSVC(xt, yt, C).predict(xs)
            error_matrix[f, c] = 1.0 - _accuracy(ys, y_pred)
            if return_predictions:
                info = {"pred_counts": _value_counts(y_pred), "true_counts": _value_counts(ys)}
                if pred_sample_n and pred_sample_n > 0:
                    info["pred_sample"] = y_pred[:pred_sample_n].tolist()
                    info["true_sample"] = ys[:pred_sample_n].tolist()
                pred_info[f][c] = info
    gaps = []
    for f in range(nf):
        vals = error_matrix[f, :]
        vals = np.sort(vals[np.isfinite(vals)])
        if vals.size >= 2:
            gaps.append(vals[1] - vals[0])
    return result(float(np.mean(gaps)) if gaps else float("nan"))
