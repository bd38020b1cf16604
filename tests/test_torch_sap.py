"""msd_tpu_torch's SAP metrics (numpy and scipy) against msd_tpu's
(scikit-learn) on seeded codes and labels: scores, score matrices and
prediction summaries equal to 1e-12, and the pieces written out in place of
scikit-learn (one-feature decision trees, stratified folds, stratified
shuffle splits, linear SVMs) against scikit-learn itself."""

import numpy as np
import pytest

from msd_tpu.metrics import sap as jax_sap
from msd_tpu_torch.metrics import sap

TOL = 1e-12


def _data(seed, n=60, nc=5, n_classes=2, signal=1.0, ties=False):
    """Codes [n, nc] with latent 0 carrying a class label and latent 1 an
    age; labels [n, 2] = (class, age)."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, n_classes, n)
    age = rng.uniform(55, 90, n)
    codes = rng.standard_normal((n, nc))
    codes[:, 0] += signal * cls
    codes[:, 1] += signal * (age - 70) / 10
    if ties:  # repeated values: splits only between distinct values
        codes = np.round(codes, 1)
    return np.stack([cls, age], axis=1).astype(np.float64), codes.astype(np.float32)


SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["classification", "binned", "regression"])
def test_sap_matches_msd_tpu(seed, kind):
    labels, codes = _data(seed, ties=seed == 3, n_classes=3 if seed == 2 else 2)
    if kind == "classification":
        kw = dict(continuous_factors=False, regression=False)
        factors = labels[:, :1]
    elif kind == "binned":
        kw = dict(continuous_factors=True, regression=False, nb_bins=5)
        factors = labels[:, 1:]
    else:
        kw = dict(continuous_factors=True, regression=True)
        factors = labels[:, 1:]
    assert abs(sap.sap(factors, codes, **kw) - jax_sap.sap(factors, codes, **kw)) <= TOL
    np.testing.assert_allclose(sap.sap_score_matrix(factors, codes, **kw),
                               jax_sap.sap_score_matrix(factors, codes, **kw), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_locatello_matches_msd_tpu(seed):
    labels, codes = _data(seed, n=50, signal=0.6, ties=seed == 3, n_classes=3 if seed == 2 else 2)
    ours = sap.sap_binary_classification_locatello(labels[:, :1], codes, return_predictions=True, pred_sample_n=5)
    ref = jax_sap.sap_binary_classification_locatello(labels[:, :1], codes, return_predictions=True,
                                                      pred_sample_n=5)
    assert abs(ours[0] - ref[0]) <= TOL
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=TOL)
    assert ours[2] == ref[2]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_predictions_and_holdout_match_msd_tpu(seed):
    labels, codes = _data(seed, n=40)
    f = labels[:, :1]
    assert sap.sap_classification_predictions(f, codes, continuous_factors=False, pred_sample_n=4) == \
        jax_sap.sap_classification_predictions(f, codes, continuous_factors=False, pred_sample_n=4)
    assert sap.sap_regression_predictions(labels[:, 1:], codes, pred_sample_n=3) == \
        jax_sap.sap_regression_predictions(labels[:, 1:], codes, pred_sample_n=3)
    ours = sap.sap_classification_holdout_predictions(f, codes, continuous_factors=False, pred_sample_n=3)
    ref = jax_sap.sap_classification_holdout_predictions(f, codes, continuous_factors=False, pred_sample_n=3)
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=TOL)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=TOL)
    assert ours[2] == ref[2]


def test_degenerate_inputs_match_msd_tpu():
    """Too few rows, a single class, and a class with one member (the
    stratified split falls back to a plain shuffle)."""
    labels, codes = _data(5, n=20)
    one_class = np.zeros((20, 1))
    assert np.isnan(sap.sap_binary_classification_locatello(labels[:3, :1], codes[:3])[0])
    np.testing.assert_array_equal(sap.sap_binary_classification_locatello(one_class, codes)[1],
                                  jax_sap.sap_binary_classification_locatello(one_class, codes)[1])
    lonely = labels[:, :1].copy()
    lonely[:] = 0
    lonely[7] = 1
    lonely[3] = 2
    lonely[11] = 2
    np.testing.assert_allclose(sap.sap_binary_classification_locatello(lonely, codes)[1],
                               jax_sap.sap_binary_classification_locatello(lonely, codes)[1], rtol=0, atol=TOL)
    assert sap.sap(lonely, codes, continuous_factors=False, regression=False) == \
        jax_sap.sap(lonely, codes, continuous_factors=False, regression=False)


# the pieces against scikit-learn itself


@pytest.mark.parametrize("depth", [1, 2, 3, 9])
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_matches_sklearn(depth, seed):
    from sklearn.tree import DecisionTreeClassifier

    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(0, 1, 80), 2)  # ties
    y = (x + 0.3 * rng.standard_normal(80) > 0.5).astype(int) + (rng.uniform(size=80) > 0.8)
    ref = DecisionTreeClassifier(max_depth=depth).fit(x[:, None], y)
    ours = sap._Tree(x, y, depth)
    grid = np.linspace(-0.1, 1.1, 501)
    np.testing.assert_array_equal(ours.predict(grid), ref.predict(grid[:, None]))
    np.testing.assert_array_equal(ours.predict(x), ref.predict(x[:, None]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_folds_and_splits_match_sklearn(seed):
    from sklearn.model_selection import StratifiedKFold, train_test_split

    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, 37)
    for (tr, te), (tr_r, te_r) in zip(sap._stratified_kfold(y), StratifiedKFold(5).split(np.zeros((37, 1)), y)):
        np.testing.assert_array_equal(tr, tr_r)
        np.testing.assert_array_equal(te, te_r)
    x = np.arange(37.0)
    for stratify in (True, False):
        tr, te = sap._holdout_indices(y, 8, 29, 0, stratify)
        ref = train_test_split(x, test_size=8, train_size=29, random_state=0, stratify=y if stratify else None)
        np.testing.assert_array_equal(x[tr], ref[0])
        np.testing.assert_array_equal(x[te], ref[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_linear_svc_matches_sklearn(seed):
    from sklearn.svm import LinearSVC

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(60)
    y = (x + rng.standard_normal(60) > 0.3).astype(int)
    ours = sap._LinearSVC(x, y, 0.01)
    xz = (x - x.mean()) / x.std()
    ref = LinearSVC(C=0.01, max_iter=5000, tol=1e-10).fit(xz[:, None], y)
    np.testing.assert_allclose(ours.coef[0], [ref.coef_[0, 0], ref.intercept_[0]], rtol=1e-6, atol=1e-9)
