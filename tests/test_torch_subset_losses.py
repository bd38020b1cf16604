"""msd_tpu_torch's group ("subset") losses and the disentanglement losses no
trainer reaches against msd_tpu's, in float32 on the CPU: every function of
``losses/subset.py`` and ``snn_loss``, ``cls_correlation_loss``,
``reg_correlation_loss``, ``wasserstein_loss``, ``pairwise_euclid_distance``,
``pairwise_cos_distance`` and ``snnl_cross_entropy`` of
``losses/disentangle.py``, in value and gradient in the differentiable
input, on numpy-made inputs, with and without a validity mask (rtol 1e-5,
atol 1e-6, as tests/test_torch_stage2_losses.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu.losses import disentangle as jdl
from msd_tpu.losses import subset as jsub
from msd_tpu_torch.losses import disentangle as dl
from msd_tpu_torch.losses import subset as sub

TOL = dict(rtol=1e-5, atol=1e-6)
B, D = 12, 6
RNG = np.random.default_rng(0)
X = RNG.standard_normal((B, D)).astype(np.float32)
Y_CLS = (RNG.uniform(size=B) > 0.5).astype(np.float32)
Y_REG = RNG.uniform(55, 90, B).astype(np.float32) / 100
VALID = np.ones(B, bool)
VALID[[2, 7]] = False
W_DEC = RNG.standard_normal((D, 5)).astype(np.float32)
SUBSETS = {"a": [0, 1], "b": [2], "c": [3, 5], "empty": []}
COV_KEY = jax.random.PRNGKey(3)


def _valid(masked, lib):
    if not masked:
        return None
    return jnp.asarray(VALID) if lib is jnp else torch.tensor(VALID)


def _decoder(lib):
    """A fixed nonlinear decoder for the sensitivity loss, in either
    library."""
    if lib is jnp:
        return lambda z: jnp.tanh(z @ jnp.asarray(W_DEC))
    return lambda z: torch.tanh(z @ torch.tensor(W_DEC))


def cases(masked):
    """name -> (f(lib, x) for lib in (jnp, torch)); f returns a scalar or a
    tuple whose first entry is differentiated."""

    def both(jfn, tfn, *args, **kw):
        def f(lib, x):
            a = [v if not isinstance(v, np.ndarray) else jnp.asarray(v) if lib is jnp else torch.tensor(v)
                 for v in args]
            v = _valid(masked, lib)
            extra = dict(kw, valid=v) if "valid" in kw else kw
            return (jfn if lib is jnp else tfn)(x, *a, **extra)
        return f

    return {
        "snn_loss": both(jdl.snn_loss, dl.snn_loss, Y_CLS, T=2.0, valid=None),
        "cls_correlation": both(jdl.cls_correlation_loss, dl.cls_correlation_loss, Y_CLS, valid=None),
        "reg_correlation": both(jdl.reg_correlation_loss, dl.reg_correlation_loss, Y_REG, valid=None),
        "snnl_ce_cos": both(jdl.snnl_cross_entropy, dl.snnl_cross_entropy, Y_CLS, temp=0.5),
        "snnl_ce_euclid": both(jdl.snnl_cross_entropy, dl.snnl_cross_entropy, Y_CLS, temp=4.0, cos_distance=False),
        "corr_leak_group": both(jsub.corr_leakage_penalty_group, sub.corr_leakage_penalty_group, Y_REG, [0, 2],
                                valid=None),
        "corr_leak_pca": both(jsub.corr_leakage_penalty_pca_subsets, sub.corr_leakage_penalty_pca_subsets, Y_REG,
                              [[1, 2, 3], [4], [], [0, 5]]),
        "cross_cov_group": both(jsub.cross_cov_penalty_group, sub.cross_cov_penalty_group, [1, 4], valid=None),
        "cross_cov_pca": both(jsub.cross_cov_penalty_pca_subsets, sub.cross_cov_penalty_pca_subsets, [0, 1],
                              [[2, 3], [4, 5], [3]]),
        "snnl_cls_group": both(jsub.snn_loss_cls_group, sub.snn_loss_cls_group, Y_CLS, [0, 3], valid=None),
        "snnl_cls_group_fixed_T": both(jsub.snn_loss_cls_group, sub.snn_loss_cls_group, Y_CLS, [0, 3, 4, 5, 1, 2],
                                       use_adaptive_T=False, normalize_z=False, valid=None),
        "snnl_reg_group": both(jsub.snn_reg_loss_exact_group, sub.snn_reg_loss_exact_group, Y_REG, [1, 2],
                               threshold=0.05, valid=None),
        "snnl_reg_group_topk": both(jsub.snn_reg_loss_exact_group, sub.snn_reg_loss_exact_group, Y_REG, [1],
                                    pos_mode="topk", topk_frac=0.3, valid=None),
        "match_std_group": both(jsub.match_std_group, sub.match_std_group, [0, 4], valid=None),
        "match_std_group_all": both(jsub.match_std_group, sub.match_std_group, list(range(D)), valid=None),
        "rank_group": both(jsub.rank_loss_group, sub.rank_loss_group, Y_CLS, [0, 2], margin=0.5, valid=None),
        "sensitivity_group": lambda lib, x: (jsub.sensitivity_group_loss if lib is jnp else sub.sensitivity_group_loss)(
            0.01 * x, _decoder(lib), [1, 3], eps=0.02, eta=0.05),
        "covariance_subset": lambda lib, x: (
            jsub.covariance_subset_loss(COV_KEY, x, 0.1 * x[:, ::-1], SUBSETS, lambda_off=0.7, beta=0.3)
            if lib is jnp else sub.covariance_subset_loss(
                torch.tensor(np.asarray(jax.random.normal(COV_KEY, (B, D)))), x, 0.1 * x.flip(1), SUBSETS,
                lambda_off=0.7, beta=0.3)),
    }


MASKED = {"snn_loss", "cls_correlation", "reg_correlation", "corr_leak_group", "cross_cov_group", "snnl_cls_group",
          "snnl_cls_group_fixed_T", "snnl_reg_group", "snnl_reg_group_topk", "match_std_group",
          "match_std_group_all", "rank_group"}
CASES = [(name, False) for name in cases(False)] + [(name, True) for name in sorted(MASKED)]


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name,masked", CASES, ids=[f"{n}{'-valid' if m else ''}" for n, m in CASES])
def test_loss_matches_jax(name, masked):
    """Every output, and the gradient of the first in the input x."""
    f = cases(masked)[name]
    ref = f(jnp, jnp.asarray(X))
    g_ref = jax.grad(lambda x: _first(f(jnp, x)))(jnp.asarray(X))
    x = torch.tensor(X, requires_grad=True)
    out = f(torch, x)
    for o, r in zip(out if isinstance(out, tuple) else (out,), ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(float(o.detach()), float(r), err_msg=name, **TOL)
    if not _first(out).requires_grad:  # a constant (match_std_group with no other dims): msd_tpu's gradient is 0
        assert not np.asarray(g_ref).any()
        return
    _first(out).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), err_msg=name, **TOL)


def test_pca1_scores_and_pairwise_distances_match_jax():
    """pca1 scores up to the eigenvector's sign (eigh may return either),
    and the two pairwise distance matrices."""
    ours = sub.pca1_scores(torch.tensor(X[:, :4])).numpy()
    ref = np.asarray(jsub.pca1_scores(jnp.asarray(X[:, :4])))
    np.testing.assert_allclose(ours * np.sign(ours @ ref), ref, **TOL)
    np.testing.assert_allclose(sub.pca1_scores(torch.tensor(X[:, :1])).numpy(),
                               np.asarray(jsub.pca1_scores(jnp.asarray(X[:, :1]))), **TOL)
    a, b = X[:7], X[3:]  # rows 3-6 in both: their distances cancel to 0 in the expanded form,
    for tfn, jfn in ((dl.pairwise_euclid_distance, jdl.pairwise_euclid_distance),  # so atol is 1e-5
                     (dl.pairwise_cos_distance, jdl.pairwise_cos_distance)):   # of the largest
        ref = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(tfn(torch.tensor(a), torch.tensor(b)).numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("seed", [0, 5])
def test_wasserstein_matches_jax(seed):
    """msd_tpu seeds its numpy generator from the key; the port takes that
    seed. Value and gradient."""
    key = jax.random.PRNGKey(seed)
    np_seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    ref, g_ref = jax.value_and_grad(lambda x: jdl.wasserstein_loss(key, x, delta=0.8))(jnp.asarray(X))
    x = torch.tensor(X, requires_grad=True)
    out = dl.wasserstein_loss(x, delta=0.8, rng=np_seed)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), **TOL)


def test_subset_validation_errors_match_jax():
    """The same ValueErrors as msd_tpu's: empty, out-of-range and duplicate
    target dims, and out-of-range subset dims."""
    x = torch.tensor(X)
    for dims in ([], [D], [1, 1], [-1]):
        with pytest.raises(ValueError) as ours:
            sub.cross_cov_penalty_group(x, dims)
        with pytest.raises(ValueError) as ref:
            jsub.cross_cov_penalty_group(jnp.asarray(X), dims)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="subset dims out of range"):
        sub.covariance_subset_loss(torch.zeros(B, D), x, x, {"a": [0], "b": [D]})
