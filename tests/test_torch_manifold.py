"""msd_tpu_torch.manifold against scikit-learn (which the port may not
import; tests may), and ``python -m msd_tpu_torch.latent_manifold``
against the root ``latent_manifold.py`` on the same latents, on the CPU.

Tolerances, each with what was measured here (scikit-learn 1.9.0, scipy
1.17.0, numpy 2.0.2):
* PCA's "full" route (up to 500 samples and features), FastICA and Hessian
  LLE (dense and ``eigsh``) make the same scipy and numpy calls in the same
  order: equal bit for bit.
* PCA where scikit-learn takes the covariance matrix's eigenvectors (10
  times as many samples as features; 7.3e-13 measured) or its randomized
  solver (1.1e-8 of a 15.3 extent measured, on a spectrum with a gap): the
  same components to 1e-10 and 1e-6 of the scores' extent.
* t-SNE's P: 6.6e-16 of its largest entry measured (the perplexity search's
  sums in another order): held to 1e-14 relative. KL: 1.7e-16 relative
  measured, held to 1e-14; its float32 gradient equal bit for bit
  measured, held to 1e-6 relative (one float32 rounding of a float64 sum
  that can differ in its last bit).
* A whole t-SNE run against ``TSNE(method="exact")`` from the same start:
  equal bit for bit measured, held to 1e-3 of the embedding's extent.
* Against ``msd_tpu``'s Barnes-Hut run (``TSNE``'s default method) only the
  final KL under the exact P compares: the exact gradient's was at most
  0.24% above Barnes-Hut's measured, held to 1%.
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial.distance import squareform
from sklearn.decomposition import PCA, FastICA
from sklearn.manifold import TSNE, LocallyLinearEmbedding
from sklearn.manifold import _t_sne
from sklearn.metrics import pairwise_distances

import latent_manifold as root_manifold
from msd_tpu_torch import latent_manifold, manifold
from msd_tpu_torch.data.labels import save_labels
from msd_tpu_torch.utils.checkpoint import save_latent_vectors


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch and one BLAS thread: the t-SNE loop is a thousand small
    steps, and beside the other test workers many threads oversubscribe the
    cores (496 worker-seconds for this file in a 6-worker run, about 20 s
    alone). Both packages run under the same limit."""
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def line_latents(s, dim, seed=0, dtype=np.float64):
    """tests/test_tooling.py:249's latents: a noisy line through latent space."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, s)
    return (np.outer(t, rng.normal(size=dim)) + 0.05 * rng.normal(size=(s, dim))).astype(dtype)


def swiss_roll(s, seed=0):
    rng = np.random.default_rng(seed)
    t = 1.5 * np.pi * (1 + 2 * rng.uniform(size=s))
    return np.stack([t * np.cos(t), 21 * rng.uniform(size=s), t * np.sin(t)], 1)


@pytest.mark.parametrize("s,dim,dtype", [(40, 16, np.float64), (64, 256, np.float32), (64, 256, np.float64)])
def test_pca_full_route_bit_for_bit(s, dim, dtype):
    x = line_latents(s, dim, dtype=dtype)
    ours, ref = manifold.pca(x), PCA(2, random_state=0).fit_transform(x)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("s,dim,rel", [(1200, 64, 1e-10), (600, 256, 1e-6)], ids=["covariance_eigh", "randomized"])
def test_pca_other_routes(s, dim, rel):
    """scikit-learn's covariance and randomized solvers against the exact SVD
    (a spectrum with a gap, so that the components are well defined)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(s, dim)) @ np.diag(np.r_[[5.0, 3.0], np.full(dim - 2, 0.5)])
    ours, ref = manifold.pca(x), PCA(2, random_state=0).fit_transform(x)
    assert np.abs(ours - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("s,dim", [(40, 16), (64, 256), (250, 16)])
def test_fast_ica_bit_for_bit(s, dim):
    x = line_latents(s, dim)
    ours = manifold.fast_ica(x, n_components=2, seed=0, max_iter=1000)
    np.testing.assert_array_equal(ours, FastICA(n_components=2, random_state=0, max_iter=1000).fit_transform(x))
    other_seed = manifold.fast_ica(x, n_components=2, seed=3, max_iter=1000)
    np.testing.assert_array_equal(other_seed, FastICA(n_components=2, random_state=3, max_iter=1000).fit_transform(x))


@pytest.mark.parametrize("x", [line_latents(40, 16), line_latents(64, 256), swiss_roll(150), swiss_roll(300)],
                         ids=["dense-40x16", "dense-64x256", "dense-swiss150", "eigsh-swiss300"])
def test_hessian_lle_bit_for_bit(x):
    """``eigen_solver="auto"``: dense up to 200 points, ``eigsh`` above."""
    n_neighbors = max(8, min(x.shape[0] - 1, 12))
    ours = manifold.hessian_lle(x, n_neighbors, n_components=2, seed=0)
    ref = LocallyLinearEmbedding(n_neighbors=n_neighbors, n_components=2, method="hessian",
                                 random_state=0).fit_transform(x)
    np.testing.assert_array_equal(ours, ref)


def test_hessian_lle_singular_raises_as_sklearn():
    """Above 200 points on latents whose M is singular, scikit-learn's
    shift-invert ``eigsh`` fails and raises ValueError; so does the port."""
    x = line_latents(250, 16)
    with pytest.raises(ValueError, match="null-space with ARPACK") as ref:
        LocallyLinearEmbedding(n_neighbors=12, n_components=2, method="hessian", random_state=0).fit_transform(x)
    with pytest.raises(ValueError, match="null-space with ARPACK") as ours:
        manifold.hessian_lle(x, 12)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("s,dim", [(40, 16), (64, 256)])
def test_tsne_joint_probabilities(s, dim, dtype):
    x = line_latents(s, dim, dtype=dtype)
    perplexity = min(30.0, max(2.0, s / 4))
    ours = manifold.joint_probabilities(x, perplexity).numpy()
    ref = squareform(_t_sne._joint_probabilities(pairwise_distances(x, metric="euclidean", squared=True),
                                                 perplexity, 0))
    assert np.abs(ours - ref).max() <= 1e-14 * ref.max()
    assert (np.diag(ours) == 0).all() and np.array_equal(ours, ours.T)


@pytest.mark.parametrize("s,dim", [(40, 16), (64, 256)])
def test_tsne_kl_and_gradient(s, dim):
    x = line_latents(s, dim)
    perplexity = min(30.0, max(2.0, s / 4))
    p = manifold.joint_probabilities(x, perplexity)
    y = (1e-2 * np.random.default_rng(7).standard_normal((s, 2))).astype(np.float32)
    kl, grad = manifold.kl_divergence(p, torch.from_numpy(y))
    ref_kl, ref_grad = _t_sne._kl_divergence(y.ravel(), squareform(p.numpy()), 1, s, 2)
    assert grad.dtype == torch.float32 and ref_grad.dtype == np.float32
    assert abs(kl - ref_kl) <= 1e-14 * ref_kl
    np.testing.assert_allclose(grad.numpy().ravel(), ref_grad, rtol=1e-6, atol=1e-6 * np.abs(ref_grad).max())
    assert np.isnan(manifold.kl_divergence(p, torch.from_numpy(y), compute_error=False)[0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("s,dim", [(40, 16), (64, 256)])
def test_tsne_run_matches_exact_sklearn(s, dim, dtype):
    """The whole run from the same start array, and from the PCA start,
    against ``TSNE(method="exact")``: the embedding, ``kl_divergence_`` and
    ``n_iter_``."""
    x = line_latents(s, dim, dtype=dtype)
    perplexity = min(30.0, max(2.0, s / 4))
    y0 = (1e-2 * np.random.default_rng(5).standard_normal((s, 2))).astype(np.float32)
    for init in (y0, None):
        ours, info = manifold.tsne(x, perplexity=perplexity, init=init, return_info=True)
        ref_model = TSNE(2, perplexity=perplexity, random_state=0, method="exact",
                         init="pca" if init is None else init.copy())
        ref = ref_model.fit_transform(x)
        assert ours.dtype == np.float32 and ours.shape == (s, 2)
        assert np.abs(ours - ref).max() <= 1e-3 * np.abs(ref).max()
        assert info["n_iter"] == ref_model.n_iter_
        assert info["kl_divergence"] == pytest.approx(ref_model.kl_divergence_, rel=1e-6)


@pytest.mark.parametrize("s,dim", [(40, 16), (64, 256), (200, 32)])
def test_tsne_kl_against_barnes_hut(s, dim):
    """``msd_tpu``'s ``plot_manifold_tsne`` (msd_tpu/plotting.py:342-355)
    runs scikit-learn's Barnes-Hut t-SNE; the port's exact gradient must
    embed as well, by the final KL under the exact P."""
    x = line_latents(s, dim, dtype=np.float32)
    perplexity = min(30.0, max(2.0, (s - 1) / 3.0))
    ours = manifold.tsne(x, perplexity=perplexity)
    bh = TSNE(n_components=2, perplexity=perplexity, random_state=0).fit_transform(x)
    p = manifold.joint_probabilities(x, perplexity)
    ours_kl, bh_kl = (manifold.kl_divergence(p, torch.from_numpy(np.asarray(e, np.float32)))[0] for e in (ours, bh))
    assert ours_kl <= 1.01 * bh_kl, (ours_kl, bh_kl)


def test_tsne_runs_on_the_tensor_device_and_checks_perplexity():
    x = torch.from_numpy(line_latents(20, 8))
    emb = manifold.tsne(x, perplexity=5.0)
    np.testing.assert_array_equal(emb, manifold.tsne(x.numpy(), perplexity=5.0, device="cpu"))
    with pytest.raises(ValueError, match="perplexity must be less than n_samples"):
        manifold.tsne(x, perplexity=20.0)


def manifold_experiment(root, s=40, dim=16):
    """tests/test_tooling.py:249's experiment: ``s`` latents on a noisy line,
    a split of their ids and a label file."""
    exp = root / "exp"
    exp.mkdir()
    lat = line_latents(s, dim).astype(np.float32)
    save_latent_vectors(str(exp), "latest.pth", torch.from_numpy(lat), 7)
    ids = [f"shape_{i:03d}" for i in range(s)]
    import json

    json.dump({"ds": {"grp": ids}}, open(root / "split.json", "w"))
    json.dump({"Description": "m", "DataSource": str(root), "TrainSplit": str(root / "split.json"),
               "NetworkArch": "deep_sdf_decoder", "NetworkSpecs": {}, "CodeLength": dim},
              open(exp / "specs.json", "w"))
    save_labels(str(root / "labels.json"), {i: [float(k % 3)] for k, i in enumerate(ids)})
    return str(exp), lat


def test_latent_manifold_cli_matches_root(tmp_path):
    """``python -m msd_tpu_torch.latent_manifold`` (in process) writes each
    method's PNG and .npy; pca, ica and hlle bit for bit the root script's
    ``embed`` of the same latents, tsne the exact-gradient run (its KL
    against the root script's Barnes-Hut run in
    test_tsne_kl_against_barnes_hut)."""
    exp, lat = manifold_experiment(tmp_path)
    written = latent_manifold.main(["-e", exp, "--methods", "hlle", "ica", "pca", "tsne", "--labels_path",
                                    str(tmp_path / "labels.json"), "--device", "cpu", "--quiet"])
    out_dir = os.path.join(exp, "Evaluation", "Manifold")
    assert sorted(written) == ["hlle", "ica", "pca", "tsne"]
    x = np.asarray(lat, np.float64)
    for method in ("hlle", "ica", "pca", "tsne"):
        assert os.path.isfile(os.path.join(out_dir, f"latent_{method}.png")), method
        emb = np.load(written[method])
        assert emb.shape == (40, 2) and np.isfinite(emb).all()
        if method != "tsne":
            np.testing.assert_array_equal(emb, root_manifold.embed(x, method))
    np.testing.assert_array_equal(np.load(written["tsne"]), manifold.tsne(x, perplexity=10.0))
    with pytest.raises(ValueError, match="unknown embedding method"):
        latent_manifold.embed(x, "umap")
