"""msd_tpu_torch.plotting, ``plot_log``, ``analyze_sdf_npz`` and the Stage-1
eval hooks' figures against msd_tpu's on the same data, on the CPU.

Figures compare by their Agg RGBA buffers after ``fig.canvas.draw()``, 2-D
and 3-D alike: on the same data the two packages draw the same pixels
(measured equal for every figure here). Where a figure's data come from a
computation the port does its own way (the t-SNE embedding, the meshes of
``plot_lat_interpolation``), both packages are handed the same data and
the port's own computation is held separately (tests/test_torch_manifold.py,
and below against its ``create_mesh``).
"""

import contextlib
import io
import json
import logging
import os
import sys

import jax
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import msd_tpu.workspace as jax_ws  # noqa: E402
from conftest import make_sphere_mesh  # noqa: E402
from msd_tpu import plotting as jax_plotting  # noqa: E402
from msd_tpu.models import build_decoder as jax_build_decoder  # noqa: E402
from msd_tpu_torch import analyze_sdf_npz, manifold, plot_log, plotting  # noqa: E402
from msd_tpu_torch import mesh as mesh_mod  # noqa: E402
from msd_tpu_torch.data.mesh_io import save_obj, save_ply  # noqa: E402
from msd_tpu_torch.utils.checkpoint import save_logs  # noqa: E402
from msd_tpu_torch.utils.logging_utils import _NullWriter  # noqa: E402
from test_torch_decoder import CONFIGS, LATENT, make_pair  # noqa: E402


def rgba(fig):
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def same_pixels(ours, ref):
    a, b = rgba(ours), rgba(ref)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def sdf_points(n=1000, seed=0):
    pts = np.random.default_rng(seed).uniform(-1, 1, (n, 3))
    return pts, np.linalg.norm(pts, axis=1) - 0.5


def test_plot_train_stats_and_violin():
    hists = [[1.0, 0.5, 0.3], [0.9, 0.6]]
    same_pixels(plotting.plot_train_stats(hists, labels=["a", "b"]),
                jax_plotting.plot_train_stats(hists, labels=["a", "b"]))
    same_pixels(plotting.plot_train_stats(hists, step_hist=np.array([0, 10, 20])),
                jax_plotting.plot_train_stats(hists, step_hist=np.array([0, 10, 20])))
    data = np.abs(np.random.default_rng(0).normal(size=500))
    (fig, pct), (ref_fig, ref_pct) = plotting.plot_dist_violin(data), jax_plotting.plot_dist_violin(data)
    assert pct == ref_pct and set(pct) == {50, 75, 90, 99}
    same_pixels(fig, ref_fig)


def test_mesh_and_sdf_renders():
    v, f = make_sphere_mesh(16, 32)
    same_pixels(plotting.render_mesh(v, f), jax_plotting.render_mesh(v, f))
    same_pixels(plotting.render_mesh(v, f, cam_angles=(0.3, 1.0, 0)),
                jax_plotting.render_mesh(v, f, cam_angles=(0.3, 1.0, 0)))
    pts, sdf = sdf_points()
    same_pixels(plotting.render_sdf(pts, sdf), jax_plotting.render_sdf(pts, sdf))
    same_pixels(plotting.plot_sdf_cross_section(pts, sdf), jax_plotting.plot_sdf_cross_section(pts, sdf))
    kw = dict(plane_normal=np.array([0.0, 0.2, 1.0]), margin=0.1)
    same_pixels(plotting.plot_sdf_cross_section(pts, sdf, **kw), jax_plotting.plot_sdf_cross_section(pts, sdf, **kw))
    rows = [("a", [(v, f), None]), ("b", [(v, f), (v * 0.9, f)])]
    same_pixels(plotting.plot_mesh_comparison(rows, annotate={("b", 1): "CD=0.1"}),
                jax_plotting.plot_mesh_comparison(rows, annotate={("b", 1): "CD=0.1"}))
    color, depth = plotting.pyrender_helper((v, f), alpha=0.2, resolution=(64, 48))
    assert color.shape == (48, 64, 3) and depth.shape == (48, 64) and (depth > 0).any()


def test_reconstruction_comparison(tmp_path, monkeypatch):
    """tests/test_tooling.py:32's fixture: a GT mesh and one experiment's
    reconstruction; the same figure, Chamfer annotation included, and the
    PDF written."""
    v, f = make_sphere_mesh(12, 24)
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    save_obj(str(gt_dir / "shape0.obj"), v, f)
    exp = tmp_path / "expA"
    recon = jax_ws.get_reconstructed_mesh_filename(str(exp), 5, "ds", "cls", "shape0")
    os.makedirs(os.path.dirname(recon), exist_ok=True)
    save_ply(recon, v * 0.98, f)
    monkeypatch.chdir(tmp_path)
    kw = dict(chckpt=5, dataset_name="ds", class_name="cls", gt_mesh_dir=str(gt_dir), angle_num=2)
    fig = plotting.plot_reconstruction_comparison({"expA": str(exp)}, ["shape0", "missing"], **kw)
    assert os.path.isfile(tmp_path / "reconstruction_comparison.pdf")
    same_pixels(fig, jax_plotting.plot_reconstruction_comparison({"expA": str(exp)}, ["shape0", "missing"], **kw))


def test_sdf_video(tmp_path):
    """Two frames through Pillow (no ffmpeg here): the same GIF frames."""
    from PIL import Image, ImageSequence

    pts, sdf = sdf_points(200)
    plotting.render_sdf_vid(pts, sdf, fps=2, n_seconds=1, save_filepath=str(tmp_path / "ours"))
    jax_plotting.render_sdf_vid(pts, sdf, fps=2, n_seconds=1, save_filepath=str(tmp_path / "ref"))
    plt.close("all")
    ext = ".mp4" if os.path.isfile(tmp_path / "ref.mp4") else ".gif"
    assert os.path.isfile(tmp_path / f"ours{ext}")
    if ext == ".gif":
        frames = [[np.asarray(fr.convert("RGBA")) for fr in ImageSequence.Iterator(Image.open(tmp_path / f"{n}.gif"))]
                  for n in ("ours", "ref")]
        assert len(frames[0]) == len(frames[1]) == 2
        for a, b in zip(*frames):
            np.testing.assert_array_equal(a, b)


def test_binary_vs_continuous():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"diag": [0, 1, 0, 1], "loss": [0.5, 0.7, 0.4, 0.9]})
    same_pixels(plotting.plot_binary_vs_continuous(df, "diag", "loss"),
                jax_plotting.plot_binary_vs_continuous(df, "diag", "loss"))


CAPACITY_SPECS = [
    {"dims": [8, 8], "norm_layers": [], "latent_in": [1], "weight_norm": True},
    {"dims": [16, 16, 16], "norm_layers": [0, 1, 2], "latent_in": [2], "weight_norm": True},
    {"dims": [12, 12], "norm_layers": [0], "latent_in": [], "weight_norm": False},
]


def test_capacity_vs_chamfer_counts_parameters_as_msd_tpu(tmp_path):
    """The capacity axis: the port's parameter count equals msd_tpu's
    ``num_params`` of the initialised decoder, for a plain config (the
    flagship's kind: ``weight_norm`` set, no norm layer, so plain Linear),
    a weight-normed one with LayerNorm (``g`` and LayerNorm leaves) and one
    with LayerNorm only; the latent-size axis too."""
    exp_dirs, counts = [], []
    for i, net in enumerate(CAPACITY_SPECS):
        d = str(tmp_path / f"cap{i}")
        specs = {"Description": "cap", "DataSource": "x", "TrainSplit": "x", "NetworkArch": "deep_sdf_decoder",
                 "CodeLength": 4 + 4 * i, "NetworkSpecs": dict(net, dropout=[], dropout_prob=0.0,
                                                               xyz_in_all=False, use_tanh=False,
                                                               latent_dropout=False)}
        jax_ws.save_experiment_specifications(d, specs)
        ev_dir = jax_ws.get_evaluation_dir(d, "5", True)
        with open(os.path.join(ev_dir, "chamfer.csv"), "w") as fh:
            fh.write("shape;chamfer_dist;90th_percentile;95th_percentile;normal_consistency\n")
            fh.write(f"s0;{0.01 / (i + 1)};0.02;0.03;0.9\ns1;{0.02 / (i + 1)};0.02;0.03;0.9\n")
        exp_dirs.append(d)
        jdec = jax_build_decoder("deep_sdf_decoder", specs["CodeLength"], specs["NetworkSpecs"])
        counts.append(jdec.num_params(jdec.init(jax.random.PRNGKey(0))))
    assert len(set(counts)) == 3
    for means in (False, True):
        kw = dict(exp_dirs_net_capacity=exp_dirs, exp_dirs_lat_capacity=exp_dirs, checkpoint=5, plot_means=means)
        fig, ref = plotting.plot_capacity_vs_chamfer_dist(**kw), jax_plotting.plot_capacity_vs_chamfer_dist(**kw)
        np.testing.assert_array_equal(fig.axes[0].lines[0].get_xdata(), sorted(counts))
        np.testing.assert_array_equal(fig.axes[1].lines[0].get_xdata(), [4, 8, 12])
        same_pixels(fig, ref)
    with pytest.raises(ValueError, match="NO EXPERIMENT DIRS GIVEN"):
        plotting.plot_capacity_vs_chamfer_dist()


def test_manifold_tsne_figure(monkeypatch):
    """The same embedding drawn the same way (labels and none), and the port
    asks ``manifold.tsne`` for msd_tpu's perplexity cap (its PCA start takes
    no seed)."""
    lat = np.random.default_rng(0).normal(size=(20, 8))
    emb = np.random.default_rng(1).normal(size=(20, 2)).astype(np.float32)
    calls = []

    def fake_tsne(x, perplexity):
        calls.append((x.shape, 2, perplexity))
        return emb

    class FakeTSNE:
        def __init__(self, n_components, perplexity, random_state):
            calls.append(("sklearn", n_components, perplexity, random_state))

        def fit_transform(self, x):
            return emb

    import sklearn.manifold

    monkeypatch.setattr(manifold, "tsne", fake_tsne)
    monkeypatch.setattr(sklearn.manifold, "TSNE", FakeTSNE)
    for labels in (lat[:, 0] > 0, None):
        same_pixels(plotting.plot_manifold_tsne(lat, labels=labels, seed=3),
                    jax_plotting.plot_manifold_tsne(lat, labels=labels, seed=3))
    assert calls[0] == ((20, 8), 2, 19 / 3) and calls[1] == ("sklearn", 2, 19 / 3, 3)


def test_manifold_tsne_runs():
    lat = np.random.default_rng(0).normal(size=(30, 8))
    fig = plotting.plot_manifold_tsne(torch.from_numpy(lat), labels=lat[:, 0])
    offsets = fig.axes[0].collections[0].get_offsets()
    np.testing.assert_array_equal(np.asarray(offsets), manifold.tsne(lat, perplexity=29 / 3))
    plt.close(fig)


def test_lat_interpolation():
    """Both packages interpolate the same latents and draw the same strip
    from the same meshes; the port's default meshes are its
    ``create_mesh``'s, through one ``PointEvaluator`` for the strip."""
    v, f = make_sphere_mesh(10, 20)
    a = np.random.default_rng(0).normal(size=LATENT).astype(np.float32)
    b = np.random.default_rng(1).normal(size=LATENT).astype(np.float32)
    seen = {"ours": [], "ref": []}

    def fixed(decoder, *args, N, return_mesh):
        """The sphere, but no surface at the second step. msd_tpu passes
        (params, latent), the port (latent)."""
        calls = seen["ref" if len(args) == 2 else "ours"]
        calls.append((np.asarray(args[-1]), N))
        return False if len(calls) == 2 else (v, f)

    _, _, tdec = make_pair(CONFIGS[1], seed=21, surface=True)
    fig = plotting.plot_lat_interpolation(tdec, a, b, steps=4, N=33, create_mesh_fn=fixed)
    ref = jax_plotting.plot_lat_interpolation(None, None, a, b, steps=4, N=33, create_mesh_fn=fixed)
    same_pixels(fig, ref)
    assert [n for _, n in seen["ours"]] == [33] * 4
    for (ours, _), (theirs, _) in zip(seen["ours"], seen["ref"]):
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs.astype(np.float32))

    direct = []
    fig = plotting.plot_lat_interpolation(tdec, a * 0.01, b * 0.01, steps=2, N=33)
    for i, t in enumerate((0.0, 1.0)):
        lat = torch.as_tensor((1 - t) * a * 0.01 + t * b * 0.01, dtype=torch.float32)
        direct.append(mesh_mod.create_mesh(tdec, lat, N=33, return_mesh=True))
    ref = plotting.plot_lat_interpolation(tdec, a * 0.01, b * 0.01, steps=2, N=33,
                                          create_mesh_fn=lambda d, lat, **kw: direct.pop(0))
    same_pixels(fig, ref)


def test_plot_log_all_types_match_root(tmp_path):
    """``python -m msd_tpu_torch.plot_log`` (in process) for all five types:
    the PNG's pixels equal the root script's on the same Logs.pth."""
    import plot_log as root_plot_log
    from matplotlib.image import imread

    exp = str(tmp_path)
    rng = np.random.default_rng(0)
    save_logs(exp, list(rng.uniform(0.1, 1.0, 120)), [[1e-3, 1e-4], [5e-4, 5e-5], [2.5e-4, 2.5e-5]],
              [5.0, 5.1, 4.9], [0.1, 0.2, 0.25], {"lin0.w": [1.0, 1.1, 1.2], "lin0.b": [0.1, 0.2, 0.2]}, 3)
    for t in ("loss", "learning_rate", "time", "lat_mag", "param_mag"):
        out = plot_log.main(["-e", exp, "-t", t, "--quiet"])
        assert out == os.path.join(exp, f"plot_{t}.png")
        ours = imread(out)
        assert root_plot_log.plot_logs(exp, t) == out
        plt.close("all")
        np.testing.assert_array_equal(ours, imread(out))
    with pytest.raises(Exception, match="unrecognized plot type"):
        plot_log.main(["-e", exp, "-t", "nope", "--quiet"])


def test_analyze_sdf_npz_matches_root(tmp_path, monkeypatch):
    """The printed lines and both PNGs equal the root script's."""
    import analyze_sdf_npz as root_analyze
    from matplotlib.image import imread

    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, (3000, 4)).astype(np.float32)
    pos[:, 3] = np.abs(pos[:, 3]) * 0.1
    neg = rng.uniform(-1, 1, (2500, 4)).astype(np.float32)
    neg[:, 3] = -np.abs(neg[:, 3]) * 0.1
    npz = str(tmp_path / "shape.npz")
    np.savez(npz, pos=pos, neg=neg)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        paths = analyze_sdf_npz.main([npz, "--max_points", "2000"])
    ours = buf.getvalue()
    images = [imread(p) for p in paths]
    monkeypatch.setattr(sys, "argv", ["analyze_sdf_npz.py", npz, "--max_points", "2000"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        root_analyze.main()
    plt.close("all")
    assert ours == buf.getvalue() and ours.count("\n") == 7
    for p, img in zip(paths, images):
        np.testing.assert_array_equal(img, imread(p))


class FigureRecorder:
    """Stands in for the trainer's TensorBoard writer: every tag it is given."""

    def __init__(self):
        self.scalars, self.figures = {}, {}

    def add_scalar(self, tag, value, step=None):
        self.scalars.setdefault(tag, []).append(float(value))

    def add_figure(self, tag, fig, global_step=None):
        self.figures.setdefault(tag, []).append((fig, global_step))

    def add_hparams(self, *args, **kwargs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tiny Stage-1 experiment of tests/test_torch_train_cli.py, trained
    3 epochs on the CPU, and a sphere as every shape's GT mesh."""
    from chip_smoke import write_dataset
    from msd_tpu_torch import train_deep_sdf
    from test_torch_train_cli import SPECS

    import msd_tpu_torch.workspace as ws

    root = tmp_path_factory.mktemp("figures")
    data = str(root / "data")
    split = write_dataset(data, 4, 2000, seed=5)
    split_path = str(root / "train_split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    exp = str(root / "exp")
    ws.save_experiment_specifications(exp, dict(SPECS, DataSource=os.path.join(data, "SdfSamples"),
                                                TrainSplit=split_path, TestSplit=split_path))
    train_deep_sdf.main(["-e", exp, "--device", "cpu", "--quiet"])
    gt_dir = str(root / "gt")
    os.makedirs(gt_dir)
    verts, faces = make_sphere_mesh(n_theta=12, n_phi=24, radius=0.5)
    for name in split["smoke"]["ellipsoid"]:
        save_obj(os.path.join(gt_dir, name + ".obj"), verts, faces)
    return exp, gt_dir


def hook_trainer(trained, **changes):
    from msd_tpu_torch.train.stage1 import Stage1Trainer

    import msd_tpu_torch.workspace as ws

    exp, gt_dir = trained
    specs = dict(ws.load_experiment_specifications(exp), TorusPath=gt_dir, EvalTrainSceneNumber=3,
                 EvalTestSceneNumber=2, EvalTestOptimizationSteps=5, EvalGridResolution=33)
    specs.update(changes)
    trainer = Stage1Trainer(exp, specs=specs, device="cpu")
    trainer.resume("latest")
    trainer._writer = FigureRecorder()
    return trainer


def test_stage1_hooks_write_the_figures(trained):
    """``_eval_train`` writes msd_tpu's "CD Percentiles/train dists" and
    "Reconstructions/train comparison" (3 GT-vs-reconstruction rows),
    ``_eval_test`` "CD Percentiles/test dists", each with the epoch, and the
    violins hold every shape's per-point distances."""
    trainer = hook_trainer(trained)
    trainer._eval_train(3)
    trainer._eval_test(3)
    rec = trainer.writer
    assert sorted(rec.figures) == ["CD Percentiles/test dists", "CD Percentiles/train dists",
                                   "Reconstructions/train comparison"]
    assert all(len(v) == 1 and v[0][1] == 3 for v in rec.figures.values())
    assert len(rec.scalars["Mean Chamfer Dist/train"]) == 1 and len(rec.scalars["Mean Chamfer Dist/test"]) == 1
    comparison = rec.figures["Reconstructions/train comparison"][0][0]
    assert len(comparison.axes) == 6
    violin = rec.figures["CD Percentiles/train dists"][0][0]
    assert len(violin.axes[0].collections) >= 1
    plt.close("all")


def test_stage1_hook_figure_failure_is_a_warning(trained, monkeypatch, caplog):
    """As msd_tpu's hooks: a figure that fails is logged and skipped, the
    scalars are still written."""
    def broken(*args, **kwargs):
        raise RuntimeError("no display")

    monkeypatch.setattr(plotting, "plot_dist_violin", broken)
    trainer = hook_trainer(trained, EvalTrainSceneNumber=1)
    with caplog.at_level(logging.WARNING):
        trainer._eval_train(3)
        trainer._eval_test(3)
    assert "eval figures skipped: no display" in caplog.text
    assert "test eval figures skipped: no display" in caplog.text
    assert trainer.writer.figures == {} and "Mean Chamfer Dist/train" in trainer.writer.scalars


def test_null_writer_takes_figures():
    fig = plt.figure()
    assert _NullWriter().add_figure("tag", fig, global_step=1) is None
    plt.close(fig)
