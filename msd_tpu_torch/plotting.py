"""Figure helpers for TensorBoard and offline analysis (counterpart of
``msd_tpu/plotting.py``; every function keeps its name, arguments and
return value, except ``plot_lat_interpolation``, which takes no ``params``:
a torch module holds its own weights).

Behavioral ports of the load-bearing pieces of deep_sdf/plotting.py (799
LoC): training-stat curves (:55-76), Chamfer-distance violin plots with
percentile annotations (:78-126), SDF cross-sections (:359-391), latent
t-SNE manifolds (:672-751), and latent interpolation strips (:753-799).

Offscreen mesh rendering: ``pyrender_helper`` (same name/signature as the
reference's, ref plotting.py:127-146) renders shaded color+depth images
through the native C++ rasterizer (msd_tpu_torch/render.py — no
pyrender/EGL needed); ``render_mesh`` keeps the matplotlib trisurf variant
for axes embedded in figure grids.

matplotlib is the port's optional dependency for figures: this module
imports it, and its callers import this module only where they draw (the
trainers' eval hooks, the figure CLIs). The t-SNE of
``plot_manifold_tsne`` is ``msd_tpu_torch.manifold.tsne`` (scikit-learn's
algorithm written out, with the exact gradient).
"""

from __future__ import annotations

import logging
import time
import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from msd_tpu_torch.render import pyrender_helper  # noqa: F401,E402  (reference-name re-export)


def plot_train_stats(loss_hists, psnr_hist=None, step_hist=None, labels=None, save_path=""):
    """Loss curves for multiple runs (ref: plotting.py:55-76)."""
    fig, ax = plt.subplots(1, 1)
    ax.set_xlabel("Iterations")
    ax.set_ylabel("Loss")
    for i, hist in enumerate(loss_hists):
        xs = step_hist if step_hist is not None else np.arange(len(hist))
        label = labels[i] if labels else f"run {i}"
        ax.plot(xs[: len(hist)], hist, label=label)
    ax.set_yscale("log")
    ax.legend(loc="upper right", fontsize="small")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig


def plot_dist_violin(data: np.ndarray, percentile_keys=(50, 75, 90, 99)):
    """Violin plot of NN distances with percentile annotations
    (ref: plotting.py:78-126). Returns (fig, {percentile: value})."""
    start = time.time()
    colors = ["lightblue", "green", "orange", "purple", "lime"]
    fig, ax = plt.subplots(1, 1)
    ax.set_ylabel("Distance to NN")
    ax.set_title("Nearest Neighbor Distances (Two-way)")
    ax.set_xticks([])

    vplot = ax.violinplot(data, showmeans=False, showextrema=True)
    percentiles = {k: p for k, p in zip(percentile_keys, np.percentile(data, list(percentile_keys)))}
    for k, p in reversed(list(percentiles.items())):
        name = f"{k}th percentile" if k != 50 else "Median"
        ax.hlines([p], xmin=[0.9], xmax=[1.1], linestyles="--", colors=[colors.pop()], label=name)
        ax.annotate(f"{p:.4f}", xy=[1.1, p], va="center")
    ax.scatter(1, np.mean(data), marker="o", color="red", s=100, zorder=999, label="Mean (CD)")
    ax.legend(loc="upper left")
    for vp in vplot["bodies"]:
        vp.set_facecolor("cornflowerblue")
        vp.set_alpha(1)
    logging.debug("Plotting all chamfer distances took %.3fs", time.time() - start)
    return fig, percentiles


def render_mesh(verts: np.ndarray, faces: np.ndarray, cam_angles=(-np.pi / 7, np.pi / 4, 0), ax=None):
    """Offscreen mesh render via matplotlib trisurf (replaces
    pyrender_helper/render_mesh, ref: plotting.py:127-147, :318-335)."""
    created = ax is None
    if created:
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
    else:
        fig = ax.figure
    ax.plot_trisurf(
        verts[:, 0], verts[:, 1], faces, verts[:, 2],
        color="lightsteelblue", edgecolor="none", shade=True,
    )
    ax.view_init(elev=np.degrees(cam_angles[0]), azim=np.degrees(cam_angles[1]))
    ax.set_axis_off()
    ax.set_box_aspect((1, 1, 1))
    return fig


def render_sdf(points: np.ndarray, sdf: np.ndarray, cam_angles=(-np.pi / 7, np.pi / 4, 0)):
    """Scatter SDF samples colored by sign (ref: plotting.py:285-316)."""
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    inside = sdf < 0
    ax.scatter(*points[~inside].T, c=sdf[~inside], cmap="Reds_r", s=1, alpha=0.4)
    ax.scatter(*points[inside].T, c=sdf[inside], cmap="Blues", s=1, alpha=0.6)
    ax.view_init(elev=np.degrees(cam_angles[0]), azim=np.degrees(cam_angles[1]))
    return fig


def plot_sdf_cross_section(
    points: np.ndarray,
    sdf: np.ndarray,
    margin: float = 0.05,
    plane_orig=np.array([0.0, 0.0, 0.0]),
    plane_normal=np.array([1.0, 0.0, 0.0]),
    save_filepath: str = "",
    ax=None,
):
    """Scatter the SDF values of samples near a cutting plane
    (ref: plotting.py:359-391)."""
    plane_normal = np.asarray(plane_normal, float)
    plane_normal = plane_normal / np.linalg.norm(plane_normal)
    dist = (points - plane_orig) @ plane_normal
    mask = np.abs(dist) < margin
    # project points onto the two in-plane axes
    helper = np.array([0.0, 0.0, 1.0]) if abs(plane_normal[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(plane_normal, helper)
    u /= np.linalg.norm(u)
    v = np.cross(plane_normal, u)
    created = ax is None
    if created:
        fig, ax = plt.subplots(1, 1)
    else:
        fig = ax.figure
    p2 = (points[mask] - plane_orig) @ np.stack([u, v], axis=1)
    sc = ax.scatter(p2[:, 0], p2[:, 1], c=sdf[mask], cmap="seismic", vmin=-0.1, vmax=0.1, s=4)
    fig.colorbar(sc, ax=ax)
    ax.set_aspect("equal")
    if save_filepath:
        fig.savefig(save_filepath, bbox_inches="tight")
    return fig


def plot_mesh_comparison(rows, angles=None, annotate=None):
    """Grid of rendered meshes: one row per (name, [(verts, faces) | None,
    ...]) entry, one column per mesh, rendered from ``angles[0]``.
    The lightweight building block behind plot_reconstruction_comparison,
    also used by the trainer eval hooks (GT vs reconstruction)."""
    angles = angles or [(-np.pi / 7, np.pi / 4, 0)]
    nrows = len(rows) * len(angles)
    ncols = max(len(meshes) for _, meshes in rows)
    fig = plt.figure(figsize=(2.2 * ncols, 2.2 * nrows))
    for r, (name, meshes) in enumerate(rows):
        for a, ang in enumerate(angles):
            for c, m in enumerate(meshes):
                ax = fig.add_subplot(
                    nrows, ncols, (r * len(angles) + a) * ncols + c + 1, projection="3d"
                )
                if m is not None and m is not False:
                    render_mesh(np.asarray(m[0]), np.asarray(m[1]), cam_angles=ang, ax=ax)
                ax.set_axis_off()
                if a == 0 and c == 0:
                    ax.set_title(name, fontsize=9)
                if annotate and a == 0:
                    note = annotate.get((name, c))
                    if note:
                        ax.text2D(0.0, 0.0, note, transform=ax.transAxes, fontsize=7)
    return fig


def plot_reconstruction_comparison(
    experiment_dirs,
    shape_ids,
    chckpt=2000,
    dataset_name="dataset",
    class_name="",
    gt_mesh_dir=None,
    gt_ext=".obj",
    angle_num=3,
    suffix="",
    save=True,
):
    """Reconstructions of the same shapes across experiments, plus GT, with
    per-mesh Chamfer annotations (ref: plotting.py:148-277; rendering via
    matplotlib trisurf instead of pyrender/EGL).

    ``experiment_dirs``: {name: exp_dir} whose
    Reconstructions/<ckpt>/Meshes/<dataset>/<class>/<id>.ply exist.
    """
    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch.data.mesh_io import load_mesh
    from msd_tpu_torch.metrics.chamfer import compute_mesh_chamfer

    angles = [
        (-np.pi / 2, 0, 0),               # birds-eye view
        (-np.pi / 4, 3 * np.pi / 4, 0),   # upper-left
        (0, 3 * np.pi / 4, 0),            # center-left
    ][: max(1, angle_num)]

    rows, annotate = [], {}
    for shape_id in shape_ids:
        meshes = []
        gt = None
        if gt_mesh_dir:
            gt_path = _first_existing(
                [f"{gt_mesh_dir}/{shape_id}{ext}" for ext in (gt_ext, ".obj", ".ply")]
            )
            if gt_path:
                gt = load_mesh(gt_path)
        meshes.append(gt)
        for c, (name, exp_dir) in enumerate(experiment_dirs.items()):
            path = _first_existing([
                ws.get_reconstructed_mesh_filename(exp_dir, chckpt, dataset_name, class_name, shape_id),
                f"{exp_dir}/{class_name}/{shape_id}.ply" if class_name else f"{exp_dir}/{shape_id}.ply",
            ])
            if path is None:
                logging.error("reconstruction missing for %s in %s", shape_id, exp_dir)
                meshes.append(None)
                continue
            m = load_mesh(path)
            meshes.append(m)
            if gt is not None:
                try:
                    cd, _ = compute_mesh_chamfer(gt, m)
                    annotate[(shape_id, c + 1)] = f"CD={cd:.6f}"
                except Exception as exc:
                    logging.warning("chamfer failed for %s: %s", shape_id, exc)
        rows.append((shape_id, meshes))

    fig = plot_mesh_comparison(rows, angles=angles, annotate=annotate)
    # column titles: GT + experiment names (ref layout)
    for c, title in enumerate(["GT"] + list(experiment_dirs.keys())):
        fig.axes[c].set_title(title, fontsize=9)
    if save:
        savepath = f"reconstruction_comparison{'_' + suffix if suffix else ''}.pdf"
        fig.savefig(savepath, bbox_inches="tight")
        logging.info("saved %s", savepath)
    return fig


def _first_existing(paths):
    import os

    for p in paths:
        if p and os.path.exists(p):
            return p
    return None


def render_sdf_vid(points: np.ndarray, sdf: np.ndarray, fps=2, n_seconds=5, save_filepath=""):
    """SDF scatter rotated a quarter turn over the video
    (ref: plotting.py:337-357). Saves .mp4 when ffmpeg is available, else
    .gif via Pillow; returns the animation object."""
    from matplotlib import animation

    fig = plt.figure(figsize=(8, 8))

    frames = []
    n_frames = n_seconds * fps
    for i in range(n_frames):
        rot = (np.pi / 2 * i) / n_frames
        frames.append((-np.pi / 7, np.pi / 4 + rot, 0))

    ax = fig.add_subplot(111, projection="3d")

    def animate_func(i):
        ax.clear()
        inside = sdf < 0
        ax.scatter(*points[~inside].T, c=sdf[~inside], cmap="Reds_r", s=1, alpha=0.4)
        ax.scatter(*points[inside].T, c=sdf[inside], cmap="Blues", s=1, alpha=0.6)
        ax.view_init(elev=np.degrees(frames[i][0]), azim=np.degrees(frames[i][1]))
        return []

    anim = animation.FuncAnimation(fig, animate_func, frames=n_frames, interval=1000 / fps)
    if save_filepath:
        try:
            anim.save(save_filepath + ".mp4", fps=fps, extra_args=["-vcodec", "libx264"])
        except Exception:
            anim.save(save_filepath + ".gif", fps=fps, writer="pillow")
    return anim


def plot_binary_vs_continuous(df, binary: str, continuous: str):
    """Loss vs a categorical variable (ref: plotting.py:278-283)."""
    fig, ax = plt.subplots(1, 2, figsize=(12, 4))
    df.plot(x=binary, y=continuous, kind="bar", ax=ax[0])
    df.groupby(binary)[continuous].mean().plot(kind="bar", ax=ax[1])
    return fig


def plot_capacity_vs_chamfer_dist(
    exp_dirs_net_capacity=None,
    exp_dirs_lat_capacity=None,
    checkpoint: int = 2000,
    plot_means: bool = False,
    add_title: bool = True,
):
    """Model capacity (decoder parameter count / latent size) vs Chamfer
    distance across experiments (ref: plotting.py:393-671). Reads each
    experiment's specs.json for the capacity axis and its
    Evaluation/<ckpt>/chamfer.csv (semicolon CSV, ``chamfer_dist`` column)
    for the quality axis. A decoder's parameter count is the number of its
    torch parameters, which equals ``msd_tpu``'s ``num_params`` of its
    initialised pytree (weight-normed layers count their ``g`` too)."""
    import csv
    import os

    import msd_tpu_torch.workspace as ws
    from msd_tpu_torch.models import build_decoder

    def read_cd(exp_dir):
        path = os.path.join(ws.get_evaluation_dir(exp_dir, str(checkpoint)), "chamfer.csv")
        with open(path) as f:
            rows = list(csv.DictReader(f, delimiter=";"))
        vals = np.array([float(r["chamfer_dist"]) for r in rows])
        return float(vals.mean()), float(np.median(vals))

    groups = {}
    for name, exp_dirs in (("net", exp_dirs_net_capacity), ("lat", exp_dirs_lat_capacity)):
        if not exp_dirs:
            continue
        xs, means, medians = [], [], []
        for exp_dir in exp_dirs:
            specs = ws.load_experiment_specifications(exp_dir)
            if name == "net":
                decoder = build_decoder(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"])
                xs.append(sum(p.numel() for p in decoder.parameters()))
            else:
                xs.append(specs["CodeLength"])
            cd_mean, cd_median = read_cd(exp_dir)
            means.append(cd_mean)
            medians.append(cd_median)
        order = np.argsort(xs)
        groups[name] = (np.asarray(xs)[order], np.asarray(means)[order], np.asarray(medians)[order])

    if not groups:
        raise ValueError("NO EXPERIMENT DIRS GIVEN")
    fig, axes = plt.subplots(1, len(groups), figsize=(7 * len(groups), 5), sharey=True, squeeze=False)
    labels = {"net": "No. of Network Parameters", "lat": "Latent Code Length"}
    for ax, (name, (xs, means, medians)) in zip(axes[0], groups.items()):
        ax.plot(xs, means if plot_means else medians, marker="o")
        ax.set_xlabel(labels[name])
        ax.set_xscale("log")
        ax.set_yscale("log")
        if add_title:
            ax.set_title(f"{labels[name]} vs. Reconstruction Quality")
    axes[0][0].set_ylabel("Chamfer Distance" + (" (mean)" if plot_means else " (median)"))
    return fig


def plot_manifold_tsne(latents: np.ndarray, labels=None, perplexity: float = 30.0, seed: int = 0):
    """2-D t-SNE of latent codes (ref: plotting.py:672-751), computed by
    ``manifold.tsne`` on the latents' device (a tensor's, else the CPU).
    ``seed`` keeps ``msd_tpu``'s signature; t-SNE's PCA start draws no
    random numbers."""
    from msd_tpu_torch import manifold

    perplexity = min(perplexity, max(2.0, (latents.shape[0] - 1) / 3.0))
    emb = manifold.tsne(latents, perplexity=perplexity)
    fig, ax = plt.subplots(1, 1)
    if labels is not None:
        sc = ax.scatter(emb[:, 0], emb[:, 1], c=np.asarray(labels, float), cmap="coolwarm", s=12)
        fig.colorbar(sc, ax=ax)
    else:
        ax.scatter(emb[:, 0], emb[:, 1], s=12)
    ax.set_title("Latent manifold (t-SNE)")
    return fig


def plot_lat_interpolation(decoder, latent_a, latent_b, steps: int = 5, N: int = 97, create_mesh_fn=None):
    """Latent lerp -> mesh -> rendered strip (ref: plotting.py:753-799).
    Each latent is meshed by ``create_mesh_fn(decoder, latent, N=N,
    return_mesh=True)``, by default the port's ``create_mesh`` through one
    ``PointEvaluator`` for the whole strip (K1 on the card)."""
    import torch

    from msd_tpu_torch import mesh as mesh_mod

    if create_mesh_fn is None:
        evaluator = mesh_mod.mesh_evaluator(decoder, N)

        def create_mesh_fn(decoder, latent, **kw):
            return mesh_mod.create_mesh(decoder, latent, evaluator=evaluator, **kw)

    device = next(decoder.parameters()).device
    fig = plt.figure(figsize=(3 * steps, 3))
    for i, t in enumerate(np.linspace(0.0, 1.0, steps)):
        lat = (1 - t) * np.asarray(latent_a) + t * np.asarray(latent_b)
        res = create_mesh_fn(decoder, torch.as_tensor(lat, dtype=torch.float32, device=device), N=N,
                             return_mesh=True)
        ax = fig.add_subplot(1, steps, i + 1, projection="3d")
        if res is not None and res is not False:
            render_mesh(res[0], res[1], ax=ax)
        ax.set_title(f"t={t:.2f}")
    return fig
