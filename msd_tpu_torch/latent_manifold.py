"""Latent-space manifold plots (counterpart of the root
``latent_manifold.py``, the reference's run_HLLE_ICA_latent_space.ipynb):
HLLE / ICA / t-SNE / PCA 2-D embeddings of trained Stage-1 latents,
colored by a label when one is given.

``python -m msd_tpu_torch.latent_manifold -e <experiment_dir> [-c latest]
[--methods hlle ica tsne pca] [--labels_path labels.pt] [--label_index 0]
[--out_dir DIR] [--device cuda|cpu]`` writes
``<exp>/Evaluation/Manifold/latent_<method>.png`` and ``.npy``. The
embeddings are ``msd_tpu_torch.manifold``'s, which write out
scikit-learn's algorithms (the port does not import scikit-learn); t-SNE
runs on ``--device`` (default ``cuda``; asking for ``cuda`` without a GPU
raises), the others on the host. The PNGs need matplotlib.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

import msd_tpu_torch.workspace as ws
from msd_tpu_torch import manifold
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.utils import add_common_args, configure_logging


def embed(latents: np.ndarray, method: str, seed: int = 0, device="cpu") -> np.ndarray:
    """[S, L] -> [S, 2] embedding (the root script's ``embed``; t-SNE on
    ``device``, and ``seed`` seeds ICA and HLLE, as t-SNE's PCA start draws
    no random numbers)."""
    if method == "hlle":
        # HLLE needs n_neighbors > n_components * (n_components + 3) / 2
        n_neighbors = max(8, min(latents.shape[0] - 1, 12))
        return manifold.hessian_lle(latents, n_neighbors, n_components=2, seed=seed)
    if method == "ica":
        return manifold.fast_ica(latents, n_components=2, seed=seed, max_iter=1000)
    if method == "tsne":
        perplexity = min(30.0, max(2.0, latents.shape[0] / 4))
        return manifold.tsne(latents, perplexity=perplexity, device=device)
    if method == "pca":
        return manifold.pca(latents, n_components=2)
    raise ValueError(f"unknown embedding method {method!r}")


def main(argv=None):
    """Runs the CLI on ``argv``; returns {method: .npy path} for the
    embeddings written."""
    parser = argparse.ArgumentParser(description="latent manifold embeddings")
    parser.add_argument("--experiment", "-e", required=True)
    parser.add_argument("--checkpoint", "-c", default="latest")
    parser.add_argument("--methods", nargs="+", default=["hlle", "ica"],
                        choices=["hlle", "ica", "tsne", "pca"])
    parser.add_argument("--labels_path", default=None,
                        help="labels file (.pt/.npz/.json); colors points by a label")
    parser.add_argument("--label_index", type=int, default=0,
                        help="which label column to color by")
    parser.add_argument("--out_dir", default=None,
                        help="default: <experiment>/Evaluation/Manifold")
    parser.add_argument("--device", default="cuda", help="t-SNE's device: cuda (default) or cpu")
    add_common_args(parser)
    args = parser.parse_args(argv)
    configure_logging(args)
    dev = resolve_device(args.device)

    from msd_tpu_torch.utils import checkpoint as ckpt

    latents, epoch = ckpt.load_latent_vectors(args.experiment, args.checkpoint + ".pth")
    latents = np.asarray(latents.numpy(), np.float64)
    logging.info("loaded %d latents (dim %d) from epoch %s", *latents.shape, epoch)

    colors = None
    if args.labels_path:
        from msd_tpu_torch.data.labels import load_labels
        from msd_tpu_torch.data.splits import load_split, split_instance_ids

        specs = ws.load_experiment_specifications(args.experiment)
        ids = split_instance_ids(load_split(specs["TrainSplit"]))
        labels = load_labels(args.labels_path)
        if len(ids) == latents.shape[0]:
            colors = np.array([
                float(np.asarray(labels.get(iid, [np.nan])).reshape(-1)[args.label_index])
                for iid in ids
            ])
        else:
            logging.warning(
                "split has %d ids but %d latents (missing sample files at "
                "train time?) — skipping label coloring", len(ids), latents.shape[0],
            )

    out_dir = args.out_dir or os.path.join(args.experiment, ws.evaluation_subdir, "Manifold")
    os.makedirs(out_dir, exist_ok=True)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    written = {}
    for method in args.methods:
        try:
            emb = embed(latents, method, device=dev)
        except Exception as e:  # one method failing leaves the others' plots, as the root script
            logging.warning("%s embedding failed: %s", method, e)
            continue
        fig, ax = plt.subplots(figsize=(6, 5))
        sc = ax.scatter(emb[:, 0], emb[:, 1], c=colors, cmap="viridis", s=14)
        if colors is not None:
            fig.colorbar(sc, ax=ax, label=f"label[{args.label_index}]")
        ax.set_title(f"{method.upper()} embedding of Stage-1 latents (epoch {epoch})")
        path = os.path.join(out_dir, f"latent_{method}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)
        written[method] = os.path.join(out_dir, f"latent_{method}.npy")
        np.save(written[method], emb)
        logging.info("wrote %s", path)
    return written


if __name__ == "__main__":
    main()
