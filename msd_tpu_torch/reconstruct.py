"""Reconstruct shapes from SDF samples with a trained decoder.

``python -m msd_tpu_torch.reconstruct -e <exp> -c <ckpt> -d <data> -s <split>``
takes the flags of the root ``reconstruct.py`` (ref: reconstruct.py:154-357)
plus ``--device`` (default ``cuda``; ``cpu`` runs on the CPU, and asking
for ``cuda`` without a GPU raises). For each shape of the split it fits a
latent (``train/reconstruct.py``), meshes it with ``create_mesh`` and
writes ``Reconstructions/<epoch>/Meshes/<id>.ply`` and
``Reconstructions/<epoch>/Codes/<id>.pth`` (the latent as a [1, 1, L]
tensor).

``--batch N`` fits N shapes at once. Over ranks (``main(argv, group=)``,
or ``torchrun --nproc_per_node=<cards> -m msd_tpu_torch.reconstruct
--batch N ...``, which joins the group ``torchrun`` describes: NCCL, one
card per rank) each rank fits its slice of every batch
(``reconstruct_batch(group=)``), as ``msd_tpu`` shards the batched fit
over every visible device. The meshing after the fit runs on the main
rank alone, with no group: it writes every file and returns the summary;
the other ranks write nothing and return an empty list. The one-at-a-time
branch takes no group.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random

import numpy as np
import torch

import msd_tpu_torch.workspace as ws
from msd_tpu_torch import mesh
from msd_tpu_torch.data.sdf_samples import read_sdf_samples, remove_nans
from msd_tpu_torch.data.splits import get_instance_filenames
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.ops import fused_mlp
from msd_tpu_torch.parallel import init_group_from_env
from msd_tpu_torch.train.reconstruct import reconstruct, reconstruct_batch
from msd_tpu_torch.utils import add_common_args, configure_logging
from msd_tpu_torch.utils import checkpoint as ckpt
from msd_tpu_torch.utils import spans

# SDF samples drawn for each shape in each fit iteration
NUM_SAMPLES = 8000


def _parser():
    p = argparse.ArgumentParser(
        description="Use a trained DeepSDF decoder to reconstruct a shape given SDF samples."
    )
    p.add_argument("--experiment", "-e", dest="experiment_directory", required=True)
    p.add_argument("--checkpoint", "-c", dest="checkpoint", default="latest")
    p.add_argument("--data", "-d", dest="data_source", required=True)
    p.add_argument("--split", "-s", dest="split_filename", required=True)
    p.add_argument("--iters", dest="iterations", default=800)
    p.add_argument("--mesh_resolution", dest="mesh_resolution", type=int, default=256)
    p.add_argument("--skip", dest="skip", action="store_true", help="Skip shapes already reconstructed.")
    p.add_argument(
        "--batch", dest="batch_size", type=int, default=0,
        help="Fit this many shapes at once (0 = one at a time, the reference's behavior).",
    )
    p.add_argument("--device", dest="device", default="cuda", help="cuda (default) or cpu")
    add_common_args(p)
    return p


def main(argv=None, group=None):
    """Run the CLI; returns one summary dict per reconstructed shape
    (losses, phase times, points evaluated, mesh size, K1 launches). The
    times are the program's spans (``utils/spans.py``): ``t_reconstruct``
    the ``fit`` span (a ``--batch`` fit's over its shapes), ``t_mesh`` the
    ``mesh.create_mesh`` span.

    ``group``: a ``DataParallelGroup`` to fit ``--batch`` over (each rank
    on ``group.device``; see the module's docstring). Without one, a
    process that ``torchrun`` started with ``WORLD_SIZE`` above 1 joins
    the group from the environment, on ``--device``, and leaves it at the
    end."""
    args = _parser().parse_args(argv)
    configure_logging(args)
    own_group = group is None and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if own_group:
        group = init_group_from_env(resolve_device(args.device))
    try:
        return _run(args, group)
    finally:
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, group):
    if group is not None and args.batch_size <= 1:
        raise ValueError("reconstruct: a group fits --batch N (N > 1) only; the one-at-a-time branch "
                         "runs in one process, as msd_tpu shards only --batch")
    device = resolve_device(args.device if group is None else group.device)
    main_rank = group is None or group.is_main

    specs = ws.load_experiment_specifications(args.experiment_directory)
    latent_size = specs["CodeLength"]
    decoder = build_decoder(specs["NetworkArch"], latent_size, specs["NetworkSpecs"])
    saved_model_epoch = ckpt.load_model(args.experiment_directory, args.checkpoint, decoder)
    decoder = decoder.to(device).eval()
    evaluator = mesh.PointEvaluator(decoder)
    if mesh._streams(evaluator):
        evaluator.warm_stream(mesh._snap_n(args.mesh_resolution))

    with open(args.split_filename) as f:
        split = json.load(f)
    npz_filenames = get_instance_filenames(args.data_source, split)
    random.shuffle(npz_filenames)

    dirname = str(saved_model_epoch)
    if "train" in args.split_filename:
        dirname += "_on_train_set"
    reconstruction_dir = os.path.join(args.experiment_directory, ws.reconstructions_subdir, dirname)
    meshes_dir = os.path.join(reconstruction_dir, ws.reconstruction_meshes_subdir)
    codes_dir = os.path.join(reconstruction_dir, ws.reconstruction_codes_subdir)
    if main_rank:
        os.makedirs(meshes_dir, exist_ok=True)
        os.makedirs(codes_dir, exist_ok=True)

    work = []
    for npz in npz_filenames:
        if "npz" not in npz or not os.path.isfile(npz):
            continue
        mesh_filename = os.path.join(meshes_dir, os.path.basename(npz)[:-4])
        latent_filename = os.path.join(codes_dir, os.path.basename(npz)[:-4] + ".pth")
        if args.skip and os.path.isfile(mesh_filename + ".ply") and os.path.isfile(latent_filename):
            continue
        work.append((npz, mesh_filename, latent_filename))
    if group is not None:  # every rank fits the main rank's shapes, in its order
        work = group.broadcast_object(work)

    summary = []

    def save_outputs(npz, hist, t_fit, latent, mesh_filename, latent_filename):
        launches0, evaluated0 = fused_mlp.LAUNCHES, evaluator.n_evaluated
        res = mesh.create_mesh(
            decoder, latent, mesh_filename, N=args.mesh_resolution, max_batch=int(2**18),
            return_mesh=True, evaluator=evaluator,
        )
        t_mesh = spans.last("mesh.create_mesh").seconds
        torch.save(latent.detach().cpu().reshape(1, -1)[None, ...].clone(), latent_filename)
        n = mesh._snap_n(args.mesh_resolution)
        k = max(1, len(hist) // 10)
        summary.append({
            "shape": os.path.basename(npz)[:-4],
            "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
            "loss_first_tenth": float(np.mean(hist[:k])), "loss_last_tenth": float(np.mean(hist[-k:])),
            "t_reconstruct": t_fit, "t_mesh": t_mesh,
            "n_evaluated": evaluator.n_evaluated - evaluated0, "n_grid": n**3,
            "verts": int(res[0].shape[0]) if res else 0, "faces": int(res[1].shape[0]) if res else 0,
            "k1_launches": fused_mlp.LAUNCHES - launches0,
            "streaming": dict(mesh.LAST_STREAMING_STATS) if mesh._streams(evaluator) else None,
        })
        logging.info("%s", json.dumps(summary[-1]))

    fit_kw = dict(num_samples=NUM_SAMPLES, lr=5e-3, l2reg=True, return_loss_hist=True)
    if args.batch_size > 1:
        for start_i in range(0, len(work), args.batch_size):
            batch = work[start_i : start_i + args.batch_size]
            shapes = []
            for npz, _, _ in batch:
                pos, neg = read_sdf_samples(npz)
                shapes.append((remove_nans(pos), remove_nans(neg)))
            hists, latents = reconstruct_batch(
                decoder, int(args.iterations), latent_size, shapes, 0.01, 0.1, group=group, **fit_kw
            )
            t_fit = spans.last("fit").seconds / len(batch)
            if not main_rank:
                continue
            for (npz, mesh_filename, latent_filename), hist, latent in zip(batch, hists, latents):
                save_outputs(npz, hist, t_fit, latent, mesh_filename, latent_filename)
    else:
        for npz, mesh_filename, latent_filename in work:
            logging.info("reconstructing %s", npz)
            pos, neg = read_sdf_samples(npz)
            hist, latent = reconstruct(
                decoder, int(args.iterations), latent_size, [remove_nans(pos), remove_nans(neg)],
                0.01, 0.1, **fit_kw,
            )
            save_outputs(npz, hist, spans.last("fit").seconds, latent, mesh_filename, latent_filename)
    return summary


if __name__ == "__main__":
    main()
