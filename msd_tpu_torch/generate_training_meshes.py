"""Mesh every training latent of an experiment.

``python -m msd_tpu_torch.generate_training_meshes -e <exp> [-c <ckpt>]
[-k] [--resolution N]`` takes the flags of the root
``generate_training_meshes.py`` (ref: generate_training_meshes.py:14-140)
plus ``--device`` (default ``cuda``; ``cpu`` runs on the CPU, and asking
for ``cuda`` without a GPU raises). Latent i of ``LatentCodes/<ckpt>.pth``
is meshed with ``create_mesh`` (K1 on the card) to
``TrainingMeshes/<epoch>/<dataset>/<class>/<instance>.ply``, the i-th
instance of the specs' ``TrainSplit``; unless ``-k``, its vertices are
taken back to the instance's own frame with the offset and scale of
``NormalizationParameters/<dataset>/<class>/<instance>.npz`` under the
``DataSource``, where that file exists.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

import msd_tpu_torch.workspace as ws
from msd_tpu_torch import mesh
from msd_tpu_torch.data.splits import get_instance_filenames, load_split
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.utils import add_common_args, configure_logging


def code_to_mesh(experiment_directory, checkpoint, keep_normalized=False, resolution=256, device="cuda"):
    """Mesh every training latent (see the module's docstring). Returns one
    summary per instance: its name, the PLY path, whether an offset and
    scale were applied, and the seconds ``create_mesh`` took."""
    dev = resolve_device(device)
    specs = ws.load_experiment_specifications(experiment_directory)
    decoder, saved_model_epoch = ws.load_decoder(experiment_directory, checkpoint, specs)
    decoder = decoder.to(dev).eval()
    latent_vectors = ws.load_latent_vectors(experiment_directory, checkpoint)

    data_source = specs["DataSource"]
    instance_filenames = get_instance_filenames(data_source, load_split(specs["TrainSplit"]))
    logging.info("%d instances vs %d latents", len(instance_filenames), len(latent_vectors))

    evaluator = mesh.mesh_evaluator(decoder, resolution)
    summary = []
    for i, latent_vector in enumerate(latent_vectors):
        parts = instance_filenames[i].split("/")
        instance_name = os.path.splitext(parts[-1])[0]
        dataset_name = parts[-3] if len(parts) >= 3 else ""
        class_name = parts[-2] if len(parts) >= 2 else ""
        mesh_dir = os.path.join(experiment_directory, ws.training_meshes_subdir, str(saved_model_epoch),
                                dataset_name, class_name)
        os.makedirs(mesh_dir, exist_ok=True)
        mesh_filename = os.path.join(mesh_dir, instance_name)

        offset = scale = None
        if not keep_normalized:
            norm_file = ws.get_normalization_params_filename(data_source, dataset_name, class_name, instance_name)
            if os.path.isfile(norm_file):
                normalization_params = np.load(norm_file)
                offset = normalization_params["offset"]
                scale = normalization_params["scale"]

        t0 = time.time()
        mesh.create_mesh(decoder, torch.from_numpy(latent_vector), mesh_filename, N=resolution,
                         max_batch=int(2**18), offset=offset, scale=scale, evaluator=evaluator)
        summary.append({"instance": instance_name, "path": mesh_filename + ".ply",
                        "normalized_back": offset is not None or scale is not None, "seconds": time.time() - t0})
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="Use a trained DeepSDF decoder to generate a mesh given a latent code.")
    p.add_argument("--experiment", "-e", dest="experiment_directory", required=True)
    p.add_argument("--checkpoint", "-c", dest="checkpoint", default="latest")
    p.add_argument("--keep_normalized", "-k", dest="keep_normalized", action="store_true")
    p.add_argument("--resolution", dest="resolution", type=int, default=256)
    p.add_argument("--device", dest="device", default="cuda", help="cuda (default) or cpu")
    add_common_args(p)
    args = p.parse_args(argv)
    configure_logging(args)
    return code_to_mesh(args.experiment_directory, args.checkpoint, args.keep_normalized, args.resolution,
                        args.device)


if __name__ == "__main__":
    main()
