"""Offline Chamfer evaluation of reconstructions vs GT surface samples.

Behavioral port of evaluate.py:17-97: for each (dataset, class, instance) in
a nested split, load Reconstructions/<ckpt>/Meshes/<...>.ply and
SurfaceSamples/<...>.ply, un-normalize with NormalizationParameters, compute
(chamfer, 90/95th percentiles, normal consistency), and write a
semicolon-separated CSV under Evaluation/<ckpt>/.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

import msd_tpu_torch.workspace as ws
from msd_tpu_torch.data.mesh_io import load_ply
from msd_tpu_torch.metrics import mesh_normal_consistency
from msd_tpu_torch.metrics.chamfer import compute_mesh_chamfer


def evaluate(experiment_directory, checkpoint, data_dir, split_filename, curvature_sampling=0.0):
    with open(split_filename) as f:
        split = json.load(f)

    chamfer_results = []
    items = []
    if isinstance(split, dict):
        for dataset in split:
            for class_name in split[dataset]:
                for instance_name in split[dataset][class_name]:
                    items.append((dataset, class_name, os.path.splitext(instance_name)[0]))
    else:
        items = [("", "", os.path.splitext(n)[0]) for n in split]

    for dataset, class_name, instance_name in items:
        checkpoint_ = f"{checkpoint}_on_train_set" if "train" in split_filename else checkpoint
        reconstructed_mesh_filename = ws.get_reconstructed_mesh_filename(
            experiment_directory, checkpoint_, dataset, class_name, instance_name
        )
        if not os.path.isfile(reconstructed_mesh_filename):
            # reconstruct.py writes flat basenames under Meshes/
            flat = os.path.join(
                experiment_directory, ws.reconstructions_subdir, str(checkpoint_),
                ws.reconstruction_meshes_subdir, instance_name + ".ply",
            )
            if os.path.isfile(flat):
                reconstructed_mesh_filename = flat
            else:
                logging.warning("missing reconstruction %s", reconstructed_mesh_filename)
                continue

        ground_truth_samples_filename = os.path.join(
            data_dir, ws.surface_samples_subdir, dataset, class_name, instance_name + ".ply"
        )
        normalization_params_filename = os.path.join(
            data_dir, ws.normalization_param_subdir, dataset, class_name, instance_name + ".npz"
        )
        if not os.path.isfile(ground_truth_samples_filename):
            # flat splits don't carry the data-source subdir; search for the
            # instance under SurfaceSamples/*/
            import glob as _glob

            hits = _glob.glob(
                os.path.join(data_dir, ws.surface_samples_subdir, "**", instance_name + ".ply"),
                recursive=True,
            )
            if hits:
                ground_truth_samples_filename = hits[0]
                rel = os.path.relpath(
                    os.path.dirname(hits[0]), os.path.join(data_dir, ws.surface_samples_subdir)
                )
                normalization_params_filename = os.path.join(
                    data_dir, ws.normalization_param_subdir, rel, instance_name + ".npz"
                )
        if not os.path.isfile(ground_truth_samples_filename):
            logging.warning("missing GT surface samples %s", ground_truth_samples_filename)
            continue

        gt_points, _ = load_ply(ground_truth_samples_filename)
        reconstruction = load_ply(reconstructed_mesh_filename)

        if os.path.isfile(normalization_params_filename):
            normalization_params = np.load(normalization_params_filename)
            offset = normalization_params["offset"]
            scale = normalization_params["scale"]
        else:
            offset, scale = None, None

        chamfer_dist, all_dists = compute_mesh_chamfer(
            gt_points, reconstruction, offset, scale, curvature_sampling=curvature_sampling
        )
        percentiles = np.percentile(all_dists, [90, 95])
        normal_consistency = mesh_normal_consistency(*reconstruction)
        logging.debug("chamfer distance: %s", chamfer_dist)
        chamfer_results.append(
            (
                os.path.join(dataset, class_name, instance_name),
                (chamfer_dist, percentiles),
                normal_consistency,
            )
        )

    output_filename = os.path.join(
        ws.get_evaluation_dir(experiment_directory, checkpoint, True), "chamfer"
    )
    output_filename += "_on_train_set" if "train" in split_filename else ""
    output_filename += ".csv" if curvature_sampling == 0.0 else f"_{curvature_sampling:.3f}_curvature.csv"
    logging.info(output_filename)
    with open(output_filename, "w") as f:
        f.write("shape;chamfer_dist;90th_percentile;95th_percentile;normal_consistency\n")
        for result in chamfer_results:
            f.write(
                "{};{};{};{};{}\n".format(
                    result[0], result[1][0], result[1][1][0], result[1][1][1], result[2]
                )
            )
    return chamfer_results
