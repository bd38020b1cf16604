"""Experiment-directory contract (a copy of ``msd_tpu/workspace.py``'s
constants and path helpers).

Mirrors the reference workspace layout (ref: deep_sdf/workspace.py:8-201) so
experiments trained by either framework can be inspected by the same tooling:

    <experiment>/
        specs.json
        ModelParameters/<epoch>.pth
        OptimizerParameters/<epoch>.pth
        LatentCodes/<epoch>.pth
        Logs.pth
        TensorBoard/
        Reconstructions/<epoch>/{Meshes,Codes}/
        Evaluation/<epoch>/
        TrainingMeshes/<epoch>/

Dataset directories follow the same contract (ref: deep_sdf/workspace.py:16-24):

    <data_dir>/
        .datasources.json
        SdfSamples/<dataset>/<class>/<instance>.npz   {pos:[N,4], neg:[M,4]}
        SurfaceSamples/<dataset>/<class>/<instance>.ply
        NormalizationParameters/<dataset>/<class>/<instance>.npz {offset,scale}
"""

from __future__ import annotations

import json
import logging
import os

# Directory / file name constants (ref: deep_sdf/workspace.py:8-24).
model_params_subdir = "ModelParameters"
optimizer_params_subdir = "OptimizerParameters"
latent_codes_subdir = "LatentCodes"
logs_filename = "Logs.pth"
tb_logs_dir = "TensorBoard"
tb_logs_train_reconstructions = "ReconstructionsTrain"
tb_logs_test_reconstructions = "ReconstructionsTest"
reconstructions_subdir = "Reconstructions"
reconstruction_meshes_subdir = "Meshes"
reconstruction_codes_subdir = "Codes"
specifications_filename = "specs.json"
data_source_map_filename = ".datasources.json"
evaluation_subdir = "Evaluation"
sdf_samples_subdir = "SdfSamples"
surface_samples_subdir = "SurfaceSamples"
normalization_param_subdir = "NormalizationParameters"
training_meshes_subdir = "TrainingMeshes"
tensorboard_subdir = "TensorBoard"


def load_experiment_specifications(experiment_directory):
    """Load <experiment>/specs.json (ref: deep_sdf/workspace.py:27-37).

    ``MSD_SPEC_OVERRIDES`` (a JSON object in the environment) is merged
    over the loaded specs, top-level key by key. This is the documented
    smoke/CI facility for running a *stock* specs.json verbatim while
    shrinking only sizes/frequencies (NumEpochs, SamplesPerScene, eval
    frequencies, ...) — see README. It is
    intentionally env-based so every entry-point CLI honors it without
    growing flags the reference doesn't have."""
    filename = os.path.join(experiment_directory, specifications_filename)
    if not os.path.isfile(filename):
        raise Exception(
            f'The experiment directory ({experiment_directory}) does not include '
            f'specifications file "{specifications_filename}"'
        )
    with open(filename) as f:
        specs = json.load(f)
    overrides = os.environ.get("MSD_SPEC_OVERRIDES")
    if overrides:
        od = json.loads(overrides)
        logging.info(
            "applying MSD_SPEC_OVERRIDES to %s: %s",
            experiment_directory, sorted(od),
        )
        specs.update(od)
    return specs


def get_model_params_dir(experiment_directory, create_if_nonexistent=False):
    d = os.path.join(experiment_directory, model_params_subdir)
    if create_if_nonexistent:
        os.makedirs(d, exist_ok=True)
    return d


def get_evaluation_dir(experiment_directory, checkpoint, create_if_nonexistent=False):
    d = os.path.join(experiment_directory, evaluation_subdir, str(checkpoint))
    if create_if_nonexistent:
        os.makedirs(d, exist_ok=True)
    return d


def get_reconstructed_mesh_filename(experiment_directory, epoch, dataset, class_name, instance_name):
    """ref: deep_sdf/workspace.py path helpers."""
    return os.path.join(
        experiment_directory,
        reconstructions_subdir,
        str(epoch),
        reconstruction_meshes_subdir,
        dataset,
        class_name,
        instance_name + ".ply",
    )
