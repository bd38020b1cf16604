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


def save_experiment_specifications(experiment_directory, specs):
    os.makedirs(experiment_directory, exist_ok=True)
    with open(os.path.join(experiment_directory, specifications_filename), "w") as f:
        json.dump(specs, f, indent=2)


def _subdir(experiment_directory, name, create_if_nonexistent):
    d = os.path.join(experiment_directory, name)
    if create_if_nonexistent:
        os.makedirs(d, exist_ok=True)
    return d


def get_model_params_dir(experiment_directory, create_if_nonexistent=False):
    return _subdir(experiment_directory, model_params_subdir, create_if_nonexistent)


def get_optimizer_params_dir(experiment_directory, create_if_nonexistent=False):
    return _subdir(experiment_directory, optimizer_params_subdir, create_if_nonexistent)


def get_latent_codes_dir(experiment_directory, create_if_nonexistent=False):
    return _subdir(experiment_directory, latent_codes_subdir, create_if_nonexistent)


def get_tensorboard_dir(experiment_directory, create_if_nonexistent=False):
    return _subdir(experiment_directory, tensorboard_subdir, create_if_nonexistent)


def get_logs_filename(experiment_directory):
    return os.path.join(experiment_directory, logs_filename)


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


def get_reconstructed_code_filename(experiment_directory, epoch, dataset, class_name, instance_name):
    return os.path.join(
        experiment_directory,
        reconstructions_subdir,
        str(epoch),
        reconstruction_codes_subdir,
        dataset,
        class_name,
        instance_name + ".pth",
    )


def get_data_source_map_filename(data_dir):
    return os.path.join(data_dir, data_source_map_filename)


def get_normalization_params_filename(data_dir, dataset_name, class_name, instance_name):
    return os.path.join(
        data_dir, normalization_param_subdir, dataset_name, class_name, instance_name + ".npz"
    )


def get_surface_samples_filename(data_dir, dataset_name, class_name, instance_name):
    return os.path.join(
        data_dir, surface_samples_subdir, dataset_name, class_name, instance_name + ".ply"
    )


def get_sdf_samples_filename(data_dir, dataset_name, class_name, instance_name):
    return os.path.join(
        data_dir, sdf_samples_subdir, dataset_name, class_name, instance_name + ".npz"
    )


# ---------------------------------------------------------------------------
# Model and latent loaders (msd_tpu/workspace.py:180-204; ref:
# deep_sdf/workspace.py:40-115): thin wrappers over the registry and the
# checkpoint module, for reference-style call sites.


def build_decoder(experiment_directory, experiment_specifications=None):
    """The experiment's decoder, built from its specs (ref:
    deep_sdf/workspace.py:56-66), on the CPU with fresh weights."""
    from msd_tpu_torch.models import build_decoder as _build

    specs = experiment_specifications or load_experiment_specifications(experiment_directory)
    return _build(specs["NetworkArch"], specs["CodeLength"], specs["NetworkSpecs"])


def load_decoder(experiment_directory, checkpoint, experiment_specifications=None):
    """Returns (decoder, epoch): the experiment's decoder with
    ``ModelParameters/<checkpoint>.pth`` loaded, on the CPU (ref:
    deep_sdf/workspace.py:69-80). ``msd_tpu``'s returns (decoder, params,
    epoch) because a JAX decoder holds no weights; a torch module holds its
    own, so there is no params entry."""
    from msd_tpu_torch.utils.checkpoint import load_model

    decoder = build_decoder(experiment_directory, experiment_specifications)
    epoch = load_model(experiment_directory, checkpoint, decoder)
    return decoder, epoch


def load_latent_vectors(experiment_directory, checkpoint):
    """The [S, L] float32 latent table of a checkpoint as a numpy array, from
    the Embedding state dict or the legacy [S, 1, L] tensor (ref:
    deep_sdf/workspace.py:83-115)."""
    from msd_tpu_torch.utils.checkpoint import load_latent_vectors as _load

    table, _epoch = _load(experiment_directory, str(checkpoint) + ".pth")
    return table.numpy()
