"""specs.json handling (a copy of ``msd_tpu/config.py``).

The reference drives every run from a single per-experiment ``specs.json``
with required keys plus a long tail of optional keys read through
``get_spec_with_default`` (ref: train_deep_sdf.py:191-195,217-296). The port
accepts the same raw JSON unchanged, with the same defaulting semantics.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

# Required Stage-1 keys (ref: train_deep_sdf.py:217-296).
STAGE1_REQUIRED_KEYS = (
    "DataSource",
    "TrainSplit",
    "NetworkArch",
    "NetworkSpecs",
    "CodeLength",
    "NumEpochs",
    "SnapshotFrequency",
    "LearningRateSchedule",
    "SamplesPerScene",
    "ScenesPerBatch",
    "ClampingDistance",
)


def get_spec_with_default(specs: Mapping[str, Any], key: str, default):
    """ref: train_deep_sdf.py:191-195."""
    try:
        return specs[key]
    except KeyError:
        return default


def resolve_spec_path(path, experiment_directory: str):
    """Resolve a spec-relative path (ref: train_MLP_VAE_deep_sdf.py:56-61):
    absolute paths pass through; a relative path is tried against the
    experiment directory, then taken as it is (the working directory)."""
    if path is None:
        return None
    path = os.path.expanduser(str(path))
    if os.path.isabs(path):
        return path
    candidate = os.path.join(experiment_directory, path)
    if os.path.exists(candidate):
        return candidate
    return path


def validate_stage1_specs(specs: Mapping[str, Any]):
    missing = [k for k in STAGE1_REQUIRED_KEYS if k not in specs]
    if missing:
        raise KeyError(f"specs.json missing required Stage-1 keys: {missing}")
    lrs = specs["LearningRateSchedule"]
    if not isinstance(lrs, (list, tuple)) or len(lrs) < 2:
        raise ValueError(
            "LearningRateSchedule must contain two dicts: [network, latent-codes]"
        )


# Reference keys that are deliberate no-ops: the data lives on the device
# (no DataLoader workers, nothing to page into RAM). They are accepted
# silently so raw reference specs run unchanged.
NOOP_KEYS = {
    "DataLoaderThreads": "device-resident data; no host DataLoader workers",
    "LoadDatasetIntoRAM": "dataset always lives in device memory",
    "LatentExportBatchSize": "latent export is one device program",
}


def note_noop_keys(specs: Mapping[str, Any]) -> None:
    """Log reference keys present in the spec that are accepted as no-ops
    (ref keys: train_deep_sdf.py:394-403, train_MLP_VAE_deep_sdf.py
    DataLoaderThreads/LoadDatasetIntoRAM/LatentExportBatchSize)."""
    for key, why in NOOP_KEYS.items():
        if key in specs:
            logging.info("spec key %s accepted but unused (%s)", key, why)
