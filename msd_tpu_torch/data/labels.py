"""Per-shape label files (counterpart of ``msd_tpu/data/labels.py``).

The reference stores labels as ``labels.pt``, a torch-saved dict
``{instance_id: tensor}`` next to the SdfSamples (ref: deep_sdf/data.py
:231-263); ``.npz`` and ``.json`` hold the same map.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch


def load_labels(labels_path: str) -> dict:
    """Load an id -> float32 vector map from .pt/.pth, .npz or .json."""
    if not os.path.isfile(labels_path):
        raise FileNotFoundError(f"labels file not found: {labels_path}")
    ext = os.path.splitext(labels_path)[1].lower()
    if ext in (".pt", ".pth"):
        raw = torch.load(labels_path, map_location="cpu", weights_only=False)
        return {
            k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v, np.float32).reshape(-1)
            for k, v in raw.items()
        }
    if ext == ".npz":
        npz = np.load(labels_path)
        return {k: np.asarray(npz[k], np.float32).reshape(-1) for k in npz.files}
    if ext == ".json":
        with open(labels_path) as f:
            raw = json.load(f)
        return {k: np.asarray(v, np.float32).reshape(-1) for k, v in raw.items()}
    raise ValueError(f"unsupported labels file format: {labels_path}")


def save_labels(labels_path: str, label_map: dict):
    ext = os.path.splitext(labels_path)[1].lower()
    if ext in (".pt", ".pth"):
        torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in label_map.items()}, labels_path)
    elif ext == ".npz":
        np.savez(labels_path, **{k: np.asarray(v) for k, v in label_map.items()})
    elif ext == ".json":
        with open(labels_path, "w") as f:
            json.dump({k: np.asarray(v).tolist() for k, v in label_map.items()}, f)
    else:
        raise ValueError(f"unsupported labels file format: {labels_path}")
    logging.debug("saved %d labels to %s", len(label_map), labels_path)


def labels_for_instances(label_map: dict, instance_ids, warn_missing: bool = True) -> np.ndarray:
    """[S, L] float32 label matrix for ``instance_ids``, with the
    reference's ``_femur`` suffix fallback and NaN for missing ids (ref:
    deep_sdf/data.py:239-283)."""
    first = np.asarray(next(iter(label_map.values()))).reshape(-1)
    out = np.full((len(instance_ids), first.shape[0]), np.nan, dtype=np.float32)
    for i, iid in enumerate(instance_ids):
        key = iid
        if key not in label_map and key.endswith("_femur"):
            key = key[:-6]
        if key in label_map:
            out[i] = np.asarray(label_map[key], np.float32).reshape(-1)
        elif warn_missing:
            logging.warning("Missing label for %s", iid)
    return out
