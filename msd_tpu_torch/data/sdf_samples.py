"""SDF sample files: the reference's ``.npz`` with float32 ``pos``/``neg``
arrays of shape [N, 4] = (x, y, z, sdf) (ref: src/PreprocessMesh.cpp:196-226,
deep_sdf/data.py:83-136). Counterpart of the host readers in
``msd_tpu/data/sdf_samples.py``."""

from __future__ import annotations

import numpy as np


def remove_nans(arr: np.ndarray) -> np.ndarray:
    """Drop rows whose SDF value is NaN (ref: deep_sdf/data.py:78-80)."""
    return arr[~np.isnan(arr[:, 3]), :]


def read_sdf_samples(filename):
    """Return (pos, neg) float32 arrays from a SdfSamples .npz
    (ref: deep_sdf/data.py:83-88)."""
    npz = np.load(filename)
    return np.asarray(npz["pos"], np.float32), np.asarray(npz["neg"], np.float32)
