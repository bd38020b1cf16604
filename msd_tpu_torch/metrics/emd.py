"""Exact Earth Mover's Distance by Hungarian assignment (a copy of
``msd_tpu/metrics/emd.py``; ref: deep_sdf/metrics/emd.py:4-6)."""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist


def compute_emd(points_a: np.ndarray, points_b: np.ndarray) -> float:
    d = cdist(points_a, points_b)
    assignment = linear_sum_assignment(d)
    return float(d[assignment].sum() / min(len(points_a), len(points_b)))
