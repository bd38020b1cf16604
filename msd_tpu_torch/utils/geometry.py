"""Geometry helper functions (a copy of ``msd_tpu/utils/geometry.py``).

Behavioral ports of deep_sdf/utils.py:16-171 operating on plain
(vertices, faces) numpy pairs instead of trimesh objects.
"""

from __future__ import annotations

import math

import numpy as np


def R_x(rad):
    return np.array(
        [[1, 0, 0, 0],
         [0, np.cos(rad), -np.sin(rad), 0],
         [0, np.sin(rad), np.cos(rad), 0],
         [0, 0, 0, 1]]
    )


def R_y(rad):
    return np.array(
        [[np.cos(rad), 0, np.sin(rad), 0],
         [0, 1, 0, 0],
         [-np.sin(rad), 0, np.cos(rad), 0],
         [0, 0, 0, 1]]
    )


def R_z(rad):
    return np.array(
        [[np.cos(rad), -np.sin(rad), 0, 0],
         [np.sin(rad), np.cos(rad), 0, 0],
         [0, 0, 1, 0],
         [0, 0, 0, 1]]
    )


def rotate(x, alpha=0.0, beta=0.0, gamma=0.0):
    """Rotate by alpha/beta/gamma rad around X/Y/Z (homogeneous 4x4,
    ref: deep_sdf/utils.py:16-39)."""
    return R_z(gamma) @ R_y(beta) @ R_x(alpha) @ x


def equi_dist_points_on_sphere(num_samples: int, radius: float = 1.0) -> np.ndarray:
    """Fibonacci-spiral near-equidistant points on a sphere
    (ref: src/Utils.cpp:7-26 EquiDistPointsOnSphere — same recurrence, so
    the multi-view camera rigs match the reference's)."""
    i = np.arange(num_samples, dtype=np.float64)
    offset = 2.0 / num_samples
    increment = np.pi * (3.0 - np.sqrt(5.0))
    y = (i * offset - 1.0) + offset / 2.0
    r = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    phi = (i + 1.0) * increment
    pts = np.stack([np.cos(phi) * r, y, np.sin(phi) * r], axis=1)
    return (radius * pts).astype(np.float32)


def psnr(mse):
    """Peak signal-to-noise ratio for mse in [0, 1] (ref: utils.py:100-107)."""
    return 20 * np.log10(1.0 / np.sqrt(mse))


def _bbox_centroid(vertices):
    return (vertices.min(axis=0) + vertices.max(axis=0)) / 2.0


def scale_to_unit_sphere(vertices, faces=None, return_stats=False):
    """Center at the bbox centroid and scale so max vertex distance is 1
    (ref: utils.py:138-151)."""
    vertices = np.asarray(vertices, np.float64)
    centroid = _bbox_centroid(vertices)
    v = vertices - centroid
    scale = np.linalg.norm(v, axis=1).max()
    v = v / scale
    if return_stats:
        return (v.astype(np.float32), faces), centroid, scale
    return v.astype(np.float32), faces


def scale_to_unit_cube(vertices, faces=None, return_stats=False, extent=1.0):
    """Center and scale so the max bbox extent is 2*extent
    (ref: utils.py:154-165)."""
    vertices = np.asarray(vertices, np.float64)
    centroid = _bbox_centroid(vertices)
    v = vertices - centroid
    extents = vertices.max(axis=0) - vertices.min(axis=0)
    v = v * (2.0 / extents.max() * extent)
    if return_stats:
        return (v.astype(np.float32), faces), centroid, extents.max() * extent / 2.0
    return v.astype(np.float32), faces


def rescale_unit_mesh(vertices, faces=None, shift=None, scale=1.0):
    """Invert unit scaling: v*scale + shift (ref: utils.py:168-170)."""
    v = np.asarray(vertices, np.float64) * scale
    if shift is not None:
        v = v + shift
    return v.astype(np.float32), faces


def comp_fc_net_frac_params(num_params, codelength, div):
    """Width of an equal-width 8-layer FC net with num_params/div parameters
    (ref: utils.py:127-133)."""
    return -(codelength + 4) / (7 * 2) + math.sqrt(
        ((codelength + 4) / (7 * 2)) ** 2 + (num_params / (div * 7))
    )


def is_watertight(faces) -> bool:
    """True iff every undirected edge is shared by exactly two faces
    (the manifold-closedness test trimesh's is_watertight performs;
    used by the OAI-ZIB grooming checks, ref: sdf_utils/mesh_scaling.ipynb)."""
    f = np.asarray(faces)
    if f.size == 0:
        return False
    edges = np.sort(
        np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1
    )
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return bool((counts == 2).all())
