"""Surface sampling primitives.

Replaces trimesh.sample.sample_surface (used by the reference for Chamfer
point sampling, deep_sdf/metrics/chamfer.py:42, and dataset surface points,
deep_sdf/data.py:139-142) and the area-weighted CDF triangle sampling of the
C++ preprocessing (ref: src/PreprocessMesh.cpp:23-60 SampleFromSurface,
src/Utils.cpp:77-107 TriangleArea/SamplePointFromTriangle).

A copy of ``msd_tpu/ops/sampling.py`` (numpy, host side).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def triangle_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)


def face_normals(verts: np.ndarray, faces: np.ndarray, normalize=True) -> np.ndarray:
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    n = np.cross(b - a, c - a)
    if normalize:
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    return n


def sample_mesh_surface(
    verts: np.ndarray,
    faces: np.ndarray,
    num_samples: int,
    rng: Optional[np.random.Generator] = None,
    face_weight: Optional[np.ndarray] = None,
    return_normals: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Area-weighted (or custom-weighted) surface point sampling with
    uniform barycentric coordinates (sqrt trick)."""
    rng = rng or np.random.default_rng()
    w = triangle_areas(verts, faces) if face_weight is None else np.asarray(face_weight, np.float64)
    w = np.maximum(w, 0.0)
    total = w.sum()
    if total <= 0:
        raise ValueError("mesh has zero total face weight")
    probs = w / total
    face_idx = rng.choice(len(faces), size=num_samples, p=probs)
    a = verts[faces[face_idx, 0]]
    b = verts[faces[face_idx, 1]]
    c = verts[faces[face_idx, 2]]
    r1 = np.sqrt(rng.random(num_samples))
    r2 = rng.random(num_samples)
    pts = (1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b + (r1 * r2)[:, None] * c
    if return_normals:
        n = face_normals(verts, faces)[face_idx]
        return pts.astype(np.float32), n.astype(np.float32), face_idx
    return (pts.astype(np.float32),)



def bounding_cube_normalization(
    verts: np.ndarray, buffer: float = 1.03, mode: str = "sphere"
) -> Tuple[np.ndarray, float]:
    """(offset, scale) such that (v + offset) * scale fits the unit sphere.

    Mirrors the reference's ComputeNormalizationParameters: offset = -center
    (midpoint of the bounding box), scale = 1 / (max distance from center *
    buffer) (ref: src/Utils.cpp:109-168).
    """
    vmin = verts.min(axis=0)
    vmax = verts.max(axis=0)
    center = (vmin + vmax) / 2.0
    offset = -center
    d = np.linalg.norm(verts + offset, axis=1).max()
    scale = 1.0 / (d * buffer)
    return offset.astype(np.float64), float(scale)
