"""Mesh normal-consistency metric.

Replaces the reference's pytorch3d.loss.mesh_normal_consistency wrapper
(ref: deep_sdf/metrics/mesh_normal_consistency.py:13-20): mean of
(1 - cos(angle)) between face normals across every interior edge.
"""

from __future__ import annotations

import numpy as np

from msd_tpu_torch.ops.sampling import face_normals


def mesh_normal_consistency(verts: np.ndarray, faces: np.ndarray) -> float:
    n = face_normals(verts, faces)
    # adjacency: edges shared by two faces
    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    face_ids = np.tile(np.arange(len(faces)), 3)
    key = edges[:, 0].astype(np.int64) * (verts.shape[0] + 1) + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    fid_sorted = face_ids[order]
    same = key_sorted[1:] == key_sorted[:-1]
    fa = fid_sorted[:-1][same]
    fb = fid_sorted[1:][same]
    if fa.size == 0:
        return 0.0
    cos = np.einsum("ij,ij->i", n[fa], n[fb])
    return float(np.mean(1.0 - cos))
