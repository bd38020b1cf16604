"""Offscreen rendering via the native C++ rasterizer (counterpart of
``msd_tpu/render.py``; the same rasterizer source, built by
``msd_tpu_torch.native``).

Replaces the reference's two GL render users:

* ``pyrender_helper`` — shaded color + depth figures
  (ref: deep_sdf/plotting.py:127-146), same camera rig: perspective
  yfov=pi/3 at z=2, rotated by (alpha, beta, gamma) with the reference's
  euler convention (ref: deep_sdf/utils.py:16-39).
* ``visible_faces`` / ``render_view`` — the multi-view visibility pass of
  PreprocessMesh/SampleVisibleMeshSurface (ref: PreprocessMesh.cpp:443-494,
  src/ShaderProgram.cpp:5-141): cameras on a Fibonacci sphere render
  face-id buffers; a triangle is "visible" iff some camera sees it.

The rasterizer is ~100 LoC of plain C++ (msd_tpu_torch/native/raster.cpp)
— no GL/EGL/pyrender dependency, runs on the host wherever ``g++`` does.
A failed build raises (``load_native``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from msd_tpu_torch.native import load_native
from msd_tpu_torch.utils.geometry import equi_dist_points_on_sphere, rotate

YFOV = np.pi / 3.0


def _as_vf(mesh):
    if isinstance(mesh, (tuple, list)):
        v, f = mesh
    else:  # trimesh.Trimesh-like
        v, f = mesh.vertices, mesh.faces
    return (np.ascontiguousarray(v, np.float32),
            np.ascontiguousarray(f, np.int32))


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """4x4 camera-to-world with the camera at ``eye`` looking at ``target``
    (camera -Z toward the target, pyrender convention)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    if abs(np.dot(fwd, up / np.linalg.norm(up))) > 0.999:
        up = np.array([1.0, 0.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = true_up
    pose[:3, 2] = -fwd
    pose[:3, 3] = eye
    return pose


def render_view(mesh, cam_pose, resolution=(1000, 1000), yfov=YFOV,
                want_color=True, want_depth=True, want_faceid=False):
    """Render one view; returns the requested subset of
    (color u8 [H,W,3], depth f32 [H,W], faceid i32 [H,W])."""
    lib = load_native()
    verts, faces = _as_vf(mesh)
    W, H = resolution
    pose = np.ascontiguousarray(np.asarray(cam_pose, np.float32).reshape(16))
    color = np.zeros((H, W, 3), np.uint8) if want_color else None
    depth = np.zeros((H, W), np.float32) if want_depth else None
    faceid = np.zeros((H, W), np.int32) if want_faceid else None

    def ptr(arr, ty):
        return arr.ctypes.data_as(ctypes.POINTER(ty)) if arr is not None else None

    lib.rast_render(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(len(verts)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(len(faces)),
        pose.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_float(yfov),
        ctypes.c_int(W), ctypes.c_int(H),
        ptr(color, ctypes.c_uint8), ptr(depth, ctypes.c_float), ptr(faceid, ctypes.c_int32),
    )
    out = tuple(a for a in (color, depth, faceid) if a is not None)
    return out[0] if len(out) == 1 else out


def pyrender_helper(mesh, alpha=0.0, beta=0.0, gamma=0.0, resolution=(1000, 1000)):
    """Shaded color + depth render of a mesh; same signature and camera rig
    as the reference's pyrender_helper (ref: deep_sdf/plotting.py:127-146):
    camera 2 units out on +Z, rotated by (alpha, beta, gamma)."""
    camera_pose = np.eye(4)
    camera_pose[2, 3] = 2.0
    camera_pose = rotate(camera_pose, alpha=alpha, beta=beta, gamma=gamma)
    color, depth = render_view(mesh, camera_pose, resolution=resolution)
    return color, depth


def visibility_scan(mesh, num_views=100, radius=2.0, resolution=(400, 400),
                    yfov=YFOV):
    """Multi-view visibility: render face-id buffers from ``num_views``
    Fibonacci-sphere cameras (ref: PreprocessMesh.cpp:443-451 — 100 views
    at 400x400). Returns (visible [nf] bool, stats dict with the covered /
    wrong-normal pixel counts used for mesh-quality rejection,
    ref: PreprocessMesh.cpp:496-512)."""
    lib = load_native()
    verts, faces = _as_vf(mesh)
    eyes = equi_dist_points_on_sphere(num_views, radius)
    poses = np.ascontiguousarray(
        np.stack([look_at_pose(e).astype(np.float32).reshape(16) for e in eyes])
    )
    W, H = resolution
    visible = np.zeros(len(faces), np.uint8)
    covered = ctypes.c_int64()
    wrong = ctypes.c_int64()
    lib.rast_visibility(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(len(verts)),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.c_int64(len(faces)),
        poses.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(num_views), ctypes.c_float(yfov),
        ctypes.c_int(W), ctypes.c_int(H),
        visible.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(covered), ctypes.byref(wrong),
    )
    stats = {
        "covered_pixels": int(covered.value),
        "wrong_normal_pixels": int(wrong.value),
        "wrong_normal_fraction": (
            int(wrong.value) / int(covered.value) if covered.value else 0.0
        ),
        "visible_fraction": float(visible.mean()) if len(faces) else 0.0,
    }
    return visible.astype(bool), stats


def visible_faces(mesh, num_views=100, radius=2.0, resolution=(400, 400)):
    """Boolean mask of triangles seen by at least one camera."""
    vis, _ = visibility_scan(mesh, num_views, radius, resolution)
    return vis
