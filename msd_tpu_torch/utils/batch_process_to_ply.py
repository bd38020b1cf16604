"""NIfTI segmentation masks -> volume-corrected PLY meshes.

Native equivalent of the reference's ShapeWorks grooming pipeline
(ref: utils/batch_process_to_ply.py:1-556):

1. binary mask -> iso-surface at 0.5 (marching tetrahedra on the padded
   voxel grid, physical mm coordinates via the NIfTI zooms)
2. [smooth variant] Laplacian smoothing (3 iterations, relaxation 1)
3. center mesh at origin
4. volume correction: scale = (V_true / V_mesh)^(1/3), V_true from the
   voxel count x voxel volume
5. per-group global scale 1 / (1.2 * max dimension over the group)
6. write minimal/ and minimal_smooth/ PLYs + metadata.csv

Replaces ShapeWorks/nibabel/trimesh with the port's NIfTI reader,
marching tetrahedra, and mesh ops.

    python -m msd_tpu_torch.utils.batch_process_to_ply -i <masks> -o <out> [-g <group>]

Counterpart of the root ``utils/batch_process_to_ply.py``.
"""

import argparse
import csv
import os
from glob import glob

import numpy as np

from msd_tpu_torch.data.mesh_io import save_ply
from msd_tpu_torch.data.nifti import load_nifti
from msd_tpu_torch.ops.marching_cubes import marching_tetrahedra


def mesh_volume(verts, faces) -> float:
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    return float(abs(np.sum(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0))


def laplacian_smooth(verts, faces, iterations=3, relaxation=1.0):
    """Uniform Laplacian smoothing (VTK smoothPolyData-style:
    v += relaxation * (mean(neighbors) - v))."""
    n = len(verts)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    deg = np.zeros(n)
    np.add.at(deg, src, 1.0)
    deg = np.maximum(deg, 1.0)
    v = verts.astype(np.float64).copy()
    for _ in range(iterations):
        acc = np.zeros_like(v)
        np.add.at(acc, src, v[dst])
        v += relaxation * (acc / deg[:, None] - v)
    return v.astype(np.float32)


def mask_to_mesh(nifti_file, pad=5, smooth=False):
    """(verts in mm, not centered; faces; true volume in mm^3)."""
    data, zooms = load_nifti(nifti_file)
    if data.ndim > 3:
        data = data[..., 0]
    binary = (data > 0).astype(np.float32)
    true_volume = float(binary.sum()) * zooms[0] * zooms[1] * zooms[2]
    vol = np.pad(binary, pad, mode="constant")
    # iso-surface at 0.5 in physical coordinates
    verts, faces = marching_tetrahedra(vol, level=0.5, spacing=zooms)
    if smooth:
        verts = laplacian_smooth(verts, faces, iterations=3, relaxation=1.0)
    return verts, faces, true_volume


def get_nifti_dimension_fast(nifti_file):
    """Max physical bounding-box extent of the mask (mm)
    (ref: batch_process_to_ply.py:69-102)."""
    try:
        data, zooms = load_nifti(nifti_file)
        if data.ndim > 3:
            data = data[..., 0]
        coords = np.where(data > 0)
        if len(coords[0]) == 0:
            return None
        return max(
            (np.max(coords[i]) - np.min(coords[i])) * zooms[i] for i in range(3)
        )
    except Exception as e:
        print(f"Error reading {os.path.basename(nifti_file)}: {e}")
        return None


def process_one(nifti_file, output_file, global_scale, smooth=False):
    """(success, volume_correction) (ref: :104-242)."""
    try:
        verts, faces, true_volume = mask_to_mesh(nifti_file, smooth=smooth)
        # center at origin
        center = (verts.min(axis=0) + verts.max(axis=0)) / 2.0
        verts = verts - center
        v_mesh = mesh_volume(verts, faces)
        volume_correction = (true_volume / v_mesh) ** (1.0 / 3.0)
        verts = verts * volume_correction * global_scale
        save_ply(output_file, verts, faces)
        return True, volume_correction
    except Exception as e:
        print(f"Error processing {os.path.basename(nifti_file)}: {e}")
        return False, None


def process_group(input_files, output_base_dir, group_name):
    """Per-group global scale + both variants + metadata.csv
    (ref: :244-447)."""
    out_dir = os.path.join(output_base_dir, f"{group_name}_ply")
    os.makedirs(os.path.join(out_dir, "minimal"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "minimal_smooth"), exist_ok=True)

    print(f"\nStep 1: Calculating global scale factor for {group_name}...")
    max_dimensions = [d for d in (get_nifti_dimension_fast(f) for f in input_files) if d]
    if not max_dimensions:
        print("No valid masks in group.")
        return
    global_max = max(max_dimensions) * 1.2  # 20% buffer (ref: :295)
    global_scale = 1.0 / global_max
    volume_unscale = (1.0 / global_scale) ** 3
    print(f"  Global scale factor: {global_scale:.8f}")
    print(f"  Volume unscale factor: {volume_unscale:.6e}")

    rows = []
    for f in input_files:
        base = os.path.basename(f).replace(".nii.gz", "").replace(".nii", "")
        ok1, vc1 = process_one(f, os.path.join(out_dir, "minimal", base + ".ply"), global_scale, smooth=False)
        ok2, vc2 = process_one(f, os.path.join(out_dir, "minimal_smooth", base + ".ply"), global_scale, smooth=True)
        rows.append([base, ok1, vc1, ok2, vc2])
        print(f"  {base}: minimal={'ok' if ok1 else 'FAIL'} smooth={'ok' if ok2 else 'FAIL'}")

    with open(os.path.join(out_dir, "metadata.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["global_scale", global_scale])
        w.writerow(["volume_unscale", volume_unscale])
        w.writerow(["shape", "minimal_ok", "minimal_volume_correction", "smooth_ok", "smooth_volume_correction"])
        w.writerows(rows)


def main():
    parser = argparse.ArgumentParser(description="NIfTI masks -> volume-corrected PLY meshes")
    parser.add_argument("--input_dir", "-i", required=True, help="directory of .nii/.nii.gz masks")
    parser.add_argument("--output_dir", "-o", required=True)
    parser.add_argument("--group", "-g", default="shapes", help="group name (separate global scale per group)")
    args = parser.parse_args()
    files = sorted(glob(os.path.join(args.input_dir, "*.nii*")))
    if not files:
        print(f"no NIfTI files under {args.input_dir}")
        return
    process_group(files, args.output_dir, args.group)


if __name__ == "__main__":
    main()
