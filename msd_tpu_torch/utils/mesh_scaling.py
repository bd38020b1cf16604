"""Group-uniform mesh scaling + watertightness audit — script equivalent of
the reference's sdf_utils/mesh_scaling.ipynb (OAI-ZIB grooming step).

Computes the global vertex min/max over a folder of meshes, rescales every
mesh with ONE shared affine map into [target_min, target_max] (so relative
sizes across the cohort are preserved — the property the volume/disease
analyses depend on), writes the scaled meshes plus a scale_info.json, and
reports which outputs are not watertight.

    python -m msd_tpu_torch.utils.mesh_scaling -i <meshes> -o <out> [--pattern "*.obj"]

Counterpart of the root ``utils/mesh_scaling.py``.
"""

import argparse
import json
import os
from glob import glob

import numpy as np

from msd_tpu_torch.data.mesh_io import load_mesh, save_mesh
from msd_tpu_torch.utils.geometry import is_watertight


def compute_global_min_max(files):
    """Global scalar min/max/mean over all vertex coordinates of all meshes."""
    gmin, gmax, total, count = np.inf, -np.inf, 0.0, 0
    for f in files:
        verts, _ = load_mesh(f)
        gmin = min(gmin, float(verts.min()))
        gmax = max(gmax, float(verts.max()))
        total += float(verts.sum())
        count += verts.size
    return gmin, gmax, total / max(count, 1)


def scale_mesh_to_uniform_range(verts, gmin, gmax, tmin, tmax):
    s = (tmax - tmin) / (gmax - gmin)
    return (verts - gmin) * s + tmin


def main():
    parser = argparse.ArgumentParser(description="group-uniform mesh rescale")
    parser.add_argument("--input_dir", "-i", required=True)
    parser.add_argument("--output_dir", "-o", required=True)
    parser.add_argument("--pattern", default="*.obj", help="glob inside input_dir (*.obj / *.ply)")
    parser.add_argument("--target_min", type=float, default=-0.9)
    parser.add_argument("--target_max", type=float, default=0.9)
    args = parser.parse_args()

    files = sorted(glob(os.path.join(args.input_dir, args.pattern)))
    if not files:
        print(f"no meshes matching {args.pattern} under {args.input_dir}")
        return
    os.makedirs(args.output_dir, exist_ok=True)

    gmin, gmax, gavg = compute_global_min_max(files)
    print(f"Global min: {gmin}, Global max: {gmax}, Global avg: {gavg}")
    scale_info = {
        "global_min": gmin,
        "global_max": gmax,
        "global_avg": gavg,
        "target_min": args.target_min,
        "target_max": args.target_max,
        "scaling_factor": (args.target_max - args.target_min) / (gmax - gmin),
    }
    with open(os.path.join(args.output_dir, "scale_info.json"), "w") as f:
        json.dump(scale_info, f, indent=2)

    non_watertight = []
    for path in files:
        verts, faces = load_mesh(path)
        scaled = scale_mesh_to_uniform_range(
            verts, gmin, gmax, args.target_min, args.target_max
        ).astype(np.float32)
        out = os.path.join(args.output_dir, os.path.basename(path))
        save_mesh(out, scaled, faces)
        if not is_watertight(faces):
            non_watertight.append(os.path.basename(path))
        print(f"{os.path.basename(path)}: vertices {len(verts)}, faces {len(faces)}")

    print(f"Watertight meshes: {len(files) - len(non_watertight)}/{len(files)}")
    for name in non_watertight:
        print(f"  NOT watertight: {name}")


if __name__ == "__main__":
    main()
