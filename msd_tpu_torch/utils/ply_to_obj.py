"""Batch-convert .ply meshes to .obj (ref: utils/ply_to_obj.py:16-32).

    python -m msd_tpu_torch.utils.ply_to_obj -i <ply_dir> -o <obj_dir>

Counterpart of the root ``utils/ply_to_obj.py``.
"""

import argparse
import os
from glob import glob

from msd_tpu_torch.data.mesh_io import load_ply, save_obj


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", "-i", required=True)
    parser.add_argument("--output_dir", "-o", required=True)
    args = parser.parse_args()
    os.makedirs(args.output_dir, exist_ok=True)
    for ply in sorted(glob(os.path.join(args.input_dir, "*.ply"))):
        verts, faces = load_ply(ply)
        base = os.path.splitext(os.path.basename(ply))[0]
        out = os.path.join(args.output_dir, base + ".obj")
        save_obj(out, verts, faces if faces is not None else [])
        print(f"{ply} -> {out}")


if __name__ == "__main__":
    main()
