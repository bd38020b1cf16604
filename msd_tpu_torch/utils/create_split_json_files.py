"""Create shuffled 80/10/10 split JSONs from a mesh directory
(ref: utils/create_split_json_files.py:14-34), or — with --subject_pattern —
subject-disjoint, optionally metadata-stratified splits
(ref: utils/create_split_json_files_ADNI_hippo.ipynb).

    python -m msd_tpu_torch.utils.create_split_json_files -m <mesh_dir> -o <out> [-p <prefix>]

Counterpart of the root ``utils/create_split_json_files.py``.
"""

import argparse
import os
from glob import glob

from msd_tpu_torch.data.splits import create_split_files, create_subject_split_files


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh_dir", "-m", required=True)
    parser.add_argument("--out_dir", "-o", required=True)
    parser.add_argument("--prefix", "-p", default="split")
    parser.add_argument("--ext", default=".obj")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fractions", nargs=3, type=float, default=[0.8, 0.1, 0.1])
    parser.add_argument(
        "--subject_pattern", default=None,
        help="regex with one capture group extracting the subject id from a "
        r"filename (e.g. 'ADNI_(\d+_S_\d+)_'); enables subject-disjoint splits",
    )
    parser.add_argument("--metadata_csv", default=None)
    parser.add_argument("--id_column", default="subject_id")
    parser.add_argument("--label_column", default="diagnosis")
    parser.add_argument(
        "--allowed_labels", nargs="*", default=None,
        help="keep only subjects whose labels are all in this set (e.g. CN AD)",
    )
    parser.add_argument("--stratify", action="store_true")
    args = parser.parse_args()
    meshes = sorted(glob(os.path.join(args.mesh_dir, "*" + args.ext)))
    if not meshes:
        raise SystemExit(f"no {args.ext} files under {args.mesh_dir}")
    if args.subject_pattern:
        paths = create_subject_split_files(
            meshes, args.out_dir, args.prefix,
            subject_pattern=args.subject_pattern,
            metadata_csv=args.metadata_csv,
            id_column=args.id_column, label_column=args.label_column,
            allowed_labels=args.allowed_labels, stratify=args.stratify,
            fractions=tuple(args.fractions), seed=args.seed,
        )
    else:
        paths = create_split_files(
            meshes, args.out_dir, args.prefix, tuple(args.fractions), args.seed
        )
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
