"""Pre-process meshes into SDF samples / surface samples — CLI compatible
with the reference's preprocess_data.py (ref: preprocess_data.py:81-269)
and with ``msd_tpu``'s root ``preprocess_data.py``, plus ``--device``.

    python -m msd_tpu_torch.preprocess_data -d <data_dir> -s <mesh_dir> \\
        --split <split.json> [--test | --surface] [--device cuda|cpu]

Meshes are processed one after another. On ``cuda`` (the default) each
mesh's kNN sign vote takes the tiled route on the card; ``--device cpu``
takes the host cKDTree route. Every draw is made on the host with numpy,
so the written samples match ``msd_tpu``'s on the same meshes. A mesh that
fails is logged and skipped, as the reference does; so a caller checks
that every expected output exists. Each processed mesh also logs one
``preprocess_stats {json}`` line: mode, seconds by part, pos/neg counts,
the rejected fraction and the vote's route statistics.
"""

import argparse
import json
import logging
import os
import time

import numpy as np

import msd_tpu_torch.workspace as ws
from msd_tpu_torch.data.mesh_io import load_mesh, save_ply
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.preprocess import preprocess_mesh
from msd_tpu_torch.preprocess.mesh_to_sdf import _sample_visible_surface
from msd_tpu_torch.utils import add_common_args, configure_logging


def append_data_source_map(data_dir, name, source):
    """Maintain .datasources.json (ref: preprocess_data.py:56-78)."""
    data_source_map_filename = ws.get_data_source_map_filename(data_dir)
    source = os.path.abspath(source)
    data_source_map = {}
    if os.path.isfile(data_source_map_filename):
        with open(data_source_map_filename) as f:
            data_source_map = json.load(f)
    if name in data_source_map and not os.path.abspath(data_source_map[name]) == source:
        raise RuntimeError(f"Cannot add data with the same name and a different source: {name}")
    data_source_map[name] = source
    with open(data_source_map_filename, "w") as f:
        json.dump(data_source_map, f, indent=2)


def process_one(mesh_path, target, args, device, normalization_param_dir):
    """Write one mesh's output; returns its ``preprocess_stats`` record."""
    base = os.path.splitext(os.path.basename(target))[0]
    t0 = time.perf_counter()
    verts, faces = load_mesh(mesh_path)
    t_load = time.perf_counter() - t0
    if args.surface_sampling:
        pts, offset, scale, seconds = _sample_visible_surface(
            verts, faces, 30000, 0, args.visibility
        )
        save_ply(target, pts)
        np.savez(os.path.join(normalization_param_dir, base + ".npz"), offset=offset, scale=scale)
        return {"mesh": base, "mode": "surface", "faces": int(len(faces)), "points": int(len(pts)),
                "load_seconds": t_load, "seconds": seconds,
                "write_seconds": time.perf_counter() - t0 - t_load - seconds["total"]}
    pos, neg, info = preprocess_mesh(
        verts, faces, num_samples=args.num_samples,
        test=args.test_sampling, visibility=args.visibility, knn_device=device,
    )
    t_done = time.perf_counter()
    np.savez(target, pos=pos, neg=neg)
    logging.info(
        "%s: %d pos / %d neg (rejected %.2f%%)",
        base, len(pos), len(neg), 100 * info["rejected_fraction"],
    )
    if info.get("rejected"):
        # quality gate tripped (ref "mesh rejected" print,
        # PreprocessMesh.cpp:509-512) — output was still written
        q = info["quality"]
        logging.warning(
            "%s: mesh rejected (winding=%.4f boundary=%.4f); "
            "winding auto-repaired=%s",
            base, q["inconsistent_winding_ratio"],
            q["boundary_edge_ratio"], q.get("repaired_faces", 0),
        )
    return {"mesh": base, "mode": "test" if args.test_sampling else "sdf", "faces": int(len(faces)),
            "pos": int(len(pos)), "neg": int(len(neg)), "queries": info["num_queries"],
            "rejected_fraction": info["rejected_fraction"],
            "visibility": "render" if "covered_pixels" in info["quality"] else "watertight",
            "load_seconds": t_load, "seconds": info["seconds"], "vote": info["vote"],
            "write_seconds": time.perf_counter() - t_done}


def main(argv=None):
    arg_parser = argparse.ArgumentParser(
        description="Pre-processes data from a data source and appends the results to a dataset."
    )
    arg_parser.add_argument("--data_dir", "-d", dest="data_dir", required=True)
    arg_parser.add_argument("--source", "-s", dest="source_dir", required=True)
    arg_parser.add_argument("--name", "-n", dest="source_name", default=None)
    arg_parser.add_argument("--split", dest="split_filename", required=True)
    arg_parser.add_argument("--skip", dest="skip", default=False, action="store_true")
    arg_parser.add_argument(
        "--threads", dest="num_threads", default=8,
        help="(accepted for CLI compatibility with the reference's per-shape "
        "thread pool, ref preprocess_data.py:252-269; meshes run one after "
        "another here, each vote on --device)",
    )
    arg_parser.add_argument("--test", "-t", dest="test_sampling", default=False, action="store_true")
    arg_parser.add_argument("--surface", dest="surface_sampling", default=False, action="store_true")
    arg_parser.add_argument("--aug", dest="use_augmented", default=False, action="store_true")
    arg_parser.add_argument("--samples", dest="num_samples", type=int, default=500000)
    arg_parser.add_argument(
        "--visibility", dest="visibility", default="auto",
        choices=("auto", "render", "watertight"),
        help="surface-point source: 'render' = the reference's multi-view "
        "visibility pass (C++ rasterizer); 'watertight' = all faces; "
        "'auto' = render only for non-watertight meshes.",
    )
    arg_parser.add_argument(
        "--device", default="cuda",
        help="device of the kNN sign vote: cuda (the tiled route on the card, "
        "the default) or cpu (the host cKDTree route)",
    )
    add_common_args(arg_parser)
    args = arg_parser.parse_args(argv)
    configure_logging(args)
    device = resolve_device(args.device)

    if args.surface_sampling:
        subdir = ws.surface_samples_subdir
        extension = ".ply"
    else:
        subdir = ws.sdf_samples_subdir
        extension = ".npz"

    with open(args.split_filename) as f:
        object_files = json.load(f)
    if isinstance(object_files, dict):  # nested split
        flat = []
        for ds in object_files.values():
            for cls in ds.values():
                flat.extend(cls)
        object_files = flat

    if args.source_name is None:
        args.source_name = os.path.basename(os.path.normpath(args.source_dir))

    dest_dir = os.path.join(args.data_dir, subdir, args.source_name)
    os.makedirs(dest_dir, exist_ok=True)
    normalization_param_dir = None
    if args.surface_sampling:
        normalization_param_dir = os.path.join(
            args.data_dir, ws.normalization_param_subdir, args.source_name
        )
        os.makedirs(normalization_param_dir, exist_ok=True)

    append_data_source_map(args.data_dir, args.source_name, args.source_dir)

    if args.use_augmented:
        original_files = object_files.copy()
        for obj_file in original_files:
            base_name = os.path.splitext(obj_file)[0]
            for i in range(5):
                object_files.append(base_name + "_transformed_" + str(i) + ".obj")
        logging.info(
            "Augmentation enabled: %d original + %d augmented files",
            len(original_files), len(original_files) * 5,
        )

    logging.info("Preprocessing %d meshes from %s into %s", len(object_files), args.source_dir, dest_dir)

    for obj_file in object_files:
        mesh_path = os.path.join(args.source_dir, obj_file)
        base = os.path.splitext(obj_file)[0]
        target = os.path.join(dest_dir, base + extension)
        if args.skip and os.path.isfile(target):
            logging.debug("skipping %s", target)
            continue
        if not os.path.isfile(mesh_path):
            logging.warning("No mesh found for instance %s", obj_file)
            continue
        try:
            stats = process_one(mesh_path, target, args, device, normalization_param_dir)
            logging.info("preprocess_stats %s", json.dumps(stats))
        except Exception as e:  # the reference logs a failed mesh and goes on
            logging.exception("failed to process %s: %s", obj_file, e)


if __name__ == "__main__":
    main()
