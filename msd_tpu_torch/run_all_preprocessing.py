"""Run preprocessing over every split JSON in a directory — CLI equivalent of
the reference's run_all_preprocessing.py (ref: run_all_preprocessing.py:1-72)
and of ``msd_tpu``'s root ``run_all_preprocessing.py``, plus ``--device``.

    python -m msd_tpu_torch.run_all_preprocessing -d <data_dir> -s <mesh_dir> \\
        --splits_dir <dir of split JSONs> [--no_surface] [--device cuda|cpu]

For each split it runs ``python -m msd_tpu_torch.preprocess_data`` with
``--skip`` three times: training SDF samples, test-mode samples and
evaluation surface samples. The test pass writes to the same SdfSamples
files as the training pass, so ``--skip`` leaves it nothing to do once
those exist, as in the reference.
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import time

from msd_tpu_torch.utils import add_common_args, configure_logging

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(data_dir, source_dir, splits_dir, debug=False, include_surface=True, device="cuda"):
    all_splits_paths = sorted(
        os.path.join(splits_dir, f) for f in os.listdir(splits_dir) if f.endswith(".json")
    )
    logging.info("Preprocessing data %s --> %s.", source_dir, data_dir)
    logging.info("Found these splits-files to preprocess:\n\t%s", "\n\t".join(all_splits_paths))

    # the children import msd_tpu_torch from this checkout, wherever they start
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, env.get("PYTHONPATH")) if p)
    for i, split_path in enumerate(all_splits_paths):
        start_time = time.time()
        with open(split_path) as f:
            num_shapes = len(json.load(f))
        logging.info(
            "[%d/%d] Preprocessing split: %s (containing %d shapes).",
            i, len(all_splits_paths), split_path, num_shapes,
        )
        base = [sys.executable, "-m", "msd_tpu_torch.preprocess_data", "--data_dir", data_dir,
                "--source", source_dir, "--split", split_path, "--skip", "--device", device]
        cmds = [base, base + ["--test"]]
        if include_surface:
            cmds.append(base + ["--surface"])
        for cmd in cmds:
            if debug:
                logging.info("Running cmd: %s", " ".join(cmd))
            subprocess.run(cmd, capture_output=not debug, check=True, env=env)
        duration = time.time() - start_time
        logging.info(
            "Preprocessing %d shapes took %d:%04.1f (min:sec).",
            num_shapes, int(duration // 60), duration % 60,
        )


if __name__ == "__main__":
    arg_parser = argparse.ArgumentParser()
    arg_parser.add_argument("--data_dir", "-d", required=True)
    arg_parser.add_argument("--source", "-s", dest="source_dir", required=True)
    arg_parser.add_argument("--splits_dir", required=True)
    arg_parser.add_argument("--no_surface", action="store_true")
    arg_parser.add_argument("--device", default="cuda", help="passed to preprocess_data (cuda or cpu)")
    add_common_args(arg_parser)
    args = arg_parser.parse_args()
    configure_logging(args)
    os.makedirs(args.data_dir, exist_ok=True)
    main(args.data_dir, args.source_dir, args.splits_dir,
         debug=args.debug, include_surface=not args.no_surface, device=args.device)
