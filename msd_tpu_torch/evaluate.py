"""Evaluate reconstructions (Chamfer vs GT surface samples).

``python -m msd_tpu_torch.evaluate -e <exp> -c <ckpt> -d <data> -s <split>``
takes the flags of the root ``evaluate.py`` (ref: evaluate.py:100-158) and
writes the same semicolon CSV under ``Evaluation/<ckpt>/``. The metrics
are numpy and scipy on the host in both packages, so there is no
``--device``.
"""

from __future__ import annotations

import argparse
import logging

from msd_tpu_torch.eval_chamfer import evaluate
from msd_tpu_torch.utils import add_common_args, configure_logging


def main(argv=None):
    """Run the CLI; returns ``eval_chamfer.evaluate``'s per-shape results."""
    p = argparse.ArgumentParser(description="Evaluate a DeepSDF autodecoder")
    p.add_argument("--experiment", "-e", dest="experiment_directory", required=True)
    p.add_argument("--checkpoint", "-c", dest="checkpoint", default="2000")
    p.add_argument("--data", "-d", dest="data_source", required=True)
    p.add_argument("--split", "-s", dest="split_filename", required=True)
    p.add_argument(
        "--curvature_sampling", "-cs", dest="curvature_sampling", default=0.0,
        help="0 = sample w.r.t. face area, 1 = w.r.t. face curvature.",
    )
    add_common_args(p)
    args = p.parse_args(argv)
    configure_logging(args)
    try:
        curvature_sampling = float(args.curvature_sampling)
    except ValueError as ve:
        logging.error("Could not cast %s to float: %s", args.curvature_sampling, ve)
        raise SystemExit(1)
    return evaluate(
        args.experiment_directory, args.checkpoint, args.data_source,
        args.split_filename, curvature_sampling,
    )


if __name__ == "__main__":
    main()
