"""Train a DeepSDF auto-decoder (Stage 1).

``python -m msd_tpu_torch.train_deep_sdf -e <exp> [-c latest] [--batch_split k] [--device cuda|cpu]``
takes the flags of the root ``train_deep_sdf.py`` (ref: train_deep_sdf.py
:1083-1123) plus ``--device`` (default ``cuda``; ``cpu`` runs on the CPU,
and asking for ``cuda`` without a GPU raises).
"""

from __future__ import annotations

import argparse

from msd_tpu_torch.train.stage1 import main_function
from msd_tpu_torch.utils import add_common_args, configure_logging


def _parser():
    p = argparse.ArgumentParser(description="Train a DeepSDF autodecoder")
    p.add_argument(
        "--experiment", "-e", dest="experiment_directory", required=True,
        help="The experiment directory. This directory should include experiment specifications in "
        "'specs.json', and logging will be done in this directory as well.",
    )
    p.add_argument(
        "--continue", "-c", dest="continue_from",
        help="A snapshot to continue from. This can be 'latest' to continue from the latest running "
        "snapshot, or an integer corresponding to an epochal snapshot.",
    )
    p.add_argument(
        "--batch_split", dest="batch_split", type=int, default=1,
        help="This splits the batch into separate subbatches which are processed separately, with "
        "gradients accumulated across all subbatches.",
    )
    p.add_argument("--device", dest="device", default="cuda", help="cuda (default) or cpu")
    add_common_args(p)
    return p


def main(argv=None):
    """Run the CLI; returns the trainer."""
    args = _parser().parse_args(argv)
    configure_logging(args)
    return main_function(args.experiment_directory, args.continue_from, args.batch_split, args.device)


if __name__ == "__main__":
    main()
