"""Train the Stage-2 disentanglement VAE over Stage-1 latent codes.

``python -m msd_tpu_torch.train_MLP_VAE_deep_sdf -e <exp> [-c latest] [--batch_split k] [--device cuda|cpu]``
takes the flags of the root ``train_MLP_VAE_deep_sdf.py`` (ref:
train_MLP_VAE_deep_sdf.py:3916-3957) plus ``--device`` (default ``cuda``;
``cpu`` runs on the CPU, and asking for ``cuda`` without a GPU raises). The
log goes to ``<exp>/train.log`` unless ``--log`` names another file.
"""

from __future__ import annotations

import argparse
import os

from msd_tpu_torch.train.stage2 import main_function
from msd_tpu_torch.utils import add_common_args, configure_logging


def _parser():
    p = argparse.ArgumentParser(description="Train a VAE over DeepSDF latent codes with disentanglement losses")
    p.add_argument("--experiment", "-e", dest="experiment_directory", required=True,
                   help="The experiment directory, holding 'specs.json'; logs and checkpoints go there too.")
    p.add_argument("--continue", "-c", dest="continue_from",
                   help="A snapshot to continue from: 'latest' or an epoch number.")
    p.add_argument("--batch_split", dest="batch_split", type=int, default=1,
                   help="Split the SDF term's points into this many chunks whose gradients are accumulated "
                   "(takes the float32 autograd path instead of the fused kernel).")
    p.add_argument("--device", dest="device", default="cuda", help="cuda (default) or cpu")
    add_common_args(p)
    return p


def main(argv=None):
    """Run the CLI; returns the trainer."""
    args = _parser().parse_args(argv)
    if args.logfile is None:
        os.makedirs(args.experiment_directory, exist_ok=True)
        args.logfile = os.path.join(args.experiment_directory, "train.log")
    configure_logging(args)
    return main_function(args.experiment_directory, args.continue_from, args.batch_split, args.device)


if __name__ == "__main__":
    main()
