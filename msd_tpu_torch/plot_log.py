"""Offline plots from Logs.pth (counterpart of the root ``plot_log.py``,
CLI compatible with the reference's plot_log.py, ref: plot_log.py:1-104).

``python -m msd_tpu_torch.plot_log -e <exp> -t {loss,learning_rate,time,lat_mag,param_mag}``
saves ``<exp>/plot_<type>.png`` (headless). Needs matplotlib.
"""

from __future__ import annotations

import argparse
import logging
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from msd_tpu_torch.utils import add_common_args, configure_logging  # noqa: E402
from msd_tpu_torch.utils.checkpoint import load_logs  # noqa: E402


def running_mean(x, N):
    cumsum = np.cumsum(np.insert(x, 0, 0))
    return (cumsum[N:] - cumsum[:-N]) / float(N)


def plot_logs(experiment_directory, plot_type):
    loss_log, lr_log, timing_log, lat_mag_log, param_mag_log, epoch = load_logs(
        experiment_directory
    )
    logging.info("latest epoch is %s", epoch)
    num_iters = len(loss_log)
    iters_per_epoch = num_iters / max(epoch, 1)
    logging.info("%s iters per epoch", iters_per_epoch)

    fig, ax = plt.subplots()
    if plot_type == "loss":
        ax.plot(np.arange(num_iters) / iters_per_epoch, loss_log, "#82c6eb")
        if num_iters > 41:
            ax.plot(
                np.arange(20, num_iters - 20) / iters_per_epoch,
                running_mean(loss_log, 41), "#2a9edd",
            )
        if num_iters > 1601:
            ax.plot(
                np.arange(800, num_iters - 800) / iters_per_epoch,
                running_mean(loss_log, 1601), "#16628b",
            )
        ax.set(xlabel="Epoch", ylabel="Loss", title="Training Loss")
    elif plot_type == "learning_rate":
        combined_lrs = np.array(lr_log)
        for col in range(combined_lrs.shape[1]):
            ax.plot(np.arange(combined_lrs.shape[0]), combined_lrs[:, col])
        ax.set(xlabel="Epoch", ylabel="Learning Rate", title="Learning Rates")
    elif plot_type == "time":
        ax.plot(timing_log, "#833eb7")
        ax.set(xlabel="Epoch", ylabel="Time per Epoch (s)", title="Timing")
    elif plot_type == "lat_mag":
        ax.plot(lat_mag_log)
        ax.set(xlabel="Epoch", ylabel="Magnitude", title="Latent Vector Magnitude")
    elif plot_type == "param_mag":
        for _name, mags in param_mag_log.items():
            ax.plot(mags)
        ax.set(xlabel="Epoch", ylabel="Magnitude", title="Parameter Magnitude")
        ax.legend(list(param_mag_log.keys()), fontsize="x-small")
    else:
        raise Exception(f'unrecognized plot type "{plot_type}"')
    ax.grid()
    out = os.path.join(experiment_directory, f"plot_{plot_type}.png")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    logging.info("saved %s", out)
    return out


def main(argv=None):
    """Runs the CLI on ``argv``; returns the PNG's path."""
    arg_parser = argparse.ArgumentParser(description="Plot DeepSDF training logs")
    arg_parser.add_argument("--experiment", "-e", dest="experiment_directory", required=True)
    arg_parser.add_argument("--type", "-t", dest="type", default="loss")
    add_common_args(arg_parser)
    args = arg_parser.parse_args(argv)
    configure_logging(args)
    return plot_logs(args.experiment_directory, args.type)


if __name__ == "__main__":
    main()
