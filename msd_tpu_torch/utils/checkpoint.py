"""Decoder checkpoints in the reference's ``.pth`` layout
``ModelParameters/<E>.pth = {"epoch", "model_state_dict"}`` with its
parameter names (ref: train_deep_sdf.py:32-79), so checkpoints move between
the reference, ``msd_tpu`` and this port in every direction. Counterpart of
``msd_tpu/utils/checkpoint.py:save_model/load_model``."""

from __future__ import annotations

import os

import torch

import msd_tpu_torch.workspace as ws


def save_model(experiment_directory, filename, decoder, epoch):
    d = ws.get_model_params_dir(experiment_directory, True)
    state = {k: v.detach().cpu() for k, v in decoder.state_dict().items()}
    torch.save({"epoch": epoch, "model_state_dict": state}, os.path.join(d, filename))


def load_model(experiment_directory, checkpoint, decoder):
    """Load ``ModelParameters/<checkpoint>.pth`` into ``decoder``; returns
    the epoch. Reference-trained checkpoints work (the decoder's
    ``load_state_dict`` maps their names)."""
    filename = os.path.join(ws.get_model_params_dir(experiment_directory), str(checkpoint) + ".pth")
    if not os.path.isfile(filename):
        raise Exception(f'model state dict "{filename}" does not exist')
    data = torch.load(filename, map_location="cpu", weights_only=False)
    decoder.load_state_dict(data["model_state_dict"])
    return data["epoch"]
