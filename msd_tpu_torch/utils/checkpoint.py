"""Checkpoint IO in the reference's and ``msd_tpu``'s on-disk formats
(counterpart of ``msd_tpu/utils/checkpoint.py``), so every checkpoint moves
between the reference, ``msd_tpu`` and this port in every direction:

* ModelParameters/<E>.pth     = {"epoch", "model_state_dict"} with the
  reference's parameter names (ref: train_deep_sdf.py:32-79); Stage 2:
  {"epoch", "vae_state_dict", "sdf_decoder_state_dict"} (msd_tpu/train/
  stage2.py:1062-1075);
* LatentCodes/<E>.pth         = {"epoch", "latent_codes": {"weight"}}, an
  Embedding state dict (the legacy [S, 1, L] tensor is read too); Stage 2
  stores the VAE's mu there;
* OptimizerParameters/<E>.pth = {"epoch", "optimizer_state_dict":
  {"msd_tpu_adam": [count, mu leaves..., nu leaves...]}}, ``msd_tpu``'s
  layout: its Adam state flattened in JAX's order (sorted dict keys: "gmm"
  (the GMM prior's "log_sigma", "logits", "mu") before "lat" before "net",
  "sdf" before "vae", then "bn<i>"/"lin<i>" by name, then "b" before "w",
  or "b", "g", "v"; "bias" before "scale"; list entries in order), weights
  stored [in, out]. As in ``msd_tpu``, no file holds the GMM parameters
  themselves, only their moments;
* Logs.pth                    = loss/lr/timing/magnitude histories + epoch.
"""

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


def save_latent_vectors(experiment_directory, filename, latents, epoch):
    """latents [num_scenes, latent_size], stored as an Embedding state dict
    {"weight": tensor} (ref: train_deep_sdf.py:70-79)."""
    d = ws.get_latent_codes_dir(experiment_directory, True)
    weight = latents.detach().float().cpu().clone()
    torch.save({"epoch": epoch, "latent_codes": {"weight": weight}}, os.path.join(d, filename))


def load_latent_vectors(experiment_directory, filename, expected_shape=None):
    """Returns (latents [S, L] float32 CPU tensor, epoch); reads the
    Embedding state dict and the legacy [S, 1, L] tensor
    (ref: train_deep_sdf.py:83-113)."""
    full = os.path.join(ws.get_latent_codes_dir(experiment_directory), filename)
    if not os.path.isfile(full):
        raise Exception(f'latent state file "{full}" does not exist')
    data = torch.load(full, map_location="cpu", weights_only=False)
    codes = data["latent_codes"]
    arr = codes["weight"] if isinstance(codes, dict) else codes
    arr = torch.as_tensor(arr).detach().float()
    if arr.dim() == 3:  # legacy [S, 1, L]
        arr = arr[:, 0, :]
    if expected_shape is not None and tuple(arr.shape) != tuple(expected_shape):
        raise Exception(f"num latent codes mismatched: {tuple(arr.shape)} vs {tuple(expected_shape)}")
    return arr.contiguous(), data["epoch"]


# torch parameter suffix -> (msd_tpu leaf name, transposed)
_LEAF = {"weight": ("w", True), "weight_v": ("v", True), "weight_g": ("g", False), "bias": ("b", False)}
_LN_LEAF = {"weight": "scale", "bias": "bias"}


def msd_tpu_names(decoder):
    """[(msd_tpu leaf path "lin0.w", port parameter name "lin0.weight",
    transposed)] in JAX's flatten order of the decoder's param dict."""
    out = []
    for name, _ in decoder.named_parameters():
        module, suffix = name.split(".", 1)
        if module.startswith("bn"):
            out.append((module + "." + _LN_LEAF[suffix], name, False))
        else:
            leaf, transposed = _LEAF[suffix]
            out.append((module + "." + leaf, name, transposed))
    return sorted(out, key=lambda e: tuple(e[0].split(".")))


def vae_msd_tpu_names(vae):
    """[(msd_tpu leaf path, port parameter name, transposed)] in JAX's
    flatten order of ``msd_tpu``'s ResidualMLPVAE params: paths like
    ("encoder", "backbone", "stages", 0, "blocks", 0, "fc1", "w")."""
    out = []
    for name, _ in vae.named_parameters():
        parts = name.split(".")
        if parts[-2] == "norm":
            leaf, transposed = _LN_LEAF[parts[-1]], False
        else:
            leaf, transposed = _LEAF[parts[-1]]
        path = tuple(int(q) if q.isdigit() else q for q in parts[:-1]) + (leaf,)
        out.append((path, name, transposed))
    return sorted(out, key=lambda e: e[0])


def _to_jax(t, transposed):
    """A port tensor in msd_tpu's layout: ``transposed`` True for [out, in]
    weights, False for the rest (weight_g [out, 1] becomes [out]), None
    for a tensor kept as it is."""
    t = t.detach().float().cpu()
    if transposed:
        return t.t().contiguous()
    if transposed is False and t.dim() == 2 and t.shape[1] == 1:
        return t.reshape(-1).clone()
    return t.clone()


def _save_flat(experiment_directory, filename, optimizer, entries, epoch):
    """``entries``: [(group, parameter name, transposed)] of ``optimizer``
    (a ``utils.optim.GroupAdam``) in msd_tpu's flatten order."""
    d = ws.get_optimizer_params_dir(experiment_directory, True)
    flat = [torch.tensor(optimizer.count, dtype=torch.int32)]
    for moments in (optimizer.mu, optimizer.nu):
        flat += [_to_jax(moments[g][n], tr) for g, n, tr in entries]
    torch.save(
        {"epoch": epoch, "optimizer_state_dict": {"msd_tpu_adam": flat}},
        os.path.join(d, filename),
    )


def _load_flat(experiment_directory, filename, optimizer, entries):
    full = os.path.join(ws.get_optimizer_params_dir(experiment_directory), filename)
    if not os.path.isfile(full):
        raise Exception(f'optimizer state dict "{full}" does not exist')
    data = torch.load(full, map_location="cpu", weights_only=False)
    flat = list(data["optimizer_state_dict"]["msd_tpu_adam"])
    if len(flat) != 1 + 2 * len(entries):
        raise Exception("optimizer state structure mismatch")
    optimizer.count = int(torch.as_tensor(flat[0]))
    it = iter(flat[1:])
    for moments in (optimizer.mu, optimizer.nu):
        for g, n, tr in entries:
            dst = moments[g][n]
            src = torch.as_tensor(next(it)).float()
            dst.copy_((src.t() if tr else src).reshape(dst.shape))
    return data["epoch"]


def _stage1_entries(decoder, optimizer):
    gmm = [("gmm", k, None) for k in sorted(optimizer.groups.get("gmm", ()))]
    return gmm + [("lat", "weight", None)] + [("net", n, tr) for _, n, tr in msd_tpu_names(decoder)]


def save_optimizer(experiment_directory, filename, decoder, optimizer, epoch):
    """``optimizer``: ``utils.optim.GroupAdam`` over groups "net" (the
    decoder's parameters by name), "lat" (the latent table) and, with the
    GMM prior, "gmm"."""
    _save_flat(experiment_directory, filename, optimizer, _stage1_entries(decoder, optimizer), epoch)


def load_optimizer(experiment_directory, filename, decoder, optimizer):
    """Fill ``optimizer`` (count and moments, on their devices) from a file
    in ``msd_tpu``'s layout; returns the epoch."""
    return _load_flat(experiment_directory, filename, optimizer, _stage1_entries(decoder, optimizer))


def _stage2_entries(vae, sdf_decoder):
    entries = [] if sdf_decoder is None else [("sdf", n, tr) for _, n, tr in msd_tpu_names(sdf_decoder)]
    return entries + [("vae", n, tr) for _, n, tr in vae_msd_tpu_names(vae)]


def save_stage2_optimizer(experiment_directory, filename, vae, sdf_decoder, optimizer, epoch):
    """Stage 2's optimizer file: ``optimizer`` has group "vae" and, when
    the SDF decoder trains, "sdf" (``sdf_decoder`` None otherwise)."""
    _save_flat(experiment_directory, filename, optimizer, _stage2_entries(vae, sdf_decoder), epoch)


def load_stage2_optimizer(experiment_directory, filename, vae, sdf_decoder, optimizer):
    return _load_flat(experiment_directory, filename, optimizer, _stage2_entries(vae, sdf_decoder))


def save_stage2_model(experiment_directory, filename, vae, sdf_decoder, epoch):
    d = ws.get_model_params_dir(experiment_directory, True)
    torch.save(
        {
            "epoch": epoch,
            "vae_state_dict": {k: v.detach().cpu() for k, v in vae.state_dict().items()},
            "sdf_decoder_state_dict": {k: v.detach().cpu() for k, v in sdf_decoder.state_dict().items()},
        },
        os.path.join(d, filename),
    )


def save_logs(experiment_directory, loss_log, lr_log, timing_log, lat_mag_log, param_mag_log, epoch):
    """ref: train_deep_sdf.py:135-155."""
    torch.save(
        {
            "epoch": epoch,
            "loss": loss_log,
            "learning_rate": lr_log,
            "timing": timing_log,
            "latent_magnitude": lat_mag_log,
            "param_magnitude": param_mag_log,
        },
        ws.get_logs_filename(experiment_directory),
    )


def load_logs(experiment_directory):
    full = ws.get_logs_filename(experiment_directory)
    if not os.path.isfile(full):
        raise Exception(f'log file "{full}" does not exist')
    data = torch.load(full, map_location="cpu", weights_only=False)
    return (
        data["loss"],
        data["learning_rate"],
        data["timing"],
        data["latent_magnitude"],
        data["param_magnitude"],
        data["epoch"],
    )


def clip_logs(loss_log, lr_log, timing_log, lat_mag_log, param_mag_log, epoch):
    """ref: train_deep_sdf.py:177-188."""
    iters_per_epoch = len(loss_log) // max(1, len(lr_log))
    loss_log = loss_log[: (iters_per_epoch * epoch)]
    lr_log = lr_log[:epoch]
    timing_log = timing_log[:epoch]
    lat_mag_log = lat_mag_log[:epoch]
    for n in param_mag_log:
        param_mag_log[n] = param_mag_log[n][:epoch]
    return loss_log, lr_log, timing_log, lat_mag_log, param_mag_log

