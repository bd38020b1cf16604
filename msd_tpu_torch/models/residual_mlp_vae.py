"""Residual MLP-VAE, the Stage-2 model (counterpart of
``msd_tpu/models/residual_mlp_vae.py``).

ResidualMLPBlock (fc-act-drop-fc-drop + residual, then LayerNorm), stages of
an optional projection, the activation and blocks, the encoder with its mu
and logvar heads, the decoder, and the VAE returning {mu, logvar, z, z_hat}
(ref: networks/residual_mlp_vae.py:16-275). Submodule names are the
reference's, so ``state_dict()`` keys equal ``msd_tpu``'s
``params_to_torch_state_dict`` keys (``encoder.backbone.stages.{i}.proj``,
``.blocks.{j}.fc1|fc2|norm``, ``encoder.mu_head``, ``encoder.logvar_head``,
``decoder.backbone...``, ``decoder.out``) and ``vae_state_dict`` files load
both ways.

The reparameterisation noise is an argument: ``forward`` takes the noise
tensor itself or a ``torch.Generator`` to draw it from, since JAX's random
streams cannot be reproduced.
"""

from __future__ import annotations

import torch
from torch import nn

from msd_tpu_torch.models.common import LAYER_NORM_EPS, Linear, linear_from_jax


def _act(name: str):
    name = name.lower()
    if name == "relu":
        return nn.ReLU()
    if name == "gelu":
        return nn.GELU(approximate="none")  # exact erf form, as msd_tpu
    raise ValueError(f"Unsupported activation: {name}")


class ResidualMLPBlock(nn.Module):
    def __init__(self, dim, activation="gelu", dropout=0.0, use_layernorm=True, generator=None):
        super().__init__()
        self.fc1 = Linear(dim, dim, generator)
        self.fc2 = Linear(dim, dim, generator)
        self.act = _act(activation)
        self.drop = nn.Dropout(dropout)
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS) if use_layernorm else None

    def forward(self, x):
        h = self.drop(self.act(self.fc1(x)))
        x = self.drop(self.fc2(h)) + x
        return self.norm(x) if self.norm is not None else x


class ResidualStage(nn.Module):
    def __init__(self, prev, dim, num_blocks, activation, dropout, use_layernorm, generator=None):
        super().__init__()
        self.proj = Linear(prev, dim, generator) if prev != dim else None
        self.act = _act(activation)
        self.blocks = nn.ModuleList(
            ResidualMLPBlock(dim, activation, dropout, use_layernorm, generator) for _ in range(num_blocks)
        )

    def forward(self, x):
        if self.proj is not None:
            x = self.proj(x)
        x = self.act(x)
        for block in self.blocks:
            x = block(x)
        return x


class ResidualMLPStack(nn.Module):
    """Sequence of stages; each stage = optional projection + act + blocks."""

    def __init__(self, in_dim, hidden_dims, num_blocks=1, activation="gelu", dropout=0.0, use_layernorm=True,
                 generator=None):
        super().__init__()
        dims = list(hidden_dims)
        if not dims:
            raise ValueError("hidden_dims must be non-empty")
        prev, stages = in_dim, []
        for dim in dims:
            stages.append(ResidualStage(prev, dim, int(num_blocks), activation, float(dropout),
                                        bool(use_layernorm), generator))
            prev = dim
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        for stage in self.stages:
            x = stage(x)
        return x


class ResidualMLPEncoder(nn.Module):
    """Backbone + mu/logvar heads (ref: residual_mlp_vae.py:109-137)."""

    def __init__(self, input_dim=256, latent_dim=16, hidden_dims=(256, 128), num_blocks=1, activation="gelu",
                 dropout=0.0, use_layernorm=True, generator=None):
        super().__init__()
        self.backbone = ResidualMLPStack(input_dim, hidden_dims, num_blocks, activation, dropout, use_layernorm,
                                         generator)
        final = list(hidden_dims)[-1]
        self.mu_head = Linear(final, latent_dim, generator)
        self.logvar_head = Linear(final, latent_dim, generator)

    def forward(self, x):
        h = self.backbone(x)
        return self.mu_head(h), self.logvar_head(h)


class ResidualMLPDecoder(nn.Module):
    """Backbone + output projection (ref: residual_mlp_vae.py:140-164)."""

    def __init__(self, latent_dim=16, output_dim=256, hidden_dims=(128, 256, 256), num_blocks=1, activation="gelu",
                 dropout=0.0, use_layernorm=True, generator=None):
        super().__init__()
        self.backbone = ResidualMLPStack(latent_dim, hidden_dims, num_blocks, activation, dropout, use_layernorm,
                                         generator)
        self.out = Linear(list(hidden_dims)[-1], output_dim, generator)

    def forward(self, z):
        return self.out(self.backbone(z))


class ResidualMLPVAE(nn.Module):
    """Encoder + reparameterisation + decoder (ref: residual_mlp_vae.py
    :167-219). ``forward(x, noise=None, generator=None)`` returns {mu,
    logvar, z, z_hat}; z = mu + exp(logvar / 2) * noise when ``use_kl``,
    else mu. Without ``noise`` it is drawn from ``generator``."""

    def __init__(self, input_dim=256, latent_dim=16, encoder_hidden_dims=(256, 128),
                 decoder_hidden_dims=(128, 256, 256), num_blocks=1, activation="gelu", dropout=0.0,
                 use_layernorm=True, use_kl=True, generator=None):
        super().__init__()
        self.input_dim = input_dim
        self.latent_dim = latent_dim
        self.use_kl = bool(use_kl)
        self.encoder = ResidualMLPEncoder(input_dim, latent_dim, encoder_hidden_dims, num_blocks, activation,
                                          dropout, use_layernorm, generator)
        self.decoder = ResidualMLPDecoder(latent_dim, input_dim, decoder_hidden_dims, num_blocks, activation,
                                          dropout, use_layernorm, generator)

    def forward(self, x, noise=None, generator=None):
        mu, logvar = self.encoder(x)
        if self.use_kl:
            if noise is None:
                noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * noise
        else:
            z = mu
        return {"mu": mu, "logvar": logvar, "z": z, "z_hat": self.decoder(z)}

    def decode(self, z):
        return self.decoder(z)


def _stack_from_jax(sd, prefix, stack_params):
    for i, stage in enumerate(stack_params["stages"]):
        if "proj" in stage:
            linear_from_jax(sd, f"{prefix}.stages.{i}.proj", stage["proj"])
        for j, block in enumerate(stage["blocks"]):
            b = f"{prefix}.stages.{i}.blocks.{j}"
            linear_from_jax(sd, b + ".fc1", block["fc1"])
            linear_from_jax(sd, b + ".fc2", block["fc2"])
            if "norm" in block:
                sd[b + ".norm.weight"] = torch.tensor(block["norm"]["scale"])
                sd[b + ".norm.bias"] = torch.tensor(block["norm"]["bias"])


def decoder_params_from_jax(params_np) -> dict:
    """``decoder.backbone...`` and ``decoder.out`` of a VAE's
    ``ResidualMLPDecoder`` from ``msd_tpu``'s decoder params."""
    sd = {}
    _stack_from_jax(sd, "decoder.backbone", params_np["backbone"])
    linear_from_jax(sd, "decoder.out", params_np["out"])
    return sd


def vae_params_from_jax(params_np) -> dict:
    """A ``state_dict`` for ``ResidualMLPVAE`` from ``msd_tpu``'s VAE params
    (nested dicts of numpy arrays; linear weights stored [in, out]), the
    naming of ``params_to_torch_state_dict`` (msd_tpu/models/
    residual_mlp_vae.py:184-216)."""
    sd = {}
    _stack_from_jax(sd, "encoder.backbone", params_np["encoder"]["backbone"])
    linear_from_jax(sd, "encoder.mu_head", params_np["encoder"]["mu_head"])
    linear_from_jax(sd, "encoder.logvar_head", params_np["encoder"]["logvar_head"])
    sd.update(decoder_params_from_jax(params_np["decoder"]))
    return sd


def expand_latent_to_points(latent, xyz):
    """Broadcast per-scene latents over their point sets
    (ref: residual_mlp_vae.py:222-230).

    latent [B, L], xyz [B, P, 3] -> ([B*P, L], [B*P, 3]); or latent [1, L],
    xyz [N, 3] -> ([N, L], xyz)."""
    if xyz.dim() == 3 and latent.dim() == 2:
        b, p, _ = xyz.shape
        return latent[:, None, :].expand(b, p, latent.shape[-1]).reshape(-1, latent.shape[-1]), xyz.reshape(-1, 3)
    if xyz.dim() == 2 and latent.dim() == 2 and latent.shape[0] == 1:
        return latent.expand(xyz.shape[0], latent.shape[-1]), xyz
    return latent, xyz
