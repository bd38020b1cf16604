"""Point-cloud VAE over the Stage-1 latents (counterpart of
``msd_tpu/models/pointnet_vae.py``; ref: networks/pointnet_vae.py:9-65): a
point encoder chosen by name (``resnet_pointnet``/``pointnet``,
``pointnet2``/``pointnet++``, ``pointnet_encoder``) gives (mu, logvar),
z = mu + exp(logvar / 2) * noise, and the port's ``ResidualMLPDecoder``
maps z back to the teacher-latent space.

``forward(points, noise=, fps_start=, generator=)`` returns {mu, logvar,
z, z_hat}. The reparameterisation noise and PointNet++'s FPS start indices
are tensors a caller may give (a test hands over ``msd_tpu``'s draws);
what is not given is drawn from ``generator``. The encoders' BatchNorm
running statistics are buffers, updated by a training-mode forward.

Over ranks (``forward(..., group=)``, every rank passing the whole batch):
each rank encodes its contiguous share of the scenes
(``group.scene_slice``) with BatchNorm over every rank's rows, and mu and
logvar are gathered back (``all_gather_rows``, differentiable), so z and
z_hat are the whole batch's on every rank, as in one process. The encoder's
parameter gradients are then each rank's share and are summed over the
ranks by the caller; the decoder's are whole on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from msd_tpu_torch.models.pointnet import (
    PointNetEncoder,
    ResnetPointnet,
    pointnet_encoder_from_jax,
    resnet_pointnet_from_jax,
)
from msd_tpu_torch.models.pointnet2 import PointNet2Encoder, pointnet2_from_jax
from msd_tpu_torch.models.residual_mlp_vae import ResidualMLPDecoder, decoder_params_from_jax

ENCODERS = {
    "resnet_pointnet": (ResnetPointnet, resnet_pointnet_from_jax),
    "pointnet": (ResnetPointnet, resnet_pointnet_from_jax),
    "pointnet2": (PointNet2Encoder, pointnet2_from_jax),
    "pointnet++": (PointNet2Encoder, pointnet2_from_jax),
    "pointnet_encoder": (PointNetEncoder, pointnet_encoder_from_jax),
}


class PointNetLatentVAE(nn.Module):
    def __init__(self, latent_dim=16, output_dim=256, encoder_type="pointnet2", decoder_hidden_dims=(128, 256, 256),
                 decoder_blocks=1, decoder_activation="gelu", decoder_dropout=0.0, decoder_layernorm=True,
                 use_kl=True, generator=None):
        super().__init__()
        self.latent_dim = latent_dim
        self.use_kl = bool(use_kl)
        self.encoder_type = encoder_type.lower()
        if self.encoder_type not in ENCODERS:
            raise ValueError(f"Unsupported encoder_type: {encoder_type}")
        self.encoder = ENCODERS[self.encoder_type][0](latent_size=latent_dim, kl_div_loss=self.use_kl,
                                                      generator=generator)
        self.decoder = ResidualMLPDecoder(latent_dim, output_dim, decoder_hidden_dims, decoder_blocks,
                                          decoder_activation, decoder_dropout, decoder_layernorm, generator)

    def encode(self, points, fps_start=None, generator=None, group=None):
        """(mu, logvar); logvar is zeros without KL. ``group``: the
        BatchNorms' ranks, ``points`` this rank's rows."""
        kw = dict(fps_start=fps_start, generator=generator) if isinstance(self.encoder, PointNet2Encoder) else {}
        if group is not None and not isinstance(self.encoder, ResnetPointnet):
            kw["group"] = group
        out = self.encoder(points, **kw)
        if self.use_kl:
            return out
        return out, torch.zeros_like(out)

    def forward(self, points, noise=None, fps_start=None, generator=None, group=None):
        """``group``: a ``parallel.DataParallelGroup`` of several ranks to
        encode over (the module docstring); ``points``, ``noise`` and
        ``fps_start`` are the whole batch's, the FPS starts drawn for the
        whole batch, in one process's order, when not given."""
        if group is not None and group.world_size > 1:
            rows = group.scene_slice(points.shape[0])
            if fps_start is None and isinstance(self.encoder, PointNet2Encoder):
                fps_start = self.encoder.draw_starts(points, generator)
            if fps_start is not None:
                fps_start = tuple(s[rows] for s in fps_start)
            mu, logvar = self.encode(points[rows], fps_start, generator, group)
            mu, logvar = group.all_gather_rows(torch.cat([mu, logvar], dim=1)).split(mu.shape[1], dim=1)
        else:
            mu, logvar = self.encode(points, fps_start, generator)
        if self.use_kl:
            if noise is None:
                noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * noise
        else:
            z = mu
        return {"mu": mu, "logvar": logvar, "z": z, "z_hat": self.decoder(z)}

    def decode(self, z):
        return self.decoder(z)

    def params_from_jax(self, params_np) -> dict:
        """A ``state_dict`` from ``msd_tpu``'s ``PointNetLatentVAE`` params
        (nested dicts of numpy arrays), BatchNorm statistics included."""
        enc = ENCODERS[self.encoder_type][1](params_np["encoder"])
        return {**{"encoder." + k: v for k, v in enc.items()}, **decoder_params_from_jax(params_np["decoder"])}
