"""Deep-Local-Shapes-style decoder: a grid of local codes per shape plus a
global code, as an ``nn.Module`` (counterpart of
``msd_tpu/models/local_shapes.py:23-107``; ref: networks/local_decoder.py).

Each shape has a ``grid_size``^3 grid of local codes, trilinearly
interpolated at the query point (ref: :86-165; the cell's floor clipped to
[0, grid_size - 2], so points outside [-1, 1]^3 extrapolate from the edge
cell), then [global || local || xyz] goes through an inner
``DeepSDFDecoder`` (the port's). Queries carry their shape index, and each
point gathers the 8 corners of its own shape's cell, so there is no loop
over shapes and no per-point copy of a grid.

The forward differs from the other decoders, as in the reference:
``forward(xyz, global_codes, all_local_codes, indices)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from msd_tpu_torch.models.deepsdf import DeepSDFDecoder
from msd_tpu_torch.models.deepsdf import params_from_jax as deepsdf_params_from_jax


class LocalShapesDecoder(nn.Module):
    def __init__(
        self,
        latent_size: int,
        dims: Sequence[int],
        grid_size: int = 8,
        global_latent_size: int = 256,
        encoding_features: int = 1,
        encoding_sigma: float = 0.0,
        xyz_in: Sequence[int] = (),
        xyz_in_all: bool = False,
        generator: Optional[torch.Generator] = None,
        **siren_decoder_kwargs,
    ):
        """``encoding_features``, ``encoding_sigma`` and ``xyz_in`` are
        accepted and unused, as in ``msd_tpu``."""
        super().__init__()
        self.latent_size = int(latent_size)  # local code width
        self.global_latent_size = int(global_latent_size)
        self.grid_size = int(grid_size)
        self.num_local_codes = self.grid_size**3
        kw = siren_decoder_kwargs
        self.decoder = DeepSDFDecoder(
            self.global_latent_size + self.latent_size, list(dims), dropout=kw.get("dropout"),
            dropout_prob=kw.get("dropout_prob", 0.0), norm_layers=kw.get("norm_layers", ()),
            latent_in=kw.get("latent_in", []), weight_norm=kw.get("weight_norm", False), xyz_in_all=xyz_in_all,
            use_tanh=kw.get("use_tanh", False), latent_dropout=kw.get("latent_dropout", False), generator=generator,
        )

    def init_local_codes(self, num_shapes: int, std: float = 0.01, generator=None) -> torch.Tensor:
        """[num_shapes, grid^3, L] codes drawn from std * N(0, 1)."""
        return std * torch.randn(num_shapes, self.num_local_codes, self.latent_size, generator=generator)

    def interpolate(self, xyz: torch.Tensor, all_local_codes: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """Trilinear interpolation of shape ``indices[i]``'s grid at
        ``xyz[i]``: xyz [N, 3] in [-1, 1], all_local_codes [S, G^3, L]
        (grid axes x, y, z, row-major), indices [N] -> [N, L]."""
        g = self.grid_size
        coords = (xyz + 1.0) * (g - 1) / 2.0
        floor = torch.floor(coords).long().clamp(0, g - 2)
        frac = coords - floor.to(coords.dtype)
        flat = all_local_codes.reshape(-1, self.latent_size)
        base = indices.long() * g**3

        def corner(dx, dy, dz):
            return flat[base + ((floor[:, 0] + dx) * g + floor[:, 1] + dy) * g + floor[:, 2] + dz]

        xd, yd, zd = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
        c00 = corner(0, 0, 0) * (1 - xd) + corner(1, 0, 0) * xd
        c01 = corner(0, 0, 1) * (1 - xd) + corner(1, 0, 1) * xd
        c10 = corner(0, 1, 0) * (1 - xd) + corner(1, 1, 0) * xd
        c11 = corner(0, 1, 1) * (1 - xd) + corner(1, 1, 1) * xd
        c0 = c00 * (1 - yd) + c10 * yd
        c1 = c01 * (1 - yd) + c11 * yd
        return c0 * (1 - zd) + c1 * zd

    def forward(self, xyz, global_codes, all_local_codes, indices) -> torch.Tensor:
        """xyz [N, 3]; global_codes [N, global_latent_size]; all_local_codes
        [num_shapes, grid^3, L]; indices [N] shape ids -> [N, 1]."""
        local = self.interpolate(xyz, all_local_codes, indices)
        return self.decoder(torch.cat([global_codes, local, xyz], dim=1))


def params_from_jax(decoder: LocalShapesDecoder, params_np) -> dict:
    """State dict of the port's decoder from ``msd_tpu``'s params (those of
    its inner DeepSDF decoder) given as numpy arrays."""
    return {"decoder." + k: v for k, v in deepsdf_params_from_jax(decoder.decoder, params_np).items()}
