"""SIREN decoder with Fourier-feature encoding and stream-in layers, as an
``nn.Module`` (counterpart of ``msd_tpu/models/siren.py:43-198``; ref:
networks/siren_decoder.py:30-237, networks/modules.py:4-39):

* optional Gaussian random-Fourier xyz encoding, used when
  ``encoding_features`` > 1: B ~ sigma^2 N(0, 1) (the reference passes
  sigma^2 as the std, modules.py:30), features [sin(2 pi x B^T),
  cos(2 pi x B^T)];
* ``latent_in`` / ``xyz_in`` stream-in layers whose widths shrink so that
  every layer keeps its configured width (siren_decoder.py:131-138);
  layer 0 always takes [latent || xyz (or its encoding)];
* nonlinearities "sine" (sin 30x), "relu", and the learnable blends
  "sine_relu_line" (per unit, init 0.5) and "sine_relu_plane" (per unit
  [relu weight, sine weight], init [0, 1]);
* SIREN init U(+-sqrt(6 / in) / 30), first layer U(+-1 / in); "relu"
  takes kaiming-normal fan-in; biases keep the Linear default;
* weight norm on ``norm_layers`` when ``weight_norm``, else BatchNorm
  there (``models.common.BatchNorm``: statistics of the batch in training
  mode and the running ones, never updated, in eval mode, as in
  ``msd_tpu``); tanh on the output only with ``use_tanh``.

Parameter names: ``lin{i}`` (``weight``/``bias`` or ``weight_g``/
``weight_v``/``bias``), ``bn{i}``, ``nl_line{i}``, ``nl_plane{i}`` and
``encoding_B``, which ``params_from_jax`` fills from ``msd_tpu``'s params.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from msd_tpu_torch.models.common import BatchNorm, Linear, WeightNormLinear

NONLINEARITIES = ("sine", "relu", "sine_relu_line", "sine_relu_plane")


def _sine(x):
    return torch.sin(30.0 * x)


class SirenDecoder(nn.Module):
    def __init__(
        self,
        latent_size: int,
        dims: Sequence[int],
        encoding_features: int = 1,
        encoding_sigma: float = 0.0,
        xyz_in: Sequence[int] = (),
        xyz_in_all: bool = False,
        dropout: Optional[Sequence[int]] = None,
        dropout_prob: float = 0.0,
        norm_layers: Sequence[int] = (),
        latent_in: Sequence[int] = (),
        weight_norm: bool = False,
        latent_dropout: bool = False,
        nonlinearity: str = "relu",
        use_tanh: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if nonlinearity not in NONLINEARITIES:
            raise NotImplementedError(f"Nonlinearity '{nonlinearity}' is not available.")
        self.latent_size = int(latent_size)
        self.encoding_features = int(encoding_features)
        xyz_dim = 2 * self.encoding_features if self.encoding_features > 1 else 3
        self.num_layers = num_layers = len(dims) + 2
        xyz_in = list(xyz_in) + [0]  # layer 0 always takes xyz (ref: :62-63)
        self.xyz_input_dims = [xyz_dim if (xyz_in_all or i in xyz_in) else 0 for i in range(num_layers - 1)] + [0]
        self.xyz_in = list(range(num_layers)) if xyz_in_all else xyz_in
        self.latent_in = list(latent_in) + [0]  # (ref: :132)
        latent_dims = [self.latent_size if i in self.latent_in else 0 for i in range(num_layers - 1)] + [0]
        fc_dims = [0] + [dims[i] - self.xyz_input_dims[i + 1] - latent_dims[i + 1] for i in range(len(dims))] + [1]
        if not all(d > 0 for d in fc_dims[1:]):
            raise ValueError(f"LAYER WIDTH (dims) TOO SMALL FOR INSTREAMING: fc_dims {fc_dims}")
        self.norm_layers = tuple(norm_layers or ())
        self.dropout = tuple(dropout or ())
        self.dropout_prob = float(dropout_prob)
        self.latent_dropout = bool(latent_dropout)
        self.nonlinearity = nonlinearity
        self.use_tanh = bool(use_tanh)

        if self.encoding_features > 1:
            self.encoding_B = nn.Parameter(
                float(encoding_sigma) ** 2 * torch.randn(self.encoding_features, 3, generator=generator))
        self.layer_shapes = []
        for i in range(num_layers - 1):
            in_dim = fc_dims[i] + self.xyz_input_dims[i] + latent_dims[i]
            out_dim = fc_dims[i + 1]
            is_wn = bool(weight_norm) and i in self.norm_layers
            has_bn = not weight_norm and i in self.norm_layers
            self.layer_shapes.append((in_dim, out_dim, is_wn, has_bn))
            lin = (WeightNormLinear if is_wn else Linear)(in_dim, out_dim, generator)
            with torch.no_grad():  # the weights again, by nonlinearity (ref: :8-27)
                if nonlinearity == "relu":
                    w = math.sqrt(2.0 / in_dim) * torch.randn(out_dim, in_dim, generator=generator)
                else:
                    bound = 1.0 / in_dim if i == 0 else math.sqrt(6.0 / in_dim) / 30.0
                    w = torch.empty(out_dim, in_dim).uniform_(-bound, bound, generator=generator)
                if is_wn:
                    lin.weight_v.copy_(w)
                    lin.weight_g.copy_(torch.linalg.vector_norm(w, dim=1, keepdim=True))
                else:
                    lin.weight.copy_(w)
            setattr(self, f"lin{i}", lin)
            if has_bn:
                setattr(self, f"bn{i}", BatchNorm(out_dim))
            if i < num_layers - 2 and nonlinearity == "sine_relu_line":
                setattr(self, f"nl_line{i}", nn.Parameter(torch.full((out_dim,), 0.5)))
            elif i < num_layers - 2 and nonlinearity == "sine_relu_plane":
                setattr(self, f"nl_plane{i}", nn.Parameter(torch.stack([torch.zeros(out_dim), torch.ones(out_dim)], 1)))

    def _encode(self, xyz):
        proj = 2.0 * math.pi * xyz @ self.encoding_B.t()
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs [N, latent_size+3] = [latent || xyz] -> [N, 1]."""
        xyz, latent = inputs[:, -3:], inputs[:, :-3]
        encoded = self._encode(xyz) if self.encoding_features > 1 else None
        if self.latent_dropout and self.training:
            latent = F.dropout(latent, 0.2, training=True)
        x = torch.cat([latent, xyz if self.xyz_input_dims[0] == 3 else encoded], dim=1)
        for i in range(self.num_layers - 1):
            if i > 0:
                if i in self.latent_in:
                    x = torch.cat([x, latent], dim=1)
                if i in self.xyz_in:
                    x = torch.cat([x, xyz if self.xyz_input_dims[i] == 3 else encoded], dim=1)
            x = getattr(self, f"lin{i}")(x)
            if i < self.num_layers - 2:
                bn = getattr(self, f"bn{i}", None)
                if bn is not None:
                    x = bn(x)
                if self.nonlinearity == "sine_relu_line":
                    blend = getattr(self, f"nl_line{i}")
                    x = blend * _sine(x) + (1 - blend) * F.relu(x)
                elif self.nonlinearity == "sine_relu_plane":
                    plane = getattr(self, f"nl_plane{i}")
                    x = plane[:, 0] * F.relu(x) + plane[:, 1] * _sine(x)
                elif self.nonlinearity == "sine":
                    x = _sine(x)
                else:
                    x = F.relu(x)
                if self.training and i in self.dropout and self.dropout_prob > 0:
                    x = F.dropout(x, self.dropout_prob, training=True)
        return torch.tanh(x) if self.use_tanh else x


def params_from_jax(decoder: SirenDecoder, params_np) -> dict:
    """State dict of the port's SIREN decoder from ``msd_tpu``'s param
    pytree given as numpy arrays (weights stored [in, out] there)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    sd = {}
    if "encoding_B" in params_np:
        sd["encoding_B"] = t(params_np["encoding_B"])
    for i, (_, _, is_wn, has_bn) in enumerate(decoder.layer_shapes):
        p = params_np[f"lin{i}"]
        if is_wn:
            sd[f"lin{i}.weight_v"] = t(p["v"]).t().contiguous()
            sd[f"lin{i}.weight_g"] = t(p["g"]).reshape(-1, 1)
        else:
            sd[f"lin{i}.weight"] = t(p["w"]).t().contiguous()
        sd[f"lin{i}.bias"] = t(p["b"])
        if has_bn:
            bn = params_np[f"bn{i}"]
            sd.update({f"bn{i}.weight": t(bn["scale"]), f"bn{i}.bias": t(bn["bias"]),
                       f"bn{i}.running_mean": t(bn["mean"]), f"bn{i}.running_var": t(bn["var"])})
        for name in (f"nl_line{i}", f"nl_plane{i}"):
            if name in params_np:
                sd[name] = t(params_np[name])
    return sd
