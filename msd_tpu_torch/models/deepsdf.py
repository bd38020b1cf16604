"""DeepSDF auto-decoder MLP as an ``nn.Module``.

Counterpart of ``msd_tpu/models/deepsdf.py`` with the same architecture
rules (ref: networks/deep_sdf_decoder.py:9-109):

* dims = [latent+3] + hidden_dims + [1]; a layer whose *next* index is in
  ``latent_in`` shrinks its output by dims[0] so the full input can be
  re-concatenated before that next layer.
* ``xyz_in_all`` re-concatenates xyz before every non-first, non-last layer
  (shrinking outputs by 3).
* weight norm only when ``weight_norm`` AND the layer is in ``norm_layers``;
  LayerNorm when not ``weight_norm`` and the layer is in ``norm_layers``.
* ReLU + dropout on all but the last layer; optional latent dropout p=0.2;
  optional tanh on the last linear output (``use_tanh``); a final tanh is
  ALWAYS applied.

Parameter names are the reference's (``lin{i}.weight``/``.bias``,
``lin{i}.weight_g``/``.weight_v``, ``bn{i}.weight``/``.bias``), so its
checkpoints and ``msd_tpu``'s load directly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from msd_tpu_torch.models.common import LAYER_NORM_EPS, Linear, WeightNormLinear


def layer_shapes(latent_size, dims, norm_layers=(), latent_in=(), weight_norm=False, xyz_in_all=False):
    """Per-layer (in_dim, out_dim, is_weight_norm, has_layernorm)."""
    dims_full = [latent_size + 3] + list(dims) + [1]
    n = len(dims_full)
    shapes = []
    for layer in range(n - 1):
        if layer + 1 in latent_in:
            out_dim = dims_full[layer + 1] - dims_full[0]
        else:
            out_dim = dims_full[layer + 1]
            if xyz_in_all and layer != n - 2:
                out_dim -= 3
        is_wn = weight_norm and layer in norm_layers
        has_ln = (not weight_norm) and layer in norm_layers
        shapes.append((dims_full[layer], out_dim, is_wn, has_ln))
    return shapes


class DeepSDFDecoder(nn.Module):
    def __init__(
        self,
        latent_size: int,
        dims: Sequence[int],
        dropout: Optional[Sequence[int]] = None,
        dropout_prob: float = 0.0,
        norm_layers: Sequence[int] = (),
        latent_in: Sequence[int] = (),
        weight_norm: bool = False,
        xyz_in_all: Optional[bool] = None,
        use_tanh: bool = False,
        latent_dropout: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.latent_size = int(latent_size)
        self.dims = [self.latent_size + 3] + list(dims) + [1]
        self.num_layers = len(self.dims)
        self.norm_layers = tuple(norm_layers or ())
        self.latent_in = tuple(latent_in or ())
        self.latent_dropout = bool(latent_dropout)
        self.xyz_in_all = bool(xyz_in_all) if xyz_in_all is not None else False
        self.weight_norm = bool(weight_norm)
        self.use_tanh = bool(use_tanh)
        self.dropout = tuple(dropout or ())
        self.dropout_prob = float(dropout_prob)
        self.layer_shapes = layer_shapes(
            self.latent_size, dims, self.norm_layers, self.latent_in,
            self.weight_norm, self.xyz_in_all,
        )
        for layer, (in_dim, out_dim, is_wn, has_ln) in enumerate(self.layer_shapes):
            lin_cls = WeightNormLinear if is_wn else Linear
            setattr(self, f"lin{layer}", lin_cls(in_dim, out_dim, generator))
            if has_ln:
                setattr(self, f"bn{layer}", nn.LayerNorm(out_dim, eps=LAYER_NORM_EPS))

    def layer_weight(self, layer: int) -> torch.Tensor:
        """Effective [out, in] weight of layer ``layer`` (weight norm folded)."""
        return getattr(self, f"lin{layer}").weight

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs [N, latent_size+3] = [latent || xyz] -> [N, 1] SDF."""
        xyz = inputs[:, -3:]
        if inputs.shape[1] > 3 and self.latent_dropout and self.training:
            latent_vecs = F.dropout(inputs[:, :-3], 0.2, training=True)
            x = torch.cat([latent_vecs, xyz], dim=1)
        else:
            x = inputs
        last = self.num_layers - 2
        for layer in range(self.num_layers - 1):
            if layer in self.latent_in:
                x = torch.cat([x, inputs], dim=1)
            elif layer != 0 and self.xyz_in_all:
                x = torch.cat([x, xyz], dim=1)
            x = getattr(self, f"lin{layer}")(x)
            if layer == last and self.use_tanh:
                x = torch.tanh(x)
            if layer < last:
                bn = getattr(self, f"bn{layer}", None)
                if bn is not None:
                    x = bn(x)
                x = F.relu(x)
                if self.training and layer in self.dropout and self.dropout_prob > 0:
                    x = F.dropout(x, self.dropout_prob, training=True)
        return torch.tanh(x)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Accepts the reference's names as ``msd_tpu``'s
        ``params_from_torch_state_dict`` does: a DataParallel ``module.``
        prefix, and torch>=2 ``parametrizations.weight.original0/1`` for
        ``weight_g``/``weight_v``."""
        fixed = {}
        for k, v in state_dict.items():
            if k.startswith("module."):
                k = k[len("module."):]
            k = k.replace(".parametrizations.weight.original0", ".weight_g")
            k = k.replace(".parametrizations.weight.original1", ".weight_v")
            v = torch.as_tensor(v)
            if k.endswith(".weight_g"):
                v = v.reshape(-1, 1)
            fixed[k] = v
        return super().load_state_dict(fixed, strict=strict, assign=assign)


def params_from_jax(decoder: DeepSDFDecoder, params_np) -> dict:
    """State dict of the port's decoder from ``msd_tpu``'s param pytree
    given as numpy arrays ({"lin{i}": {"w"} or {"v", "g"}, "b"},
    {"bn{i}": {"scale", "bias"}}), weights stored [in, out] there."""
    sd = {}
    for layer, (_, _, is_wn, has_ln) in enumerate(decoder.layer_shapes):
        p = params_np[f"lin{layer}"]
        if is_wn:
            sd[f"lin{layer}.weight_v"] = torch.tensor(np.asarray(p["v"], np.float32).T)
            sd[f"lin{layer}.weight_g"] = torch.tensor(np.asarray(p["g"], np.float32).reshape(-1, 1))
        else:
            sd[f"lin{layer}.weight"] = torch.tensor(np.asarray(p["w"], np.float32).T)
        sd[f"lin{layer}.bias"] = torch.tensor(np.asarray(p["b"], np.float32))
        if has_ln:
            ln = params_np[f"bn{layer}"]
            sd[f"bn{layer}.weight"] = torch.tensor(np.asarray(ln["scale"], np.float32))
            sd[f"bn{layer}.bias"] = torch.tensor(np.asarray(ln["bias"], np.float32))
    return sd


def decode_sdf(decoder: DeepSDFDecoder, latent_vector, queries: torch.Tensor) -> torch.Tensor:
    """Expand one latent over N query points and run the decoder
    (ref: deep_sdf/utils.py:86-97). Returns [N, 1]."""
    if latent_vector is None:
        return decoder(queries)
    latent = latent_vector.reshape(1, -1).to(queries.dtype)
    inputs = torch.cat([latent.expand(queries.shape[0], -1), queries], dim=1)
    return decoder(inputs)


@torch.no_grad()
def give_surface_(decoder: DeepSDFDecoder, latent: torch.Tensor, gain: float = 6**0.5, n: int = 17) -> float:
    """Make a decoder with seeded random weights usable for meshing and
    fitting, in place; returns the bias shift.

    Default-initialised weights (U(±1/sqrt(in))) shrink the activations
    layer by layer, so the field is nearly flat and seldom crosses zero in
    the box. Every layer's weight is multiplied by ``gain`` (sqrt(6) turns
    the default into a ReLU-preserving He-uniform init), then the last
    layer's bias is shifted so the median pre-tanh output over an ``n``^3
    grid of [-1, 1]^3 at ``latent`` is zero, so the level set cuts through
    the box. Needs ``use_tanh=False`` (the pre-tanh output is then linear
    in the bias)."""
    if decoder.use_tanh:
        raise ValueError("give_surface_ needs use_tanh=False")
    for layer in range(decoder.num_layers - 1):
        lin = getattr(decoder, f"lin{layer}")
        (lin.weight_g if hasattr(lin, "weight_g") else lin.weight).mul_(gain)
    dev = next(decoder.parameters()).device
    lin = torch.linspace(-1.0, 1.0, n, device=dev)
    grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)
    out = decode_sdf(decoder, latent.to(dev), grid)[:, 0].double()
    shift = float(torch.atanh(out.clamp(-1 + 1e-12, 1 - 1e-12)).median())
    getattr(decoder, f"lin{decoder.num_layers - 2}").bias -= shift
    return shift
