"""The DeepSDF decoder in plain PyTorch, for the reference and its control.

Layer rules (Park et al., CVPR 2019; ``NetworkSpecs`` of the examples):
hidden ``dims``, a last layer of width 1, ReLU after every layer but the
last, the latent and xyz concatenated again before each ``latent_in``
layer (the layer before it shrinks by their width), and a final tanh.
No dropout, weight norm or layer norm: the configurations benchmarked use
none (``norm_layers`` is empty, so ``weight_norm`` changes nothing).

Every product runs in the precision ``mode`` names:

- ``"float32"``: float32 with TF32 off, the reference;
- ``"tf32"``: float32 operands on TF32 tensor cores, the control of a
  float32 path;
- ``"fp8"``: both operands of each product rounded to float8 e4m3 with a
  per-tensor scale, and the gradient arriving at each product's output
  rounded the same way, products accumulated in float32: the control of a
  bf16 path.
"""

from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

MODES = ("float32", "tf32", "fp8")
E4M3_MAX = 448.0


def check_supported(config: dict) -> None:
    net = config["NetworkSpecs"]
    if net.get("xyz_in_all") or net.get("norm_layers") or net.get("dropout") or net.get("latent_dropout") \
            or net.get("use_tanh"):
        raise NotImplementedError("reference decoder: xyz_in_all, norm layers, dropout and use_tanh are not "
                                  "written here")


def linear_shapes(config: dict) -> list[tuple[int, int]]:
    """(in, out) of each linear layer."""
    check_supported(config)
    net = config["NetworkSpecs"]
    latent = int(config["CodeLength"])
    dims = [latent + 3] + [int(d) for d in net["dims"]] + [1]
    latent_in = set(net.get("latent_in") or ())
    return [(dims[i], dims[i + 1] - (dims[0] if i + 1 in latent_in else 0)) for i in range(len(dims) - 1)]


@contextlib.contextmanager
def precision(mode: str):
    """TF32 on for ``"tf32"``, off otherwise; restores the flags after."""
    if mode not in MODES:
        raise ValueError(f"precision mode {mode!r}")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest value, returned in ``x``'s type."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _straight(x: torch.Tensor) -> torch.Tensor:
    """The rounded value forward, the identity backward."""
    return x + (fp8_round(x) - x).detach()


class _RoundGrad(torch.autograd.Function):
    """Identity forward; rounds the gradient that flows back through it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _straight(g)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp8":
        return _RoundGrad.apply(F.linear(_straight(x), _straight(w))) + b
    return F.linear(x, w, b)


def forward(config: dict, params: dict, latents: torch.Tensor, xyz: torch.Tensor, mode: str = "float32"):
    """Pre-clamp SDF [...] of points ``xyz`` [..., 3] at ``latents`` [..., L]
    (broadcast to the points), ``params`` as ``lin{i}.weight`` [out, in] and
    ``lin{i}.bias``."""
    shapes = linear_shapes(config)
    latent_in = set(config["NetworkSpecs"].get("latent_in") or ())
    inputs = torch.cat([latents.expand(*xyz.shape[:-1], latents.shape[-1]), xyz], dim=-1)
    lead = inputs.shape[:-1]
    inputs = inputs.reshape(-1, inputs.shape[-1])
    x = inputs
    last = len(shapes) - 1
    for layer in range(len(shapes)):
        if layer in latent_in:
            x = torch.cat([x, inputs], dim=1)
        x = linear(x, params[f"lin{layer}.weight"], params[f"lin{layer}.bias"], mode)
        if layer < last:
            x = F.relu(x)
    return torch.tanh(x).reshape(lead)
