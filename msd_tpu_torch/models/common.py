"""Shared building blocks for the port's models.

Counterpart of ``msd_tpu/models/common.py``. Weights keep PyTorch's
``[out, in]`` layout, so ``x @ w.T + b`` is the forward.
"""

from __future__ import annotations

import math

import torch
from torch import nn

LAYER_NORM_EPS = 1e-5


def uniform_(t: torch.Tensor, bound: float, generator=None) -> torch.Tensor:
    """Fill ``t`` in place with U(-bound, bound) from ``generator``."""
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)
    return t


def weight_norm_effective(weight_v: torch.Tensor, weight_g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v|| with one norm per output row of the ``[out, in]``
    weight (``torch.nn.utils.weight_norm`` with dim=0)."""
    norm = torch.linalg.vector_norm(weight_v, dim=1, keepdim=True)
    return weight_g.reshape(-1, 1) * weight_v / norm


class Linear(nn.Linear):
    """nn.Linear with the reference's default init, U(±1/sqrt(in)) for
    weight and bias, drawn from an explicit generator."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__(in_dim, out_dim)
        bound = 1.0 / math.sqrt(in_dim)
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)


class WeightNormLinear(nn.Module):
    """Linear layer with the explicit reparameterisation w = g * v / ||v||.

    Parameter names (``weight_g`` [out, 1], ``weight_v`` [out, in],
    ``bias``) are the reference's ``nn.utils.weight_norm`` names. g starts
    at ||v||, so the effective weight at init equals the Linear init."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        v = uniform_(torch.empty(out_dim, in_dim), bound, generator)
        b = uniform_(torch.empty(out_dim), bound, generator)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(torch.linalg.vector_norm(v, dim=1, keepdim=True))
        self.bias = nn.Parameter(b)

    @property
    def weight(self) -> torch.Tensor:
        return weight_norm_effective(self.weight_v, self.weight_g)

    def forward(self, x):
        return nn.functional.linear(x, self.weight, self.bias)



class BatchNorm(nn.Module):
    """BatchNorm over the leading axes of [..., C] with ``msd_tpu``'s
    parameters (``batch_norm_init``, ``msd_tpu/models/pointnet.py:25-33``:
    scale 1, bias 0, mean 0, var 1) under torch's names (``weight``,
    ``bias``, buffers ``running_mean``, ``running_var``). In training mode
    it normalizes with the batch's mean and biased variance, else with the
    running statistics, as ``batch_norm_apply`` (:36-51). It never updates
    the running statistics: ``msd_tpu``'s SIREN decoder drops the new ones
    that ``batch_norm_apply`` returns, where ``torch.nn.BatchNorm1d`` in
    training mode would keep them."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean, var = x.mean(dim=dims), x.var(dim=dims, unbiased=False)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
