"""Shared building blocks for the port's models.

Counterpart of ``msd_tpu/models/common.py``. Weights keep PyTorch's
``[out, in]`` layout, so ``x @ w.T + b`` is the forward.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from msd_tpu_torch.parallel.mesh_utils import all_reduce_sum

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


def linear_from_jax(sd: dict, name: str, p: dict):
    """``name.weight``/``name.bias`` of a state dict from an ``msd_tpu``
    linear layer ({"w": [in, out], "b": [out]}; a bias-free one has no
    "b")."""
    sd[name + ".weight"] = torch.tensor(p["w"]).t().contiguous()
    if "b" in p:
        sd[name + ".bias"] = torch.tensor(p["b"])


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



def global_moments(x, dims, group):
    """(mean, biased variance, row count) of ``x`` over ``dims`` and every
    rank of ``group``, in two passes: the sums and the count, then the
    squared deviations from the global mean. The count travels with the
    sums in ``x``'s dtype (exact up to 2^24 rows in float32)."""
    count = x.new_full((1,), x.numel() // x.shape[-1])
    sums = all_reduce_sum(torch.cat([x.sum(dim=dims), count]), group)
    n = sums[-1]
    mean = sums[:-1] / n
    var = all_reduce_sum(((x - mean) ** 2).sum(dim=dims), group) / n
    return mean, var, n


class BatchNorm(nn.Module):
    """BatchNorm over the leading axes of [..., C] with ``msd_tpu``'s
    parameters (``batch_norm_init``, ``msd_tpu/models/pointnet.py:25-33``:
    scale 1, bias 0, mean 0, var 1) under torch's names (``weight``,
    ``bias``, buffers ``running_mean``, ``running_var``). In training mode
    it normalizes with the batch's mean and biased variance, else with the
    running statistics, as ``batch_norm_apply`` (:36-51).

    ``update_stats`` (off by default) decides whether a training-mode
    forward also folds the batch into the running statistics, as the
    ``bn_updates`` that ``batch_norm_apply`` returns: mean and the unbiased
    variance ``var * n / max(n - 1, 1)`` with momentum 0.1, under
    ``no_grad``. The point encoders keep them; ``msd_tpu``'s SIREN decoder
    drops them, so its BatchNorm leaves the switch off.

    ``group`` (a ``parallel.DataParallelGroup`` of several ranks, each
    holding its share of the batch's rows) takes the training-mode
    statistics over every rank's rows, as XLA computes ``msd_tpu``'s over
    the global batch of its SPMD step: the per-channel sums and the row
    count are summed over the ranks for the mean, then the sums of squared
    deviations from that mean for the biased variance, both differentiably
    (``all_reduce_sum``). The running statistics take the global mean and
    the unbiased variance over the global count, the same on every rank."""

    MOMENTUM = 0.1

    def __init__(self, dim: int, eps: float = 1e-5, update_stats: bool = False):
        super().__init__()
        self.eps = eps
        self.update_stats = update_stats
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, group=None):
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if group is None or group.world_size == 1:
                mean, var = x.mean(dim=dims), x.var(dim=dims, unbiased=False)
                n = x.numel() // x.shape[-1]
                n_less_1 = max(n - 1, 1)
            else:
                mean, var, n = global_moments(x, dims, group)
                n_less_1 = torch.clamp(n - 1, min=1)
            if self.update_stats:
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var + m * (var * n / n_less_1))
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
