"""Optimizer helpers (counterpart of ``msd_tpu/utils/optim.py``).

``GroupAdam`` is the reference's one torch Adam over two parameter groups,
decoder parameters at lr_schedules[0] and the latent table at
lr_schedules[1] (ref: train_deep_sdf.py:445-454), with gradient clipping on
the decoder group only (ref: train_deep_sdf.py:780-782). Its arithmetic is
``msd_tpu``'s ``fused_clip_adam`` (b1 0.9, b2 0.999, eps 1e-8 added after
the square root, bias correction in float32, dense over the whole latent
table), so both packages take the same step from the same gradients.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def project_code_bound(latents: torch.Tensor, code_bound):
    """nn.Embedding(max_norm=...) renorm: rescale rows whose L2 norm exceeds
    the bound (ref: train_deep_sdf.py:429; reconstruct.py:134-140)."""
    if code_bound is None:
        return latents
    norms = torch.linalg.vector_norm(latents, dim=-1, keepdim=True)
    scale = torch.clamp(code_bound / (norms + 1e-12), max=1.0)
    return latents * scale


class GroupAdam:
    """Adam over named parameter groups, each with its own learning rate.

    ``groups`` maps a group name to {parameter name: tensor}; ``mu`` and
    ``nu`` hold one moment tensor per parameter under the same names.
    ``count`` is the number of steps taken (a host integer)."""

    def __init__(self, groups: Dict[str, Dict[str, torch.Tensor]], b1=0.9, b2=0.999, eps=1e-8):
        self.groups = groups
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {g: {k: torch.zeros_like(p) for k, p in ps.items()} for g, ps in groups.items()}
        self.nu = {g: {k: torch.zeros_like(p) for k, p in ps.items()} for g, ps in groups.items()}

    @torch.no_grad()
    def step(self, lrs: Dict[str, float], max_norm: Optional[float] = None, clip_groups=("net",)):
        """One step from the parameters' ``.grad``; returns {group: pre-clip
        gradient norm} (device scalars) for the clipped groups."""
        self.count += 1
        t = np.float32(self.count)
        # bias corrections in float32, as msd_tpu computes them
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        norms = {}
        for g, params in self.groups.items():
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
            if g in clip_groups and max_norm is not None:
                gnorm = torch.sqrt(sum((x.float() ** 2).sum() for x in grads.values()))
                scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
                grads = {k: x * scale for k, x in grads.items()}
                norms[g] = gnorm
            lr = lrs[g]
            for k, p in params.items():
                m, v, x = self.mu[g][k], self.nu[g][k], grads[k]
                m.mul_(self.b1).add_((1.0 - self.b1) * x)
                v.mul_(self.b2).add_((1.0 - self.b2) * (x * x))
                p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))
        return norms
