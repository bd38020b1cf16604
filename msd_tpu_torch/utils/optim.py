"""Optimizer helpers (counterpart of ``msd_tpu/utils/optim.py``)."""

from __future__ import annotations

import torch


def project_code_bound(latents: torch.Tensor, code_bound):
    """nn.Embedding(max_norm=...) renorm: rescale rows whose L2 norm exceeds
    the bound (ref: train_deep_sdf.py:429; reconstruct.py:134-140)."""
    if code_bound is None:
        return latents
    norms = torch.linalg.vector_norm(latents, dim=-1, keepdim=True)
    scale = torch.clamp(code_bound / (norms + 1e-12), max=1.0)
    return latents * scale
