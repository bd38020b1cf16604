"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A request
for ``cuda`` on a host without a GPU raises: the port never continues on
the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent. Also pins float32 products to full float32 (no TF32), for
    matrix products and cuDNN alike, so a float32 result on the card is
    computed the way the CPU computes it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass --device cpu (or device='cpu') to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
