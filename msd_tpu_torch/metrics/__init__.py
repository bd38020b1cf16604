"""Mesh and point-cloud metrics (counterpart of ``msd_tpu/metrics``)."""

from msd_tpu_torch.metrics.chamfer import compute_chamfer, compute_mesh_chamfer  # noqa: F401
from msd_tpu_torch.metrics.normal_consistency import mesh_normal_consistency  # noqa: F401
