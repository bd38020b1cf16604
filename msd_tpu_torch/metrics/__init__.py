"""Mesh and point-cloud metrics (counterpart of ``msd_tpu/metrics``), with
the reference's ``compute_metric`` dispatcher (ref:
deep_sdf/metrics/__init__.py:9-25)."""

from msd_tpu_torch.metrics.chamfer import compute_chamfer, compute_mesh_chamfer  # noqa: F401
from msd_tpu_torch.metrics.emd import compute_emd  # noqa: F401
from msd_tpu_torch.metrics.normal_consistency import mesh_normal_consistency  # noqa: F401


def compute_metric(gt_mesh=None, gen_mesh=None, num_mesh_samples: int = 30000, metric: str = "chamfer"):
    """gt_mesh / gen_mesh: a path or a (verts, faces) tuple; ``metric`` one of
    chamfer, hausdorff, normal_consistency (msd_tpu/metrics/__init__.py:15-45).
    Hausdorff samples each surface with its own seeded generator (0 for the
    ground truth, 1 for the generated mesh), as ``msd_tpu`` does."""
    import numpy as np
    from scipy.spatial import cKDTree

    from msd_tpu_torch.data.mesh_io import load_mesh
    from msd_tpu_torch.ops.sampling import sample_mesh_surface

    def as_mesh(m):
        return load_mesh(m) if isinstance(m, str) else m

    if metric == "chamfer":
        return compute_mesh_chamfer(gt_mesh, gen_mesh, num_mesh_samples=num_mesh_samples)
    if metric == "hausdorff":
        gv, gf = as_mesh(gt_mesh)
        rv, rf = as_mesh(gen_mesh)
        a = sample_mesh_surface(gv, gf, num_mesh_samples, np.random.default_rng(0))[0]
        b = sample_mesh_surface(rv, rf, num_mesh_samples, np.random.default_rng(1))[0]
        return float(max(cKDTree(b).query(a)[0].max(), cKDTree(a).query(b)[0].max()))
    if metric == "normal_consistency":
        return mesh_normal_consistency(*as_mesh(gen_mesh))
    raise ValueError(f"unknown metric {metric}")
