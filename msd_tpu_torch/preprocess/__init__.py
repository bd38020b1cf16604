from msd_tpu_torch.preprocess.mesh_to_sdf import (  # noqa: F401
    preprocess_mesh,
    sample_surface_points,
    knn_sign_vote,
)
