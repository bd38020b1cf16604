from msd_tpu_torch.parallel.mesh_utils import (  # noqa: F401
    DataParallelGroup,
    all_reduce_sum,
    init_group,
    init_group_from_env,
    pad_to_multiple,
    run_ranks,
)
