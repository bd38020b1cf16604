from msd_tpu_torch.utils.logging_utils import add_common_args, configure_logging  # noqa: F401
