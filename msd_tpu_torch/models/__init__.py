from msd_tpu_torch.models.deepsdf import DeepSDFDecoder  # noqa: F401
from msd_tpu_torch.models.registry import ARCH_REGISTRY, build_decoder  # noqa: F401
