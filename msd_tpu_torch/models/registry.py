"""Config-driven architecture registry (counterpart of
``msd_tpu/models/registry.py``): ``NetworkArch`` names the decoder class
and ``NetworkSpecs`` its keyword arguments, as in the reference's
specs.json files."""

from __future__ import annotations

from msd_tpu_torch.models.deepsdf import DeepSDFDecoder
from msd_tpu_torch.models.local_shapes import LocalShapesDecoder
from msd_tpu_torch.models.siren import SirenDecoder

ARCH_REGISTRY = {"deep_sdf_decoder": DeepSDFDecoder, "siren_decoder": SirenDecoder,
                 "local_decoder": LocalShapesDecoder}


def build_decoder(arch_name: str, latent_size: int, network_specs: dict, generator=None):
    """Equivalent of ``arch.Decoder(latent_size, **specs["NetworkSpecs"])``."""
    if arch_name not in ARCH_REGISTRY:
        raise KeyError(f"unknown NetworkArch '{arch_name}' (known: {sorted(ARCH_REGISTRY)})")
    return ARCH_REGISTRY[arch_name](latent_size, generator=generator, **network_specs)
