"""Config-driven architecture registry (counterpart of
``msd_tpu/models/registry.py``). The port has the DeepSDF decoder only so
far; any other ``NetworkArch`` raises."""

from __future__ import annotations

from msd_tpu_torch.models.deepsdf import DeepSDFDecoder

ARCH_REGISTRY = {"deep_sdf_decoder": DeepSDFDecoder}


def build_decoder(arch_name: str, latent_size: int, network_specs: dict, generator=None):
    """Equivalent of ``arch.Decoder(latent_size, **specs["NetworkSpecs"])``."""
    if arch_name not in ARCH_REGISTRY:
        raise KeyError(
            f"NetworkArch '{arch_name}' is not ported to msd_tpu_torch yet "
            f"(ported: {sorted(ARCH_REGISTRY)})"
        )
    return ARCH_REGISTRY[arch_name](latent_size, generator=generator, **network_specs)
