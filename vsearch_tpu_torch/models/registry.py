"""Encoder registry: string type -> (config class, encoder class)
(counterpart of ``vsearch_tpu/models/registry.py``; VDR only so far)."""
from .vdr import VDREncoder, VDREncoderConfig

ENCODER_TYPES = {"vdr": VDREncoder}
CONFIG_TYPES = {"vdr": VDREncoderConfig}


def get_encoder_classes(type_name: str):
    if type_name not in ENCODER_TYPES:
        raise NotImplementedError(
            f"encoder type {type_name!r} is not ported yet "
            f"(available: {sorted(ENCODER_TYPES)})")
    return CONFIG_TYPES[type_name], ENCODER_TYPES[type_name]
