"""Encoder registry: string type -> (config class, encoder class)
(counterpart of ``vsearch_tpu/models/registry.py``). The cross-modal
encoders register on first use, as in the JAX package."""
from .dpr import DPREncoder, DPREncoderConfig
from .vdr import VDREncoder, VDREncoderConfig


def _lazy_crossmodal():
    from .crossmodal_image import VDRImageEncoder, VDRImageEncoderConfig
    from .crossmodal_text import VDRTextEncoder, VDRTextEncoderConfig
    ENCODER_TYPES["vdr_crossmodal_text"] = VDRTextEncoder
    ENCODER_TYPES["vdr_crossmodal_image"] = VDRImageEncoder
    CONFIG_TYPES["vdr_crossmodal_text"] = VDRTextEncoderConfig
    CONFIG_TYPES["vdr_crossmodal_image"] = VDRImageEncoderConfig


ENCODER_TYPES = {"vdr": VDREncoder, "dpr": DPREncoder}
CONFIG_TYPES = {"vdr": VDREncoderConfig, "dpr": DPREncoderConfig}


def get_encoder_classes(type_name: str):
    if type_name not in ENCODER_TYPES and type_name.startswith(
            "vdr_crossmodal"):
        _lazy_crossmodal()
    return CONFIG_TYPES[type_name], ENCODER_TYPES[type_name]
