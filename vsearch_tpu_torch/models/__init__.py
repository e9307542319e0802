"""Model families: BERT backbone and the VDR text encoder."""
from .bert import BertConfig, BertModel
from .registry import CONFIG_TYPES, ENCODER_TYPES, get_encoder_classes
from .vdr import VDREncoder, VDREncoderConfig, VDRModule

__all__ = [
    "BertConfig", "BertModel",
    "VDREncoder", "VDREncoderConfig", "VDRModule",
    "ENCODER_TYPES", "CONFIG_TYPES", "get_encoder_classes",
]
