"""Model families: the BERT backbone, the VDR and DPR text encoders and
(imported on first use) the cross-modal text and image encoders."""
from .bert import BertConfig, BertModel
from .dpr import DPREncoder, DPREncoderConfig, DPRModule
from .registry import CONFIG_TYPES, ENCODER_TYPES, get_encoder_classes
from .vdr import VDREncoder, VDREncoderConfig, VDRModule

__all__ = [
    "BertConfig", "BertModel",
    "VDREncoder", "VDREncoderConfig", "VDRModule",
    "DPREncoder", "DPREncoderConfig", "DPRModule",
    "ENCODER_TYPES", "CONFIG_TYPES", "get_encoder_classes",
]
