"""Training: losses, optimizer, train step, trainer loop, checkpointing
(counterpart of ``vsearch_tpu/train``)."""
from .loss import (VDRLossConfig, biencoder_nll_loss, compute_dpr_loss,
                   compute_vdr_loss, symmetry_biencoder_nll_loss)
from .optim import (get_optimizer, get_schedule_cosine,
                    get_schedule_linear, get_schedule_warmup)
from .step import (TrainBatch, TrainState, TrainStepConfig,
                   make_encoder_apply, make_train_step)

__all__ = [
    "VDRLossConfig", "biencoder_nll_loss", "compute_dpr_loss",
    "compute_vdr_loss", "symmetry_biencoder_nll_loss",
    "get_optimizer", "get_schedule_cosine", "get_schedule_linear",
    "get_schedule_warmup",
    "TrainBatch", "TrainState", "TrainStepConfig",
    "make_encoder_apply", "make_train_step",
]
