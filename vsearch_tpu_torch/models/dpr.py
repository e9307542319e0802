"""DPR dense encoder: text -> BERT [CLS] vector (counterpart of
``vsearch_tpu/models/dpr.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..utils.profiling import TRACER
from .bert import BertConfig, BertModel, init_bert_weights
from .encoder_base import TextEncoderBase, build_module


@dataclasses.dataclass(frozen=True)
class DPREncoderConfig:
    model_id: str = "bert-base-uncased"
    max_len: int = 256
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    type: str = "dpr"

    @property
    def out_dim(self) -> int:
        return self.bert.hidden_size

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DPREncoderConfig":
        bert_keys = {f.name for f in dataclasses.fields(BertConfig)}
        own_keys = {f.name for f in dataclasses.fields(cls)} - {"bert"}
        bert = BertConfig(**{k: v for k, v in d.items() if k in bert_keys})
        own = {k: v for k, v in d.items() if k in own_keys}
        return cls(bert=bert, **own)


class DPRModule(nn.Module):
    """tokens -> [B, H] [CLS] vector. The backbone sits under
    ``bert_model.``, as in the reference's torch DPR encoder."""

    def __init__(self, config: DPREncoderConfig):
        super().__init__()
        self.config = config
        self.bert_model = BertModel(config.bert)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        return self.bert_model(input_ids, token_type_ids,
                               attention_mask)[:, 0, :]


class DPREncoder(TextEncoderBase):
    """Host-facing DPR encoder. Weights come from ``seed`` unless
    ``state_dict`` is given (``models.convert`` carries JAX parameter
    trees and HF state dicts over)."""

    config_class = DPREncoderConfig

    def __init__(self, config: DPREncoderConfig, state_dict=None,
                 tokenizer=None, seed: int = 0, device="cuda"):
        if tokenizer is None:
            from ..tokenization import get_tokenizer
            tokenizer = get_tokenizer(config.model_id)
        super().__init__(config, tokenizer, device)
        self.module = build_module(DPRModule, config, init_bert_weights,
                                   seed, self.device, config.bert.dtype,
                                   state_dict)

    @torch.no_grad()
    def embed(self, texts: Union[str, List[str]], batch_size: int = 128,
              max_len: Optional[int] = None, **_ignored) -> np.ndarray:
        """[N, hidden] f32 [CLS] vectors (bf16 compute gives bf16 values,
        held exactly in f32)."""
        if isinstance(texts, str):
            texts = [texts]
        max_len = max_len or self.config.max_len
        # self.module is looked up at each call: under a mesh each piece
        # runs its own device's replica
        outs = self._run_batches(texts, batch_size, max_len,
                                 lambda *t: self.module(*t))
        with TRACER.span("to_host"):
            return torch.cat([o[:n] for o, n in outs]).float().cpu().numpy()
