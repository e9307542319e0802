"""Cross-modal VDR text encoder: text -> valid-vocab-subspace vector
(counterpart of ``vsearch_tpu/models/crossmodal_text.py``).

BERT -> LayerNorm (eps 1e-5, not BERT's 1e-12) -> projection onto the
rows of the tied word embeddings at the *valid* vocabulary ids -> max-pool
over the sequence -> elu1p -> L2 norm (always on), then top-k or
bag-of-words masking in the valid space.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..ops.activations import elu1p
from ..ops.sparse import build_bow_mask, build_topk_mask
from ..utils.profiling import TRACER
from .bert import BertConfig, BertModel, init_bert_weights
from .encoder_base import TextEncoderBase, build_module
from .valid_vocab import VALID_TOKEN_IDS, valid_token_ids
from .vdr import _masked_max_project


@dataclasses.dataclass(frozen=True)
class VDRTextEncoderConfig:
    model_id: str = "bert-base-uncased"
    max_len: int = 256
    topk: int = 768
    # the reference pads every batch to max_len and max-pools the pad
    # positions too, so its embeddings depend on max_len; off by default
    # (masked pooling), on for converted reference checkpoints
    compat_pad_pooling: bool = False
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    type: str = "vdr_crossmodal_text"

    @property
    def vocab_size(self) -> int:
        return self.bert.vocab_size

    @property
    def out_dim(self) -> int:
        return len(self.valid_ids)

    @property
    def valid_ids(self) -> np.ndarray:
        if self.bert.vocab_size == 30522:
            return VALID_TOKEN_IDS
        # small vocabularies (tests): everything past 5 specials is valid
        return valid_token_ids(self.bert.vocab_size) if \
            self.bert.vocab_size > 30000 else np.arange(
                5, self.bert.vocab_size)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VDRTextEncoderConfig":
        bert_keys = {f.name for f in dataclasses.fields(BertConfig)}
        own_keys = {f.name for f in dataclasses.fields(cls)} - {"bert"}
        bert = BertConfig(**{k: v for k, v in d.items() if k in bert_keys})
        own = {k: v for k, v in d.items() if k in own_keys}
        return cls(bert=bert, **own)


class VDRTextModule(nn.Module):
    """tokens -> [B, V_valid] f32 L2-normalised embedding. Parameter names
    follow the reference's torch encoder (``bert_model.*`` + ``ln``)."""

    def __init__(self, config: VDRTextEncoderConfig):
        super().__init__()
        self.config = config
        self.bert_model = BertModel(config.bert)
        self.ln = nn.LayerNorm(config.bert.hidden_size, eps=1e-5)
        self._valid_np = np.asarray(config.valid_ids, dtype=np.int64)
        self._valid: Optional[torch.Tensor] = None

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        h = self.ln(self.bert_model(input_ids, token_type_ids,
                                    attention_mask))
        if self._valid is None or self._valid.device != h.device:
            self._valid = torch.from_numpy(self._valid_np).to(h.device)
        proj = self.bert_model.embeddings.word_embeddings.weight[self._valid]
        if self.config.compat_pad_pooling:
            # every position of the max_len-padded batch, as the reference
            valid = torch.ones_like(attention_mask, dtype=torch.bool)
        else:
            valid = attention_mask.bool()
        emb = elu1p(_masked_max_project(h, proj, valid))
        return emb / torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True).clamp_min(1e-12)


class VDRTextEncoder(TextEncoderBase):
    """Host-facing cross-modal text encoder. Weights come from ``seed``
    unless ``state_dict`` (the port's layout) is given."""

    config_class = VDRTextEncoderConfig

    def __init__(self, config: VDRTextEncoderConfig, state_dict=None,
                 tokenizer=None, seed: int = 0, device="cuda"):
        if tokenizer is None:
            from ..tokenization import get_tokenizer
            tokenizer = get_tokenizer(config.model_id)
        super().__init__(config, tokenizer, device)
        self.module = build_module(VDRTextModule, config, init_bert_weights,
                                   seed, self.device, config.bert.dtype,
                                   state_dict)
        self._valid_ids = np.asarray(config.valid_ids)
        self._valid_t = torch.from_numpy(
            self._valid_ids.astype(np.int64)).to(self.device)

    def encode(self, texts, max_len=None):
        enc = super().encode(texts, max_len=max_len)
        if self.config.compat_pad_pooling:
            # the reference pads to max_len and its max-pool reads the pad
            # positions: input ids extend with the real pad id, the mask
            # and token types with 0
            pad = (max_len or self.config.max_len) - enc["input_ids"].shape[1]
            if pad > 0:
                pad_id = int(getattr(self.tokenizer, "pad_id", 0) or 0)
                enc = {k: np.pad(v, ((0, 0), (0, pad)),
                                 constant_values=(pad_id if k == "input_ids"
                                                  else 0))
                       for k, v in enc.items()}
        return enc

    def _bow_valid(self, ids: torch.Tensor) -> torch.Tensor:
        """Bag of words over the full vocabulary, then its valid columns."""
        bow = build_bow_mask(ids, vocab_size=self.config.vocab_size)
        return bow[:, self._valid_t.to(ids.device)]

    def _masked_embed(self, ids, ttype, mask, topk):
        emb = self.module(ids, ttype, mask)
        bow = self._bow_valid(ids) > 0
        if topk == 0:
            m = bow
        elif topk is None or topk == -1:
            return emb
        else:
            m = build_topk_mask(emb, k=topk) | bow
        return emb * m

    @torch.no_grad()
    def embed(self, texts: Union[str, List[str]], batch_size: int = 128,
              max_len: Optional[int] = None, topk: Optional[int] = "cfg",
              bow: bool = False, **_ignored) -> np.ndarray:
        """[N, V_valid] embeddings. topk: 0 -> the text's own (valid)
        tokens; None or -1 -> every dim; k -> top-k dims plus the text's
        tokens. ``bow=True`` gives the bag of words itself."""
        if isinstance(texts, str):
            texts = [texts]
        max_len = max_len or self.config.max_len
        if topk == "cfg":
            topk = self.config.topk
        if topk is not None and topk > 0:
            topk = min(topk, self.config.out_dim)
        if bow:
            fn = lambda ids, tt, m: self._bow_valid(ids)
        else:
            fn = lambda ids, tt, m: self._masked_embed(ids, tt, m, topk)
        outs = self._run_batches(texts, batch_size, max_len, fn)
        with TRACER.span("to_host"):
            return torch.cat([o[:n] for o, n in outs]).cpu().numpy()

    def disentangle(self, text: str, topk: Optional[int] = None,
                    visual: bool = False, save_file: Optional[str] = None
                    ) -> Dict[str, float]:
        """Top-k (token -> weight) interpretation of an embedding;
        ``visual`` draws it as a word cloud (``utils.vis``)."""
        topk = topk or self.config.topk
        emb = self.embed(text)[0]
        k = min(topk, emb.shape[-1])
        idx = [int(i) for i in np.argsort(-emb)[:k] if emb[i] != 0]
        token_ids = [int(self._valid_ids[i]) for i in idx]
        tokens = self.tokenizer.convert_ids_to_tokens(token_ids)
        results = dict(zip(tokens, [float(emb[i]) for i in idx]))
        if visual:
            from ..utils.vis import wordcloud_from_dict
            wordcloud_from_dict(results, max_words=topk,
                                save_file=save_file)
        return results

    dst = disentangle
