"""VDR encoder: text -> sparse vector on the LM vocabulary space
(counterpart of ``vsearch_tpu/models/vdr.py``).

BERT last hidden states -> LayerNorm (eps 1e-5) -> projection onto the
vocab-shifted tied word embeddings -> masked max-pool over the sequence
-> elu1p -> optional L2 norm, then top-k / bag-of-words masking. As in
the JAX package, padding positions are masked out of the pooling unless
``compat_pad_pooling`` asks for the reference's pooling over them, and
the max branch pools raw logits and applies elu1p once after the pool
(elu1p is monotone).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..ops.activations import elu1p
from ..ops.sparse import build_bow_mask, build_topk_mask
from .bert import BertConfig, BertModel, init_bert_weights
from .encoder_base import TextEncoderBase

# elements of one [B*L, chunk] f32 logits block in the chunked max-pool
_POOL_BLOCK_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class VDREncoderConfig:
    model_id: str = "bert-base-uncased"
    max_len: int = 256
    norm: bool = False
    shift_vocab_num: int = 999
    topk: int = 768
    pooling: str = "max"  # 'max' | 'mean'
    pooling_topk: int = 0  # for 'mean': average of top-k sequence acts
    compat_pad_pooling: bool = False
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    type: str = "vdr"

    @property
    def vocab_size(self) -> int:
        return self.bert.vocab_size

    @property
    def out_dim(self) -> int:
        return self.bert.vocab_size - self.shift_vocab_num

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VDREncoderConfig":
        bert_keys = {f.name for f in dataclasses.fields(BertConfig)}
        own_keys = {f.name for f in dataclasses.fields(cls)} - {"bert"}
        bert = BertConfig(**{k: v for k, v in d.items() if k in bert_keys})
        own = {k: v for k, v in d.items() if k in own_keys}
        return cls(bert=bert, **own)


class VDRModule(nn.Module):
    """tokens -> [B, V - shift] f32 vocabulary embedding. Parameter names
    follow the reference's torch VDR encoder (``bert_model.*`` + ``ln``)."""

    def __init__(self, config: VDREncoderConfig):
        super().__init__()
        self.config = config
        self.bert_model = BertModel(config.bert)
        self.ln = nn.LayerNorm(config.bert.hidden_size, eps=1e-5)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        cfg = self.config
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        h = self.ln(self.bert_model(input_ids, token_type_ids,
                                    attention_mask))
        # tied head: the shifted word embeddings [V', H]
        proj = self.bert_model.embeddings.word_embeddings.weight[
            cfg.shift_vocab_num:]
        if cfg.compat_pad_pooling:
            # pool every position up to the batch's longest row, as the
            # reference's padding=True batches do
            longest = attention_mask.sum(dim=1).max()
            pos = torch.arange(attention_mask.shape[1],
                               device=attention_mask.device)
            valid = (pos[None, :] < longest).expand(attention_mask.shape)
        else:
            valid = attention_mask.bool()
        if cfg.pooling == "max":
            emb = elu1p(_masked_max_project(h, proj, valid))
        elif cfg.pooling == "mean":
            logits = (h @ proj.T).float()  # [B, L, V']
            validf = valid[:, :, None].float()
            acts = elu1p(logits) * validf
            if cfg.pooling_topk:
                top = torch.topk(acts.transpose(1, 2), cfg.pooling_topk,
                                 dim=-1).values
                emb = top.mean(dim=-1)
            else:
                emb = acts.sum(dim=1) / validf.sum(dim=1).clamp_min(1.0)
        else:
            raise NotImplementedError(cfg.pooling)
        if cfg.norm:
            emb = emb / torch.linalg.vector_norm(
                emb, dim=-1, keepdim=True).clamp_min(1e-12)
        return emb


def _masked_max_project(h: torch.Tensor, proj: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """max over valid positions of h @ proj.T, [B, V'] f32, computed in
    vocab chunks so the [B, L, V'] logits never exist whole (at rerank
    batch shapes they would be ~1 GB a batch). Rows with no valid
    position give -inf (elu1p maps it to 0)."""
    b, l, _ = h.shape
    hx = h.reshape(b * l, -1)
    v = proj.shape[0]
    chunk = max(128, _POOL_BLOCK_ELEMS // max(b * l, 1))
    out = torch.empty((b, v), dtype=torch.float32, device=h.device)
    invalid = ~valid[:, :, None]
    for s in range(0, v, chunk):
        lg = (hx @ proj[s:s + chunk].T).float().view(b, l, -1)
        out[:, s:s + chunk] = lg.masked_fill(invalid, float("-inf")) \
            .amax(dim=1)
    return out


class VDREncoder(TextEncoderBase):
    """Host-facing VDR encoder with the reference's ``embed`` surface.

    Weights are made from ``seed`` with an explicit ``torch.Generator``
    unless ``state_dict`` is given (the port's own layout; see
    ``models.convert`` for JAX parameter trees and HF state dicts)."""

    config_class = VDREncoderConfig

    def __init__(self, config: VDREncoderConfig, state_dict=None,
                 tokenizer=None, seed: int = 0, device="cuda"):
        if tokenizer is None:
            from ..tokenization import get_tokenizer
            tokenizer = get_tokenizer(config.model_id)
        super().__init__(config, tokenizer, device)
        with torch.device("meta"):
            module = VDRModule(config)
        module = module.to_empty(device=self.device)
        init_bert_weights(module, torch.Generator(
            device=self.device).manual_seed(seed))
        self.module = module.to(config.bert.dtype).eval()
        if state_dict is not None:  # cast to the compute dtype on load
            self.module.load_state_dict(state_dict)

    # -- per-batch pipelines -------------------------------------------------
    def _masked_embed(self, ids, ttype, mask, topk, activate_lexical):
        cfg = self.config
        emb = self.module(ids, ttype, mask)
        if topk is None or topk == -1:
            return emb
        bow = build_bow_mask(ids, vocab_size=cfg.vocab_size,
                             shift_num=cfg.shift_vocab_num) > 0
        if topk == 0:
            m = bow if activate_lexical else torch.zeros_like(bow)
        else:
            m = build_topk_mask(emb, k=topk)
            if activate_lexical:
                m = m | bow
        return emb * m

    # -- public API ----------------------------------------------------------
    @torch.no_grad()
    def embed(self, texts: Union[str, List[str]], batch_size: int = 128,
              max_len: Optional[int] = None, topk: Optional[int] = "cfg",
              bow: bool = False, activate_lexical: bool = True,
              **_ignored) -> np.ndarray:
        """Embed texts into [N, V - shift] sparse lexical vectors.

        topk: 0 -> only lexical (present-token) dims; None or -1 -> all
        dims; k -> top-k dims (plus lexical dims when
        ``activate_lexical``)."""
        if isinstance(texts, str):
            texts = [texts]
        max_len = max_len or self.config.max_len
        if topk == "cfg":
            topk = self.config.topk
        if topk is not None and topk > 0:
            topk = min(topk, self.config.out_dim)
        cfg = self.config
        if bow:
            fn = lambda ids, tt, m: build_bow_mask(
                ids, vocab_size=cfg.vocab_size,
                shift_num=cfg.shift_vocab_num, norm=cfg.norm)
        else:
            fn = lambda ids, tt, m: self._masked_embed(ids, tt, m, topk,
                                                       activate_lexical)
        outs = self._run_batches(texts, batch_size, max_len, fn)
        return torch.cat([o[:n] for o, n in outs]).cpu().numpy()

    @torch.no_grad()
    def embed_sparse(self, texts: Union[str, List[str]],
                     batch_size: int = 128, max_len: Optional[int] = None,
                     topk: Optional[int] = None,
                     activate_lexical: bool = False,
                     return_device: bool = False):
        """Embed directly into compact sparse form: (cols [N, k] int32
        sentinel-padded with ``out_dim``, vals [N, k] f32). k is ``topk``
        plus ``max_len`` when ``activate_lexical`` (the lexical-union
        bound), at most ``out_dim``.

        ``return_device=True`` keeps the result on the device, with the
        row count padded up to a multiple of ``batch_size`` (trailing rows
        come from pad inputs)."""
        if isinstance(texts, str):
            texts = [texts]
        max_len = max_len or self.config.max_len
        if topk is None:
            topk = self.config.topk
        if topk <= 0:
            raise ValueError(
                "embed_sparse needs topk >= 1 (use embed(topk=0) for "
                "lexical-only dense masks)")
        cfg = self.config
        topk = min(topk, cfg.out_dim)
        k_out = min(topk + (max_len if activate_lexical else 0),
                    cfg.out_dim)

        def fn(ids, ttype, mask):
            emb = self.module(ids, ttype, mask)
            if activate_lexical:
                bow = build_bow_mask(ids, vocab_size=cfg.vocab_size,
                                     shift_num=cfg.shift_vocab_num) > 0
                emb = emb * (build_topk_mask(emb, k=topk) | bow)
            vals, cols = torch.topk(emb, k_out, dim=-1)
            # zero entries -> sentinel column (mask-free scoring)
            pos = vals > 0
            cols = torch.where(pos, cols, torch.full_like(cols, cfg.out_dim))
            vals = torch.where(pos, vals, torch.zeros_like(vals))
            return cols.to(torch.int32), vals

        outs = self._run_batches(texts, batch_size, max_len, fn)
        if return_device:
            return (torch.cat([c for (c, _), _ in outs]),
                    torch.cat([v for (_, v), _ in outs]))
        return (torch.cat([c[:n] for (c, _), n in outs]).cpu().numpy(),
                torch.cat([v[:n] for (_, v), n in outs]).cpu().numpy())

    def disentangle(self, text: str, topk: int = 768) -> Dict[str, float]:
        """Top-k (token -> weight) interpretation of an embedding."""
        emb = self.embed(text)[0]
        k = min(topk, emb.shape[-1])
        idx = np.argsort(-emb)[:k]
        idx = [int(i) for i in idx if emb[i] != 0]
        token_ids = [i + self.config.shift_vocab_num for i in idx]
        tokens = self.tokenizer.convert_ids_to_tokens(token_ids)
        return dict(zip(tokens, [float(emb[i]) for i in idx]))

    dst = disentangle
