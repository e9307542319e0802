"""VDR encoder: text -> sparse vector on the LM vocabulary space
(counterpart of ``vsearch_tpu/models/vdr.py``).

Trunk last hidden states -> LayerNorm (eps 1e-5) -> projection onto the
vocab-shifted tied word embeddings -> masked max-pool over the sequence
-> elu1p -> optional L2 norm, then top-k / bag-of-words masking. The
trunk is BERT or another entry of ``TRUNKS`` (a config dict's ``trunk``
key). As in the JAX package, padding positions are masked out of the
pooling unless ``compat_pad_pooling`` asks for the reference's pooling
over them, and the max branch pools raw logits and applies elu1p once
after the pool (elu1p is monotone).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.activations import elu1p
from ..ops.sparse import build_bow_mask, build_topk_mask
from ..utils.profiling import TRACER
from . import convert
from .bert import BertConfig, BertModel, init_bert_weights
from .encoder_base import TextEncoderBase, build_module
from .granite_hybrid import (GraniteHybridConfig, GraniteHybridModel,
                             init_granite_weights)

# elements of one [B*L, chunk] f32 logits block in the chunked max-pool
_POOL_BLOCK_ELEMS = 1 << 27


class Trunk(NamedTuple):
    """A trunk VDR's head can sit on. ``module(config)`` maps ``(input_ids,
    token_type_ids, attention_mask)`` to hidden states [B, L, H] and has
    ``tied_embedding`` (its word embeddings [V, H]) and ``head_scale``
    (what the head divides its logits by)."""

    config: type  # a dataclass, built from a config dict's matching keys
    module: type
    attr: str  # the VDRModule attribute it lives under: its key prefix
    init: Callable  # init(VDRModule, generator)
    read_hf: Callable  # read_hf(HF-layout state dict, config) -> the port's


# the trunks by the name a config dict's ``trunk`` key gives (default BERT)
TRUNKS: Dict[str, Trunk] = {
    "bert": Trunk(BertConfig, BertModel, "bert_model", init_bert_weights,
                  lambda sd, cfg: convert.vdr_state_dict_from_hf(
                      sd, cfg.hidden_size)),
    # granite-4.0-h: the port's names are HF's already
    "granite_hybrid": Trunk(GraniteHybridConfig, GraniteHybridModel, "model",
                            init_granite_weights, lambda sd, cfg: dict(sd)),
}


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
    # the trunk's config: BERT's, or the config class of another entry of
    # ``TRUNKS`` (the field keeps the first trunk's name)
    bert: Any = dataclasses.field(default_factory=BertConfig)
    type: str = "vdr"

    @property
    def trunk(self) -> str:
        """The name of the entry of ``TRUNKS`` whose config ``bert`` is."""
        return next(name for name, t in TRUNKS.items()
                    if isinstance(self.bert, t.config))

    @property
    def vocab_size(self) -> int:
        return self.bert.vocab_size

    @property
    def out_dim(self) -> int:
        return self.vocab_size - self.shift_vocab_num

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VDREncoderConfig":
        trunk = d.get("trunk", "bert")
        if trunk not in TRUNKS:
            raise ValueError(f"unknown VDR trunk {trunk!r}")
        trunk_cls = TRUNKS[trunk].config
        trunk_keys = {f.name for f in dataclasses.fields(trunk_cls)}
        own_keys = {f.name for f in dataclasses.fields(cls)} - {"bert"}
        return cls(bert=trunk_cls(**{k: v for k, v in d.items()
                                     if k in trunk_keys}),
                   **{k: v for k, v in d.items() if k in own_keys})


class VDRModule(nn.Module):
    """tokens -> [B, V - shift] f32 vocabulary embedding. Parameter names
    are the trunk's under its ``Trunk.attr`` (the reference's torch VDR
    encoder's ``bert_model.*`` for BERT) + the head's ``ln``.

    With ``tp_devices`` (``encoder_base.set_tp``; the mesh's tp line, this
    module's device first) the trunk runs once, here, and the head's
    shifted vocabulary splits into one contiguous slice a device (the
    first ``V' % T`` slices one column wider): each device pools its
    slice from a copy of the trunk's output, and the slices come back
    here in vocabulary order. The copies are differentiable ``.to``s, so
    the gradients reach the one weight here (a no-op on repeated
    devices)."""

    def __init__(self, config: VDREncoderConfig):
        super().__init__()
        self.config = config
        trunk = TRUNKS[config.trunk]
        self.trunk_attr = trunk.attr
        setattr(self, trunk.attr, trunk.module(config.bert))
        self.ln = nn.LayerNorm(config.bert.hidden_size, eps=1e-5)
        # checkpoint the max-pool's vocab chunks under autograd (remat)
        self.remat = False
        self.tp_devices = None  # the head's vocabulary split (set_tp)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        cfg = self.config
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        trunk = getattr(self, self.trunk_attr)
        h = self.ln(trunk(input_ids, token_type_ids, attention_mask))
        if trunk.head_scale != 1.0:
            # dividing the head's input divides its logits (exactly, for a
            # power-of-two scale)
            h = h / trunk.head_scale
        # tied head: the shifted word embeddings [V', H]
        proj = trunk.tied_embedding[cfg.shift_vocab_num:]
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
            remat = self.remat and torch.is_grad_enabled()
            emb = elu1p(_vocab_split(
                lambda *a: _masked_max_project(*a, remat=remat), h, proj,
                valid, self.tp_devices))
        elif cfg.pooling == "mean":
            emb = _vocab_split(
                lambda *a: _mean_project(*a, topk=cfg.pooling_topk), h,
                proj, valid, self.tp_devices)
        else:
            raise NotImplementedError(cfg.pooling)
        if cfg.norm:  # over the whole row, after the slices are joined
            emb = emb / torch.linalg.vector_norm(
                emb, dim=-1, keepdim=True).clamp_min(1e-12)
        return emb


def _vocab_split(pool, h: torch.Tensor, proj: torch.Tensor,
                 valid: torch.Tensor, devices) -> torch.Tensor:
    """``pool(h, proj, valid)`` -> [B, V'] computed in contiguous vocab
    slices of ``proj``, one a device of ``devices`` (None: all here), each
    from its own copy of ``h`` and ``valid``, joined on ``h``'s device."""
    if not devices:
        return pool(h, proj, valid)
    home = h.device
    return torch.cat([pool(h.to(d), part.to(d), valid.to(d)).to(home)
                      for d, part in zip(devices,
                                         proj.tensor_split(len(devices)))],
                     dim=1)


def _mean_project(h: torch.Tensor, proj: torch.Tensor, valid: torch.Tensor,
                  topk: int = 0) -> torch.Tensor:
    """[B, V'] mean over valid positions of elu1p(h @ proj.T), or with
    ``topk`` the mean of each column's ``topk`` largest activations."""
    logits = (h @ proj.T).float()  # [B, L, V']
    validf = valid[:, :, None].float()
    acts = elu1p(logits) * validf
    if topk:
        return torch.topk(acts.transpose(1, 2), topk, dim=-1).values.mean(
            dim=-1)
    return acts.sum(dim=1) / validf.sum(dim=1).clamp_min(1.0)


def _chunk_max(hx: torch.Tensor, proj: torch.Tensor, invalid: torch.Tensor
               ) -> torch.Tensor:
    """[B, chunk] max over valid positions of one vocab chunk's logits.
    ``amax`` splits the gradient evenly among tied maxima, as JAX's max
    does."""
    b, l = invalid.shape[:2]
    lg = (hx @ proj.T).float().view(b, l, -1)
    return lg.masked_fill(invalid, float("-inf")).amax(dim=1)


def _masked_max_project(h: torch.Tensor, proj: torch.Tensor,
                        valid: torch.Tensor, remat: bool = False
                        ) -> torch.Tensor:
    """max over valid positions of h @ proj.T, [B, V'] f32, computed in
    vocab chunks so the [B, L, V'] logits never exist whole (at rerank
    batch shapes they would be ~1 GB a batch). Rows with no valid
    position give -inf (elu1p maps it to 0). Under autograd each chunk's
    f32 logits are kept for the backward pass, unless ``remat``
    recomputes them there chunk by chunk."""
    b, l, _ = h.shape
    hx = h.reshape(b * l, -1)
    v = proj.shape[0]
    chunk = max(128, _POOL_BLOCK_ELEMS // max(b * l, 1))
    out = torch.empty((b, v), dtype=torch.float32, device=h.device)
    invalid = ~valid[:, :, None]
    for s in range(0, v, chunk):
        if remat:
            out[:, s:s + chunk] = checkpoint(
                _chunk_max, hx, proj[s:s + chunk], invalid,
                use_reentrant=False)
        else:
            out[:, s:s + chunk] = _chunk_max(hx, proj[s:s + chunk], invalid)
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
        self.module = build_module(VDRModule, config,
                                   TRUNKS[config.trunk].init, seed,
                                   self.device, config.bert.dtype,
                                   state_dict)

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
        with TRACER.span("to_host"):
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
        with TRACER.span("to_host"):
            return (torch.cat([c[:n] for (c, _), n in outs]).cpu().numpy(),
                    torch.cat([v[:n] for (_, v), n in outs]).cpu().numpy())

    def disentangle(self, text: str, topk: int = 768, visual: bool = False,
                    save_file: Optional[str] = None) -> Dict[str, float]:
        """Top-k (token -> weight) interpretation of an embedding;
        ``visual`` draws it as a word cloud (``utils.vis``)."""
        emb = self.embed(text)[0]
        k = min(topk, emb.shape[-1])
        idx = np.argsort(-emb)[:k]
        idx = [int(i) for i in idx if emb[i] != 0]
        token_ids = [i + self.config.shift_vocab_num for i in idx]
        tokens = self.tokenizer.convert_ids_to_tokens(token_ids)
        results = dict(zip(tokens, [float(emb[i]) for i in idx]))
        if visual:
            from ..utils.vis import wordcloud_from_dict
            wordcloud_from_dict(results, max_words=topk, save_file=save_file)
        return results

    dst = disentangle
