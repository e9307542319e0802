"""Bi-encoder: a query encoder + a passage encoder behind one config
(counterpart of ``vsearch_tpu/biencoder.py``; checkpoint save/load comes
in a later slice, weights load through ``models.convert``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .device import resolve_device
from .models.registry import get_encoder_classes


def join_corpus(corpus) -> List[str]:
    """Normalize corpus entries to strings: dicts with title/text join as
    "title [SEP] text"."""
    processed = []
    for p in corpus:
        if isinstance(p, str):
            processed.append(p)
        elif isinstance(p, dict):
            body = p.get("text") or p.get("contents") or ""
            if p.get("title"):
                processed.append(f"{p['title']} [SEP] {body}")
            else:
                processed.append(body)
        else:
            raise TypeError(
                f"corpus entries must be str or dict, got {type(p)}")
    return processed


@dataclasses.dataclass
class BiEncoderConfig:
    encoder_q: Dict[str, Any] = dataclasses.field(default_factory=dict)
    encoder_p: Dict[str, Any] = dataclasses.field(default_factory=dict)
    max_len: int = 512
    shared_encoder: bool = False


class BiEncoder:
    """Holds ``encoder_q`` and ``encoder_p``, built through the registry
    from config dicts with a ``type`` key. Weights come from ``seed``
    (query encoder) and ``seed + 1`` (passage encoder)."""

    config_class = BiEncoderConfig

    def __init__(self, config: BiEncoderConfig, tokenizer=None,
                 seed: int = 0, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.default_batch_size = 32
        q_cfg_cls, q_cls = get_encoder_classes(config.encoder_q["type"])
        q_cfg = q_cfg_cls.from_dict(config.encoder_q)
        if config.shared_encoder:
            # one encoder for both sides, at the larger of the two lengths
            p_max = config.encoder_p.get("max_len", q_cfg.max_len)
            if p_max > q_cfg.max_len:
                q_cfg = dataclasses.replace(q_cfg, max_len=p_max)
        self.encoder_q = q_cls(q_cfg, tokenizer=tokenizer, seed=seed,
                               device=self.device)
        if config.shared_encoder:
            self.encoder_p = self.encoder_q
        else:
            p_cfg_cls, p_cls = get_encoder_classes(config.encoder_p["type"])
            self.encoder_p = p_cls(p_cfg_cls.from_dict(config.encoder_p),
                                   tokenizer=tokenizer, seed=seed + 1,
                                   device=self.device)

    def encode_queries(self, queries: List[str],
                       batch_size: Optional[int] = None,
                       **kwargs) -> np.ndarray:
        batch_size = batch_size or self.default_batch_size
        return self.encoder_q.embed(queries, batch_size=batch_size,
                                    activate_lexical=False, **kwargs)

    def encode_corpus(self, corpus: Union[List[str], List[Dict[str, str]]],
                      batch_size: Optional[int] = None,
                      max_len: Optional[int] = None,
                      **kwargs) -> np.ndarray:
        batch_size = batch_size or self.default_batch_size
        return self.encoder_p.embed(join_corpus(corpus),
                                    batch_size=batch_size, max_len=max_len,
                                    activate_lexical=False, **kwargs)

    def explain(self, q: str, p: str, topk: int = 768) -> Dict[str, float]:
        """Token-level q x p attribution, largest first."""
        q_dst = self.encoder_q.dst(q, topk=topk)
        p_dst = self.encoder_p.dst(p, topk=topk)
        inter = {
            key: q_dst.get(key, 0) * p_dst.get(key, 0)
            for key in set(q_dst) | set(p_dst)
            if q_dst.get(key, 0) * p_dst.get(key, 0) != 0
        }
        return dict(sorted(inter.items(), key=lambda kv: -kv[1]))
