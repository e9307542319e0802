"""Host-side encoder wrapper: tokenize -> length-bucketed batches ->
forward on the device (counterpart of
``vsearch_tpu/models/encoder_base.py``; PyTorch runs eagerly, so there
is no jit cache and no mesh placement).

CUDA launches are asynchronous: the batch loop keeps every output on the
device and copies once at the end, so the host tokenizes the next batch
while the card runs the current one.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device


def length_buckets(max_len: int, min_bucket: int = 32) -> List[int]:
    """Doubling buckets: 32, 64, ..., max_len (always includes max_len)."""
    buckets = []
    b = min_bucket
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class TextEncoderBase:
    """Shared host-side machinery for VDR-style text encoders."""

    def __init__(self, config, tokenizer, device="cuda"):
        self.config = config
        self.tokenizer = tokenizer
        self.device = resolve_device(device)

    def encode(self, texts: Union[str, List[str]],
               max_len: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Tokenize to [N, bucket] int32 arrays padded to the smallest
        length bucket that holds the longest row."""
        max_len = max_len or self.config.max_len
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            raise ValueError("cannot encode an empty list of texts")
        id_lists = self.tokenizer.encode_batch(texts, max_length=max_len)
        longest = max(len(ids) for ids in id_lists)
        bucket = pick_bucket(longest, length_buckets(max_len))
        n = len(texts)
        # pad positions hold the real pad id; the mask comes from lengths
        ids = np.full((n, bucket), self.tokenizer.pad_id, dtype=np.int32)
        attn = np.zeros((n, bucket), dtype=np.int32)
        for i, row in enumerate(id_lists):
            ids[i, : len(row)] = row
            attn[i, : len(row)] = 1
        return {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
                "attention_mask": attn}

    def _pad_batch(self, enc: Dict[str, np.ndarray], batch_size: int
                   ) -> Dict[str, np.ndarray]:
        pad = batch_size - enc["input_ids"].shape[0]
        if pad <= 0:
            return enc
        return {k: np.pad(v, ((0, pad), (0, 0))) for k, v in enc.items()}

    def _run_batches(self, texts: List[str], batch_size: int, max_len: int,
                     fn: Callable) -> List[Tuple[object, int]]:
        """``fn(ids, token_types, mask)`` on each batch of ``batch_size``
        texts (the last one padded with empty rows). Returns
        ``(device output, real row count)`` per batch."""
        outs = []
        for start in range(0, len(texts), batch_size):
            chunk = texts[start: start + batch_size]
            enc = self._pad_batch(self.encode(chunk, max_len=max_len),
                                  batch_size)
            t = [torch.from_numpy(enc[k]).to(self.device).long()
                 for k in ("input_ids", "token_type_ids", "attention_mask")]
            outs.append((fn(*t), len(chunk)))
        return outs
