"""Host-side encoder wrapper: tokenize -> length-bucketed batches ->
forward on the device (counterpart of
``vsearch_tpu/models/encoder_base.py``; PyTorch runs eagerly, so there
is no jit cache and no mesh placement).

CUDA launches are asynchronous: the batch loop keeps every output on the
device and copies once at the end, so the host tokenizes the next batch
while the card runs the current one.

A module's weights are stored in its compute dtype for inference
(``build_module``); training keeps them in f32 (the trainer's master
copy) and computes in the configured dtype under ``torch.autocast``
(``compute_context``), and ``embed`` then does the same on the live
weights.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


def build_module(module_cls, config, init: Callable, seed: int,
                 device: torch.device, dtype: torch.dtype,
                 state_dict=None) -> nn.Module:
    """``module_cls(config)`` built without storage (meta device), then
    materialised on ``device``, initialised by ``init(module, generator)``
    from ``seed`` (an explicit generator), cast to ``dtype`` and put in
    eval mode; ``state_dict`` (the port's layout) then loads over it."""
    with torch.device("meta"):
        module = module_cls(config)
    module = module.to_empty(device=device)
    init(module, torch.Generator(device=device).manual_seed(seed))
    module = module.to(dtype).eval()
    if state_dict is not None:  # cast to the compute dtype on load
        module.load_state_dict(state_dict)
    return module


def compute_dtype(config) -> torch.dtype:
    """The dtype an encoder computes in: its BERT's ``dtype`` (f32 for
    encoders without one, such as the image encoder)."""
    return getattr(getattr(config, "bert", None), "dtype", torch.float32)


def compute_context(module: nn.Module, dtype: torch.dtype):
    """``torch.autocast`` to ``dtype`` when ``module`` stores wider weights
    than it computes in (f32 weights of a bf16 encoder under training),
    else a no-op context."""
    p = next(module.parameters())
    if dtype == torch.float32 or p.dtype == dtype:
        return contextlib.nullcontext()
    return torch.autocast(p.device.type, dtype=dtype)


def set_remat(module: nn.Module, on: bool) -> None:
    """Turn activation checkpointing on or off in every submodule that
    offers it (a ``remat`` attribute: BERT's layer stack, the VDR head's
    pooling). It applies only where gradients are being recorded."""
    for sub in module.modules():
        if hasattr(sub, "remat"):
            sub.remat = on


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
        ctx = compute_context(self.module, compute_dtype(self.config))
        for start in range(0, len(texts), batch_size):
            chunk = texts[start: start + batch_size]
            enc = self._pad_batch(self.encode(chunk, max_len=max_len),
                                  batch_size)
            t = [torch.from_numpy(enc[k]).to(self.device).long()
                 for k in ("input_ids", "token_type_ids", "attention_mask")]
            with ctx:
                outs.append((fn(*t), len(chunk)))
        return outs
