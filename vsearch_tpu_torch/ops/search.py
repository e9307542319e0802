"""Top-k scoring/search primitives shared by every index type
(counterpart of ``vsearch_tpu/ops/search.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


def top_k(scores: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along the last axis,
    ties broken toward the lower index as ``jax.lax.top_k`` does.

    ``torch.topk`` promises no order among equal values, and binary
    bag-of-token scores tie often (rows matching the same query terms),
    so a stable descending sort keeps results identical to the JAX
    package's."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def dense_topk_search(q: torch.Tensor, vectors: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores = q @ vectors.T, then top-k. Returns (ids, scores) [B, k].

    Inputs keep their storage type (bf16 for the index); products are
    taken in f32, which is exact for bf16 values, with f32 accumulation
    (TF32 must be off: ``device.set_f32_parity``)."""
    scores = q.float() @ vectors.float().T
    top_scores, top_ids = top_k(scores, k)
    return top_ids, top_scores
