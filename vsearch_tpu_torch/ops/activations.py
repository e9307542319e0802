"""Nonnegative activations for vocabulary-space embeddings
(counterpart of ``vsearch_tpu/ops/activations.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def elu1p(x: torch.Tensor) -> torch.Tensor:
    """``elu(x) + 1``: a smooth, strictly-positive activation mapping raw
    vocabulary logits to nonnegative term weights."""
    return F.elu(x) + 1.0
