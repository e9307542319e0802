"""Exact sparse search (counterpart of ``exact_search`` in
``vsearch_tpu/ops/two_stage.py``; the binary-support proxy of that module
is not ported yet)."""
from __future__ import annotations

from typing import Tuple

import torch

from .ell import ELLMatrix, ell_matvec_chunked
from .search import top_k


def exact_search(q: torch.Tensor, ell: ELLMatrix, k: int,
                 chunk_rows: int = 65536
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, k] by exact chunked gather scoring."""
    scores = ell_matvec_chunked(q, ell, chunk_rows)
    k = min(k, scores.shape[1])
    s, i = top_k(scores, k)
    return i, s
