"""Two-stage sparse search primitives (counterpart of
``vsearch_tpu/ops/two_stage.py``): exact search, the exact rerank of
candidate rows that follows a cheaper selection, and the binary-support
proxy that makes that selection for large real-valued indexes (the
support's bits scored by the bit-packed kernels of ``ops.bitpack``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .ell import ELLMatrix, ell_matvec_chunked, widen_cols
from .search import top_k


def exact_search(q: torch.Tensor, ell: ELLMatrix, k: int,
                 chunk_rows: int = 65536
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, k] by exact chunked gather scoring."""
    scores = ell_matvec_chunked(q, ell, chunk_rows)
    k = min(k, scores.shape[1])
    s, i = top_k(scores, k)
    return i, s


def binary_proxy_search(q: torch.Tensor, ell: ELLMatrix, bitmat, k: int,
                        num_candidates: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, k] of a large real-valued sparse index in two
    stages: the rows' binary support (``bitmat``, the ELL's ids packed by
    kernel #1) is scored against the query and the top candidates are
    re-scored exactly from the weighted ELL (``exact_rerank``).

    Stage 1 takes the fused bucketed kernel (#3) for ``capped = min(
    num_candidates, N_pad / BUCKET, true rows)`` candidates: the bucket
    structure and the true row count (not the padded one) bound how many
    distinct candidates it can give. When that is fewer than ``k``, the
    support scores of every row (kernel #2) go through an exact top-k of
    ``min(max(num_candidates, k), rows)`` instead."""
    from .bitpack import BUCKET, bitpack_bucketed_topk, bitpack_scores

    capped = min(num_candidates, bitmat.words.shape[0] // BUCKET,
                 bitmat.num_rows)
    if capped < k:
        scores = bitpack_scores(q, bitmat)[:, : ell.shape[0]]
        c = min(max(num_candidates, k), scores.shape[1])
        _, cand = top_k(scores, c)
        return exact_rerank(q, ell, cand, k)
    cand, _ = bitpack_bucketed_topk(q, bitmat, k=capped)
    return exact_rerank(q, ell, cand, k)


def exact_rerank(q: torch.Tensor, ell: ELLMatrix, cand: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 scores of the candidate rows ``cand`` [B, C] only;
    returns (ids, scores) [B, k].

    One gather of B*C*nnz_pad query values, over the zero-padded query
    (sentinel columns hit the zero at index V). An ELL that is not
    sentinel-padded is masked by ``nnz``; ``vals``, when present, weight
    the gathered values. ``ell.cols`` may hold int16 bit patterns of
    uint16 ids (the block tier's compact ELL)."""
    b, c = cand.shape
    nnz_pad = ell.nnz_pad
    v = ell.num_cols
    flat = cand.reshape(-1).long()
    crows = widen_cols(ell.cols[flat]).long().clamp(0, v)
    qp = F.pad(q.float(), (0, 1))  # [B, V+1]
    g = torch.gather(qp, 1, crows.view(b, c * nnz_pad)).view(b, c, nnz_pad)
    if ell.vals is not None:
        g = g * ell.vals[flat].view(b, c, nnz_pad).float()
    elif not ell.sentinel_padded:
        valid = (torch.arange(nnz_pad, device=g.device)[None, None, :]
                 < ell.nnz[flat].view(b, c, 1))
        g = g * valid.float()
    scores = g.sum(dim=-1)  # [B, C]
    top_scores, pos = top_k(scores, k)
    return torch.gather(cand, 1, pos), top_scores
