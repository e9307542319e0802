"""Top-k scoring/search primitives shared by every index type
(counterpart of ``vsearch_tpu/ops/search.py``).

Dense search scores the index in row chunks and keeps a running top-k,
so no f32 copy of the index and no [B, N] score matrix ever exists: at
wiki21m's 21,015,324 x 768 rows the bf16 index (32.3 GB) fits an 80 GB
card, its f32 copy would not. Products stay exact in f32 either way (see
``gemm_form``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

# working set of one chunk of dense search: the chunk upcast to f32 (on
# the upcast route), its [B, rows] f32 scores and the stable sort's
# values and int64 indices
DENSE_CHUNK_BYTES = 1 << 31

GEMM_BF16_F32 = "bf16 GEMM, f32 output (torch.mm out_dtype)"
GEMM_UPCAST_F32 = "f32 GEMM of a chunk upcast from the index dtype, TF32 off"


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


def topk_from_scores(scores: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) of the top-k entries along the last axis."""
    top_scores, top_ids = top_k(scores, k)
    return top_ids, top_scores


def merge_shard_topk(shard_ids: torch.Tensor, shard_scores: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k candidate lists into a global top-k.

    shard_ids/scores: [S, B, k_local], ids already global row ids. The S
    lists are concatenated in shard order and re-top-k'd stably, so when
    shards hold ascending row ranges and each list is ordered as
    ``top_k`` orders it, ties go to the lower id as in one top-k over
    all rows."""
    s, b, kl = shard_ids.shape
    return _topk_of_lists(shard_ids.movedim(0, 1).reshape(b, s * kl),
                          shard_scores.movedim(0, 1).reshape(b, s * kl), k)


def _topk_of_lists(ids_flat: torch.Tensor, scores_flat: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable top-k of [B, L] candidates laid side by side in row order:
    (ids, scores)."""
    top_scores, pos = top_k(scores_flat, k)
    return torch.gather(ids_flat, 1, pos), top_scores


@functools.lru_cache(maxsize=None)
def _has_bf16_f32_gemm(device_type: str) -> bool:
    """Whether ``torch.mm(a, b, out_dtype=torch.float32)`` runs for bf16
    operands on this device type (CUDA builds of recent PyTorch)."""
    try:
        a = torch.ones((1, 8), dtype=torch.bfloat16, device=device_type)
        out = torch.mm(a, a.T, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return False
    return out.dtype == torch.float32 and float(out[0, 0]) == 8.0


def gemm_form(q: torch.Tensor, vectors: torch.Tensor) -> str:
    """The product ``dense_topk_search`` takes for these operands.

    bf16 x bf16 products are exact in f32, so either form gives f32
    scores of exact products summed in f32, as the JAX package's
    ``preferred_element_type=f32`` does: a bf16 GEMM with an f32 output
    where PyTorch offers one on the device, else each chunk upcast to f32
    and multiplied with TF32 off (``device.set_f32_parity``). A bf16
    output would round the scores and reorder ids."""
    if (q.dtype == vectors.dtype == torch.bfloat16
            and _has_bf16_f32_gemm(vectors.device.type)):
        return GEMM_BF16_F32
    return GEMM_UPCAST_F32


def dense_chunk_rows(b: int, d: int) -> int:
    """Index rows scored at a time: ``DENSE_CHUNK_BYTES`` over one row's
    share of the working set (its f32 upcast, its B f32 scores and the
    sort's B values and int64 indices)."""
    return max(1, DENSE_CHUNK_BYTES // (4 * d + 16 * b))


def dense_topk_search(q: torch.Tensor, vectors: torch.Tensor, k: int,
                      precision=None, approx: bool = False,
                      recall_target: float = 0.99, *,
                      chunk_rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores = q @ vectors.T, then top-k. Returns (ids, scores) [B, k],
    ``k`` clamped to the rows. The JAX package's ``precision`` is accepted
    and unused (products are exact f32 here), and ``approx`` selects
    exactly, as the JAX package does off the TPU.

    The rows are scored ``chunk_rows`` at a time (default
    ``dense_chunk_rows``); each chunk's top-k is merged into the running
    one by ``merge_shard_topk``'s rule (candidates concatenated in row
    order, stable top-k), so ties go to the lower id across chunks as in
    ``jax.lax.top_k`` over the whole row."""
    n = vectors.shape[0]
    k = min(k, n)
    if n == 0:
        return (torch.zeros((q.shape[0], 0), dtype=torch.long,
                            device=vectors.device),
                torch.zeros((q.shape[0], 0), device=vectors.device))
    chunk = chunk_rows or dense_chunk_rows(q.shape[0], vectors.shape[1])
    bf16_out = gemm_form(q, vectors) == GEMM_BF16_F32
    qf = q if bf16_out else q.float()
    best_ids = best_scores = None
    for s in range(0, n, chunk):
        blk = vectors[s:s + chunk]
        if bf16_out:
            scores = torch.mm(qf, blk.T, out_dtype=torch.float32)
        else:
            scores = qf @ blk.float().T
        top_scores, top_ids = top_k(scores, min(k, scores.shape[1]))
        top_ids = top_ids + s
        if best_ids is None:
            best_ids, best_scores = top_ids, top_scores
        else:  # merge_shard_topk's operation on lists of unequal length
            best_ids, best_scores = _topk_of_lists(
                torch.cat([best_ids, top_ids], dim=1),
                torch.cat([best_scores, top_scores], dim=1), k)
    return best_ids, best_scores
