"""Vocabulary-space sparsification primitives
(counterpart of ``vsearch_tpu/ops/sparse.py``)."""
from __future__ import annotations

import torch


def build_topk_mask(embs: torch.Tensor, k: int = 768, axis: int = -1
                    ) -> torch.Tensor:
    """Boolean mask marking the top-``k`` entries along ``axis`` (``k`` is
    clamped to the axis length)."""
    k = min(k, embs.shape[axis])
    _, idx = torch.topk(embs, k, dim=axis)
    mask = torch.zeros(embs.shape, dtype=torch.bool, device=embs.device)
    return mask.scatter(axis, idx, True)


def topk_sparsify(emb_dense: torch.Tensor, k: int, axis: int = -1
                  ) -> torch.Tensor:
    """Zero out everything but the top-``k`` entries along ``axis``."""
    return emb_dense * build_topk_mask(emb_dense, k=k, axis=axis)


def build_bow_mask(text_ids: torch.Tensor, vocab_size: int = 30522,
                   shift_num: int = 0, norm: bool = False,
                   dtype=torch.float32) -> torch.Tensor:
    """Binary bag-of-words vector [N, vocab_size - shift_num] from token
    ids. Ids below ``shift_num`` fall off after the shift slice."""
    n = text_ids.shape[0]
    full = torch.zeros((n, vocab_size), dtype=torch.bool,
                       device=text_ids.device)
    full.scatter_(1, text_ids.long(), True)
    bow = full[:, shift_num:].to(dtype)
    if norm:
        denom = torch.linalg.vector_norm(bow, dim=-1, keepdim=True)
        bow = bow / torch.clamp(denom, min=1e-12)
    return bow


def init_cts_mask_like(embs: torch.Tensor) -> torch.Tensor:
    """Round-robin assignment of vocab slots to batch rows: slot ``v``
    belongs to row ``v % batch_size`` ([N, V] bool)."""
    batch_size, vocab_size = embs.shape
    slot_owner = torch.arange(vocab_size, device=embs.device) % batch_size
    return slot_owner[None, :] == torch.arange(batch_size,
                                               device=embs.device)[:, None]


def build_cts_mask(bow_embs: torch.Tensor) -> torch.Tensor:
    """Contrastive-mask regularizer: each row's round-robin vocab slots
    that are NOT in the batch's bag-of-words union ([N, V] bool)."""
    bow_batch = bow_embs.sum(0) > 0  # [V] union of active slots
    return init_cts_mask_like(bow_embs) & ~bow_batch[None, :]
