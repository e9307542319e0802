"""Contrastive losses for bi-encoder training (counterpart of
``vsearch_tpu/train/loss.py``).

Batch layout (as in the JAX package): passages are ordered
[N positives] + [negatives...], so the positive for query ``i`` is passage
row ``i`` and every other row is a negative. The top-k masks are built
from the embeddings but carry no gradient, as ``jax.lax.top_k`` masks do
not; ``scaled_loss`` detaches the ratio where JAX has ``stop_gradient``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.sparse import build_cts_mask, build_topk_mask

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class VDRLossConfig:
    """Training-loss options (reference conf/train/*.yaml + loss_utils)."""

    semi: bool = True          # 4-term semi-parametric InfoNCE
    sym_loss: bool = True      # symmetric (q->p and p->q) CE
    scaled_loss: bool = False  # loss1 + (loss1/loss2).detach()*loss2
    temperature: float = 1.0
    topk: int = 768            # sparsification k for the *_topk terms
    cts_mask: bool = False     # contrastive vocab-slot regularizer
    cts_mask_weight: float = 1.0
    cts_mask_norm: bool = False


def _diagonal_ce(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax CE with row ``i``'s target at column ``i``: (mean loss,
    count of rows whose argmax is the target)."""
    n = scores.shape[0]
    logprobs = F.log_softmax(scores, dim=1)
    targets = torch.arange(n, device=scores.device)
    loss = -logprobs[targets, targets].mean()
    correct = (logprobs.argmax(dim=1) == targets).sum()
    return loss, correct


def biencoder_nll_loss(q_emb: torch.Tensor, p_emb: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch softmax CE with positives on the leading diagonal
    (reference loss_utils.py:302-340). Returns (loss, correct_count)."""
    return _diagonal_ce(q_emb @ p_emb.T)


def symmetry_biencoder_nll_loss(q_emb: torch.Tensor, p_emb: torch.Tensor,
                                temperature: float = 1.0,
                                scaled_loss: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric q->p + p->q CE (reference loss_utils.py:343-388).
    The p->q direction uses only the positive rows of p."""
    n = q_emb.shape[0]
    scores = q_emb @ p_emb.T  # [N, M]
    loss1, correct = _diagonal_ce(scores / temperature)
    loss2, _ = _diagonal_ce(scores.T[:n, :] / temperature)
    if scaled_loss:
        return loss1 + (loss1 / loss2).detach() * loss2, correct
    return loss1 + loss2, correct


def _loss_fn(cfg: VDRLossConfig):
    if cfg.sym_loss:
        return lambda q, p: symmetry_biencoder_nll_loss(
            q, p, temperature=cfg.temperature, scaled_loss=cfg.scaled_loss)
    if cfg.temperature != 1.0 or cfg.scaled_loss:
        # reference parity: the asymmetric NLL has no temperature or
        # loss scaling (loss_utils.py:302-340) — warn instead of
        # silently training a different model than the config claims
        logger.warning(
            "temperature=%s / scaled_loss=%s apply only with "
            "sym_loss=true; the asymmetric NLL ignores them",
            cfg.temperature, cfg.scaled_loss)
    return biencoder_nll_loss


def sparsify_with_lexical(emb: torch.Tensor, bow: torch.Tensor, k: int
                          ) -> torch.Tensor:
    """topk(emb) OR lexical dims, then mask — the reference's
    ``fetch_global_vectors`` sparsification (loss_utils.py:16-19)."""
    with torch.no_grad():
        mask = build_topk_mask(emb, k=k) | (bow > 0)
    return emb * mask


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def compute_vdr_loss(q_emb: torch.Tensor, p_emb: torch.Tensor,
                     q_bin: torch.Tensor, p_bin: torch.Tensor,
                     cfg: VDRLossConfig) -> Tuple[torch.Tensor, dict]:
    """4-term (or 2-term) semi-parametric symmetric InfoNCE
    (reference loss_utils.py:109-207).

    q_emb [N, V], p_emb [M, V] (M = N * (1 + negs), positives first),
    q_bin/p_bin binary bag-of-words of the same shapes.
    Returns (loss, metrics dict with correct counts).
    """
    loss_func = _loss_fn(cfg)
    n = q_emb.shape[0]

    q_topk = sparsify_with_lexical(q_emb, q_bin, cfg.topk)
    p_topk = sparsify_with_lexical(p_emb, p_bin, cfg.topk)

    if cfg.semi:
        loss_1, correct_1 = loss_func(q_topk, p_emb)
        loss_2, correct_2 = loss_func(q_emb, p_topk)

        if cfg.cts_mask:
            # vocab-slot regularizer (loss_utils.py:179-191): activate
            # per-row unused slots in the binary views, deactivate them in
            # the dense opposite view
            cts_q = build_cts_mask(q_bin)  # [N, V]
            deact_p = torch.ones_like(p_emb)
            deact_p[:n] = 1.0 - cts_q.to(p_emb.dtype)
            cts_qf = cts_q.to(q_emb.dtype)
            if cfg.cts_mask_norm:
                cts_qf = _unit_rows(cts_qf)
            q_bin = q_bin + cts_qf * cfg.cts_mask_weight
            p_emb_r = p_emb * deact_p

            cts_p = build_cts_mask(p_bin)  # [M, V]
            deact_q = 1.0 - cts_p[:n].to(q_emb.dtype)
            cts_pf = cts_p.to(p_emb.dtype)
            if cfg.cts_mask_norm:
                cts_pf = _unit_rows(cts_pf)
            p_bin = p_bin + cts_pf * cfg.cts_mask_weight
            q_emb_r = q_emb * deact_q

            loss_3, correct_3 = loss_func(q_bin, p_emb_r)
            loss_4, correct_4 = loss_func(q_emb_r, p_bin)
        else:
            loss_3, correct_3 = loss_func(q_bin, p_emb)
            loss_4, correct_4 = loss_func(q_emb, p_bin)

        loss = (loss_1 + loss_2 + loss_3 + loss_4) / 4
        correct_para = (correct_1 + correct_2) / 2
        correct_semi = (correct_3 + correct_4) / 2
    else:
        loss_1, correct_1 = loss_func(q_topk, p_emb)
        loss_2, correct_2 = loss_func(q_bin, p_emb)
        loss = (loss_1 + loss_2) / 2
        correct_para = correct_1
        correct_semi = correct_2

    return loss, {"correct_parametric": correct_para,
                  "correct_semiparametric": correct_semi,
                  "batch_size": torch.tensor(n, device=q_emb.device)}


def compute_dpr_loss(q_emb: torch.Tensor, p_emb: torch.Tensor,
                     cfg: VDRLossConfig) -> Tuple[torch.Tensor, dict]:
    """Dense InfoNCE (reference loss_utils.py:211-224)."""
    loss, correct = _loss_fn(cfg)(q_emb, p_emb)
    return loss, {"correct_parametric": correct,
                  "correct_semiparametric": correct,
                  "batch_size": torch.tensor(q_emb.shape[0],
                                            device=q_emb.device)}
