"""Standalone negative-mining helper (a copy of
``vsearch_tpu/utils/neg_utils.py``).

The reference ships a near-duplicate of ``Retriever.retireve_negatives``
here (reference: src/ir/utils/neg_utils.py:13-66). We keep the module for
API parity but delegate to the single implementation on ``Retriever``.
"""
from __future__ import annotations

from typing import List


def retrieve_negatives(retriever, q_emb, answers: List[List[str]],
                       ret_neg_num: int = 1, ret_topk: int = 100,
                       pool_size: int = 20, ret_dropout: float = 0.0,
                       index=None, seed=None) -> List[List[str]]:
    return retriever.retrieve_negatives(
        q_emb, answers=answers, ret_neg_num=ret_neg_num,
        ret_topk=ret_topk, pool_size=pool_size, ret_dropout=ret_dropout,
        index=index, seed=seed)


# reference-spelling alias
retireve_negatives = retrieve_negatives
