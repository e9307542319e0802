"""Retrieval-quality metrics: NDCG@k, MRR@k, Recall@k (counterpart of
``vsearch_tpu/eval/retrieval_eval.py``).

Any (queries, corpus, qrels) triple can be scored through a bi-encoder's
``encode_queries``/``encode_corpus``, the two methods mteb/beir-style
harnesses call.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import numpy as np


def dcg_at_k(rels: Sequence[float], k: int) -> float:
    return sum(r / math.log2(i + 2) for i, r in enumerate(rels[:k]))


def ndcg_at_k(ranked_rels: Sequence[float],
              ideal_rels: Sequence[float], k: int) -> float:
    ideal = dcg_at_k(sorted(ideal_rels, reverse=True), k)
    if ideal == 0:
        return 0.0
    return dcg_at_k(ranked_rels, k) / ideal


def evaluate_rankings(run: Mapping[str, Sequence[str]],
                      qrels: Mapping[str, Mapping[str, float]],
                      ks: Sequence[int] = (1, 5, 10, 20, 100)
                      ) -> Dict[str, float]:
    """Score a retrieval run.

    run: query_id -> ranked doc_id list.
    qrels: query_id -> {doc_id: relevance}.
    Returns ndcg@k, mrr@k, recall@k averaged over queries.
    """
    metrics = {f"ndcg@{k}": 0.0 for k in ks}
    metrics.update({f"recall@{k}": 0.0 for k in ks})
    metrics.update({f"mrr@{k}": 0.0 for k in ks})
    n = 0
    for qid, ranked in run.items():
        rel = qrels.get(qid, {})
        if not rel:
            continue
        n += 1
        ranked_rels = [rel.get(d, 0.0) for d in ranked]
        ideal = list(rel.values())
        num_rel = sum(1 for v in rel.values() if v > 0)
        # first relevant rank
        first = next((i for i, r in enumerate(ranked_rels) if r > 0),
                     None)
        for k in ks:
            metrics[f"ndcg@{k}"] += ndcg_at_k(ranked_rels, ideal, k)
            got = sum(1 for r in ranked_rels[:k] if r > 0)
            metrics[f"recall@{k}"] += got / max(num_rel, 1)
            metrics[f"mrr@{k}"] += (1.0 / (first + 1)
                                    if first is not None and first < k
                                    else 0.0)
    if n:
        metrics = {m: v / n for m, v in metrics.items()}
    return metrics


def evaluate_biencoder(model, queries: Mapping[str, str],
                       corpus: Mapping[str, dict],
                       qrels: Mapping[str, Mapping[str, float]],
                       k: int = 100, batch_size: int = 64,
                       ks: Sequence[int] = (1, 5, 10, 20, 100)
                       ) -> Dict[str, float]:
    """BEIR-style end-to-end eval: encode corpus + queries with the
    bi-encoder, rank by dot product, score."""
    doc_ids = list(corpus.keys())
    doc_inputs = [corpus[d] for d in doc_ids]
    q_ids = list(queries.keys())
    q_emb = np.asarray(model.encode_queries(
        [queries[q] for q in q_ids], batch_size=batch_size))
    p_emb = np.asarray(model.encode_corpus(doc_inputs,
                                           batch_size=batch_size))
    scores = q_emb @ p_emb.T
    top = np.argsort(-scores, axis=1)[:, :k]
    run = {q_ids[i]: [doc_ids[j] for j in top[i]]
           for i in range(len(q_ids))}
    return evaluate_rankings(run, qrels, ks=ks)
