"""Whether what a granite-4.0-h cell served is correct: a sample of the
window's answers held to the plain reference (``reference/granite_vdr.py``)
by ``checks.py``'s numbers (``missed.t<tol>``, ``rerank_err.*``,
``rerank_err.request_p10_over.0.002``, ``order_violations`` ...), each a
gap relative to the request's best reference score. The sampling, the
limits and the quantiles are ``checks.py``'s; the reference queries and
candidates are the granite reference's, embedded in f32 (or fp8 for the
control) from the benchmark's own token ids and weights.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import corpus as corpus_mod
from .checks import (MISS_TOLERANCES, REQUEST_P10_OVER, _quantiles,
                     against_limits, draw_sample)
from .reference import granite_vdr as ref
from .reference.vdr import exact_topk, sparse_scores

__all__ = ["against_limits", "compare", "control", "draw_sample"]


def ref_cfg(cfg: Dict) -> Dict:
    """The reference's configuration: the model's ``config.json`` keys (the
    configuration file's top level) and VDR's head settings."""
    model = cfg["model"]
    return dict(cfg, shift_vocab_num=model["shift_vocab_num"],
                topk=model["topk"])


def _embed(cfg, sd, words_list, tok_table, vocab, max_len, dev, precision):
    toks = [corpus_mod.token_ids(w, tok_table, vocab["[CLS]"],
                                 vocab["[SEP]"], max_len)
            for w in words_list]
    return ref.embed_texts(sd, toks, ref_cfg(cfg), dev, precision)


def reference_queries(cfg, weights, tok_table, vocab, q_words, dev,
                      precision="f32") -> torch.Tensor:
    return _embed(cfg, weights[0], q_words, tok_table, vocab,
                  cfg["model"]["q_max_len"], dev, precision)


def reference_candidates(cfg, weights, tok_table, vocab, corpus, ids, dev,
                         precision="f32") -> torch.Tensor:
    return _embed(cfg, weights[1], [corpus.passage_words(int(i))
                                    for i in ids], tok_table, vocab,
                  cfg["model"]["p_max_len"], dev, precision)


def compare(cfg: Dict, traffic: Dict, corpus, weights, tok_table, vocab,
            q_words: Sequence[np.ndarray],
            served: Tuple[List[np.ndarray], List[np.ndarray]], dev
            ) -> Dict[str, float]:
    """The numbers of ``served`` (ids and scores of each sampled request)
    against the reference."""
    q = reference_queries(cfg, weights, tok_table, vocab, q_words, dev)
    return _numbers(cfg, traffic, corpus, weights, tok_table, vocab, q,
                    served, dev)


def _numbers(cfg, traffic, corpus, weights, tok_table, vocab, q, served,
             dev) -> Dict[str, float]:
    """``checks._numbers`` with the granite reference's candidates."""
    k, rerank = int(traffic["k"]), bool(traffic["rerank"])
    ids_l, scores_l = served
    score_err, kth_gap, missed = [], [], []
    rises = sum(int((np.diff(np.asarray(s, dtype=np.float64)) > 0).sum())
                for s in scores_l)
    for r in range(q.shape[0]):
        s_all, _, top = exact_topk(q[r], corpus.cols, k)
        ids = torch.as_tensor(ids_l[r], device=dev)
        got = s_all[ids].double()
        best = float(top[0]) if float(top[0]) > 0 else 1.0
        kk = min(len(ids), k)
        gap = (top[:kk].double() - torch.sort(got, descending=True)
               .values[:kk]).clamp_min(0)
        kth_gap.append(float(gap.max()) / best)
        missed.append([float((got < float(top[kk - 1]) - t * best)
                             .double().mean()) for t in MISS_TOLERANCES])
        if not rerank:
            s = torch.as_tensor(scores_l[r], device=dev, dtype=torch.float64)
            score_err.extend(((s - got).abs() / best).tolist())
    out = {"kth_gap.max": max(kth_gap),
           "kth_gap.median": float(np.median(kth_gap)),
           "order_violations": float(rises)}
    for t, share in zip(MISS_TOLERANCES, np.mean(missed, axis=0)):
        out[f"missed.t{t:g}"] = float(share)
    if not rerank:
        out.update(_quantiles("score_err", score_err))
        return out
    uniq = sorted({int(i) for ids in ids_l for i in ids})
    p_emb = reference_candidates(cfg, weights, tok_table, vocab, corpus,
                                 uniq, dev)
    at = {i: j for j, i in enumerate(uniq)}
    rows = [[at[int(i)] for i in ids] for ids in ids_l]
    rho = sparse_scores(q, p_emb, rows).double()
    s = torch.as_tensor(np.stack(scores_l), device=dev, dtype=torch.float64)
    best = rho.max(dim=1, keepdim=True).values.clamp_min(1e-30)
    err = (s - rho).abs() / best
    order = ((torch.sort(rho, dim=1, descending=True).values - rho)
             .clamp_min(0) / best)
    out.update(_quantiles("rerank_err", err.flatten().cpu().numpy()))
    per_request = torch.quantile(err, 0.1, dim=1)
    out[f"rerank_err.request_p10_over.{REQUEST_P10_OVER:g}"] = float(
        (per_request > REQUEST_P10_OVER).double().mean())
    out["order_gap.max"] = float(order.max())
    return out


def control(cfg: Dict, traffic: Dict, corpus, weights, tok_table, vocab,
            q_words: Sequence[np.ndarray], dev,
            precision: str = "fp8") -> Dict[str, float]:
    """The numbers when the reference at ``precision`` answers in the
    program's place (``checks.control``'s rule)."""
    k, rerank = int(traffic["k"]), bool(traffic["rerank"])
    q32 = reference_queries(cfg, weights, tok_table, vocab, q_words, dev)
    qlo = reference_queries(cfg, weights, tok_table, vocab, q_words, dev,
                            precision)
    ids_l, scores_l = [], []
    for r in range(qlo.shape[0]):
        _, ids, vals = exact_topk(qlo[r], corpus.cols, k)
        ids_l.append(ids.cpu().numpy())
        scores_l.append(vals.double().cpu().numpy())
    if rerank:
        uniq = sorted({int(i) for ids in ids_l for i in ids})
        p = reference_candidates(cfg, weights, tok_table, vocab, corpus,
                                 uniq, dev, precision)
        at = {i: j for j, i in enumerate(uniq)}
        rows = [[at[int(i)] for i in ids] for ids in ids_l]
        rho = sparse_scores(qlo, p, rows).cpu().numpy()
        order = np.argsort(-rho, axis=1, kind="stable")
        ids_l = [ids[o] for ids, o in zip(ids_l, order)]
        scores_l = [r_[o].astype(np.float64) for r_, o in zip(rho, order)]
    return _numbers(cfg, traffic, corpus, weights, tok_table, vocab, q32,
                    (ids_l, scores_l), dev)
