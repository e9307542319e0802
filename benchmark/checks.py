"""Whether what the timed path served is correct: a sample of the window's
answers held to the plain reference (``reference/vdr.py``).

The reference embeds the sampled queries in float32 from the benchmark's
own token ids and weights, scores every passage of the corpus exactly,
and, with the rerank, embeds each served candidate in float32 and rescores
it. Each number is a gap relative to the request's best reference score:

- ``score_err.median`` / ``score_err.max``: the served first-stage score of
  a row against that row's reference score (first stage only);
- ``kth_gap.max``: how far the j-th best reference score among the served
  rows lies below the reference's own j-th best (rows missed, or answers
  that are not the query's);
- ``missed.t<tol>``: the share of served rows whose reference score lies
  below the reference's k-th best by more than ``tol`` of its best (with
  the rerank, the rows are the first stage's candidates, whatever order
  the rerank gave them);
- ``rerank_err.median`` / ``rerank_err.max``: the served rerank score of a
  candidate against the reference's rescoring of it;
- ``rerank_err.request_p10_over.0.002``: the share of the sampled
  requests whose own 10th percentile of that error passes 0.002 (a
  request answered with another's rescoring stands out here, where the
  pooled quantiles barely move while most requests are sound);
- ``order_violations``: served scores that rise down a request's list;
- ``order_gap.max``: how far the j-th served candidate's reference
  rescoring lies below the j-th best of the served candidates'.

``control`` puts the reference itself, computed in fp8, in the program's
place.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import corpus as corpus_mod
from .reference import vdr as ref


# a served row is "missed" when its reference score lies below the
# reference's k-th best by more than this share of the best
MISS_TOLERANCES = (0.001, 0.05, 0.1)
# a request's rerank is "off" when its own 10th percentile of the rerank
# error passes this share of its best
REQUEST_P10_OVER = 0.002


def draw_sample(answered: np.ndarray, queries, seed: int, size: int
                ) -> List[int]:
    """``size`` answered requests drawn from the seed, the one with the
    longest query among them."""
    answered = np.asarray(answered)
    if len(answered) == 0:
        return []
    longest = int(answered[np.argmax([len(queries.words[i])
                                      for i in answered])])
    rng = np.random.default_rng([seed, 7])
    rest = answered[answered != longest]
    pick = rng.choice(rest, size=min(size - 1, len(rest)), replace=False)
    return [longest] + sorted(int(i) for i in pick)


def _ref_cfg(model: Dict) -> Dict:
    return dict(model["bert"], shift_vocab_num=model["shift_vocab_num"],
                topk=model["topk"])


def _tokens(words_list, tok_table, vocab, max_len):
    return [corpus_mod.token_ids(w, tok_table, vocab["[CLS]"],
                                 vocab["[SEP]"], max_len)
            for w in words_list]


def reference_queries(cfg, weights, tok_table, vocab, q_words, dev,
                      precision="f32") -> torch.Tensor:
    model = cfg["model"]
    toks = _tokens(q_words, tok_table, vocab, model["q_max_len"])
    return ref.embed_texts(weights[0], toks, _ref_cfg(model), dev, precision)


def reference_candidates(cfg, weights, tok_table, vocab, corpus, ids, dev,
                         precision="f32") -> torch.Tensor:
    model = cfg["model"]
    toks = _tokens([corpus.passage_words(int(i)) for i in ids], tok_table,
                   vocab, model["p_max_len"])
    return ref.embed_texts(weights[1], toks, _ref_cfg(model), dev, precision)


def compare(cfg: Dict, traffic: Dict, corpus, weights, tok_table, vocab,
            q_words: Sequence[np.ndarray],
            served: Tuple[List[np.ndarray], List[np.ndarray]], dev
            ) -> Dict[str, float]:
    """The numbers of ``served`` (ids and scores of each sampled request)
    against the reference."""
    q = reference_queries(cfg, weights, tok_table, vocab, q_words, dev)
    return _numbers(cfg, traffic, corpus, weights, tok_table, vocab, q,
                    served, dev)


def _quantiles(name: str, err) -> Dict[str, float]:
    err = np.asarray(err, dtype=np.float64)
    return {f"{name}.p10": float(np.percentile(err, 10)),
            f"{name}.p25": float(np.percentile(err, 25)),
            f"{name}.median": float(np.median(err)),
            f"{name}.max": float(np.max(err))}


def _numbers(cfg, traffic, corpus, weights, tok_table, vocab, q, served,
             dev) -> Dict[str, float]:
    k, rerank = int(traffic["k"]), bool(traffic["rerank"])
    q_emb = q
    ids_l, scores_l = served
    score_err, kth_gap, missed = [], [], []
    rises = sum(int((np.diff(np.asarray(s, dtype=np.float64)) > 0).sum())
                for s in scores_l)
    for r in range(q_emb.shape[0]):
        s_all, _, top = ref.exact_topk(q_emb[r], corpus.cols, k)
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
    rho = ref.sparse_scores(q_emb, p_emb, rows).double()
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
    program's place: its own exact first stage and, with the rerank, its
    own rescoring of those candidates, in its order."""
    k, rerank = int(traffic["k"]), bool(traffic["rerank"])
    q32 = reference_queries(cfg, weights, tok_table, vocab, q_words, dev)
    qlo = reference_queries(cfg, weights, tok_table, vocab, q_words, dev,
                            precision)
    ids_l, scores_l = [], []
    for r in range(qlo.shape[0]):
        _, ids, vals = ref.exact_topk(qlo[r], corpus.cols, k)
        ids_l.append(ids.cpu().numpy())
        scores_l.append(vals.double().cpu().numpy())
    if rerank:
        uniq = sorted({int(i) for ids in ids_l for i in ids})
        p = reference_candidates(cfg, weights, tok_table, vocab, corpus,
                                 uniq, dev, precision)
        at = {i: j for j, i in enumerate(uniq)}
        rows = [[at[int(i)] for i in ids] for ids in ids_l]
        rho = ref.sparse_scores(qlo, p, rows).cpu().numpy()
        order = np.argsort(-rho, axis=1, kind="stable")
        ids_l = [ids[o] for ids, o in zip(ids_l, order)]
        scores_l = [r_[o].astype(np.float64) for r_, o in zip(rho, order)]
    return _numbers(cfg, traffic, corpus, weights, tok_table, vocab, q32,
                    (ids_l, scores_l), dev)


def against_limits(numbers: Dict[str, float], limits: Dict[str, float]
                   ) -> List[Dict]:
    """[{"name", "value", "limit"}] of each limited number; a number
    passes at or under its limit. A limit on a number the cell does not
    compute is an error of the traffic file."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"limits on numbers this cell does not compute: "
                       f"{missing} (it computes {sorted(numbers)})")
    return [{"name": name, "value": numbers[name], "limit": float(limit)}
            for name, limit in limits.items()]
