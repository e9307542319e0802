"""Corpora and queries of the granite-4.0-h cells, drawn from the seed as
``corpus.py`` draws them for the BERT-sized cells, over
``vocab_granite``'s words: a passage is words drawn Zipf(1) over the
100,017 words of ``vocab_granite.word_list()``, one token each, kept as
ids on the card (int32: the word indices pass int16), its bag-of-token
row built from the ids; a passage's text is made only when the rerank
asks for it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import vocab as vocab_mod
from . import vocab_granite
from .corpus import (Corpus, Queries, RenderedCorpus, draw_lengths,
                     max_words, round_up)


def make_corpus(n: int, lengths: Dict, seed: int, device, shift: int,
                token_ids: np.ndarray, keep_words: bool,
                col_dtype=torch.int32, chunk_rows: int = 1 << 19
                ) -> Corpus:
    """``n`` passages drawn on ``device`` from ``seed`` in chunks of
    ``chunk_rows`` (one generator), over ``vocab_granite``'s columns."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    probs = vocab_mod.zipf_probs(len(token_ids))
    cdf = torch.from_numpy(np.cumsum(probs)).to(dev)
    cdf[-1] = 1.0
    tok = torch.from_numpy(token_ids.astype(np.int64) - shift).to(dev)
    v = vocab_granite.VOCAB_SIZE - shift
    width = round_up(max_words(lengths), 8)
    cols = torch.empty((n, width), dtype=col_dtype, device=dev)
    nnz = torch.empty(n, dtype=torch.int32, device=dev)
    lens_all = torch.empty(n, dtype=torch.int32, device=dev)
    words_host: List[np.ndarray] = []
    pos = torch.arange(width, device=dev)
    for r0 in range(0, n, chunk_rows):
        rows = min(chunk_rows, n - r0)
        ln = draw_lengths(lengths, rows, gen, dev)
        u = torch.rand((rows, width), generator=gen, device=dev,
                       dtype=torch.float64)
        w = torch.searchsorted(cdf, u).clamp_max(len(token_ids) - 1)
        valid = pos[None, :] < ln[:, None]
        if keep_words:
            words_host.append(w[valid].to(torch.int32).cpu().numpy())
        ids = torch.where(valid, tok[w], v)
        s = torch.sort(ids, dim=1).values
        dup = torch.zeros_like(valid)
        dup[:, 1:] = s[:, 1:] == s[:, :-1]
        s = torch.sort(s.masked_fill(dup, v), dim=1).values
        cols[r0:r0 + rows] = s.to(col_dtype)
        nnz[r0:r0 + rows] = (s < v).sum(dim=1, dtype=torch.int32)
        lens_all[r0:r0 + rows] = ln
        del u, w, valid, ids, s, dup
    lens_host = lens_all.cpu().numpy()
    words = offsets = None
    if keep_words:
        words = np.concatenate(words_host)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens_host, out=offsets[1:])
    return Corpus(cols=cols, nnz=nnz, num_cols=v, lengths=lens_host,
                  nnz_host=nnz.cpu().numpy(), words=words, offsets=offsets)


class GraniteRenderedCorpus(RenderedCorpus):
    """``RenderedCorpus`` over ``vocab_granite``'s words."""

    def __init__(self, corpus: Corpus):
        super().__init__(corpus)
        self._words = vocab_granite.word_list()


def make_queries(traffic: Dict, seed: int, seconds: float) -> Queries:
    """The open loop's requests as ``corpus.make_queries`` makes them
    (arrivals and the set of lengths from the traffic's ``schedule_seed``,
    their order and the words from ``seed``), over ``vocab_granite``'s
    words."""
    rate = float(traffic["rate_qps"])
    lead, tail = float(traffic["lead_seconds"]), float(traffic["tail_seconds"])
    span = lead + seconds + tail
    fixed = np.random.default_rng(int(traffic["schedule_seed"]))
    n = int(rate * span * 1.2) + 64
    t = np.cumsum(fixed.exponential(1.0 / rate, size=n)) - lead
    t = t[t < seconds + tail]
    lens = draw_lengths(traffic["query_words"], len(t), fixed)
    rng = np.random.default_rng(seed)
    lens = lens[rng.permutation(len(lens))]
    names = vocab_granite.word_list()
    probs = vocab_mod.zipf_probs(len(names))
    words_all = rng.choice(len(probs), size=int(lens.sum()),
                           p=probs).astype(np.int32)
    texts, words = [], []
    at = 0
    for ln in lens.tolist():
        w = words_all[at:at + ln]
        at += ln
        words.append(w)
        texts.append(" ".join(names[j] for j in w.tolist()))
    return Queries(texts=texts, words=words, due=t)
