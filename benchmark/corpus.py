"""Corpora and queries drawn from the seed (the benchmark's inputs).

A passage is a list of words drawn Zipf(1) over ``vocab.word_list()``,
as the repository's synthetic corpus draws them, but as ids on the card
rather than strings: each word is one token, so the bag-of-token row of a
passage (its unique token ids shifted by the VDR shift, sentinel-padded)
is built from the ids with no text. A passage's text is made only when
the rerank asks for it (``RenderedCorpus``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import vocab as vocab_mod


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def draw_lengths(spec: Dict, n: int, gen_or_rng, device=None):
    """``n`` word counts by ``spec``: ``{"kind": "fixed", "words": w}`` or
    ``{"kind": "lognormal", "median": m, "sigma": s, "min": a, "max":
    b}`` (rounded, clipped). With a ``torch.Generator`` the counts are
    drawn on its device as an int32 tensor, with a numpy ``Generator`` on
    the host as an int32 array."""
    if spec["kind"] == "fixed":
        if isinstance(gen_or_rng, torch.Generator):
            return torch.full((n,), int(spec["words"]), dtype=torch.int32,
                              device=device)
        return np.full(n, int(spec["words"]), dtype=np.int32)
    if spec["kind"] != "lognormal":
        raise ValueError(f"unknown length kind {spec['kind']!r}")
    mu, sigma = float(np.log(spec["median"])), float(spec["sigma"])
    if isinstance(gen_or_rng, torch.Generator):
        z = torch.randn(n, generator=gen_or_rng, device=device,
                        dtype=torch.float64)
        return (torch.exp(mu + sigma * z).round()
                .clamp(spec["min"], spec["max"]).to(torch.int32))
    z = gen_or_rng.standard_normal(n)
    return np.clip(np.round(np.exp(mu + sigma * z)), spec["min"],
                   spec["max"]).astype(np.int32)


def max_words(spec: Dict) -> int:
    return int(spec["words"] if spec["kind"] == "fixed" else spec["max"])


@dataclasses.dataclass
class Corpus:
    """The passages of one run: their bag-of-token ELL on the device and,
    when kept, their words on the host."""

    cols: torch.Tensor  # [N, W] sorted unique shifted ids, sentinel = V'
    nnz: torch.Tensor  # [N] int32
    num_cols: int  # V'
    lengths: np.ndarray  # [N] words a passage
    nnz_host: np.ndarray  # [N] int32
    words: Optional[np.ndarray] = None  # flat int16 word indices
    offsets: Optional[np.ndarray] = None  # [N + 1] int64

    @property
    def rows(self) -> int:
        return int(self.cols.shape[0])

    def passage_words(self, i: int) -> np.ndarray:
        return self.words[self.offsets[i]:self.offsets[i + 1]]


def make_corpus(n: int, lengths: Dict, seed: int, device, shift: int,
                token_ids: np.ndarray, keep_words: bool,
                col_dtype=torch.int16, chunk_rows: int = 1 << 19
                ) -> Corpus:
    """``n`` passages drawn on ``device`` from ``seed``, in chunks of
    ``chunk_rows`` (one generator, so the result does not depend on the
    chunk size's divisions of the work order beyond it being fixed)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    probs = vocab_mod.zipf_probs(len(token_ids))
    cdf = torch.from_numpy(np.cumsum(probs)).to(dev)
    cdf[-1] = 1.0
    tok = torch.from_numpy(token_ids.astype(np.int64) - shift).to(dev)
    v = vocab_mod.VOCAB_SIZE - shift
    lmax = max_words(lengths)
    width = round_up(lmax, 8)
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
            words_host.append(w[valid].to(torch.int16).cpu().numpy())
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


class RenderedCorpus(Sequence):
    """``index.data`` for the rerank: item ``i`` is passage ``i``'s text,
    rendered from its stored word indices when asked for."""

    def __init__(self, corpus: Corpus):
        if corpus.words is None:
            raise ValueError("the corpus kept no words to render")
        self._corpus = corpus
        self._words = vocab_mod.word_list()

    def __len__(self) -> int:
        return self._corpus.rows

    def __getitem__(self, i: int) -> str:
        w = self._words
        return " ".join([w[j] for j in self._corpus.passage_words(int(i))
                         .tolist()])


@dataclasses.dataclass
class Queries:
    """The requests of one run, in arrival order."""

    texts: List[str]
    words: List[np.ndarray]  # word indices of each query
    due: np.ndarray  # [R] seconds from the window's start (negative: lead)


def make_queries(traffic: Dict, seed: int, seconds: float) -> Queries:
    """The open loop's requests: arrival times and query lengths come from
    the traffic's fixed ``schedule_seed`` (every seed sends the same
    arrivals and the same set of lengths); the run's ``seed`` orders the
    lengths and draws the words."""
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
    words_all = word_draws(rng, int(lens.sum()))
    names = vocab_mod.word_list()
    texts, words = [], []
    at = 0
    for ln in lens.tolist():
        w = words_all[at:at + ln]
        at += ln
        words.append(w)
        texts.append(" ".join(names[j] for j in w.tolist()))
    return Queries(texts=texts, words=words, due=t)


def word_draws(rng: np.random.Generator, count: int) -> np.ndarray:
    """``count`` Zipf(1) word indices on the host."""
    probs = vocab_mod.zipf_probs(len(vocab_mod.word_list()))
    return rng.choice(len(probs), size=count, p=probs).astype(np.int16)


def token_ids(words: np.ndarray, token_table: np.ndarray, cls_id: int,
              sep_id: int, max_len: int) -> np.ndarray:
    """The token ids of a text of ``words`` as the tokenizer makes them:
    ``[CLS]``, one id a word, ``[SEP]``, truncated to ``max_len``."""
    body = token_table[words.astype(np.int64)][:max_len - 2]
    return np.concatenate([[cls_id], body, [sep_id]]).astype(np.int64)
