"""InfoCard: the ASCII training-progress dashboard (a copy of
``vsearch_tpu/train/info_card.py``, numpy only).

Counterpart of reference src/ir/training/info_card.py:4-158 — per-tensor
embedding stats (shape / gate ratio / mean / max / min), sample texts, and
token-rank interaction tables for V(q), V(p), V(p_neg) and V(q)*V(p).
Operates on host numpy arrays (embeddings are pulled off-device once per
log step only).

Provenance note: the method names, title defaults and format strings
deliberately MIRROR the reference class so existing log-parsing
dashboards consume either framework's output unchanged — the rendered
card format is treated as the spec (see PARITY.md). The tensor math
(gate ratios, token ranking, wrapping) is an independent numpy
implementation.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np


class InfoCard:
    def __init__(self, tokenizer=None, width: Optional[int] = None,
                 shift_vocab_num: Optional[int] = None,
                 title: Optional[str] = None):
        self.tokenizer = tokenizer
        self.width = width or 100
        self.shift_vocab_num = shift_vocab_num or 0
        self.title = title or " INFO CARD "
        self._init_card()

    def _init_card(self):
        bar = "#" * self.width
        self.info = "\n" + "\n".join(
            [bar, f"{self.title:{'#'}^{self.width}}", bar]) + "\n"

    def add_title_line(self, title: Optional[str] = None):
        if title:
            self.info += f"{title:{'='}^{self.width}}\n"

    def _pad_line(self, line: str) -> str:
        return line.ljust(self.width) + "\n"

    def token_to_rank(self, emb: np.ndarray) -> "OrderedDict[str, int]":
        emb = np.asarray(emb)
        order = np.argsort(-emb)
        ids = [int(i) + self.shift_vocab_num for i in order]
        tokens = self.tokenizer.convert_ids_to_tokens(ids)
        return OrderedDict((tok, rank) for rank, tok in enumerate(tokens))

    def add_stat_info(self, embs: np.ndarray, title: Optional[str] = None):
        self.add_title_line(title)
        embs = np.asarray(embs, dtype=np.float32)
        n, v = embs.shape
        nz = embs != 0
        denom = np.maximum(nz.sum(-1), 1)
        f_mean = float((embs.sum(-1) / denom).mean())
        f_max = float(embs.max(-1).mean())
        f_min = float(embs.min(-1).mean())
        f_nonzero = float(nz.sum(-1).mean())
        slots = [
            f"shape: ({n}, {v})",
            f" gate: {f_nonzero:>5.1f}/{v:<5.0f}={f_nonzero / v * 100:<4.2f}% ",
            f" mean: {f_mean:<7.2f} ",
            f" max: {f_max:<7.2f} ",
            f" min: {f_min:<7.2f} ",
        ]
        widths = [int(x * self.width) for x in (0.20, 0.30, 0.15, 0.15,
                                                0.14)]
        self.info += "|".join(
            f"{s:^{w}}" for s, w in zip(slots, widths)) + "\n"

    def add_texts_info(self, texts: Sequence[str],
                       descs: Optional[Sequence[str]] = None,
                       title: Optional[str] = None):
        self.add_title_line(title)
        assert descs is None or len(texts) == len(descs)
        for i, text in enumerate(texts):
            if text is None:
                continue
            if descs:
                text = f"{descs[i]}: {text}"
            items = [it.strip(" ") for it in re.split(r"(\s+)", text)
                     if it.strip(" ")]
            self.info += self.tidy_item(items) + "\n\n"

    def add_interaction_info(self, q_emb, p_emb, p2_emb=None, k: int = 20,
                             title: Optional[str] = None):
        self.add_title_line(title)
        rank_q = self.token_to_rank(q_emb)
        rank_p = self.token_to_rank(p_emb)
        rank_qp = self.token_to_rank(np.asarray(q_emb) * np.asarray(p_emb))

        top_q = [(t, rank_q[t], rank_p[t]) for t in rank_q][:k]
        self.add_title_line(" V(q) => (t, qrank, prank)")
        self.info += self.tidy_item(top_q) + "\n"

        top_p = [(t, rank_q[t], rank_p[t]) for t in rank_p][:k]
        self.add_title_line(" V(p) => (t, qrank, prank)")
        self.info += self.tidy_item(top_p) + "\n"

        if p2_emb is not None:
            rank_neg = self.token_to_rank(p2_emb)
            top_neg = [(t, rank_q[t], rank_neg[t]) for t in rank_neg][:k]
            self.add_title_line(" V(p_neg) => (t, qrank, pnegrank) ")
            self.info += self.tidy_item(top_neg) + "\n"

        top_qp = [(t, rank_q[t], rank_p[t]) for t in rank_qp][:k]
        self.add_title_line(" V(q) * V(p) => (t, qrank, prank)")
        self.info += self.tidy_item(top_qp) + "\n"

    def tidy_item(self, items) -> str:
        info, row = "", ""
        for item in items:
            s = str(item)
            if s in ("\n", "\n\n"):
                row = self._pad_line(row)
            elif s.isspace():
                pass
            elif len(row) + len(s) < self.width:
                row += f"{item} "
            else:
                info += row + "\n"
                row = f"{item} "
        info += row + "\n"
        return info.strip()

    def wrap_info(self):
        lines = ["\n"]
        line_ = ""
        for line in self.info.strip().split("\n"):
            line_ = f"### {line:<{self.width}} ###"
            lines.append(line_)
        lines.append("#" * len(line_))
        self.info = "\n".join(lines)
