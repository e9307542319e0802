"""The synthetic WordPiece vocabulary and word list of the benchmark's
corpora and queries (a frozen copy of the repository's synthetic
vocabulary, ``examples/synthetic_vocab.py``).

Every word the benchmark draws is one whole vocabulary entry, so a word
is one token id and a text's ids are known without a tokenizer: ``[CLS]``,
the words' ids, ``[SEP]``. ``tests/test_corpus.py`` holds the port's
tokenizer to that on rendered passages.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

VOCAB_SIZE = 30522

BASE_WORDS = (
    "the of and to in is was for on that what who where when how many "
    "much tea green like drink planet mars red surface water ice einstein "
    "theory relativity physics space time light speed paper wrote famous "
    "scientist passage query search index token sparse dense dog cat runs "
    "fast slow big small city river history world war nation state music "
    "film company president government people year century population "
    "area north south east west language science mathematics computer "
    "system network data model train learn deep neural machine "
    "information retrieval document term frequency inverse weight score "
    "rank vector matrix binary lexical vocabulary encode decode embed "
    "university school book author novel story character island mountain "
    "ocean forest animal species plant energy power engine wheel road "
    "bridge building house room door window glass metal stone wood paper "
    "color sound voice heart blood brain body hand head foot child family "
    "mother father brother sister friend member group team player game "
    "ball field goal point minute hour day week month season winter "
    "summer spring autumn rain snow wind cloud storm sun moon star sky "
).split()

# synthetic whole words after BASE_WORDS, as the repository's corpus has
SYNTHETIC_WORDS = 25_000


def build_vocab() -> Dict[str, int]:
    """The 30,522-entry BERT-like vocabulary: specials, 994 unused ids
    (below the VDR shift), characters, words, suffixes, then synthetic
    whole words up to 30,522 entries."""
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for i in range(994):
        vocab[f"[unused{i}]"] = len(vocab)
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        vocab[c] = len(vocab)
        vocab[f"##{c}"] = len(vocab)
    for w in BASE_WORDS:
        if w not in vocab:
            vocab[w] = len(vocab)
    for suf in ("ing", "ed", "s", "ly", "er", "est", "ion", "al", "ous"):
        vocab[f"##{suf}"] = len(vocab)
    i = 0
    while len(vocab) < VOCAB_SIZE:
        w = f"word{i:05d}"
        if w not in vocab:
            vocab[w] = len(vocab)
        i += 1
    return vocab


def word_list() -> List[str]:
    """The words drawn, in Zipf rank order: ``BASE_WORDS`` then
    ``word00000`` ... (a word repeated in ``BASE_WORDS`` keeps both
    ranks)."""
    return list(BASE_WORDS) + [f"word{i:05d}" for i in range(SYNTHETIC_WORDS)]


def word_token_ids(vocab: Dict[str, int]) -> np.ndarray:
    """[len(word_list())] int32: the token id of each word."""
    return np.asarray([vocab[w] for w in word_list()], dtype=np.int32)


def zipf_probs(n: int) -> np.ndarray:
    """Zipf(1) over ``n`` ranks: p(r) proportional to 1 / (r + 1)."""
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64)
    return p / p.sum()
