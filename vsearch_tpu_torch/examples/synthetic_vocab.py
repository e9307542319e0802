"""The synthetic word list, 30,522-entry WordPiece vocabulary and corpus of
the repo's benchmark (the port's own copy of ``bench.py``'s
``_BASE_WORDS``, ``build_wordpiece_vocab`` and ``make_corpus``): plain
Python and numpy, so the quick start, the convergence demo, the serve
probe and the port's bench need no download."""
from __future__ import annotations

import numpy as np

# words of the synthetic passages and queries
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


def build_wordpiece_vocab():
    """Synthetic 30k-entry BERT-like vocab: specials, unused (shift
    region), chars, words, subwords."""
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
    # pad out to 30522 with synthetic word entries
    i = 0
    while len(vocab) < 30522:
        w = f"word{i:05d}"
        if w not in vocab:
            vocab[w] = len(vocab)
        i += 1
    return vocab


def make_corpus(n: int, words_per_passage: int = 80, seed: int = 0):
    """``bench.py``'s synthetic passages: Zipf(1) draws over its word list
    and 25,000 synthetic words."""
    rng = np.random.default_rng(seed)
    vocab = np.array(list(BASE_WORDS) + [f"word{i:05d}"
                                         for i in range(25_000)])
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    idx = rng.choice(len(vocab), size=(n, words_per_passage),
                     p=probs / probs.sum())
    return [" ".join(row) for row in vocab[idx]]
