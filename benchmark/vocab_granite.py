"""The synthetic vocabulary of the granite-4.0-h cells: as many entries as
granite-4.0-h-micro's tokenizer (100,352), in the port's WordPiece layout,
since the model's own tokenizer files are not in the repository.

Every word the cells draw is one whole vocabulary entry (one token), so a
text's ids are ``[CLS]``, its words' ids, ``[SEP]``, as with
``vocab.py``'s BERT-sized vocabulary: specials, reserved ids up to the VDR
shift, characters, the base words, suffixes, then synthetic whole words
``w00000`` ... up to 100,352 entries.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

import numpy as np

from .vocab import BASE_WORDS

VOCAB_SIZE = 100352
# the VDR shift: ids below it (specials and reserved) are no output column
SHIFT = 256
SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


@lru_cache(maxsize=1)
def _entries() -> tuple:
    """(vocabulary entries in id order, the synthetic words)."""
    vocab = {w: i for i, w in enumerate(SPECIALS)}
    while len(vocab) < SHIFT:
        vocab[f"[unused{len(vocab) - len(SPECIALS)}]"] = len(vocab)
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        vocab[c] = len(vocab)
        vocab[f"##{c}"] = len(vocab)
    for w in BASE_WORDS:
        if w not in vocab:
            vocab[w] = len(vocab)
    for suf in ("ing", "ed", "s", "ly", "er", "est", "ion", "al", "ous"):
        vocab[f"##{suf}"] = len(vocab)
    synthetic = [f"w{i:05d}" for i in range(VOCAB_SIZE - len(vocab))]
    return tuple(vocab) + tuple(synthetic), tuple(synthetic)


def build_vocab() -> Dict[str, int]:
    """The 100,352-entry vocabulary, token -> id."""
    return {w: i for i, w in enumerate(_entries()[0])}


def word_list() -> List[str]:
    """The words drawn, in Zipf rank order: ``BASE_WORDS`` then the
    synthetic words (a word repeated in ``BASE_WORDS`` keeps both
    ranks)."""
    return list(BASE_WORDS) + list(_entries()[1])


def word_token_ids(vocab: Dict[str, int]) -> np.ndarray:
    """[len(word_list())] int32: the token id of each word."""
    return np.asarray([vocab[w] for w in word_list()], dtype=np.int32)
