"""Tokenization subsystem: BERT-compatible WordPiece.

Resolution order in ``get_tokenizer``:
  1. the C++ fast tokenizer (``native.NativeWordPieceTokenizer``) when the
     extension builds and a vocab file is resolvable,
  2. the pure-Python ``WordPieceTokenizer``.

The JAX package also tries HF ``AutoTokenizer``; the port does not, since
``transformers`` is not part of its dependencies. Both expose the surface
used by the framework: ``encode_batch``, ``convert_ids_to_tokens``,
``decode``, ``vocab_size``, ``pad_id``.
"""
from __future__ import annotations

import os
from typing import Optional

from .wordpiece import WordPieceTokenizer, load_vocab


def _find_vocab_file(model_id: str) -> Optional[str]:
    """Resolve a vocab.txt for ``model_id``: direct path, local dir, or
    VSEARCH_TPU_VOCAB env override."""
    cands = []
    env = os.environ.get("VSEARCH_TPU_VOCAB")
    if env:
        cands.append(env)
    if os.path.isfile(model_id):
        cands.append(model_id)
    cands.append(os.path.join(model_id, "vocab.txt"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    return None


def get_tokenizer(model_id: str = "bert-base-uncased",
                  prefer: str = "auto"):
    """Load a tokenizer for ``model_id``.

    prefer: 'auto' | 'native' | 'python'.
    """
    vocab_file = _find_vocab_file(model_id)
    if vocab_file is None:
        raise FileNotFoundError(
            f"no vocab.txt resolvable for tokenizer '{model_id}' "
            "(set VSEARCH_TPU_VOCAB or pass a checkpoint dir)")
    if prefer in ("auto", "native"):
        try:
            from .native import NativeWordPieceTokenizer
            return NativeWordPieceTokenizer.from_vocab_file(vocab_file)
        except Exception:
            if prefer == "native":
                raise
    return WordPieceTokenizer.from_vocab_file(vocab_file)


__all__ = ["WordPieceTokenizer", "get_tokenizer", "load_vocab"]
