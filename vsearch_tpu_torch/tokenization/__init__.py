"""Tokenization subsystem: BERT-compatible WordPiece.

Resolution order in ``get_tokenizer``, the JAX package's:
  1. the C++ fast tokenizer (``native.NativeWordPieceTokenizer``) when the
     extension builds and a vocab file is resolvable,
  2. HF ``AutoTokenizer`` (wrapped in ``HFTokenizerAdapter``) when its
     assets load; ``transformers`` is imported only here, so the package
     imports without it,
  3. the pure-Python ``WordPieceTokenizer``.

All three expose the surface used by the framework: ``encode_batch``,
``convert_ids_to_tokens``, ``decode``, ``vocab_size``, ``pad_id``.
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


class HFTokenizerAdapter:
    """Wraps an HF fast tokenizer in the framework surface."""

    def __init__(self, hf_tok):
        self.hf = hf_tok
        self.pad_id = hf_tok.pad_token_id
        self.cls_id = hf_tok.cls_token_id
        self.sep_id = hf_tok.sep_token_id
        self.unk_id = hf_tok.unk_token_id

    @property
    def vocab_size(self) -> int:
        return len(self.hf)

    def encode(self, text, max_length=256, add_special_tokens=True):
        return self.hf(text, truncation=True, max_length=max_length,
                       add_special_tokens=add_special_tokens)["input_ids"]

    def encode_batch(self, texts, max_length=256, add_special_tokens=True):
        return self.hf(list(texts), truncation=True, max_length=max_length,
                       add_special_tokens=add_special_tokens)["input_ids"]

    def convert_ids_to_tokens(self, ids):
        return self.hf.convert_ids_to_tokens(list(ids))

    def convert_tokens_to_ids(self, tokens):
        return self.hf.convert_tokens_to_ids(list(tokens))

    def decode(self, ids, skip_special=True):
        return self.hf.decode(list(ids), skip_special_tokens=skip_special)


def get_tokenizer(model_id: str = "bert-base-uncased",
                  prefer: str = "auto"):
    """Load a tokenizer for ``model_id``.

    prefer: 'auto' | 'native' | 'hf' | 'python'. 'hf' raises when
    ``AutoTokenizer`` fails; 'auto' then takes the pure-Python tokenizer
    if a vocab file resolves.
    """
    vocab_file = _find_vocab_file(model_id)
    if prefer in ("auto", "native") and vocab_file is not None:
        try:
            from .native import NativeWordPieceTokenizer
            return NativeWordPieceTokenizer.from_vocab_file(vocab_file)
        except Exception:
            if prefer == "native":
                raise
    if prefer in ("auto", "hf"):
        try:
            from transformers import AutoTokenizer
            return HFTokenizerAdapter(
                AutoTokenizer.from_pretrained(model_id))
        except Exception:
            if prefer == "hf":
                raise
    if vocab_file is None:
        raise FileNotFoundError(
            f"no vocab.txt resolvable for tokenizer '{model_id}' "
            "(set VSEARCH_TPU_VOCAB or pass a checkpoint dir)")
    return WordPieceTokenizer.from_vocab_file(vocab_file)


__all__ = ["WordPieceTokenizer", "HFTokenizerAdapter", "get_tokenizer",
           "load_vocab"]
