"""BERT-compatible WordPiece tokenizer (pure Python reference).

The reference leans on HF ``AutoTokenizer`` (src/ir/encoder/vdr.py:55);
we need tokenization to be a first-class, dependency-light subsystem
because the bag-of-token index build is tokenizer-bound (reference
baseline: 1,756 s for 21M passages — test/svdr_wiki21m/
build_binary_token_index.sh:10). This module is the correctness
reference; ``vsearch_tpu_torch.tokenization.native`` provides the C++
fast path. (A copy of the JAX package's module: the port imports
nothing of ``vsearch_tpu``.)

Implements the standard BERT pipeline: clean -> whitespace split ->
basic-tokenize (punctuation split, CJK spacing, accent stripping,
lowercase) -> greedy longest-match-first WordPiece with '##'
continuations.
"""
from __future__ import annotations

import re
import unicodedata
from typing import Dict, Iterable, List, Sequence


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def load_vocab(path: str) -> dict:
    """vocab.txt -> {token: line_number}. Blank lines keep their line
    number as an id gap (HF semantics keep positions; consumers must
    tolerate gapped ids). Shared by the pure-Python and C++ tokenizers
    so the loading semantics cannot drift."""
    vocab = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


class WordPieceTokenizer:
    """BERT-uncased-compatible tokenizer over a vocab.txt word list."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 mask_token: str = "[MASK]", max_word_chars: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.pad_token = pad_token
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_word_chars = max_word_chars
        # HF matches registered special tokens in RAW text, case-sensitive,
        # before any normalization, even mid-word ("a[SEP]b") — the corpus
        # join convention "title [SEP] text" (reference biencoder.py:88-109)
        # depends on it.
        specials = [t for t in (pad_token, unk_token, cls_token,
                                sep_token, mask_token) if t in vocab]
        self._special_re = re.compile(
            "|".join(re.escape(t) for t in specials)) if specials else None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        return cls(load_vocab(path), **kw)

    @property
    def vocab_size(self) -> int:
        # max id + 1, NOT len(vocab): gapped vocabs (blank vocab.txt
        # lines keep their line number) produce ids beyond len(), and
        # embedding/bow/index dimensions must cover every real id
        return (max(self.vocab.values()) + 1) if self.vocab else 0

    # -- pipeline ----------------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        # CJK characters become standalone tokens
        spaced = []
        for ch in text:
            if _is_cjk(ord(ch)):
                spaced.append(f" {ch} ")
            else:
                spaced.append(ch)
        words = "".join(spaced).split()
        out: List[str] = []
        for word in words:
            if self.lowercase:
                # Mirror HF *fast* BertNormalizer exactly: NFD + strip
                # combining marks FIRST, then per-char lowercase (Rust
                # char::to_lowercase has no Greek final-sigma context,
                # unlike python str.lower on a whole word).
                word = unicodedata.normalize("NFD", word)
                word = "".join(c for c in word
                               if unicodedata.category(c) != "Mn")
                word = "".join(c.lower() for c in word)
            # split on punctuation
            cur: List[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_word_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def _tokenize_segment(self, text: str, out: List[str]) -> None:
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        if self._special_re is None:
            self._tokenize_segment(text, out)
            return out
        pos = 0
        for m in self._special_re.finditer(text):
            self._tokenize_segment(text[pos:m.start()], out)
            out.append(m.group(0))
            pos = m.end()
        self._tokenize_segment(text[pos:], out)
        return out

    # -- encoding ----------------------------------------------------------
    def encode(self, text: str, max_length: int = 256,
               add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        if add_special_tokens:
            ids = ids[: max_length - 2]
            return [self.cls_id] + ids + [self.sep_id]
        return ids[:max_length]

    def encode_batch(self, texts: Sequence[str], max_length: int = 256,
                     add_special_tokens: bool = True) -> List[List[int]]:
        return [self.encode(t, max_length, add_special_tokens)
                for t in texts]

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def decode(self, ids: Iterable[int], skip_special: bool = True
               ) -> str:
        special = {self.cls_id, self.sep_id, self.pad_id}
        toks = [self.ids_to_tokens.get(int(i), self.unk_token)
                for i in ids if not (skip_special and int(i) in special)]
        text = " ".join(toks).replace(" ##", "")
        return text
