"""QA evaluation utilities: answer-span matching and qa.csv parsing
(counterpart of ``vsearch_tpu/eval/qa_utils.py``, stdlib only).

A unicode word tokenizer and token-level answer containment, used to
score retrieval accuracy (``cli.score.eval_wiki21m``). Matching is
normalised, uncased token-span equality. With the ``regex`` package
absent, words are ``re``'s ``\\w`` runs instead of ``regex``'s letter,
number and mark runs (the same on ASCII text).
"""
from __future__ import annotations

import csv
import re
import unicodedata
from typing import List, Sequence, Tuple

try:
    import regex as _regex

    _WORD_RE = _regex.compile(
        r"([\p{L}\p{N}\p{M}]+)|([^\p{Z}\p{C}])",
        flags=_regex.IGNORECASE | _regex.UNICODE | _regex.MULTILINE)
except ImportError:  # pragma: no cover - regex is a hard dep of tests
    _regex = None
    _WORD_RE = re.compile(r"(\w+)|([^\s])", flags=re.UNICODE | re.MULTILINE)


class SimpleTokenizer:
    """Word tokenizer splitting into alphanumeric runs + single
    non-space symbols (reference qa_utils.py:150-192)."""

    def tokenize(self, text: str) -> List[str]:
        return [m.group() for m in _WORD_RE.finditer(text)]

    def words(self, text: str, uncased: bool = False) -> List[str]:
        toks = self.tokenize(text)
        return [t.lower() for t in toks] if uncased else toks

    def rich_tokenize(self, text: str) -> "RichTokens":
        """:class:`RichTokens` with spans + whitespace, the surface the
        reference's SimpleTokenizer.tokenize returns
        (reference qa_utils.py:155-192); no annotations."""
        matches = list(_WORD_RE.finditer(text))
        toks = []
        for i, m in enumerate(matches):
            start, end = m.span()
            end_ws = (matches[i + 1].span()[0]
                      if i + 1 < len(matches) else end)
            toks.append(RichToken(text=m.group(),
                                  text_ws=text[start:end_ws],
                                  span=(start, end)))
        return RichTokens(toks)


_TOKENIZER = SimpleTokenizer()


def _normalize(text: str) -> str:
    text = text.replace("’", "'").replace("\n", " ")
    return unicodedata.normalize("NFD", text)


def regex_match(text: str, pattern: str) -> bool:
    """True if ``pattern`` (case-insensitive regex) occurs in ``text``
    (reference qa_utils.py:248-254)."""
    eng = _regex or re
    try:
        compiled = eng.compile(
            pattern, flags=eng.IGNORECASE | eng.UNICODE | eng.MULTILINE)
    except BaseException:
        return False
    return compiled.search(text) is not None


def has_answer(answers: Sequence[str], text: str,
               match_type: str = "string") -> bool:
    """True if any answer occurs in ``text`` as a token span (or regex)
    (reference qa_utils.py:258-291)."""
    text = _normalize(text)
    if match_type == "string":
        words = _TOKENIZER.words(text, uncased=True)
        for ans in answers:
            ans_words = _TOKENIZER.words(_normalize(ans), uncased=True)
            n = len(ans_words)
            if n == 0:
                continue
            for i in range(0, len(words) - n + 1):
                if ans_words == words[i: i + n]:
                    return True
    elif match_type == "regex":
        for ans in answers:
            if regex_match(text, _normalize(ans)):
                return True
    return False


class RichToken:
    """One token with optional linguistic annotations. Compact
    counterpart of one row of the reference's DrQA token tuples
    (reference qa_utils.py:15-28: TEXT/TEXT_WS/SPAN/POS/LEMMA/NER)."""

    __slots__ = ("text", "text_ws", "span", "pos", "lemma", "ent")

    def __init__(self, text: str, text_ws: str, span: Tuple[int, int],
                 pos: str = "", lemma: str = "", ent: str = ""):
        self.text = text
        self.text_ws = text_ws  # token + trailing whitespace
        self.span = span        # [start, end) character offsets
        self.pos = pos
        self.lemma = lemma
        self.ent = ent


class RichTokens:
    """A tokenized text with per-token annotations.

    Same capability surface as the reference's ``Tokens``
    (reference qa_utils.py:15-131) — words/offsets/pos/lemmas/
    entities/ngrams/entity_groups/untokenize/slice — rebuilt around
    attribute-named tokens instead of positional tuples.
    """

    def __init__(self, tokens: List[RichToken], annotators=(),
                 non_ent: str = "O"):
        self.tokens = list(tokens)
        self.annotators = set(annotators)
        self.non_ent = non_ent

    def __len__(self) -> int:
        return len(self.tokens)

    def slice(self, i=None, j=None) -> "RichTokens":
        return RichTokens(self.tokens[i:j], self.annotators,
                          self.non_ent)

    def untokenize(self) -> str:
        return "".join(t.text_ws for t in self.tokens).strip()

    def words(self, uncased: bool = False) -> List[str]:
        if uncased:
            return [t.text.lower() for t in self.tokens]
        return [t.text for t in self.tokens]

    def offsets(self) -> List[Tuple[int, int]]:
        return [t.span for t in self.tokens]

    def pos(self):
        if "pos" not in self.annotators:
            return None
        return [t.pos for t in self.tokens]

    def lemmas(self):
        if "lemma" not in self.annotators:
            return None
        return [t.lemma for t in self.tokens]

    def entities(self):
        if "ner" not in self.annotators:
            return None
        return [t.ent for t in self.tokens]

    def ngrams(self, n: int = 1, uncased: bool = False,
               filter_fn=None, as_strings: bool = True):
        words = self.words(uncased)
        spans = [(s, e + 1)
                 for s in range(len(words))
                 for e in range(s, min(s + n, len(words)))
                 if not (filter_fn and filter_fn(words[s:e + 1]))]
        if as_strings:
            return [" ".join(words[s:e]) for s, e in spans]
        return spans

    def entity_groups(self):
        ents = self.entities()
        if not ents:
            return None
        groups, i = [], 0
        while i < len(ents):
            tag = ents[i]
            if tag == self.non_ent:
                i += 1
                continue
            start = i
            while i < len(ents) and ents[i] == tag:
                i += 1
            groups.append((self.slice(start, i).untokenize(), tag))
        return groups


class SpacyTokenizer:
    """spaCy-backed tokenizer producing :class:`RichTokens` with
    optional pos/lemma/ner annotations (reference qa_utils.py:195-241).

    Requires the optional ``spacy`` package and a model (default
    ``en_core_web_sm``); raises a clear ImportError otherwise — none of
    the shipped pipelines depend on it (the reference never calls it
    either; retrieval accuracy scoring uses :class:`SimpleTokenizer`).
    """

    def __init__(self, model: str = "en_core_web_sm", annotators=()):
        try:
            import spacy
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "SpacyTokenizer needs the optional 'spacy' package "
                "(pip install spacy && python -m spacy download "
                "en_core_web_sm); SimpleTokenizer covers the shipped "
                "eval pipelines without it") from e
        self.annotators = set(annotators)
        need_tags = self.annotators & {"lemma", "pos", "ner"}
        exclude = ["parser"]
        if not need_tags:
            exclude.append("tagger")
        if "ner" not in self.annotators:
            exclude.append("ner")
        self.nlp = spacy.load(model, exclude=exclude)

    def tokenize(self, text: str) -> RichTokens:
        clean = text.replace("\n", " ")
        doc = (self.nlp(clean) if (self.annotators
                                   & {"lemma", "pos", "ner"})
               else self.nlp.tokenizer(clean))
        toks = []
        for i, t in enumerate(doc):
            start = t.idx
            end_ws = (doc[i + 1].idx if i + 1 < len(doc)
                      else t.idx + len(t.text))
            toks.append(RichToken(
                text=t.text, text_ws=text[start:end_ws],
                span=(start, start + len(t.text)),
                pos=t.tag_, lemma=t.lemma_, ent=t.ent_type_))
        # spaCy uses '' for non-entities (the reference sets the same
        # non_ent option, qa_utils.py:241)
        return RichTokens(toks, self.annotators, non_ent="")


def parse_qa_csv_file(location: str) -> List[Tuple[str, List[str]]]:
    """Parse DPR-style qa.csv (TSV: question \\t "['a1','a2']")
    (reference qa_utils.py:293-301) — uses ast.literal_eval, not eval."""
    import ast

    res = []
    with open(location, encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="\t"):
            if not row:
                continue
            question = row[0]
            answers = ast.literal_eval(row[1]) if len(row) > 1 else []
            res.append((question, list(answers)))
    return res
