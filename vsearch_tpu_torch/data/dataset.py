"""Training datasets: DPR-style jsonl with positive/negative contexts
(a copy of ``vsearch_tpu/data/dataset.py``).

Counterpart of reference src/ir/data/biencoder_dataset.py:11-107, without
the torch Dataset dependency — a dataset is a plain indexable list of
``BiEncoderSample``.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class BiEncoderPassage:
    text: str
    title: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BiEncoderSample:
    query: str
    answers: List[str]
    positive_passages: List[BiEncoderPassage]
    negative_passages: List[BiEncoderPassage]
    hard_negative_passages: List[BiEncoderPassage]


def _normalize(text: str) -> str:
    return text.replace("’", "'").replace("\n", " ")


def create_biencoder_passage(d: Dict[str, Any],
                             normalize: bool = True) -> BiEncoderPassage:
    text = _normalize(d["text"]) if normalize else d["text"]
    return BiEncoderPassage(text, d.get("title"))


class BiEncoderDataset:
    """jsonl loader filtering samples lacking positives/hard negatives
    (reference biencoder_dataset.py:35-83)."""

    def __init__(self, file: str, shuffle_positives: bool = False,
                 norm: bool = True, download_link: Optional[str] = None):
        self.file = file
        self.norm = norm
        self.shuffle_positives = shuffle_positives
        self.download_link = download_link
        self.data: List[BiEncoderSample] = []

    def calc_total_data_len(self) -> int:
        """Total line count WITHOUT parsing/loading — what local-shard
        geometry needs before each process loads only its own slice."""
        with open(self.file, "rb") as f:
            return sum(1 for _ in f)

    def load_data(self, require_positive: bool = True,
                  require_hard_negative: bool = True,
                  start_pos: Optional[int] = None,
                  end_pos: Optional[int] = None):
        """Load (optionally only lines [start_pos, end_pos) — the
        local-shard mode used by LocalShardedDataIterator, reference
        ddp_iterators.py:132-137)."""
        if not self.file.endswith("jsonl"):
            raise NotImplementedError(
                f"only jsonl datasets supported, got {self.file}")
        self.data = []
        with open(self.file, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f):
                if start_pos is not None and lineno < start_pos:
                    continue
                if end_pos is not None and lineno >= end_pos:
                    break
                sample = json.loads(line)
                if require_positive and not sample.get("positive_ctxs"):
                    continue
                if require_hard_negative and not sample.get(
                        "hard_negative_ctxs"):
                    continue
                query = (_normalize(sample["question"]) if self.norm
                         else sample["question"])
                if "answer" in sample:
                    answers = sample["answer"]
                elif "answers" in sample:
                    answers = sample["answers"]
                else:
                    answers = [c["text"]
                               for c in sample["positive_ctxs"]]
                if isinstance(answers, str):
                    # a bare string would make has_answer iterate
                    # CHARACTERS (any passage containing 'a' matches)
                    answers = [answers]
                self.data.append(BiEncoderSample(
                    query=query,
                    answers=answers,
                    positive_passages=[
                        create_biencoder_passage(x, self.norm)
                        for x in sample["positive_ctxs"]],
                    negative_passages=[
                        create_biencoder_passage(x, self.norm)
                        for x in sample.get("negative_ctxs", [])],
                    hard_negative_passages=[
                        create_biencoder_passage(x, self.norm)
                        for x in sample.get("hard_negative_ctxs", [])],
                ))
        logger.info("Loaded %d samples from %s", len(self.data), self.file)

    def __getitem__(self, index: int) -> BiEncoderSample:
        return self.data[index]

    def __len__(self) -> int:
        return len(self.data)
