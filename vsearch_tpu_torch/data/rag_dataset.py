"""RAG dataset: QA samples with retrieved contexts (a copy of
``vsearch_tpu/data/rag_dataset.py`` on the port's ``eval.qa_utils``).

The reference's ``conf/data_stores/wiki21m.yaml`` references
``src.rag.data_utils.RAGDataset`` which is absent from the snapshot
(SURVEY.md §1 gap list); this is its reconstruction from the data it is
pointed at (rag-nq-train.jsonl: question/answers + retrieved ctxs).
Samples expose the retrieved contexts as positives/negatives by answer
match so the bi-encoder trainer can consume them directly.
"""
from __future__ import annotations

import json
import logging
from typing import List, Optional

from ..eval.qa_utils import has_answer
from .dataset import BiEncoderPassage, BiEncoderSample, _normalize

logger = logging.getLogger(__name__)


class RAGDataset:
    """jsonl of {question, answers, ctxs: [{text, title, ...}]}.

    ``load_data`` splits each sample's retrieved contexts into positives
    (answer-bearing) and negatives via ``has_answer``, yielding
    BiEncoderSamples usable by the contrastive trainer.
    """

    def __init__(self, file: str, norm: bool = True,
                 max_ctxs: Optional[int] = None,
                 download_link: Optional[str] = None):
        self.file = file
        self.norm = norm
        self.max_ctxs = max_ctxs
        self.download_link = download_link
        self.data: List[BiEncoderSample] = []

    def calc_total_data_len(self) -> int:
        """Total line count without parsing — local-shard geometry
        (data/iterators.py get_data_iterator(local_shards=True))."""
        with open(self.file, "rb") as f:
            return sum(1 for _ in f)

    def load_data(self, require_positive: bool = True,
                  require_hard_negative: bool = False,
                  start_pos: Optional[int] = None,
                  end_pos: Optional[int] = None):
        self.data = []
        with open(self.file, encoding="utf-8") as f:
            for lineno, line in enumerate(f):
                if start_pos is not None and lineno < start_pos:
                    continue
                if end_pos is not None and lineno >= end_pos:
                    break
                obj = json.loads(line)
                question = obj.get("question") or obj.get("query")
                if not question:
                    # one foreign-schema row must not abort the whole
                    # load (or crash _normalize(None) later)
                    logger.warning("%s line %d: no question/query "
                                   "field; skipped", self.file, lineno)
                    continue
                answers = obj.get("answers") or obj.get("answer") or []
                if isinstance(answers, str):
                    answers = [answers]
                ctxs = obj.get("ctxs") or obj.get("contexts") or []
                if self.max_ctxs:
                    ctxs = ctxs[: self.max_ctxs]
                pos, neg = [], []
                for c in ctxs:
                    text = c.get("text") or c.get("contents") or ""
                    if self.norm:
                        text = _normalize(text)
                    passage = BiEncoderPassage(text, c.get("title"))
                    if answers and has_answer(answers, text, "string"):
                        pos.append(passage)
                    else:
                        neg.append(passage)
                if require_positive and not pos:
                    continue
                if require_hard_negative and not neg:
                    continue
                self.data.append(BiEncoderSample(
                    query=_normalize(question) if self.norm else question,
                    answers=list(answers),
                    positive_passages=pos,
                    negative_passages=neg,
                    hard_negative_passages=neg[:1],
                ))
        logger.info("RAGDataset: %d usable samples from %s",
                    len(self.data), self.file)

    def __getitem__(self, i: int) -> BiEncoderSample:
        return self.data[i]

    def __len__(self) -> int:
        return len(self.data)
