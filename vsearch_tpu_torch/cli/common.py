"""Shared helpers for the inference CLIs (counterpart of
``vsearch_tpu/cli/common.py``)."""
from __future__ import annotations

import json
import logging
import sys
from typing import List

logger = logging.getLogger("vsearch_tpu_torch.cli")


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(threadName)s] %(levelname)s %(name)s: "
               "%(message)s",
        stream=sys.stderr)


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the work runs (default cuda; raises when "
                         "CUDA is absent); 'cpu' runs it on the host")


def read_jsonl_texts(path: str, text_key: str = "text") -> List[str]:
    """Read corpus lines: raw strings or json objects with text/title,
    joined by ``biencoder.join_corpus`` ("title [SEP] text"), so CLI-built
    indexes embed the strings ``Retriever.build_index`` would."""
    from ..biencoder import join_corpus

    entries = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                entries.append(line)
                continue
            if isinstance(obj, (str, dict)):
                if isinstance(obj, dict) and text_key != "text":
                    # the caller's field wins even over a 'text' field
                    obj = dict(obj, text=obj[text_key])
                entries.append(obj)
            else:
                entries.append(str(obj))
    return join_corpus(entries)


def read_queries(path: str) -> List[str]:
    """Query file: one question per line (jsonl or raw)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                out.append(line)
                continue
            if isinstance(obj, str):
                out.append(obj)
            elif isinstance(obj, dict):
                q = (obj.get("question") or obj.get("query")
                     or obj.get("text"))
                if not q:
                    # fail here, with the line, not deep in the tokenizer
                    raise ValueError(
                        f"query file {path}: object without a "
                        f"question/query/text field: {line[:120]}")
                out.append(q)
            else:
                out.append(str(obj))
    return out


def shard_slice(items: List, num_shard: int, shard_id: int) -> List:
    """Contiguous shard split (the reference's sharded-build convention)."""
    if num_shard <= 1:
        return items
    per = -(-len(items) // num_shard)
    return items[shard_id * per: (shard_id + 1) * per]


def load_retriever(checkpoint: str, device="cuda", tokenizer=None):
    """``Retriever.from_pretrained`` on ``device``."""
    from ..retriever import Retriever

    return Retriever.from_pretrained(checkpoint, tokenizer=tokenizer,
                                     device=device)


def save_results(path: str, queries: List[str], ids, scores):
    import numpy as np

    ids = np.asarray(ids)
    scores = np.asarray(scores)
    results = [
        {"question": q,
         "ids": ids[i].tolist(),
         "scores": [float(s) for s in scores[i]]}
        for i, q in enumerate(queries)
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(results, f)
    logger.info("saved %d query results to %s", len(results), path)
