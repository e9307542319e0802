"""Score search results: top-k retrieval accuracy by answer matching
(counterpart of ``vsearch_tpu/cli/score/eval_wiki21m.py``; host only).

For each query, ``has_answer`` is checked over its ranked passages;
top-{1,5,10,20,100} accuracy is printed as one JSON line.

    python -m vsearch_tpu_torch.cli.score.eval_wiki21m \
        --result_file result.json --text_file corpus.jsonl --qa_file qa.csv
"""
from __future__ import annotations

import argparse
import json
import logging

from ..common import read_jsonl_texts, setup_logging
from ...eval.qa_utils import has_answer, parse_qa_csv_file

logger = logging.getLogger("vsearch_tpu_torch.cli.eval_wiki21m")

TOPK_LEVELS = (1, 5, 10, 20, 100)


def evaluate(results, texts, qa_pairs, topk_levels=TOPK_LEVELS):
    """results: list of {question, ids, scores}; qa_pairs: list of
    (question, answers) aligned with results. Returns {k: accuracy}."""
    if len(results) != len(qa_pairs):
        # zip would truncate and score a wrong pairing
        raise ValueError(
            f"{len(results)} results vs {len(qa_pairs)} qa pairs — "
            "result_file and qa_file are misaligned")
    hits_at = {k: 0 for k in topk_levels}
    n = 0
    for res, (_, answers) in zip(results, qa_pairs):
        n += 1
        first_hit = None
        for rank, pid in enumerate(res["ids"]):
            if has_answer(answers, texts[int(pid)], "string"):
                first_hit = rank
                break
        if first_hit is not None:
            for k in topk_levels:
                if first_hit < k:
                    hits_at[k] += 1
    return {k: hits_at[k] / max(n, 1) for k in topk_levels}


def main(argv=None):
    setup_logging()
    ap = argparse.ArgumentParser()
    ap.add_argument("--result_file", required=True)
    ap.add_argument("--text_file", required=True)
    ap.add_argument("--qa_file", required=True)
    args = ap.parse_args(argv)

    with open(args.result_file, encoding="utf-8") as f:
        results = json.load(f)
    texts = read_jsonl_texts(args.text_file)
    qa_pairs = parse_qa_csv_file(args.qa_file)
    acc = evaluate(results, texts, qa_pairs)
    for k, a in acc.items():
        logger.info("top-%d accuracy: %.2f", k, 100.0 * a)
    print(json.dumps({f"top{k}": round(100.0 * a, 2)
                      for k, a in acc.items()}))


if __name__ == "__main__":
    main()
