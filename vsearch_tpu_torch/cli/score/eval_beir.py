"""BEIR-style retrieval evaluation: NDCG/MRR/Recall over qrels
(counterpart of ``vsearch_tpu/cli/score/eval_beir.py``, plus
``--device``).

Inputs in BEIR's format: corpus.jsonl (_id, title, text), queries.jsonl
(_id, text), a qrels TSV (query-id, corpus-id, score). The checkpoint's
encoders run on ``--device``; the metrics are printed as one JSON line.

    python -m vsearch_tpu_torch.cli.score.eval_beir --checkpoint ckpt \
        --corpus_file corpus.jsonl --query_file queries.jsonl \
        --qrels_file qrels/test.tsv --device cuda
"""
from __future__ import annotations

import argparse
import json
import logging

from ..common import add_device_arg, load_retriever, setup_logging

logger = logging.getLogger("vsearch_tpu_torch.cli.eval_beir")


def load_beir_corpus(path):
    corpus = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            corpus[str(obj["_id"])] = {
                "title": obj.get("title", ""),
                "text": obj.get("text", ""),
            }
    return corpus


def load_beir_queries(path):
    queries = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            queries[str(obj["_id"])] = obj.get("text") or obj.get(
                "question")
    return queries


def load_qrels_tsv(path):
    qrels = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            parts = line.rstrip("\n").split("\t")
            if not parts or len(parts) < 3:
                continue
            if i == 0 and not parts[-1].replace(".", "").isdigit():
                continue  # header
            qid, did, score = parts[0], parts[1], float(parts[-1])
            qrels.setdefault(str(qid), {})[str(did)] = score
    return qrels


def main(argv=None):
    setup_logging()
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--corpus_file", required=True)
    ap.add_argument("--query_file", required=True)
    ap.add_argument("--qrels_file", required=True)
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--ks", default="1,5,10,20,100")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ...eval.retrieval_eval import evaluate_biencoder

    model = load_retriever(args.checkpoint, args.device)
    corpus = load_beir_corpus(args.corpus_file)
    queries = load_beir_queries(args.query_file)
    qrels = load_qrels_tsv(args.qrels_file)
    ks = tuple(int(k) for k in args.ks.split(","))
    metrics = evaluate_biencoder(model, queries, corpus, qrels,
                                 k=args.topk,
                                 batch_size=args.batch_size, ks=ks)
    for name, value in sorted(metrics.items()):
        logger.info("%s: %.4f", name, value)
    print(json.dumps({m: round(v, 4) for m, v in metrics.items()}))


if __name__ == "__main__":
    main()
