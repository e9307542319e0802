"""Beta search: semi-parametric retrieval over a binary token index with
an on-the-fly parametric rerank (counterpart of
``vsearch_tpu/cli/search/beta_search.py``).
"""
from __future__ import annotations

import argparse
import logging
import time

from ..common import (add_device_arg, load_retriever, read_queries,
                      save_results, setup_logging)

logger = logging.getLogger("vsearch_tpu_torch.cli.beta_search")


def main(argv=None):
    setup_logging()
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--query_file", required=True)
    ap.add_argument("--text_file", required=True,
                    help="corpus jsonl backing the index rows (used for "
                         "on-the-fly rerank embedding)")
    ap.add_argument("--index_file", required=True)
    ap.add_argument("--save_file", required=True)
    ap.add_argument("--batch_size_q", type=int, default=32)
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--num_rerank", type=int, default=100)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import numpy as np

    queries = read_queries(args.query_file)
    retriever = load_retriever(args.checkpoint, args.device)
    retriever.load_index(index_file=args.index_file,
                         data_file=args.text_file,
                         index_type="bag_of_token")

    all_ids, all_scores = [], []
    t0 = time.perf_counter()
    k = max(args.topk, args.num_rerank)
    for s in range(0, len(queries), args.batch_size_q):
        chunk = queries[s: s + args.batch_size_q]
        res = retriever.retrieve(chunk, k=k, rerank=args.num_rerank > 0,
                                 batch_size=args.batch_size_q)
        all_ids.append(np.asarray(res.ids)[:, : args.topk])
        all_scores.append(np.asarray(res.scores)[:, : args.topk])
    dt = time.perf_counter() - t0
    logger.info("beta-searched %d queries in %.1f s (%.1f q/s)",
                len(queries), dt, len(queries) / dt)
    save_results(args.save_file, queries, np.concatenate(all_ids),
                 np.concatenate(all_scores))


if __name__ == "__main__":
    main()
