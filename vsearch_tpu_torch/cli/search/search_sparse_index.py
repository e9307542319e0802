"""Search a sparse index: alpha (parametric) search (counterpart of
``vsearch_tpu/cli/search/search_sparse_index.py``). ``--index_file``
accepts glob patterns over shards; an index above the sparse index's
``exact_threshold`` rows is searched through the binary-support proxy.
"""
from __future__ import annotations

import argparse
import logging
import time

from ..common import (add_device_arg, load_retriever, read_queries,
                      save_results, setup_logging)

logger = logging.getLogger("vsearch_tpu_torch.cli.search_sparse_index")


def run_search(retriever, queries, k, batch_size_q):
    import numpy as np

    all_ids, all_scores = [], []
    t0 = time.perf_counter()
    for s in range(0, len(queries), batch_size_q):
        chunk = queries[s: s + batch_size_q]
        res = retriever.retrieve(chunk, k=k, batch_size=batch_size_q)
        all_ids.append(np.asarray(res.ids))
        all_scores.append(np.asarray(res.scores))
    dt = time.perf_counter() - t0
    logger.info("searched %d queries in %.1f s (%.1f q/s)", len(queries),
                dt, len(queries) / dt)
    return np.concatenate(all_ids), np.concatenate(all_scores)


def main(argv=None):
    setup_logging()
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--query_file", required=True)
    ap.add_argument("--index_file", required=True)
    ap.add_argument("--save_file", required=True)
    ap.add_argument("--batch_size_q", type=int, default=32)
    ap.add_argument("--topk", type=int, default=100)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    queries = read_queries(args.query_file)
    retriever = load_retriever(args.checkpoint, args.device)
    retriever.load_index(index_file=args.index_file, index_type="sparse")
    ids, scores = run_search(retriever, queries, args.topk,
                             args.batch_size_q)
    save_results(args.save_file, queries, ids, scores)


if __name__ == "__main__":
    main()
