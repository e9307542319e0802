"""Search a dense index (counterpart of
``vsearch_tpu/cli/search/search_dense_index.py``)."""
from __future__ import annotations

import argparse
import logging

from ..common import (add_device_arg, load_retriever, read_queries,
                      save_results, setup_logging)
from .search_sparse_index import run_search

logger = logging.getLogger("vsearch_tpu_torch.cli.search_dense_index")


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
    retriever.load_index(index_file=args.index_file, index_type="dense")
    ids, scores = run_search(retriever, queries, args.topk,
                             args.batch_size_q)
    save_results(args.save_file, queries, ids, scores)


if __name__ == "__main__":
    main()
