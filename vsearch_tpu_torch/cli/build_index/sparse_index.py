"""Build a sparse (embedded) vocab-space index with a retriever checkpoint
(counterpart of ``vsearch_tpu/cli/build_index/sparse_index.py``): embed
the corpus with ``encoder_p`` on ``--device``, keep each passage's top-k
dims, save as CSR ``.npz`` or native ``.ell.npz`` (shardable via
--num_shard/--shard_id).
"""
from __future__ import annotations

import argparse
import logging
import time

from ..common import (add_device_arg, load_retriever, read_jsonl_texts,
                      setup_logging, shard_slice)

logger = logging.getLogger("vsearch_tpu_torch.cli.sparse_index")


def main(argv=None):
    setup_logging()
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--text_file", required=True)
    ap.add_argument("--save_file", required=True)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--max_len", type=int, default=None)
    ap.add_argument("--num_shard", type=int, default=1)
    ap.add_argument("--shard_id", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    texts = read_jsonl_texts(args.text_file)
    texts = shard_slice(texts, args.num_shard, args.shard_id)
    logger.info("embedding %d texts", len(texts))

    retriever = load_retriever(args.checkpoint, args.device)
    t0 = time.perf_counter()
    index = retriever.build_index(texts, batch_size=args.batch_size,
                                  index_type="sparse",
                                  max_len=args.max_len)
    logger.info("***** Finish Indexing (%.0f s) *****",
                time.perf_counter() - t0)
    index.save(args.save_file)
    logger.info("***** Index save to: %s *****", args.save_file)


if __name__ == "__main__":
    main()
