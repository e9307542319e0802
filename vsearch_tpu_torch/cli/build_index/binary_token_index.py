"""Build a bag-of-token binary index, tokenizer only, no neural net
(counterpart of ``vsearch_tpu/cli/build_index/binary_token_index.py``).
The ELL rows are placed on ``--device`` and saved as the
reference-compatible scipy ``.npz`` CSR or the native ``.ell.npz``.
"""
from __future__ import annotations

import argparse
import logging
import time

from ..common import (add_device_arg, read_jsonl_texts, setup_logging,
                      shard_slice)

logger = logging.getLogger("vsearch_tpu_torch.cli.binary_token_index")


def main(argv=None):
    setup_logging()
    ap = argparse.ArgumentParser()
    ap.add_argument("--text_file", required=True)
    ap.add_argument("--save_file", required=True)
    ap.add_argument("--batch_size", type=int, default=32,
                    help="accepted for the reference CLI; the C++ "
                         "tokenizer splits the work itself")
    ap.add_argument("--num_shift", type=int, default=999)
    ap.add_argument("--max_len", type=int, default=128)
    ap.add_argument("--max_token", type=int, default=None)
    ap.add_argument("--tokenizer", default="bert-base-uncased")
    ap.add_argument("--num_shard", type=int, default=1)
    ap.add_argument("--shard_id", type=int, default=0)
    ap.add_argument("--num_workers", type=int, default=None,
                    help="accepted for the reference CLI; the C++ "
                         "tokenizer runs its own threads")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    texts = read_jsonl_texts(args.text_file)
    texts = shard_slice(texts, args.num_shard, args.shard_id)
    io_s = time.perf_counter() - t_start
    logger.info("loaded %d texts", len(texts))

    from ...index import BoTIndex
    from ...index.bot_build import build_bot_ell
    from ...tokenization import get_tokenizer

    tokenizer = get_tokenizer(args.tokenizer)
    t0 = time.perf_counter()
    ell = build_bot_ell(tokenizer, texts, max_len=args.max_len,
                        shift=args.num_shift, batch_size=args.batch_size,
                        max_token=args.max_token,
                        num_workers=args.num_workers, device=args.device)
    build_s = time.perf_counter() - t0
    logger.info("***** Finish Indexing *****")
    logger.info("***** Time for indexing (exclude i/o): %.0f s *****",
                build_s)
    logger.info("***** Time for indexing (include i/o): %.0f s *****",
                build_s + io_s)
    index = BoTIndex(device=args.device)
    index.set_ell(ell)
    index.save(args.save_file)
    n, v = ell.shape
    nnz_total = int(ell.nnz.sum())
    logger.info("***** Index save to: %s *****", args.save_file)
    logger.info("***** Index matrix shape: (%d, %d) *****", n, v)
    logger.info("***** Index sparsity rate: %.2f%% *****",
                100.0 * nnz_total / max(n * v, 1))  # n=0: empty shard


if __name__ == "__main__":
    main()
