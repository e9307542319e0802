"""Convert a reference-style HF torch checkpoint directory into this
package's layout (counterpart of ``vsearch_tpu/cli/convert_checkpoint.py``).

The layouts are the same (``config.json`` + ``vocab.txt`` +
``pytorch_model.bin``); the conversion loads the directory, which turns on
``compat_pad_pooling`` for VDR encoders whose config leaves it unset, and
writes it back with that choice stated and the weights in f32.

Usage:
  python -m vsearch_tpu_torch.cli.convert_checkpoint \\
      --torch_dir /path/to/reference-ckpt --out /path/to/converted
"""
from __future__ import annotations

import argparse
import logging

from .common import add_device_arg, load_retriever, setup_logging

logger = logging.getLogger("vsearch_tpu_torch.cli.convert_checkpoint")


def main(argv=None):
    setup_logging()
    ap = argparse.ArgumentParser(
        description="convert an HF torch bi-encoder checkpoint directory")
    ap.add_argument("--torch_dir", required=True,
                    help="reference-style HF checkpoint directory")
    ap.add_argument("--out", required=True,
                    help="output directory for the converted checkpoint")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    model = load_retriever(args.torch_dir, args.device)
    model.save_pretrained(args.out)
    logger.info("converted %s -> %s", args.torch_dir, args.out)
    print(f"checkpoint written to {args.out}")


if __name__ == "__main__":
    main()
