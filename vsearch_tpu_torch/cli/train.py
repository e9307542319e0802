"""Training CLI (counterpart of ``vsearch_tpu/cli/train.py``).

Usage:
  python -m vsearch_tpu_torch.cli.train --config conf/train_ir_cfg.yaml \\
      train_datasets=[nq_train] train.batch_size=64 biencoder=dpr \\
      [--device cpu]

One process trains on one device (``--device``, default ``cuda``, or a
``device=`` override). A mesh of more than one device (``mesh.dp > 1`` or
``mesh.tp > 1``) and a distributed launch (``WORLD_SIZE`` > 1) are
refused: they are the port's slice 7. ``model_path`` loads a checkpoint
(HF layout, with its ``vocab.txt``); without it the bi-encoder is made
from ``biencoder`` with random weights from ``seed``, and its tokenizer
from the encoders' ``model_id``.
"""
from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np

from ..config import load_config
from .common import add_device_arg

logger = logging.getLogger("vsearch_tpu_torch.cli.train")

_SLICE_7 = ("multi-GPU training (per-rank data shards and an autograd-aware "
            "all-gather of in-batch negatives) is the port's slice 7; this "
            "CLI trains on one device")


def set_seed(seed: int):
    """reference conf_utils.py:10-16."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_datasets(cfg, names):
    from ..data import BiEncoderDataset

    datasets = []
    for name in names or []:
        spec = cfg["data_stores"][name]
        datasets.append(BiEncoderDataset(
            file=spec["file"],
            shuffle_positives=spec.get("shuffle_positives", False),
            download_link=spec.get("download_link")))
    return datasets


def check_single_device(cfg) -> None:
    """Refuse a mesh of more than one device and a distributed launch."""
    mesh_cfg = cfg.get("mesh") or {}
    for axis in ("dp", "tp"):
        if (mesh_cfg.get(axis) or 1) > 1:
            raise SystemExit(f"mesh.{axis}={mesh_cfg[axis]}: {_SLICE_7}")
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise SystemExit(f"WORLD_SIZE={world}: {_SLICE_7}")


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="conf/train_ir_cfg.yaml")
    add_device_arg(ap)
    ap.add_argument("overrides", nargs="*",
                    help="dotted key=value overrides / group swaps")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    check_single_device(cfg)
    device = cfg.get("device") or args.device  # a device= override wins

    seed = int(cfg.get("seed", 12345))
    set_seed(seed)

    from ..retriever import Retriever, RetrieverConfig
    from ..train.trainer import RetrieverTrainer, TrainConfig

    if cfg.get("model_path"):
        logger.info("loading checkpoint from %s", cfg["model_path"])
        retriever = Retriever.from_pretrained(cfg["model_path"],
                                              device=device)
    else:
        retriever = Retriever(RetrieverConfig.from_dict(cfg["biencoder"]),
                              seed=seed, device=device)

    # optional live index for retrieved-negative mining
    if cfg.get("index") and cfg.get("index_stores"):
        spec = cfg["index_stores"][cfg["index"]]
        retriever.load_index(index_file=spec["index_file"],
                             data_file=spec.get("data_file"),
                             index_type=spec.get("index_type"))

    train_cfg = TrainConfig.from_dict({
        **cfg.get("train", {}),
        "seed": seed,
        "output_dir": cfg.get("output_dir", "./output"),
        "save_name_prefix": cfg.get("save_name_prefix", "checkpoint"),
    })

    datasets = build_datasets(cfg, cfg.get("train_datasets"))
    if not datasets:
        logger.warning("no train_datasets specified; nothing to do")
        return None
    trainer = RetrieverTrainer(retriever, train_cfg, datasets)
    trainer.run_train(resume=bool(cfg.get("resume")))
    return trainer


if __name__ == "__main__":
    main()
