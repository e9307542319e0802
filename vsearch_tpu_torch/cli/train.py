"""Training CLI (counterpart of ``vsearch_tpu/cli/train.py``).

Usage:
  python -m vsearch_tpu_torch.cli.train --config conf/train_ir_cfg.yaml \\
      train_datasets=[nq_train] train.batch_size=64 biencoder=dpr \\
      [--device cpu]
  torchrun --nproc_per_node N -m vsearch_tpu_torch.cli.train ...

One process trains on one device (``--device``, default ``cuda``, or a
``device=`` override). Under ``torchrun`` (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) each process joins the group
(NCCL; gloo with ``--device cpu``), takes the card ``cuda:LOCAL_RANK``
(at ``mesh.tp = 1``) and its own shard of the data, ``train.batch_size``
samples a step, and the ranks train on their global batch (``train/step.py``). ``mesh.dp``,
when set, must equal ``WORLD_SIZE``. ``mesh.tp = T`` splits the VDR head's
vocabulary over T devices of each process (``parallel/mesh.py``): cards
``LOCAL_RANK*T .. LOCAL_RANK*T+T-1`` under ``torchrun``, T cards from
``--device``'s alone, the CPU T times with ``--device cpu``; too few
cards raise with the mesh arithmetic. ``model_path`` loads a checkpoint
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


def check_launch(cfg) -> int:
    """The world size of this launch (``WORLD_SIZE``, default 1), after
    refusing what this CLI cannot run: a ``mesh.dp`` other than the world
    size, and ``WORLD_SIZE > 1`` without a coordinator address to form the
    group."""
    mesh_cfg = cfg.get("mesh") or {}
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if mesh_cfg.get("dp") and mesh_cfg["dp"] != world:
        raise SystemExit(
            f"mesh.dp={mesh_cfg['dp']} != WORLD_SIZE={world}: one process "
            "trains a card; launch mesh.dp processes with torchrun "
            "--nproc_per_node")
    if world > 1 and not (os.environ.get("MASTER_ADDR")
                          or os.environ.get("COORDINATOR_ADDRESS")):
        raise SystemExit(
            f"WORLD_SIZE={world} without MASTER_ADDR/MASTER_PORT (or "
            "COORDINATOR_ADDRESS): launch with torchrun, which sets them")
    return world


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
    world = check_launch(cfg)
    tp = int((cfg.get("mesh") or {}).get("tp") or 1)
    device = cfg.get("device") or args.device  # a device= override wins

    # the process group first (reference conf_utils.py:19-49); a bare
    # "cuda" is cuda:LOCAL_RANK there
    from ..parallel.collectives import initialize_distributed

    distributed = initialize_distributed(device=device)
    try:
        mesh = None
        if distributed or tp > 1:
            import torch

            from ..device import resolve_device
            from ..parallel.mesh import make_mesh

            try:  # a tp line a rank, its lead the rank's device
                mesh = make_mesh(dp=world if distributed else 1, tp=tp,
                                 device=resolve_device(device))
            except ValueError as exc:
                raise SystemExit(str(exc)) from None
            device = mesh.devices("tp")[0]
            if device.type == "cuda":
                torch.cuda.set_device(device)
            logger.info("training over %s", mesh)
        return _train(cfg, device, mesh)
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(cfg, device, mesh=None):
    """Train on ``device`` over ``mesh`` (None: one device, no group)."""
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
    trainer = RetrieverTrainer(retriever, train_cfg, datasets, mesh=mesh)
    trainer.run_train(resume=bool(cfg.get("resume")))
    return trainer


if __name__ == "__main__":
    main()
