"""Checkpoint/resume of the full training state (counterpart of
``vsearch_tpu/train/checkpoint.py``).

A train-state directory holds ``state.pt``, a ``torch.save`` of
``{"params": state_dict of the f32 weights, "optimizer": {"adamw":
torch.optim.AdamW state_dict, "count": updates applied}, "step": int}``,
and ``train_meta.json`` (``epoch``, ``offset``: the completed epoch and
the batches of the next one already consumed, ``step``). This is the
port's own format: it cannot read the JAX package's orbax train states,
nor they it. Model-only checkpoints (``checkpoint_<n>``) are the HF
layout of ``save_pretrained``, which both packages read.

Saves are atomic as in the JAX package: the payload and the meta land in
a ``.tmp`` sibling, the previous directory is displaced to ``.old``, then
``.tmp`` is renamed into place; the meta is written before the commit,
so a directory holding both files is complete.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Dict, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

_META_NAME = "train_meta.json"
_STATE_NAME = "state.pt"


def _complete(d: str) -> bool:
    return (os.path.isfile(os.path.join(d, _STATE_NAME))
            and os.path.isfile(os.path.join(d, _META_NAME)))


def _commit(directory: str, tmp: str) -> None:
    """Move ``tmp`` into place; the previous checkpoint survives as
    ``.old`` until the new one is in place."""
    old = directory + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.isdir(directory):
        os.rename(directory, old)
    os.rename(tmp, directory)
    shutil.rmtree(old, ignore_errors=True)


def save_checkpoint(directory: str, state, epoch: int = 0,
                    offset: int = 0, extra: Optional[Dict] = None):
    """Write the train state + iteration metadata under ``directory``,
    ATOMICALLY: repeated saves (save_steps) target one fixed dir, and a
    crash mid-save must never destroy the previous good checkpoint or
    leave state and meta out of step."""
    directory = os.path.abspath(directory)
    tmp = directory + ".tmp"
    if _complete(tmp) and not _complete(directory):
        # a previous save crashed between displacing the old dir and
        # committing tmp: tmp is the NEWEST good checkpoint and
        # resolve_checkpoint_dir has been serving it. Finish that commit
        # before starting a new save, or a second crash would fall back
        # two generations.
        _commit(directory, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    torch.save({"params": state.module.state_dict(),
                "optimizer": state.tx.state_dict(), "step": state.step},
               os.path.join(tmp, _STATE_NAME))
    meta = {"epoch": epoch, "offset": offset, "step": int(state.step)}
    if extra:
        meta.update(extra)
    with open(os.path.join(tmp, _META_NAME), "w") as f:
        json.dump(meta, f)
    _commit(directory, tmp)
    logger.info("checkpoint saved to %s (epoch=%d offset=%d)", directory,
                epoch, offset)


def resolve_checkpoint_dir(directory: str) -> Optional[str]:
    """Newest COMPLETE checkpoint for ``directory``, tolerating a crash
    at any point of the atomic save: prefer the committed dir, then a
    complete-but-uncommitted ``.tmp``, then the displaced ``.old``."""
    directory = os.path.abspath(directory)
    for cand in (directory, directory + ".tmp", directory + ".old"):
        if _complete(cand):
            return cand
    return None


def load_checkpoint(directory: str, state) -> Tuple[object, Dict]:
    """Restore a train state saved by ``save_checkpoint`` into ``state``
    (one made for the same model: its weights and optimizer are
    overwritten in place, on their own device; AdamW's step counts stay
    on the host, where it keeps them). Returns (state, meta)."""
    directory = os.path.abspath(directory)
    payload = torch.load(os.path.join(directory, _STATE_NAME),
                         map_location="cpu", weights_only=True)
    state.module.load_state_dict(payload["params"])
    state.tx.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    meta = {}
    meta_path = os.path.join(directory, _META_NAME)
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta
