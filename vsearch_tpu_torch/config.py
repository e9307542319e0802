"""Lightweight YAML config system with hydra-style groups and overrides
(a copy of ``vsearch_tpu/config.py``, which imports no JAX).

The reference composes configs with hydra 1.3 (reference:
conf/train_ir_cfg.yaml:3-8, train_ir.py:218). This dependency-free
equivalent supports:

  * a root yaml with a ``defaults`` list naming group/option pairs
    (``- biencoder: vdr`` loads ``conf/biencoder/vdr.yaml`` under the
    ``biencoder`` key);
  * dotted-path CLI overrides (``train.learning_rate=1e-5``,
    ``biencoder=dpr`` to swap a whole group);
  * values parsed as YAML scalars.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import yaml


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return yaml.safe_load(f) or {}


def _set_dotted(cfg: Dict[str, Any], key: str, value: Any):
    parts = key.split(".")
    # hydra-style strictness at the TOP level: a typo'd group
    # ('trian.batch_size=...') would otherwise create an unused
    # subtree and the override would be silently dropped
    if len(parts) > 1 and parts[0] not in cfg:
        raise KeyError(
            f"override {key!r}: unknown config group {parts[0]!r} "
            f"(known: {sorted(cfg)})")
    node = cfg
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            # e.g. 'mesh: null' in the root yaml + 'mesh.dp=4'
            nxt = {}
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


def load_config(root_file: str,
                overrides: Optional[Sequence[str]] = None
                ) -> Dict[str, Any]:
    """Compose a config from a root yaml + group defaults + overrides."""
    conf_dir = os.path.dirname(os.path.abspath(root_file))
    root = _load_yaml(root_file)
    defaults = root.pop("defaults", [])
    cfg: Dict[str, Any] = {}

    # group swaps in overrides apply before loading groups
    overrides = list(overrides or [])
    group_over: Dict[str, str] = {}
    value_over: List[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov!r}")
        k, v = ov.split("=", 1)
        if "." not in k and os.path.isdir(os.path.join(conf_dir, k)):
            group_over[k] = v
        else:
            value_over.append(ov)

    for entry in defaults:
        if isinstance(entry, dict):
            (group, option), = entry.items()
        else:
            group, option = entry, None
        option = group_over.pop(group, option)
        if option is None:
            continue
        path = os.path.join(conf_dir, group, f"{option}.yaml")
        cfg[group] = _load_yaml(path)
    for group, option in group_over.items():
        cfg[group] = _load_yaml(
            os.path.join(conf_dir, group, f"{option}.yaml"))

    cfg.update(root)
    for ov in value_over:
        k, v = ov.split("=", 1)
        _set_dotted(cfg, k, _parse_scalar(v))
    return cfg


def _parse_scalar(v: str) -> Any:
    """YAML scalar parse, plus scientific-notation floats ('1e-5') that
    YAML 1.1 treats as strings."""
    parsed = yaml.safe_load(v)
    if isinstance(parsed, str):
        try:
            return float(parsed)
        except ValueError:
            return parsed
    return parsed
