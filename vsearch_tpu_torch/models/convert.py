"""Carry weights into the port.

``vdr_state_dict_from_flax`` turns the JAX package's VDR parameter tree
(nested dicts of numpy arrays, as ``VDREncoder.variables["params"]``
holds them) into the port's state dict: the inverse of
``vsearch_tpu/models/hf_convert.py:convert_vdr_params``. Flax ``Dense``
kernels are [in, out] and torch ``Linear`` weights [out, in]; the tied
word embedding feeds both the BERT input and the VDR head.

``vdr_state_dict_from_hf`` takes an HF-layout torch state dict (a
reference VDR checkpoint with ``bert_model.*`` + ``ln.*`` keys, or a plain
``BertModel``'s), which the port's module names follow already.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def vdr_state_dict_from_flax(params: Mapping, num_layers: int
                             ) -> Dict[str, torch.Tensor]:
    """JAX VDRModule params -> port VDRModule state dict (f32)."""
    sd: Dict[str, torch.Tensor] = {}

    def lin(name, p):
        sd[name + ".weight"] = _t(np.asarray(p["kernel"]).T)
        sd[name + ".bias"] = _t(p["bias"])

    def ln(name, p):
        sd[name + ".weight"] = _t(p["scale"])
        sd[name + ".bias"] = _t(p["bias"])

    emb, bert = "bert_model.embeddings", params["bert"]
    sd[emb + ".word_embeddings.weight"] = _t(
        params["word_embeddings"]["embedding"])
    for name in ("position_embeddings", "token_type_embeddings"):
        sd[f"{emb}.{name}.weight"] = _t(
            bert["embeddings"][name]["embedding"])
    ln(emb + ".LayerNorm", bert["embeddings"]["layer_norm"])
    for i in range(num_layers):
        p, layer = f"bert_model.encoder.layer.{i}", bert[f"layer_{i}"]
        att = layer["attention"]
        for name in ("query", "key", "value"):
            lin(f"{p}.attention.self.{name}", att[name])
        lin(f"{p}.attention.output.dense", att["output"])
        ln(f"{p}.attention.output.LayerNorm", att["output_layer_norm"])
        lin(f"{p}.intermediate.dense", layer["intermediate"])
        lin(f"{p}.output.dense", layer["output"])
        ln(f"{p}.output.LayerNorm", layer["output_layer_norm"])
    ln("ln", params["ln"])
    return sd


def vdr_state_dict_from_hf(sd: Mapping, hidden_size: int
                           ) -> Dict[str, torch.Tensor]:
    """HF-layout VDR or BertModel state dict -> port state dict. A plain
    BertModel gets the ``bert_model.`` prefix and an identity head
    LayerNorm; pooler weights and position-id buffers are dropped."""
    out = {}
    prefixed = any(k.startswith("bert_model.") for k in sd)
    for k, v in sd.items():
        if k.endswith("position_ids") or ".pooler." in k \
                or k.startswith("pooler."):
            continue
        if not prefixed and not k.startswith("ln."):
            k = "bert_model." + k
        out[k] = torch.as_tensor(v).float()
    if "ln.weight" not in out:
        out["ln.weight"] = torch.ones(hidden_size)
        out["ln.bias"] = torch.zeros(hidden_size)
    return out
