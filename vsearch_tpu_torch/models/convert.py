"""Carry weights into the port.

``*_state_dict_from_flax`` turn the JAX package's parameter trees (nested
dicts of numpy arrays, as an encoder's ``variables["params"]`` holds
them) into the port's state dicts: the inverses of
``vsearch_tpu/models/hf_convert.py``'s ``convert_*_params``. Flax
``Dense`` kernels are [in, out] and torch ``Linear`` weights [out, in];
flax conv kernels are [kh, kw, cin, cout], torch's [cout, cin, kh, kw];
the tied word embedding feeds both the BERT input and the VDR heads.

The HF-layout readers (``vdr_state_dict_from_hf``, ``convert_dpr_params``,
``convert_crossmodal_text_params``, ``convert_vdr_image_params``) take a
reference torch state dict, whose names the port's modules follow
already, and drop what the modules do not hold.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _bert_state_dict_from_flax(bert: Mapping, word_embedding,
                               num_layers: int, sd: Dict[str, torch.Tensor]
                               ) -> None:
    """A flax ``BertModel`` tree (its word embedding given apart, since VDR
    hoists it) -> ``bert_model.*`` entries of ``sd``."""
    def lin(name, p):
        sd[name + ".weight"] = _t(np.asarray(p["kernel"]).T)
        sd[name + ".bias"] = _t(p["bias"])

    def ln(name, p):
        sd[name + ".weight"] = _t(p["scale"])
        sd[name + ".bias"] = _t(p["bias"])

    emb = "bert_model.embeddings"
    sd[emb + ".word_embeddings.weight"] = _t(word_embedding)
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


def vdr_state_dict_from_flax(params: Mapping, num_layers: int
                             ) -> Dict[str, torch.Tensor]:
    """JAX VDRModule params -> port VDRModule state dict (f32). The JAX
    cross-modal ``VDRTextModule`` has the same tree (``word_embeddings``,
    ``bert``, ``ln``), so this serves it too."""
    sd: Dict[str, torch.Tensor] = {}
    _bert_state_dict_from_flax(params["bert"],
                               params["word_embeddings"]["embedding"],
                               num_layers, sd)
    sd["ln.weight"] = _t(params["ln"]["scale"])
    sd["ln.bias"] = _t(params["ln"]["bias"])
    return sd


crossmodal_text_state_dict_from_flax = vdr_state_dict_from_flax


def dpr_state_dict_from_flax(params: Mapping, num_layers: int
                             ) -> Dict[str, torch.Tensor]:
    """JAX DPRModule params (``{"bert": ...}``) -> port DPRModule state
    dict (f32)."""
    sd: Dict[str, torch.Tensor] = {}
    bert = params["bert"]
    _bert_state_dict_from_flax(
        bert, bert["embeddings"]["word_embeddings"]["embedding"],
        num_layers, sd)
    return sd


def vdr_image_state_dict_from_flax(params: Mapping, layers: int
                                   ) -> Dict[str, torch.Tensor]:
    """JAX VDRImageModule params -> port VDRImageModule state dict (f32):
    the inverse of ``hf_convert.convert_vdr_image_params``."""
    sd: Dict[str, torch.Tensor] = {
        "conv1.weight": _t(np.asarray(params["conv1"]["kernel"])
                           .transpose(3, 2, 0, 1)),
        "positional_embedding": _t(params["positional_embedding"]),
        "proj": _t(params["proj"])}
    for name in ("ln_pre", "ln_post"):
        sd[f"{name}.weight"] = _t(params[name]["scale"])
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    for i in range(layers):
        blk, p = params[f"block_{i}"], f"transformer.resblocks.{i}"
        for name in ("ln_1", "ln_2"):
            sd[f"{p}.{name}.weight"] = _t(blk[name]["scale"])
            sd[f"{p}.{name}.bias"] = _t(blk[name]["bias"])
        sd[f"{p}.attn.in_proj_weight"] = _t(
            np.asarray(blk["in_proj"]["kernel"]).T)
        sd[f"{p}.attn.in_proj_bias"] = _t(blk["in_proj"]["bias"])
        for name, dst in (("out_proj", "attn.out_proj"),
                          ("c_fc", "mlp.c_fc"), ("c_proj", "mlp.c_proj")):
            sd[f"{p}.{dst}.weight"] = _t(np.asarray(blk[name]["kernel"]).T)
            sd[f"{p}.{dst}.bias"] = _t(blk[name]["bias"])
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


convert_crossmodal_text_params = vdr_state_dict_from_hf


def convert_dpr_params(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference DPR encoder's state dict (``bert_model.*``) or a plain
    ``BertModel``'s -> port DPRModule state dict (f32); pooler weights and
    position-id buffers are dropped."""
    prefixed = any(k.startswith("bert_model.") for k in sd)
    out = {}
    for k, v in sd.items():
        if k.endswith("position_ids") or ".pooler." in k \
                or k.startswith("pooler."):
            continue
        if not prefixed:
            k = "bert_model." + k
        if k.startswith("bert_model."):
            out[k] = torch.as_tensor(v).float()
    return out


_IMAGE_KEYS = ("conv1.", "positional_embedding", "ln_pre.", "ln_post.",
               "proj", "transformer.resblocks.")


def convert_vdr_image_params(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference image encoder's state dict -> port VDRImageModule state
    dict (f32): the names are the same; other entries are dropped."""
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if k.startswith(_IMAGE_KEYS)}
