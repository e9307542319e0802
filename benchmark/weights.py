"""Random BERT-VDR weights made on the device from the seed.

The weights are the benchmark's input, handed alike to the port (through
``load_state_dict``) and to the plain reference. They are made in the type
they are served in, in one draw for all matrices of both encoders, under
BERT's initialization: N(0, 0.02) for matrices and embeddings, zero
biases, unit LayerNorm scales. Names are the HF ``BertModel`` layout
under ``bert_model.`` plus the VDR head's ``ln.``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

STD = 0.02


def param_shapes(bert: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of one VDR encoder."""
    h, inter = bert["hidden_size"], bert["intermediate_size"]
    p = "bert_model."
    out = [(p + "embeddings.word_embeddings.weight", (bert["vocab_size"], h)),
           (p + "embeddings.position_embeddings.weight",
            (bert["max_position_embeddings"], h)),
           (p + "embeddings.token_type_embeddings.weight",
            (bert["type_vocab_size"], h)),
           (p + "embeddings.LayerNorm.weight", (h,)),
           (p + "embeddings.LayerNorm.bias", (h,))]
    for i in range(bert["num_hidden_layers"]):
        q = f"{p}encoder.layer.{i}."
        for lin in ("attention.self.query", "attention.self.key",
                    "attention.self.value", "attention.output.dense"):
            out += [(q + lin + ".weight", (h, h)), (q + lin + ".bias", (h,))]
        out += [(q + "attention.output.LayerNorm.weight", (h,)),
                (q + "attention.output.LayerNorm.bias", (h,)),
                (q + "intermediate.dense.weight", (inter, h)),
                (q + "intermediate.dense.bias", (inter,)),
                (q + "output.dense.weight", (h, inter)),
                (q + "output.dense.bias", (h,)),
                (q + "output.LayerNorm.weight", (h,)),
                (q + "output.LayerNorm.bias", (h,))]
    out += [("ln.weight", (h,)), ("ln.bias", (h,))]
    return out


def _is_normal(name: str) -> bool:
    return not (name.endswith("bias") or "LayerNorm" in name
                or name.startswith("ln."))


def make_encoders(bert: Dict, n: int, seed: int, device,
                  dtype: torch.dtype) -> List[Dict[str, torch.Tensor]]:
    """``n`` encoders' state dicts of ``dtype`` on ``device``: one normal
    draw of every matrix of all of them, from ``seed``."""
    shapes = param_shapes(bert)
    per = sum(torch.Size(s).numel() for name, s in shapes if _is_normal(name))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n * per, generator=gen, device=device, dtype=dtype)
    flat.mul_(STD)
    out, at = [], 0
    for _ in range(n):
        sd = {}
        for name, shape in shapes:
            if _is_normal(name):
                size = torch.Size(shape).numel()
                sd[name] = flat[at:at + size].view(shape)
                at += size
            elif name.endswith("bias"):
                sd[name] = torch.zeros(shape, device=device, dtype=dtype)
            else:
                sd[name] = torch.ones(shape, device=device, dtype=dtype)
        out.append(sd)
    return out
