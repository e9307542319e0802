"""Random granite-4.0-h VDR weights made on the device from the seed.

The weights are the benchmark's input, handed alike to the port (through
``load_state_dict``) and to the plain reference, made in the type they are
served in, from one generator: N(0, ``initializer_range``) for the linear
and embedding weights (granite's initialization), unit RMSNorm scales, and
in each Mamba-2 mixer ``mamba_ssm``'s published ranges: ``A`` uniform in
[1, 16] (``A_log = log A``), ``Δ`` log-uniform in [0.001, 0.1] (floored at
1e-4) through ``dt_bias`` (softplus's inverse), ``D = 1``, the conv's
weight and bias uniform within 1/sqrt(its 4 taps). VDR's head adds ``ln``
(unit scale, zero shift). Names are HF's ``GraniteMoeHybridModel`` layout
under ``model.``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def param_shapes(g: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of one encoder of config ``g`` (the
    model's ``config.json`` keys)."""
    h, inter = g["hidden_size"], g["shared_intermediate_size"]
    heads, n = g["mamba_n_heads"], g["mamba_d_state"]
    inner = heads * g["mamba_d_head"]
    conv_dim = inner + 2 * g["mamba_n_groups"] * n
    hd = h // g["num_attention_heads"]
    kv = g["num_key_value_heads"] * hd
    out = [("model.embed_tokens.weight", (g["vocab_size"], h))]
    for i, kind in enumerate(g["layer_types"]):
        p = f"model.layers.{i}."
        out.append((p + "input_layernorm.weight", (h,)))
        if kind == "mamba":
            m = p + "mamba."
            out += [(m + "dt_bias", (heads,)), (m + "A_log", (heads,)),
                    (m + "D", (heads,)),
                    (m + "in_proj.weight", (inner + conv_dim + heads, h)),
                    (m + "conv1d.weight", (conv_dim, 1, g["mamba_d_conv"])),
                    (m + "conv1d.bias", (conv_dim,)),
                    (m + "norm.weight", (inner,)),
                    (m + "out_proj.weight", (h, inner))]
        else:
            a = p + "self_attn."
            out += [(a + "q_proj.weight", (h, h)), (a + "k_proj.weight", (kv, h)),
                    (a + "v_proj.weight", (kv, h)),
                    (a + "o_proj.weight", (h, h))]
        out += [(p + "shared_mlp.input_linear.weight", (2 * inter, h)),
                (p + "shared_mlp.output_linear.weight", (h, inter)),
                (p + "post_attention_layernorm.weight", (h,))]
    out += [("model.norm.weight", (h,)), ("ln.weight", (h,)),
            ("ln.bias", (h,))]
    return out


def _draw(name: str, shape, gen, device, dtype, std: float) -> torch.Tensor:
    def uniform(lo, hi):
        return torch.empty(shape, device=device).uniform_(lo, hi,
                                                          generator=gen)

    if name.endswith(".weight") and (name.endswith("proj.weight")
                                     or "linear" in name
                                     or "embed_tokens" in name):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(std)
    if "conv1d" in name:
        bound = 1.0 / math.sqrt(shape[-1] if len(shape) == 3 else 4)
        return uniform(-bound, bound).to(dtype)
    if name.endswith("A_log"):
        return torch.log(uniform(1.0, 16.0)).to(dtype)
    if name.endswith("dt_bias"):
        u = torch.rand(shape, generator=gen, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001)).clamp_min(1e-4)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if name == "ln.bias":
        return torch.zeros(shape, device=device, dtype=dtype)
    return torch.ones(shape, device=device, dtype=dtype)  # norms, D


def make_encoders(g: Dict, n: int, seed: int, device, dtype: torch.dtype,
                  std: float = 0.02) -> List[Dict[str, torch.Tensor]]:
    """``n`` encoders' state dicts of ``dtype`` on ``device``, drawn in
    order from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = param_shapes(g)
    return [{name: _draw(name, shape, gen, device, dtype, std)
             for name, shape in shapes} for _ in range(n)]
