"""The granite-4.0-h cells' frozen arithmetic: the operations and bytes of
a granite-VDR forward and of the Mamba-2 chunk-scan kernel
(``ssd_chunk``), at each text's own token count, as ``flops.py`` counts
BERT's: never padding, each input byte read once and each output byte
written once. ``g`` is the model's ``config.json`` keys (the cell's
configuration file).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from .flops import H100_BF16_FLOPS, H100_BYTES_PER_S, H100_F32_FLOPS


def _pairs(tokens: int) -> int:
    """(t, s) position pairs with s <= t: a causal mixer's work."""
    return tokens * (tokens + 1) // 2


def ssd_pair_ops(g: Dict) -> int:
    """Operations of one (t, s) pair in a Mamba-2 layer's single-chunk SSD:
    C_t . B_s (shared by the heads, one group) and each head's
    decay-weighted x_s added into y_t."""
    return 2 * g["mamba_d_state"] + 2 * g["mamba_n_heads"] * g["mamba_d_head"]


def conv_dim(g: Dict) -> int:
    inner = g["mamba_n_heads"] * g["mamba_d_head"]
    return inner + 2 * g["mamba_n_groups"] * g["mamba_d_state"]


def mamba_layers(g: Dict) -> int:
    return sum(1 for kind in g["layer_types"] if kind == "mamba")


def encoder_forward_flops(tokens: int, g: Dict, v_out: int) -> float:
    """FLOPs of one granite-VDR forward over a text of ``tokens`` tokens:
    per token the matrix products of each layer (Mamba-2's in- and
    out-projections, attention's QKVO, the SwiGLU MLP) and the head's
    projection (2 h V'), plus the causal pairs of each mixer (the SSD's,
    attention's scores and context at 4 h a pair) and the Mamba-2 conv;
    norms, gating, softmax and the pooling are left out."""
    h, inter = g["hidden_size"], g["shared_intermediate_size"]
    heads, inner = g["mamba_n_heads"], g["mamba_n_heads"] * g["mamba_d_head"]
    kv = g["num_key_value_heads"] * (h // g["num_attention_heads"])
    mlp = 6 * h * inter
    mamba = (2 * h * (inner + conv_dim(g) + heads) + 2 * inner * h
             + 2 * g["mamba_d_conv"] * conv_dim(g))
    attn = 4 * h * h + 4 * h * kv
    n_m = mamba_layers(g)
    n_a = len(g["layer_types"]) - n_m
    per_tok = (n_m * (mamba + mlp) + n_a * (attn + mlp) + 2 * h * v_out)
    pairs = _pairs(tokens) * (n_m * ssd_pair_ops(g) + n_a * 4 * h)
    return float(tokens * per_tok + pairs)


def ssd_chunk_work(tokens: int, g: Dict) -> Tuple[float, float, float]:
    """(pair operations, other operations, bytes) of the chunk-scan kernel
    over one text of ``tokens`` tokens in one layer: the SSD's causal
    pairs (C.B and each head's decay-weighted x, tile products on bf16
    inputs), then the conv's taps and the D skip; xBC and dt read once and
    y written once (bf16). The layer's few parameters, read once a launch,
    are left out."""
    inner = g["mamba_n_heads"] * g["mamba_d_head"]
    pair_ops = _pairs(tokens) * ssd_pair_ops(g)
    other_ops = tokens * 2 * (g["mamba_d_conv"] * conv_dim(g) + inner)
    nbytes = tokens * 2 * (conv_dim(g) + g["mamba_n_heads"] + inner)
    return float(pair_ops), float(other_ops), float(nbytes)


def ssd_chunk_s(token_counts: Iterable[int], g: Dict) -> float:
    """The least seconds of the kernel's launches over these texts in every
    Mamba-2 layer, the largest of: their bytes at 3.35 TB/s, their pair
    products at the H100's bf16 tensor-core rate (989 TFLOP/s), and the
    conv and the skip at its f32 rate outside the tensor cores
    (67 TFLOP/s)."""
    pair_ops = other_ops = nbytes = 0.0
    for t in token_counts:
        p, o, b = ssd_chunk_work(int(t), g)
        pair_ops += p
        other_ops += o
        nbytes += b
    n = mamba_layers(g)
    return n * max(nbytes / H100_BYTES_PER_S, pair_ops / H100_BF16_FLOPS,
                   other_ops / H100_F32_FLOPS)
