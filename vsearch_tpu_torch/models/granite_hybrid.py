"""The granite-4.0-h trunk: Mamba-2 and NoPE attention layers side by side
(IBM's ``granitemoehybrid``, https://huggingface.co/ibm-granite/
granite-4.0-h-micro), as ``torch.nn.Module``s for VDR's encoders.

Each layer is ``h += r * mixer(RMSNorm(h))`` then ``h += r * MLP(RMSNorm(h))``
with ``r`` the residual multiplier; the mixer is Mamba-2 or causal GQA
attention with no positional encoding, in ``layer_types``' order, and the
MLP is SwiGLU. The embedding is scaled by the embedding multiplier and the
trunk ends in an RMSNorm. Submodule names follow HF's
``GraniteMoeHybridModel`` (``embed_tokens``, ``layers.{i}.mamba.in_proj``,
``layers.{i}.self_attn.q_proj``, ``layers.{i}.shared_mlp.input_linear``,
``norm`` ...), so an HF state dict under ``model.`` loads as it is.

Everything is causal: a row's right padding never reaches its valid
positions, so the trunk takes no mask. The Mamba-2 mixer's sequence part
(causal conv, SiLU, the step sizes, the single-chunk SSD and the D skip)
is ``ops.ssd.ssd_chunk``, a CUDA kernel on the card; the projections and
the gated RMSNorm stay PyTorch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ssd import ssd_chunk

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# granite-4.0-h-micro's ``layer_types``: attention at 5, 15, 25 and 35
MICRO_LAYER_TYPES = tuple("attention" if i in (5, 15, 25, 35) else "mamba"
                          for i in range(40))


@dataclasses.dataclass(frozen=True)
class GraniteHybridConfig:
    """The keys of the model's ``config.json`` that the trunk reads, at
    granite-4.0-h-micro's values."""

    vocab_size: int = 100352
    hidden_size: int = 2048
    shared_intermediate_size: int = 8192
    layer_types: Tuple[str, ...] = MICRO_LAYER_TYPES
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attention_multiplier: float = 0.015625
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 8.0
    mamba_n_heads: int = 64
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_chunk_size: int = 256
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    attention_bias: bool = False
    rms_norm_eps: float = 1e-5
    position_embedding_type: str = "nope"
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32  # compute (and storage) dtype

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.position_embedding_type != "nope":
            raise NotImplementedError("the trunk has no positional encoding "
                                      f"({self.position_embedding_type!r})")
        if self.mamba_n_groups != 1:
            raise NotImplementedError("one B/C group (mamba_n_groups=1)")
        bad = set(self.layer_types) - {"mamba", "attention"}
        if bad:
            raise ValueError(f"unknown layer types {sorted(bad)}")

    @property
    def num_hidden_layers(self) -> int:
        return len(self.layer_types)

    @property
    def mamba_inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def conv_dim(self) -> int:
        return self.mamba_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size: int = 1200) -> "GraniteHybridConfig":
        """Small config for tests: hidden 64, 4 Mamba heads of 16, one
        attention layer in a 3-layer pattern."""
        return cls(vocab_size=vocab_size, hidden_size=64,
                   shared_intermediate_size=128,
                   layer_types=("mamba", "attention", "mamba"),
                   num_attention_heads=4, num_key_value_heads=2,
                   mamba_n_heads=4, mamba_d_head=16, mamba_d_state=16,
                   mamba_chunk_size=64)


class RMSNorm(nn.Module):
    """HF Granite's RMSNorm: in f32, the weight applied in the input's
    dtype; with ``gate``, Mamba-2's gated form ``RMSNorm(x * SiLU(gate))``
    over every channel (one group)."""

    def __init__(self, size: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.eps = eps

    def forward(self, x, gate=None):
        dtype = x.dtype
        x = x.float()
        if gate is not None:
            x = x * F.silu(gate.float())
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x.to(dtype)


class MambaMixer(nn.Module):
    """Mamba-2: ``[z | xBC | dt] = in_proj(u)``, the sequence part
    (``ssd_chunk``: ``xBC = SiLU(conv(xBC) + bias)``, ``Δ = softplus(dt +
    dt_bias)``, ``A = -exp(A_log)``, ``S_t = exp(Δ_t A) S_{t-1} + Δ_t x_t
    B_tᵀ``, ``y_t = S_t C_t + D x_t``), ``y = RMSNorm(y * SiLU(z))``,
    ``out_proj(y)``."""

    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        self.cfg = cfg
        inner, heads = cfg.mamba_inner, cfg.mamba_n_heads
        self.in_proj = nn.Linear(cfg.hidden_size,
                                 inner + cfg.conv_dim + heads,
                                 bias=cfg.mamba_proj_bias)
        self.conv1d = nn.Conv1d(cfg.conv_dim, cfg.conv_dim, cfg.mamba_d_conv,
                                groups=cfg.conv_dim, bias=cfg.mamba_conv_bias,
                                padding=cfg.mamba_d_conv - 1)
        self.dt_bias = nn.Parameter(torch.ones(heads))
        self.A_log = nn.Parameter(torch.zeros(heads))
        self.D = nn.Parameter(torch.ones(heads))
        self.norm = RMSNorm(inner, cfg.rms_norm_eps)
        self.out_proj = nn.Linear(inner, cfg.hidden_size,
                                  bias=cfg.mamba_proj_bias)

    def forward(self, u):
        cfg = self.cfg
        proj = self.in_proj(u)
        y = ssd_chunk(proj, self.conv1d.weight.view(cfg.conv_dim, -1),
                      self.conv1d.bias, self.dt_bias, self.A_log, self.D,
                      cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state,
                      cfg.mamba_chunk_size)
        return self.out_proj(self.norm(y, proj[..., :cfg.mamba_inner]))


class NoPEAttention(nn.Module):
    """Causal GQA with no positional encoding and Granite's softmax scale
    (``attention_multiplier``)."""

    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        self.cfg = cfg
        hd, bias = cfg.head_dim, cfg.attention_bias
        self.q_proj = nn.Linear(cfg.hidden_size,
                                cfg.num_attention_heads * hd, bias=bias)
        self.k_proj = nn.Linear(cfg.hidden_size,
                                cfg.num_key_value_heads * hd, bias=bias)
        self.v_proj = nn.Linear(cfg.hidden_size,
                                cfg.num_key_value_heads * hd, bias=bias)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd,
                                cfg.hidden_size, bias=bias)

    def forward(self, x):
        cfg = self.cfg
        b, length, _ = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x).view(b, length, -1, hd).transpose(1, 2)
        k = self.k_proj(x).view(b, length, -1, hd).transpose(1, 2)
        v = self.v_proj(x).view(b, length, -1, hd).transpose(1, 2)
        rep = cfg.num_attention_heads // cfg.num_key_value_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        ctx = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=cfg.attention_multiplier)
        return self.o_proj(ctx.transpose(1, 2).reshape(b, length, -1))


class SwiGLU(nn.Module):
    """Granite's shared MLP: ``input_linear`` to gate and up halves,
    ``SiLU(gate) * up``, ``output_linear``."""

    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        self.input_linear = nn.Linear(cfg.hidden_size,
                                      2 * cfg.shared_intermediate_size,
                                      bias=False)
        self.output_linear = nn.Linear(cfg.shared_intermediate_size,
                                       cfg.hidden_size, bias=False)

    def forward(self, x):
        gate, up = self.input_linear(x).chunk(2, dim=-1)
        return self.output_linear(F.silu(gate) * up)


class GraniteHybridLayer(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, kind: str):
        super().__init__()
        self.kind = kind
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if kind == "mamba":
            self.mamba = MambaMixer(cfg)
        else:
            self.self_attn = NoPEAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.shared_mlp = SwiGLU(cfg)
        self.r = cfg.residual_multiplier

    def forward(self, h):
        mixer = self.mamba if self.kind == "mamba" else self.self_attn
        h = h + mixer(self.input_layernorm(h)) * self.r
        return h + self.shared_mlp(self.post_attention_layernorm(h)) * self.r


class GraniteHybridModel(nn.Module):
    """token ids [B, L] -> last hidden states [B, L, H] (after the final
    RMSNorm); token types and the mask are ignored (the trunk is causal,
    padding on the right). As a VDR trunk (``models.vdr.TRUNKS``) the head
    projects onto ``embed_tokens`` and divides its logits by
    ``logits_scaling``, as Granite's LM head does."""

    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        self.cfg = cfg
        self.head_scale = cfg.logits_scaling
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(GraniteHybridLayer(cfg, kind)
                                    for kind in cfg.layer_types)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    @property
    def tied_embedding(self) -> torch.Tensor:
        return self.embed_tokens.weight

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = self.embed_tokens(input_ids) * self.cfg.embedding_multiplier
        for layer in self.layers:
            h = layer(h)
        return self.norm(h)


def mamba2_init_(mixer: MambaMixer, gen: torch.Generator) -> None:
    """Mamba-2's published initial ranges (``mamba_ssm``'s ``Mamba2``):
    ``A`` uniform in [1, 16] (``A_log = log A``), ``Δ`` log-uniform in
    [0.001, 0.1] (floored at 1e-4) through ``dt_bias`` (softplus's
    inverse), ``D = 1``, and the conv's PyTorch default (uniform within
    1/sqrt(fan_in), weight and bias)."""
    with torch.no_grad():
        heads = mixer.A_log.shape[0]
        dev = mixer.A_log.device
        a = torch.empty(heads, device=dev).uniform_(1.0, 16.0, generator=gen)
        mixer.A_log.copy_(torch.log(a))
        u = torch.rand(heads, device=dev, generator=gen)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001)).clamp_min(1e-4)
        mixer.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        mixer.D.fill_(1.0)
        bound = 1.0 / math.sqrt(mixer.conv1d.weight[0].numel())
        mixer.conv1d.weight.uniform_(-bound, bound, generator=gen)
        if mixer.conv1d.bias is not None:
            mixer.conv1d.bias.uniform_(-bound, bound, generator=gen)


def init_granite_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Granite's initialization from ``gen``: N(0, initializer_range) for
    linear and embedding weights, zero biases, unit norms (and VDR's
    ``ln``: unit scale, zero shift), Mamba-2's ranges in each mixer."""
    std = None
    for m in module.modules():
        if isinstance(m, GraniteHybridModel):
            std = m.cfg.initializer_range
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MambaMixer):
                mamba2_init_(m, gen)
