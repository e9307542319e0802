"""BERT encoder as ``torch.nn.Module``s (counterpart of
``vsearch_tpu/models/bert.py``).

Submodule names follow HF's ``BertModel`` (``embeddings.LayerNorm``,
``encoder.layer.{i}.attention.self.query`` ...), so an HF-layout state
dict loads as it is. Attention is plain PyTorch: matmul, masked softmax
in f32, matmul.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    dtype: torch.dtype = torch.float32  # compute (and storage) dtype
    # GELU flavor: None resolves by dtype, exact erf in f32 (checkpoint
    # parity) and the tanh approximation in bf16, as the JAX package does
    approx_gelu: Optional[bool] = None

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])

    @property
    def gelu_approximate(self) -> bool:
        if self.approx_gelu is not None:
            return self.approx_gelu
        return self.dtype == torch.bfloat16

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "BertConfig":
        """Small config for tests."""
        return cls(vocab_size=vocab_size, hidden_size=64,
                   num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, max_position_embeddings=64)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                      eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)[None]
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.LayerNorm(x))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.dropout = nn.Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, hidden, attention_mask):
        b, l, h = hidden.shape
        hd = h // self.num_heads

        def heads(t):  # [B, L, H] -> [B, heads, L, hd]
            return t.view(b, l, self.num_heads, hd).transpose(1, 2)

        q, k, v = (heads(f(hidden))
                   for f in (self.query, self.key, self.value))
        scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
        mask = attention_mask[:, None, None, :].bool()
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = self.dropout(torch.softmax(scores, dim=-1))
        ctx = probs.to(v.dtype) @ v  # [B, heads, L, hd]
        return ctx.transpose(1, 2).reshape(b, l, h)


class BertDenseLayerNorm(nn.Module):
    """dense -> dropout -> LayerNorm(residual + .): HF's BertSelfOutput /
    BertOutput."""

    def __init__(self, cfg: BertConfig, d_in: int):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                      eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertDenseLayerNorm(cfg, cfg.hidden_size)

    def forward(self, hidden, attention_mask):
        return self.output(self.self(hidden, attention_mask), hidden)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.approximate = "tanh" if cfg.gelu_approximate else "none"

    def forward(self, x):
        return F.gelu(self.dense(x), approximate=self.approximate)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertDenseLayerNorm(cfg, cfg.intermediate_size)

    def forward(self, hidden, attention_mask):
        attn = self.attention(hidden, attention_mask)
        return self.output(self.intermediate(attn), attn)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))
        # checkpoint each layer under autograd (training's remat)
        self.remat = False

    def forward(self, hidden, attention_mask):
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layer:
            if remat:
                hidden = checkpoint(layer, hidden, attention_mask,
                                    use_reentrant=False)
            else:
                hidden = layer(hidden, attention_mask)
        return hidden


class BertModel(nn.Module):
    """Returns the last hidden state [B, L, H] (no pooler). As a VDR trunk
    (``models.vdr.TRUNKS``) its head's logits are unscaled."""

    head_scale = 1.0

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    @property
    def tied_embedding(self) -> torch.Tensor:
        return self.embeddings.word_embeddings.weight

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        return self.encoder(x, attention_mask)


def init_bert_weights(module: nn.Module, generator: torch.Generator,
                      std: float = 0.02) -> None:
    """BERT's initialization from an explicit generator: N(0, std) for
    matrices and embeddings, zero biases, unit LayerNorm scales."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "LayerNorm" in name or name.startswith("ln."):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)


def init_jax_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialization (flax's defaults) from an explicit
    generator: ``nn.Dense`` kernels LeCun-normal (a normal truncated at 2
    standard deviations, scaled to variance 1/fan_in), ``nn.Embed`` tables
    normal with variance 1/features, zero biases, unit LayerNorm scales.

    The port's models start from BERT's N(0, 0.02) (``init_bert_weights``,
    the reference's HF initialization), a difference from the JAX package
    kept on purpose (ROADMAP, queue 3). Under it a random VDR already
    matches query and passage tokens, where from flax's defaults it does
    not; a run that starts from random weights to show learning, as the
    convergence demo does, starts from these."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.embedding_dim),
                                 generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
