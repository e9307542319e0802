"""Where the VDR encoder's time goes, and a fused-QKV variant
(counterpart of ``scripts/probe_embed_mfu.py``).

    python -m vsearch_tpu_torch.scripts.probe_embed_mfu [--device cpu]
        [--b 256] [--l 128]

At BERT-base (12 layers, hidden 768, 12 heads, FFN 3,072, 30,522 ids) in
bf16 with random weights from ``--seed``, B = 256 passages of L = 128
tokens: device ms and TFLOP/s (the JAX probe's matmul count) of the full
VDR forward (``models.vdr.VDRModule``), the BERT body alone, and the
vocabulary head alone, both as one [B * L, H] x [H, V'] product then a
max over L (``head_naive``) and as the port's chunked masked max-pool
(``head_chunked``). Then the 12-layer stack as the port runs it (separate
q, k, v projections) against the JAX probe's fused-QKV variant, one
``nn.Linear`` of 3 x hidden holding the same weights: both times, and
the fused stack's largest difference from the split one, held within
``FUSED_ATOL`` (bf16 products of another shape may round otherwise; the
outputs are LayerNorm'd, of order 1). This is ROADMAP R1's and T1's first
profile of the encoder.
"""
from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..models.bert import BertConfig, init_bert_weights
from ..models.encoder_base import build_module
from ..models.vdr import VDREncoderConfig, VDRModule, _masked_max_project
from ..ops.activations import elu1p
from . import common

B, L = 256, 128
SHIFT = 999
FUSED_ATOL = 5e-2  # fused against split QKV, outputs of order 1 in bf16


class FusedQKV(nn.Module):
    """A ``BertSelfAttention`` with its q, k and v projections as one
    ``nn.Linear`` of 3 x hidden (the same weights), the rest unchanged."""

    def __init__(self, attn):
        super().__init__()
        self.num_heads = attn.num_heads
        h = attn.query.in_features
        self.qkv = nn.Linear(h, 3 * h).to(attn.query.weight)
        with torch.no_grad():
            self.qkv.weight.copy_(torch.cat([attn.query.weight,
                                             attn.key.weight,
                                             attn.value.weight]))
            self.qkv.bias.copy_(torch.cat([attn.query.bias, attn.key.bias,
                                           attn.value.bias]))

    def forward(self, hidden, attention_mask):
        b, l, h = hidden.shape
        hd = h // self.num_heads
        q, k, v = self.qkv(hidden).view(b, l, 3, self.num_heads, hd) \
            .permute(2, 0, 3, 1, 4)
        scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(hd)
        mask = attention_mask[:, None, None, :].bool()
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        ctx = torch.softmax(scores, dim=-1).to(v.dtype) @ v
        return ctx.transpose(1, 2).reshape(b, l, h)


def flops_bert(cfg: BertConfig, b: int, l: int) -> float:
    h, i = cfg.hidden_size, cfg.intermediate_size
    per_layer = 2 * b * l * (4 * h * h + 2 * h * i) + 2 * 2 * b * l * l * h
    return cfg.num_hidden_layers * per_layer


def flops_head(cfg: BertConfig, b: int, l: int) -> float:
    return 2 * b * l * cfg.hidden_size * (cfg.vocab_size - SHIFT)


def main(argv=None) -> dict:
    def add(ap):
        ap.add_argument("--b", type=int, default=B)
        ap.add_argument("--l", type=int, default=L)
        ap.add_argument("--layers", type=int, default=12)
        ap.add_argument("--hidden", type=int, default=768)
        ap.add_argument("--heads", type=int, default=12)
        ap.add_argument("--intermediate", type=int, default=3072)
        ap.add_argument("--vocab", type=int, default=common.V_BERT)
        ap.add_argument("--dtype", default="bfloat16")

    args, dev, out = common.start(__doc__, argv, add)
    b, l = args.b, args.l
    bert = BertConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                      num_hidden_layers=args.layers,
                      num_attention_heads=args.heads,
                      intermediate_size=args.intermediate,
                      dtype=args.dtype)
    cfg = VDREncoderConfig(bert=bert, max_len=l, shift_vocab_num=SHIFT)
    module = build_module(VDRModule, cfg, init_bert_weights, args.seed, dev,
                          bert.dtype)
    gen = common.generator(dev, args.seed + 1)
    ids = torch.randint(SHIFT, args.vocab, (b, l), generator=gen, device=dev)
    ttype = torch.zeros_like(ids)
    mask = torch.ones_like(ids)
    fb, fh = flops_bert(bert, b, l), flops_head(bert, b, l)

    def t(fn):
        return common.time_ms(fn, dev, args.iters)

    def tf(flops, ms):
        return None if ms is None else flops / (ms * 1e-3) / 1e12

    out.update({"b": b, "l": l, "layers": args.layers,
                "hidden": args.hidden, "dtype": args.dtype,
                "flops_bert": fb, "flops_head": fh})
    with torch.no_grad():
        ms = t(lambda: module(ids, ttype, mask))
        out["full_ms"], out["full_tfs"] = ms, tf(fb + fh, ms)
        out["passages_per_s"] = None if ms is None else b / (ms * 1e-3)
        body = module.bert_model
        ms = t(lambda: body(ids, ttype, mask))
        out["bert_ms"], out["bert_tfs"] = ms, tf(fb, ms)
        h = torch.randn((b, l, args.hidden), generator=gen, device=dev
                        ).to(bert.dtype)
        w = module.bert_model.embeddings.word_embeddings.weight[SHIFT:]
        valid = mask.bool()
        ms = t(lambda: elu1p((h @ w.T).float().amax(dim=1)))
        out["head_naive_ms"], out["head_naive_tfs"] = ms, tf(fh, ms)
        ms = t(lambda: elu1p(_masked_max_project(h, w, valid)))
        out["head_chunked_ms"], out["head_chunked_tfs"] = ms, tf(fh, ms)
        # the 12-layer stack, split (the port's) against fused QKV
        split = module.bert_model.encoder
        fused = copy.deepcopy(split)
        for layer in fused.layer:
            layer.attention.self = FusedQKV(layer.attention.self)
        ms = t(lambda: split(h, mask))
        out["stack_split_ms"], out["stack_split_tfs"] = ms, tf(fb, ms)
        ms = t(lambda: fused(h, mask))
        out["stack_fused_ms"], out["stack_fused_tfs"] = ms, tf(fb, ms)
        gap = float((fused(h, mask).float() - split(h, mask).float())
                    .abs().max())
    out["fused_max_abs_diff"] = gap
    out["fused_within_atol"] = gap <= FUSED_ATOL
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
