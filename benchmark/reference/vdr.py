"""Plain reference of the served SVDR path: the BERT-VDR encoder
(Zhou et al., "Retrieval-based Disentangled Representation Learning with
Natural Language Supervision", ICLR 2024; HF ``bert-base-uncased`` layers)
and exact bag-of-token scoring, in plain PyTorch.

It computes in float32 with TF32 off, from the benchmark's own weights and
token ids; ``precision="fp8"`` rounds every matrix product's two inputs to
float8 e4m3 (one scale a tensor) for the control. GELU is the published
exact erf form. Nothing here imports the port.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value


@contextlib.contextmanager
def full_f32():
    """float32 products without TF32, restoring the flags after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32, with the inputs rounded to fp8 first for the
    control."""
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _linear(x, sd, name, precision):
    return _mm(x, sd[name + ".weight"].T, precision) + sd[name + ".bias"]


def _ln(x, sd, name, eps):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"],
                        sd[name + ".bias"], eps)


def vdr_embed(sd: Dict[str, torch.Tensor], ids: torch.Tensor,
              mask: torch.Tensor, cfg: Dict, precision: str = "f32"
              ) -> torch.Tensor:
    """[B, V'] VDR embeddings of token ids [B, L] (mask 1 on real tokens):
    BERT, LayerNorm (eps 1e-5), the shifted tied word embeddings as the
    head, max over real positions, elu + 1, then the top-``topk`` dims
    together with the text's own (lexical) dims kept, the rest zero."""
    sd = {k: v.float() for k, v in sd.items()}
    b, length = ids.shape
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = h // heads
    eps = cfg["layer_norm_eps"]
    p = "bert_model."
    x = (sd[p + "embeddings.word_embeddings.weight"][ids]
         + sd[p + "embeddings.position_embeddings.weight"][:length][None]
         + sd[p + "embeddings.token_type_embeddings.weight"][0])
    x = _ln(x, sd, p + "embeddings.LayerNorm", eps)
    keep = mask.bool()
    for i in range(cfg["num_hidden_layers"]):
        q = f"{p}encoder.layer.{i}."

        def split(t):
            return t.view(b, length, heads, hd).transpose(1, 2)

        qh, kh, vh = (split(_linear(x, sd, q + "attention.self." + n,
                                    precision))
                      for n in ("query", "key", "value"))
        att = _mm(qh, kh.transpose(-1, -2), precision) / math.sqrt(hd)
        att = att.masked_fill(~keep[:, None, None, :], float("-inf"))
        ctx = _mm(torch.softmax(att, dim=-1), vh, precision)
        ctx = ctx.transpose(1, 2).reshape(b, length, h)
        x = _ln(_linear(ctx, sd, q + "attention.output.dense", precision) + x,
                sd, q + "attention.output.LayerNorm", eps)
        inter = F.gelu(_linear(x, sd, q + "intermediate.dense", precision))
        x = _ln(_linear(inter, sd, q + "output.dense", precision) + x,
                sd, q + "output.LayerNorm", eps)
    x = _ln(x, sd, "ln", 1e-5)
    shift = cfg["shift_vocab_num"]
    head = sd[p + "embeddings.word_embeddings.weight"][shift:]
    logits = _mm(x, head.T, precision)  # [B, L, V']
    pooled = logits.masked_fill(~keep[:, :, None], float("-inf")).amax(1)
    emb = F.elu(pooled) + 1.0
    sel = torch.zeros_like(emb, dtype=torch.bool)
    sel.scatter_(1, torch.topk(emb, cfg["topk"], dim=1).indices, True)
    v = emb.shape[1]
    own = ids - shift
    own = torch.where((own >= 0) & keep, own, v)  # others to a spare column
    lexical = torch.zeros((b, v + 1), dtype=torch.bool, device=emb.device)
    lexical.scatter_(1, own, True)
    return emb * (sel | lexical[:, :v])


def embed_texts(sd: Dict[str, torch.Tensor], token_lists: Sequence,
                cfg: Dict, device, precision: str = "f32",
                batch: int = 32) -> torch.Tensor:
    """[N, V'] embeddings of token id lists (each ``[CLS] ... [SEP]``), in
    batches of similar lengths, each padded to its longest."""
    order = sorted(range(len(token_lists)), key=lambda i: len(token_lists[i]))
    v = cfg["vocab_size"] - cfg["shift_vocab_num"]
    out = torch.empty((len(token_lists), v), device=device)
    with full_f32(), torch.no_grad():
        for s in range(0, len(order), batch):
            part = order[s:s + batch]
            length = max(len(token_lists[i]) for i in part)
            ids = torch.zeros((len(part), length), dtype=torch.long)
            mask = torch.zeros_like(ids)
            for j, i in enumerate(part):
                t = torch.as_tensor(token_lists[i], dtype=torch.long)
                ids[j, :len(t)] = t
                mask[j, :len(t)] = 1
            out[part] = vdr_embed(sd, ids.to(device), mask.to(device), cfg,
                                  precision)
    return out


def bot_scores(q: torch.Tensor, cols: torch.Tensor,
               chunk_rows: int = 1 << 20) -> torch.Tensor:
    """[N] exact bag-of-token scores of one query ``q`` [V'] over ELL rows
    ``cols`` [N, W] (ids, 16-bit or 32-bit, with the sentinel V' as
    padding): the sum of the query's weights at each row's ids."""
    qpad = torch.cat([q.float(), q.new_zeros(1)])
    out = torch.empty(cols.shape[0], device=q.device)
    with torch.no_grad():
        for r in range(0, cols.shape[0], chunk_rows):
            c = cols[r:r + chunk_rows].long()
            out[r:r + chunk_rows] = qpad[c].sum(dim=1)
    return out


def exact_topk(q: torch.Tensor, cols: torch.Tensor, k: int):
    """(scores [N], top-k ids [k], top-k scores [k]) of one query."""
    s = bot_scores(q, cols)
    top = torch.topk(s, k)
    return s, top.indices, top.values


def sparse_scores(q: torch.Tensor, p_rows: torch.Tensor,
                  index: List[List[int]]) -> torch.Tensor:
    """[B, K] scores of query b against candidate rows ``p_rows[index[b]]``."""
    idx = torch.as_tensor(index, dtype=torch.long, device=p_rows.device)
    with full_f32():
        return (p_rows[idx] * q.float()[:, None, :]).sum(dim=2)

