"""Plain reference of SVDR over a granite-4.0-h trunk: the trunk (IBM's
``granitemoehybrid``, https://huggingface.co/ibm-granite/
granite-4.0-h-micro; HF ``GraniteMoeHybridModel`` layout under ``model.``)
with VDR's head, in plain PyTorch.

It computes in float32 with TF32 off, from the benchmark's own weights and
token ids, with no kernel, cache or batching of the port: the Mamba-2
mixer's SSD is the sequential recurrence ``S_t = exp(Δ_t A) S_{t-1} +
Δ_t x_t B_tᵀ``, ``y_t = S_t C_t + D x_t`` from a zero state, after the
causal depthwise conv and SiLU of ``xBC``; attention is causal GQA with no
positional encoding under ``attention_multiplier``; every layer adds
``residual_multiplier`` times its mixer and its SwiGLU MLP, each after an
RMSNorm, to the embedding scaled by ``embedding_multiplier``; a final
RMSNorm ends the trunk.

The head (a choice of this benchmark: the model has no VDR head) is VDR's
own: LayerNorm (eps 1e-5, ``ln``), the projection onto the tied word
embeddings past the shift, divided by ``logits_scaling`` as Granite's LM
head divides its logits, the max over real positions, elu + 1, then the
top-``topk`` dims together with the text's own (lexical) dims.
``precision="fp8"`` rounds every matrix product's two inputs to float8
e4m3 (one scale a tensor) for the control. Nothing here imports the port.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from .vdr import _fp8, _mm, full_f32

# vocabulary columns of one block of the head's logits
HEAD_BLOCK = 16384


def _rms(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _linear(x, weight, precision):
    return _mm(x, weight.T, precision)


def ssd_scan(proj, conv_w, conv_b, dt_bias, a_log, d, cfg,
             precision="f32"):
    """The Mamba-2 mixer's sequence part over its in-projection ``proj``
    [B, L, inner + conv_dim + heads] (``[z | xBC | dt]``): ``xBC``'s causal
    depthwise conv (weight [conv_dim, k]) and SiLU, then the SSD step by
    step from a zero state, with the D skip; [B, L, inner]."""
    heads, d_head = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    n = cfg["mamba_d_state"]
    inner = heads * d_head
    conv_dim, k = conv_w.shape
    b, length, _ = proj.shape
    xbc = proj[..., inner:inner + conv_dim]
    dt = proj[..., inner + conv_dim:inner + conv_dim + heads]
    xpad = F.pad(xbc, (0, 0, k - 1, 0))  # k - 1 zero positions before t=0
    conv = conv_b.expand(b, length, conv_dim).clone()
    for j in range(k):  # conv[t] = bias + sum_j w[:, j] * xbc[t - k + 1 + j]
        conv += conv_w[:, j] * xpad[:, j:j + length]
    x, bm, cm = F.silu(conv).split([inner, n, n], dim=-1)
    delta = F.softplus(dt + dt_bias)  # [B, L, heads]
    a = -torch.exp(a_log)
    xh = x.reshape(b, length, heads, d_head)
    state = proj.new_zeros(b * heads, d_head, n)
    ys = []
    for t in range(length):
        decay = torch.exp(delta[:, t] * a).reshape(-1, 1, 1)
        dx = (delta[:, t, :, None] * xh[:, t]).reshape(-1, d_head, 1)
        bt = bm[:, t, None, None, :].expand(b, heads, 1, n).reshape(-1, 1, n)
        state = state * decay + _mm(dx, bt, precision)  # outer product
        ct = cm[:, t, None, :, None].expand(b, heads, n, 1).reshape(-1, n, 1)
        y = _mm(state, ct, precision).reshape(b, heads, d_head)
        ys.append(y + d[:, None] * xh[:, t])
    return torch.stack(ys, dim=1).reshape(b, length, inner)


def _mamba(u, sd, p, cfg, precision):
    """One Mamba-2 mixer over ``u`` [B, L, H]."""
    inner = cfg["mamba_n_heads"] * cfg["mamba_d_head"]
    proj = _linear(u, sd[p + "in_proj.weight"], precision)
    w = sd[p + "conv1d.weight"]
    y = ssd_scan(proj, w.reshape(w.shape[0], -1), sd[p + "conv1d.bias"],
                 sd[p + "dt_bias"], sd[p + "A_log"], sd[p + "D"], cfg,
                 precision)
    y = _rms(y * F.silu(proj[..., :inner]), sd[p + "norm.weight"],
             cfg["rms_norm_eps"])
    return _linear(y, sd[p + "out_proj.weight"], precision)


def _attention(u, sd, p, cfg, precision):
    """Causal GQA with no positional encoding."""
    b, length, h = u.shape
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = h // hq

    def heads(name, count):
        out = _linear(u, sd[p + name + ".weight"], precision)
        out = out.view(b, length, count, hd).transpose(1, 2)
        return out.repeat_interleave(hq // count, dim=1)

    q, k, v = heads("q_proj", hq), heads("k_proj", hkv), heads("v_proj", hkv)
    att = _mm(q, k.transpose(-1, -2), precision) * cfg["attention_multiplier"]
    future = torch.ones(length, length, dtype=torch.bool,
                        device=u.device).triu(1)
    att = att.masked_fill(future, float("-inf"))
    ctx = _mm(torch.softmax(att, dim=-1), v, precision)
    return _linear(ctx.transpose(1, 2).reshape(b, length, h),
                   sd[p + "o_proj.weight"], precision)


def trunk(sd: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: Dict,
          precision: str = "f32") -> torch.Tensor:
    """[B, L, H] last hidden states of token ids [B, L] (right-padded:
    every layer is causal, so padding reaches no earlier position)."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = sd["model.embed_tokens.weight"][ids] * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"model.layers.{i}."
        u = _rms(x, sd[p + "input_layernorm.weight"], eps)
        if kind == "mamba":
            x = x + r * _mamba(u, sd, p + "mamba.", cfg, precision)
        else:
            x = x + r * _attention(u, sd, p + "self_attn.", cfg, precision)
        u = _rms(x, sd[p + "post_attention_layernorm.weight"], eps)
        gate, up = _linear(u, sd[p + "shared_mlp.input_linear.weight"],
                           precision).chunk(2, dim=-1)
        x = x + r * _linear(F.silu(gate) * up,
                            sd[p + "shared_mlp.output_linear.weight"],
                            precision)
    return _rms(x, sd["model.norm.weight"], eps)


def vdr_embed(sd: Dict[str, torch.Tensor], ids: torch.Tensor,
              mask: torch.Tensor, cfg: Dict, precision: str = "f32"
              ) -> torch.Tensor:
    """[B, V'] VDR embeddings of token ids [B, L] (mask 1 on real tokens,
    all on the left) under f32 weights ``sd``."""
    x = trunk(sd, ids, cfg, precision)
    x = F.layer_norm(x, x.shape[-1:], sd["ln.weight"], sd["ln.bias"], 1e-5)
    shift = cfg["shift_vocab_num"]
    head = sd["model.embed_tokens.weight"][shift:]
    if precision == "fp8":  # one scale for each whole operand
        x, head = _fp8(x), _fp8(head)
    keep = mask.bool()
    v = head.shape[0]
    pooled = torch.empty((ids.shape[0], v), device=x.device)
    for s in range(0, v, HEAD_BLOCK):
        logits = (x @ head[s:s + HEAD_BLOCK].T) / cfg["logits_scaling"]
        pooled[:, s:s + HEAD_BLOCK] = logits.masked_fill(
            ~keep[:, :, None], float("-inf")).amax(1)
    emb = F.elu(pooled) + 1.0
    sel = torch.zeros_like(emb, dtype=torch.bool)
    sel.scatter_(1, torch.topk(emb, cfg["topk"], dim=1).indices, True)
    own = ids - shift
    own = torch.where((own >= 0) & keep, own, v)  # others to a spare column
    lexical = torch.zeros((ids.shape[0], v + 1), dtype=torch.bool,
                          device=emb.device)
    lexical.scatter_(1, own, True)
    return emb * (sel | lexical[:, :v])


def embed_texts(sd: Dict[str, torch.Tensor], token_lists: Sequence,
                cfg: Dict, device, precision: str = "f32",
                batch: int = 64) -> torch.Tensor:
    """[N, V'] embeddings of token id lists (each ``[CLS] ... [SEP]``), in
    batches of similar lengths, each padded on the right to its longest."""
    order = sorted(range(len(token_lists)), key=lambda i: len(token_lists[i]))
    v = cfg["vocab_size"] - cfg["shift_vocab_num"]
    out = torch.empty((len(token_lists), v), device=device)
    with full_f32(), torch.no_grad():
        sd32 = {k: t.float() for k, t in sd.items()}
        for s in range(0, len(order), batch):
            part = order[s:s + batch]
            length = max(len(token_lists[i]) for i in part)
            ids = torch.zeros((len(part), length), dtype=torch.long)
            mask = torch.zeros_like(ids)
            for j, i in enumerate(part):
                t = torch.as_tensor(token_lists[i], dtype=torch.long)
                ids[j, :len(t)] = t
                mask[j, :len(t)] = 1
            out[part] = vdr_embed(sd32, ids.to(device), mask.to(device), cfg,
                                  precision)
        del sd32
    return out
