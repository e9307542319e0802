"""Cross-modal VDR image encoder: image -> valid-vocab-subspace vector
(counterpart of ``vsearch_tpu/models/crossmodal_image.py``).

A CLIP-style ViT: patchify conv -> positional embedding -> ``ln_pre`` ->
pre-LN residual attention blocks with QuickGELU -> ``ln_post`` -> learned
projection onto the valid vocabulary -> max over patches -> elu1p -> L2
norm -> top-k. Pixels come in NHWC, as in the JAX package (NCHW arrays
are transposed). The encoder computes in f32 on every device, as the JAX
package's, which has no dtype switch. Parameter names are the reference
torch encoder's (``conv1``, ``transformer.resblocks.{i}.attn.in_proj_weight``
...), so its state dicts load as they are. Preprocessing is PIL + numpy
(bicubic resize, centre crop, CLIP mean and std).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.activations import elu1p
from ..ops.sparse import build_topk_mask
from .encoder_base import build_module
from .valid_vocab import VALID_TOKEN_IDS

_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class VDRImageEncoderConfig:
    resolution: int = 224
    tokenizer_id: str = "bert-base-uncased"
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    topk: int = 768
    num_valid_tokens: int = len(VALID_TOKEN_IDS)
    type: str = "vdr_crossmodal_image"

    @property
    def grid(self) -> int:
        return self.resolution // self.patch_size

    @property
    def out_dim(self) -> int:
        return self.num_valid_tokens

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VDRImageEncoderConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items()
                      if k in known and v is not None})


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class _Attention(nn.Module):
    """Multi-head self-attention with packed q/k/v projections, named as
    ``torch.nn.MultiheadAttention`` names them."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, w = x.shape
        hd = w // self.heads
        q, k, v = (t.view(b, l, self.heads, hd).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight,
                                     self.in_proj_bias).split(w, dim=-1))
        probs = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd),
                              dim=-1)
        return self.out_proj((probs @ v).transpose(1, 2).reshape(b, l, w))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads)
                                       for _ in range(layers))

    def forward(self, x):
        for block in self.resblocks:
            x = block(x)
        return x


class VDRImageModule(nn.Module):
    """pixels [B, H, W, 3] -> [B, V_valid] f32 L2-normalised embedding."""

    def __init__(self, config: VDRImageEncoderConfig):
        super().__init__()
        cfg = self.config = config
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size,
                               stride=cfg.patch_size, bias=False)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.grid ** 2, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width, eps=1e-5)
        self.transformer = _Transformer(cfg.width, cfg.layers, cfg.heads)
        self.ln_post = nn.LayerNorm(cfg.width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(cfg.num_valid_tokens,
                                             cfg.width))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.conv1(pixels.permute(0, 3, 1, 2))  # [B, width, g, g]
        x = x.flatten(2).transpose(1, 2)  # [B, g*g, width], row-major
        x = self.ln_pre(x + self.positional_embedding)
        x = self.ln_post(self.transformer(x))
        emb = elu1p((x @ self.proj.T).amax(dim=1))
        return emb / torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True).clamp_min(1e-12)


def init_vit_weights(module: nn.Module, generator: torch.Generator,
                     std: float = 0.02) -> None:
    """Random weights from an explicit generator: N(0, std) for matrices
    and embeddings, zero biases, unit LayerNorm scales."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.startswith("ln_") or ".ln_" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)


def preprocess_image(img, resolution: int = 224) -> np.ndarray:
    """PIL image or path -> [H, W, 3] float32: bicubic resize of the short
    side to ``resolution``, centre crop, CLIP normalisation."""
    from PIL import Image

    if isinstance(img, str):
        img = Image.open(img).convert("RGB")
    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize((max(resolution, round(w * scale)),
                      max(resolution, round(h * scale))),
                     Image.BICUBIC)
    w, h = img.size
    left, top = (w - resolution) // 2, (h - resolution) // 2
    img = img.crop((left, top, left + resolution, top + resolution))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - _CLIP_MEAN) / _CLIP_STD


class VDRImageEncoder:
    """Host-facing image encoder. Weights come from ``seed`` unless
    ``state_dict`` (the port's layout, which is the reference's) is
    given; the tokenizer names the vocabulary dims in ``disentangle``."""

    config_class = VDRImageEncoderConfig

    def __init__(self, config: VDRImageEncoderConfig, state_dict=None,
                 tokenizer=None, seed: int = 0, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        if tokenizer is None:
            from ..tokenization import get_tokenizer
            tokenizer = get_tokenizer(config.tokenizer_id)
        self.tokenizer = tokenizer
        self.module = build_module(VDRImageModule, config, init_vit_weights,
                                   seed, self.device, torch.float32,
                                   state_dict)

    def _batches(self, images, batch_size: int):
        """[b, H, W, 3] f32 tensors on the device, one batch at a time.
        ``images``: a path, PIL image or list of them (preprocessed a
        batch at a time), or an [N, H, W, 3] / [N, 3, H, W] array or
        tensor, or any sequence whose slices are such arrays."""
        if isinstance(images, (str, bytes)) or hasattr(images, "crop"):
            images = [images]
        for s in range(0, len(images), batch_size):
            part = images[s: s + batch_size]
            if isinstance(part, list):
                part = np.stack([preprocess_image(im, self.config.resolution)
                                 for im in part])
            t = (part if torch.is_tensor(part)
                 else torch.from_numpy(np.asarray(part, dtype=np.float32)))
            t = t.to(self.device, torch.float32)
            if t.ndim == 4 and t.shape[1] == 3:  # NCHW -> NHWC
                t = t.permute(0, 2, 3, 1)
            yield t

    @torch.no_grad()
    def embed(self, images, topk: Optional[int] = None,
              batch_size: int = 32, **_ignored) -> np.ndarray:
        """[N, V_valid] embeddings, each with its top-k dims kept."""
        topk = min(topk or self.config.topk, self.config.num_valid_tokens)
        outs = []
        for pixels in self._batches(images, batch_size):
            emb = self.module(pixels)
            outs.append(emb * build_topk_mask(emb, k=topk))
        return torch.cat(outs).cpu().numpy()

    def disentangle(self, image, topk: Optional[int] = None,
                    visual: bool = False, save_file: Optional[str] = None
                    ) -> Dict[str, float]:
        """Top-k (token -> weight) interpretation of an embedding;
        ``visual`` draws it as a word cloud (``utils.vis``)."""
        topk = topk or self.config.topk
        emb = self.embed(image)[0]
        k = min(topk, emb.shape[-1])
        idx = [int(i) for i in np.argsort(-emb)[:k] if emb[i] != 0]
        token_ids = [int(VALID_TOKEN_IDS[i]) if
                     self.config.num_valid_tokens == len(VALID_TOKEN_IDS)
                     else i for i in idx]
        tokens = self.tokenizer.convert_ids_to_tokens(token_ids)
        results = dict(zip(tokens, [float(emb[i]) for i in idx]))
        if visual:
            from ..utils.vis import wordcloud_from_dict
            wordcloud_from_dict(results, max_words=topk,
                                save_file=save_file)
        return results

    dst = disentangle

    def encode(self, *a, **k):
        raise NotImplementedError("image encoder has no text encode()")
