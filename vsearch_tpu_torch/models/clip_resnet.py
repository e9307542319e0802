"""CLIP ResNet building blocks: the anti-aliased ``Bottleneck`` and the
attention pool (counterpart of ``vsearch_tpu/models/clip_resnet.py``).

No encoder of either package uses them; they are here so that a CLIP-RN
checkpoint can be carried over. Feature maps are NHWC in and out, as in
the JAX package. BatchNorm runs in inference mode only, so
``convert_bottleneck_params`` folds each one's weight, bias and running
statistics into one scale and shift a channel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(stride) on NCHW: window == stride, no padding."""
    return x if stride <= 1 else F.avg_pool2d(x, stride)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm folded to ``x * scale + shift`` a channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("shift", torch.zeros(channels))

    def forward(self, x):  # NCHW
        return x * self.scale[:, None, None] + self.shift[:, None, None]


class Bottleneck(nn.Module):
    """CLIP-RN bottleneck: 1x1 -> 3x3 -> avgpool(stride) -> 1x1, expansion
    4; every conv has stride 1 (downsampling is the explicit avgpool). The
    shortcut avgpools and projects when the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 expansion: int = 4):
        super().__init__()
        out = planes * expansion
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample_conv = self.downsample_bn = None
        if stride > 1 or inplanes != out:
            self.downsample_conv = nn.Conv2d(inplanes, out, 1, bias=False)
            self.downsample_bn = FrozenBatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(_avg_pool(y, self.stride)))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(
                _avg_pool(x, self.stride)))
        return F.relu(y + x).permute(0, 2, 3, 1)


class AttentionPool2d(nn.Module):
    """Attention pooling over a feature map: the spatial mean is
    prepended as the query token, a learned positional embedding added,
    one multi-head attention layer with separate q/k/v projections, and
    the attended mean token projected by ``c_proj``. NHWC in, [B, D_out]
    out."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) \
            + self.positional_embedding
        hd = c // self.num_heads

        def split(t):  # [B, L, C] -> [B, heads, L, hd]
            return t.view(b, t.shape[1], self.num_heads, hd).transpose(1, 2)

        q, k, v = (split(self.q_proj(x[:, :1])), split(self.k_proj(x)),
                   split(self.v_proj(x)))
        att = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        out = (att @ v).transpose(1, 2).reshape(b, 1, c)
        return self.c_proj(out)[:, 0]


# ---- torch state dict (the reference's names) -> these modules ---------

def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def _bn(sd: Dict[str, Any], pfx: str, out: str) -> Dict[str, torch.Tensor]:
    """A BatchNorm's weight, bias and running stats folded to
    ``{out}.scale`` and ``{out}.shift``."""
    scale = _f32(sd[f"{pfx}.weight"]) / torch.sqrt(
        _f32(sd[f"{pfx}.running_var"]) + _BN_EPS)
    shift = _f32(sd[f"{pfx}.bias"]) - _f32(sd[f"{pfx}.running_mean"]) * scale
    return {f"{out}.scale": scale, f"{out}.shift": shift}


def convert_bottleneck_params(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ``Bottleneck`` state dict (torch or numpy values) ->
    ``Bottleneck``'s state dict."""
    out: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        out[f"conv{i}.weight"] = _f32(sd[f"conv{i}.weight"])
        out.update(_bn(sd, f"bn{i}", f"bn{i}"))
    if "downsample.0.weight" in sd:
        out["downsample_conv.weight"] = _f32(sd["downsample.0.weight"])
        out.update(_bn(sd, "downsample.1", "downsample_bn"))
    return out


def convert_attnpool_params(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ``AttentionPool2d`` state dict -> this module's."""
    out = {"positional_embedding": _f32(sd["positional_embedding"])}
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        for p in ("weight", "bias"):
            out[f"{name}.{p}"] = _f32(sd[f"{name}.{p}"])
    return out
