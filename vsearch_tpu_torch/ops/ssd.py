"""The Mamba-2 chunk scan of one sequence chunk (``ssd_chunk``): the
sequence part of a granite-4.0-h Mamba-2 mixer, from the in-projection's
output to the D skip, as one CUDA kernel (``csrc/ssd_chunk.cu``) and its
plain PyTorch twin.

From ``proj = [z | xBC | dt]`` ([B, L, inner + conv_dim + heads]):

- ``xBC = SiLU(causal depthwise conv(xBC) + bias)``, split into x
  [heads x d_head], B [d_state] and C [d_state] (one group);
- ``Δ = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
- per head, from a zero state, ``S_t = exp(Δ_t A) S_{t-1} + Δ_t x_t B_tᵀ``
  and ``y_t = S_t C_t + D x_t``, which within one chunk is the quadratic
  form ``y_t = Σ_{s≤t} (C_t·B_s) exp(cs_t - cs_s) Δ_s x_s + D x_t`` with
  ``cs`` the running sum of ``Δ A``.

A sequence is one chunk: ``L`` at most ``chunk`` (granite's
``mamba_chunk_size``, 256); longer ones raise. The result is [B, L, inner]
in ``proj``'s dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_build import launch

# the widths the kernel is written for (granite-4.0-h's); heads come in
# groups of HEADS_PER_CTA
KERNEL_D_HEAD = 64
KERNEL_D_STATE = 128
KERNEL_D_CONV = 4
KERNEL_MAX_LEN = 256
HEADS_PER_CTA = 16


def ssd_chunk_plain(proj: torch.Tensor, conv_w: torch.Tensor,
                    conv_b: torch.Tensor, dt_bias: torch.Tensor,
                    a_log: torch.Tensor, d: torch.Tensor, heads: int,
                    d_head: int, d_state: int) -> torch.Tensor:
    """The function in plain PyTorch, in f32 (it builds the [B, L, L,
    heads] decay tensor: for CPU tensors and as the kernel's yardstick)."""
    b, length, _ = proj.shape
    inner = heads * d_head
    conv_dim = inner + 2 * d_state
    k = conv_w.shape[1]
    xbc = proj[..., inner:inner + conv_dim].float().transpose(1, 2)
    xbc = F.conv1d(F.pad(xbc, (k - 1, 0)), conv_w.float()[:, None, :],
                   None if conv_b is None else conv_b.float(),
                   groups=conv_dim)
    xbc = F.silu(xbc).transpose(1, 2)
    x, bm, cm = xbc.split([inner, d_state, d_state], dim=-1)
    dt = proj[..., inner + conv_dim:inner + conv_dim + heads].float()
    delta = F.softplus(dt + dt_bias.float())  # [B, L, H]
    cs = torch.cumsum(delta * -torch.exp(a_log.float()), dim=1)
    seg = cs[:, :, None, :] - cs[:, None, :, :]  # [B, t, s, H]
    causal = torch.ones(length, length, dtype=torch.bool,
                        device=proj.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                      float("-inf")))
    g = cm @ bm.transpose(1, 2)  # [B, t, s]
    m = g[..., None] * decay * delta[:, None, :, :]
    xh = x.reshape(b, length, heads, d_head)
    y = torch.einsum("btsh,bshp->bthp", m, xh) + d.float()[:, None] * xh
    return y.reshape(b, length, inner).to(proj.dtype)


def _check(proj, params, heads, d_head, d_state, k) -> None:
    """Raise for what the kernel does not take."""
    if (d_head, d_state, k) != (KERNEL_D_HEAD, KERNEL_D_STATE, KERNEL_D_CONV) \
            or heads % HEADS_PER_CTA:
        raise ValueError(
            f"ssd_chunk: the kernel takes d_head {KERNEL_D_HEAD}, d_state "
            f"{KERNEL_D_STATE}, a {KERNEL_D_CONV}-wide conv and heads in "
            f"groups of {HEADS_PER_CTA}; got {d_head}, {d_state}, {k}, "
            f"{heads}")
    dev = proj.get_device()
    for name, t in (("proj", proj),) + tuple(params.items()):
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"ssd_chunk: {name} on {t.device}, proj on "
                             f"{proj.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ssd_chunk: {name} must be bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} must be contiguous")


def ssd_chunk(proj: torch.Tensor, conv_w: torch.Tensor,
              conv_b: torch.Tensor, dt_bias: torch.Tensor,
              a_log: torch.Tensor, d: torch.Tensor, heads: int, d_head: int,
              d_state: int, chunk: int = KERNEL_MAX_LEN) -> torch.Tensor:
    """``y`` [B, L, heads * d_head] of ``proj`` [B, L, inner + conv_dim +
    heads] under the mixer's conv weight [conv_dim, k] and bias, ``dt_bias``,
    ``A_log`` and ``D`` [heads]: the plain version for CPU tensors, the
    kernel for CUDA tensors (bf16, contiguous, granite's widths) or an
    error."""
    length = proj.shape[1]
    if length > chunk:
        raise ValueError(f"ssd_chunk: {length} positions exceed one chunk "
                         f"({chunk})")
    if proj.device.type == "cpu":
        return ssd_chunk_plain(proj, conv_w, conv_b, dt_bias, a_log, d,
                               heads, d_head, d_state)
    if length > KERNEL_MAX_LEN:
        raise ValueError(f"ssd_chunk: the kernel takes at most "
                         f"{KERNEL_MAX_LEN} positions, got {length}")
    params = {"conv_w": conv_w, "conv_b": conv_b, "dt_bias": dt_bias,
              "A_log": a_log, "D": d}
    _check(proj, params, heads, d_head, d_state, conv_w.shape[1])
    b = proj.shape[0]
    inner = heads * d_head
    out = torch.empty((b, length, inner), dtype=proj.dtype,
                      device=proj.device)
    return launch("ssd_chunk", out, proj.data_ptr(), proj.shape[2], inner,
                   inner + inner + 2 * d_state, conv_w.data_ptr(),
                   conv_b.data_ptr(), dt_bias.data_ptr(), a_log.data_ptr(),
                   d.data_ptr(), out.data_ptr(), b, length, heads)
