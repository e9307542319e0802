"""The probe kernels: hand-written CUDA counterparts of the Pallas calls
in the repo's TPU probes (``scripts/probe_*.py``), for the port's probes
(``vsearch_tpu_torch/scripts``). No search, build or training path calls
them.

- P1 ``bitcast_rows`` (``csrc/probe_bitcast.cu``): uint32 words [S, L] as
  bf16 rows [2S, L], the low half of word (s, l) at row 2s and the high
  half at row 2s + 1 (layout A, ``scripts/probe_bitcast_layout.py``).
- P2 ``pack_bits_t`` (``csrc/pack_t.cu``): kernel #1's bits transposed,
  words_T [VP/32, N_pad] (``scripts/probe_pack.py`` ``make_packT``).
- P5 ``bucket_keys_t`` (``csrc/bucketed_t.cu``): kernel #3's keys scored
  from words_T (``scripts/probe_scorer_variants.py`` ``acc_v3``), over
  the ordinary query operand qT [VP, B] bf16: the TPU probe's
  pair-interleaved queries scaled by 1/2 were an artifact of
  ``pltpu.bitcast``.
- the plane form's timing variants ``plane_variant("plane_operand_only"
  | "plane_fragments_only", ...)`` (``csrc/plane_*_only.cu``): kernel
  #3's plane form with the rows' words streamed and one of its two other
  streams of work dropped (``csrc/planes.cuh``). They do NOT compute the
  function; their keys are for timing only and are never compared or
  used.

As in ``ops.bitpack``, each wrapper launches its kernel on CUDA tensors
(counted in ``bitpack.LAUNCHES``) and runs its plain PyTorch twin
(``*_plain``) on CPU tensors; the timing variants' twin is the function
they time, kernel #3's plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import bitpack
from .bitpack import (BUCKET, ROW_BLOCK, TILE_BITS, _check_queries,
                      _pad_queries, _round_up, _uses_plain,
                      bucket_keys_plain, pack_bits_plain)

# rows of one P2 CTA, which its shared memory holds whole
PACK_T_ROWS = 16
PACK_T_SMEM = 227 * 1024  # the most shared memory a CTA can have


# -- P1: the bitcast layout ---------------------------------------------------
def bitcast_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: int32 words [S, L] (uint32 bit patterns) -> bf16
    [2S, L], row 2s the low halves of row s, row 2s + 1 the high halves.
    This expression is also the one-call library counterpart."""
    s, l = x.shape
    return x.view(torch.bfloat16).view(s, l, 2).permute(0, 2, 1) \
        .reshape(2 * s, l)


def bitcast_rows(x: torch.Tensor) -> torch.Tensor:
    """P1 on CUDA tensors, the plain version on CPU tensors."""
    if _uses_plain("bitcast_rows", (x, torch.int32)):
        return bitcast_rows_plain(x)
    s, l = x.shape
    out = torch.empty((2 * s, l), dtype=torch.bfloat16, device=x.device)
    return bitpack._launch("bitcast_rows", out, x.data_ptr(), out.data_ptr(),
                           s, l)


# -- P2: the transposed pack --------------------------------------------------
def pack_bits_t_plain(cols: torch.Tensor, nnz: torch.Tensor, num_cols: int
                      ) -> torch.Tensor:
    """Plain PyTorch: kernel #1's plain pack, transposed -> words_T
    [VP/32, N_pad] int32."""
    return pack_bits_plain(cols, nnz, num_cols).T.contiguous()


def pack_bits_t(cols: torch.Tensor, nnz: torch.Tensor, num_cols: int
                ) -> torch.Tensor:
    """P2 on CUDA tensors, the plain version on CPU tensors: ELL cols [n,
    nnz_pad] int32 (distinct ids a row), nnz [n] int32 -> words_T [VP/32,
    N_pad] int32, equal to ``pack_bits(cols, nnz, num_cols).T``."""
    if _uses_plain("pack_bits_t", (cols, torch.int32), (nnz, torch.int32)):
        return pack_bits_t_plain(cols, nnz, num_cols)
    n, nnz_pad = cols.shape
    if nnz.shape != (n,):
        raise ValueError(f"pack_bits_t: nnz shape {tuple(nnz.shape)} != "
                         f"({n},)")
    num_words = _round_up(num_cols, TILE_BITS) // 32
    if num_words * PACK_T_ROWS * 4 > PACK_T_SMEM:
        raise ValueError(f"pack_bits_t: {num_words} words a row do not fit "
                         "a CTA's shared memory")
    n_pad = _round_up(max(n, 1), ROW_BLOCK)
    out = torch.empty((num_words, n_pad), dtype=torch.int32,
                      device=cols.device)
    return bitpack._launch("pack_t", out, cols.data_ptr(), nnz.data_ptr(),
                           out.data_ptr(), n, n_pad, nnz_pad, num_cols,
                           num_words)


# -- P5: kernel #3's keys from words_T ----------------------------------------
def bucket_keys_t_plain(words_t: torch.Tensor, qT: torch.Tensor,
                        num_rows: int, bucket: int = BUCKET
                        ) -> torch.Tensor:
    """Plain PyTorch: kernel #3's plain keys of words_T's rows."""
    return bucket_keys_plain(words_t.T, qT, num_rows, bucket)


def bucket_keys_t(words_t: torch.Tensor, qT: torch.Tensor, num_rows: int,
                  bucket: int = BUCKET) -> torch.Tensor:
    """P5 on CUDA tensors, the plain version on CPU tensors: words_T
    [VP/32, N_pad] int32, qT [VP, B] bf16 -> keys [N_pad / bucket, B]
    int32, kernel #3's keys of the same rows (``bucket`` a power of two
    <= 8)."""
    if _uses_plain("bucket_keys_t", (words_t, torch.int32),
                   (qT, torch.bfloat16)):
        return bucket_keys_t_plain(words_t, qT, num_rows, bucket)
    w, n_pad = words_t.shape
    _check_queries("bucket_keys_t", words_t.T, qT)
    kb = bitpack._check_fold("bucket_keys_t", n_pad, bucket)
    if bucket > 8 or qT.shape[0] > 1 << 16:
        raise ValueError("bucket_keys_t: bucket must be <= 8 and the "
                         "vocabulary <= 65,536 ids")
    b = qT.shape[1]
    qp = _pad_queries(qT)
    if qp.data_ptr() % 16:
        raise ValueError("bucket_keys_t: the query operand must be 16-byte "
                         "aligned")
    keys = torch.empty((n_pad // bucket, b), dtype=torch.int32,
                       device=words_t.device)
    return bitpack._launch("bucketed_t", keys, words_t.data_ptr(),
                           qp.data_ptr(), keys.data_ptr(), num_rows, n_pad,
                           w, b, qp.shape[1], kb)


# -- the plane form's timing variants (TIMING ONLY) ---------------------------
# kernel #3's plane form with one stream of work dropped (csrc/planes.cuh)
PLANE_VARIANTS = ("plane_operand_only", "plane_fragments_only")


def plane_variant_plain(words: torch.Tensor, qT: torch.Tensor,
                        num_rows: int, bucket: int = BUCKET) -> torch.Tensor:
    """The function the variants time: kernel #3's plain keys."""
    return bucket_keys_plain(words, qT, num_rows, bucket)


def plane_variant(kernel: str, words: torch.Tensor, qT: torch.Tensor,
                  num_rows: int, bucket: int = BUCKET,
                  num_cols: Optional[int] = None) -> torch.Tensor:
    """TIMING ONLY: one of ``PLANE_VARIANTS``, launched as kernel #3's
    plane form is (``bitpack._plane_keys``). "plane_operand_only" loads
    the rows' words but builds no fragments; "plane_fragments_only"
    fills the ring of operand slices once and reuses it. Their keys are
    not the function's. The plain version on CPU tensors."""
    if kernel not in PLANE_VARIANTS:
        raise ValueError(f"plane_variant: {kernel!r} is not one of "
                         f"{PLANE_VARIANTS}")
    if _uses_plain(kernel, (words, torch.int32), (qT, torch.bfloat16)):
        return plane_variant_plain(words, qT, num_rows, bucket)
    return bitpack._plane_keys(kernel, words, qT, num_rows, bucket,
                               num_cols)
