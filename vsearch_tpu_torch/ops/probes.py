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
  ``pltpu.bitcast``. Each row is decoded once into shared memory and
  swept against every query tile (``keys_t_geometry``); its timing-only
  variant ``bucket_keys_t_decode_only`` (``csrc/bucketed_t_decode_only.cu``)
  decodes and stores keys without the sweep's gathers and adds.
- the plane form's timing variants ``plane_variant("plane_operand_only"
  | "plane_fragments_only", ...)`` (``csrc/plane_*_only.cu``): kernel
  #3's plane form with the rows' words streamed and one of its two other
  streams of work dropped (``csrc/planes.cuh``). They do NOT compute the
  function; their keys are for timing only and are never compared or
  used (nor are those of P5's timing-only variant).

As in ``ops.bitpack``, each wrapper launches its kernel on CUDA tensors
(``cuda_build.launch``) and runs its plain PyTorch twin (``*_plain``) on
CPU tensors; the timing variants' twin is the function they time, kernel
#3's plain version (P5's for P5's variant).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import bitpack
from .bitpack import (BUCKET, ROW_BLOCK, TILE_BITS, _check_queries,
                      _pad_queries, _round_up, bucket_keys_plain,
                      pack_bits_plain)
from .cuda_build import launch, uses_plain

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
    if uses_plain("bitcast_rows", (x, torch.int32)):
        return bitcast_rows_plain(x)
    s, l = x.shape
    out = torch.empty((2 * s, l), dtype=torch.bfloat16, device=x.device)
    return launch("bitcast_rows", out, x.data_ptr(), out.data_ptr(),
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
    if uses_plain("pack_bits_t", (cols, torch.int32), (nnz, torch.int32)):
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
    return launch("pack_t", out, cols.data_ptr(), nnz.data_ptr(),
                           out.data_ptr(), n, n_pad, nnz_pad, num_cols,
                           num_words)


# -- P5: kernel #3's keys from words_T ----------------------------------------
KEYS_T_ROWS = 256  # rows a CTA (kRows in csrc/bucketed_t.cuh)
KEYS_T_WARPS = 8  # one row a thread in the decode
KEYS_T_QUERIES = 32  # queries a pass (kQ)
KEYS_T_CAP = 192  # vocab ids a row's list holds in shared memory
KEYS_T_STATE_BYTES = 3 * 4 * KEYS_T_ROWS  # a row's count and resume point
KEYS_T_BUCKETS = (1, 2, 4, 8)
KEYS_T_MAX_WORDS = (1 << 16) // 32  # vocab ids are u16 in the lists


@dataclasses.dataclass(frozen=True)
class KeysTGeometry:
    """How P5 launches: ``grid`` CTAs of ``warps`` warps, 4 a 1024-row
    block, CTA x owning the key slots ``(x % 4) * kb / 4 + [0, kb / 4)``
    of block ``x // 4`` with all their members (``KEYS_T_ROWS`` rows); no
    query axis: each CTA decodes its rows once into lists of ``cap`` ids
    in ``smem`` bytes of dynamic shared memory and sweeps all ``tiles``
    tiles of ``queries`` queries."""

    grid: int
    tiles: int
    cap = KEYS_T_CAP
    warps = KEYS_T_WARPS
    queries = KEYS_T_QUERIES
    smem = KEYS_T_CAP * KEYS_T_ROWS * 2 + KEYS_T_STATE_BYTES

    def c_args(self) -> Tuple[int, int, int]:
        """(cap, grid_x, smem), as the C entry points take them."""
        return self.cap, self.grid, self.smem


def keys_t_geometry(n_pad: int, bucket: int, b: int, num_words: int
                    ) -> KeysTGeometry:
    """P5's launch over words_T [``num_words``, ``n_pad``] for ``b``
    queries folded by ``bucket``; raises for shapes the kernel does not
    take."""
    if n_pad <= 0 or n_pad % ROW_BLOCK:
        raise ValueError(f"keys_t_geometry: padded rows {n_pad} must be a "
                         f"positive multiple of {ROW_BLOCK}")
    if bucket not in KEYS_T_BUCKETS:
        raise ValueError(f"keys_t_geometry: bucket {bucket} is not one of "
                         f"{KEYS_T_BUCKETS}")
    if num_words % 8 or not 0 < num_words <= KEYS_T_MAX_WORDS:
        raise ValueError(f"keys_t_geometry: {num_words} words a row: the "
                         "vocabulary must be 1-65,536 ids, in whole words "
                         "of 8")
    if b < 0:
        raise ValueError(f"keys_t_geometry: {b} queries")
    return KeysTGeometry(grid=n_pad // KEYS_T_ROWS,
                         tiles=_round_up(max(b, 1), KEYS_T_QUERIES)
                         // KEYS_T_QUERIES)


# each device's P5 state, uint32 [2] held as int32: the pass clock that
# keeps the resident CTAs on one query tile, and the rows longer than
# their list so far. Made once a device and never reset
_KEYS_T_STATE: Dict[int, torch.Tensor] = {}


def _keys_t_state(device: torch.device) -> torch.Tensor:
    state = _KEYS_T_STATE.get(device.index)
    if state is None:
        state = torch.zeros(2, dtype=torch.int32, device=device)
        _KEYS_T_STATE[device.index] = state
    return state


def keys_t_long_rows(device: torch.device) -> int:
    """The rows longer than their list (``KEYS_T_CAP`` ids) that P5 and
    its timing variant have met on CUDA ``device`` so far, by launch."""
    device = torch.device(device)
    index = device.index
    if index is None and device.type == "cuda":
        index = torch.cuda.current_device()
    state = _KEYS_T_STATE.get(index)
    return 0 if state is None else int(state[1]) & 0xFFFFFFFF


def bucket_keys_t_plain(words_t: torch.Tensor, qT: torch.Tensor,
                        num_rows: int, bucket: int = BUCKET
                        ) -> torch.Tensor:
    """Plain PyTorch: kernel #3's plain keys of words_T's rows."""
    return bucket_keys_plain(words_t.T, qT, num_rows, bucket)


def _keys_t_args(name: str, words_t: torch.Tensor, qT: torch.Tensor,
                 num_rows: int, bucket: int) -> Tuple[torch.Tensor, tuple]:
    """(the keys, the C arguments) of a launch of P5 or of its timing
    variant on CUDA tensors: the same geometry, operand and state."""
    w, n_pad = words_t.shape
    _check_queries(name, words_t.T, qT)
    b = qT.shape[1]
    geom = keys_t_geometry(n_pad, bucket, b, w)
    qp = _pad_queries(qT)
    if qp.data_ptr() % 16:
        raise ValueError(f"{name}: the query operand must be 16-byte "
                         "aligned")
    keys = torch.empty((n_pad // bucket, b), dtype=torch.int32,
                       device=words_t.device)
    return keys, (words_t.data_ptr(), qp.data_ptr(), keys.data_ptr(),
                  _keys_t_state(keys.device).data_ptr(), num_rows, n_pad, w,
                  b, qp.shape[1], bucket, *geom.c_args())


def bucket_keys_t(words_t: torch.Tensor, qT: torch.Tensor, num_rows: int,
                  bucket: int = BUCKET) -> torch.Tensor:
    """P5 on CUDA tensors, the plain version on CPU tensors: words_T
    [VP/32, N_pad] int32, qT [VP, B] bf16 -> keys [N_pad / bucket, B]
    int32, kernel #3's keys of the same rows (``bucket`` 1, 2, 4 or 8)."""
    if uses_plain("bucket_keys_t", (words_t, torch.int32),
                   (qT, torch.bfloat16)):
        return bucket_keys_t_plain(words_t, qT, num_rows, bucket)
    keys, args = _keys_t_args("bucket_keys_t", words_t, qT, num_rows,
                              bucket)
    return launch("bucketed_t", keys, *args)


def bucket_keys_t_decode_only_plain(words_t: torch.Tensor,
                                    qT: torch.Tensor, num_rows: int,
                                    bucket: int = BUCKET) -> torch.Tensor:
    """The function the variant times: P5's plain keys."""
    return bucket_keys_t_plain(words_t, qT, num_rows, bucket)


def bucket_keys_t_decode_only(words_t: torch.Tensor, qT: torch.Tensor,
                              num_rows: int, bucket: int = BUCKET
                              ) -> torch.Tensor:
    """TIMING ONLY: P5 with its sweep's gathers and adds dropped: it reads
    and decodes the rows as P5 does and stores keys made from the lists'
    counts. Its keys are not the function's. The plain version on CPU
    tensors."""
    if uses_plain("bucket_keys_t_decode_only", (words_t, torch.int32),
                   (qT, torch.bfloat16)):
        return bucket_keys_t_decode_only_plain(words_t, qT, num_rows,
                                               bucket)
    keys, args = _keys_t_args("bucket_keys_t_decode_only", words_t, qT,
                              num_rows, bucket)
    return launch("bucketed_t_decode_only", keys, *args)


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
    if uses_plain(kernel, (words, torch.int32), (qT, torch.bfloat16)):
        return plane_variant_plain(words, qT, num_rows, bucket)
    return bitpack._plane_keys(kernel, words, qT, num_rows, bucket,
                               num_cols)
