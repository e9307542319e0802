"""Bit-packed binary scoring for bag-of-token search
(counterpart of ``vsearch_tpu/ops/bitpack.py``).

Binary passage rows live bit-packed in device memory (4 KB a row at
V' = 29,523) and are scored by hand-written CUDA kernels
(``csrc/*.cu``): the pack (#1), the exact scorer (#2) and the fused
score-and-bucket kernel (#3). Each kernel wrapper below launches its
kernel on a CUDA tensor and runs its plain PyTorch twin (same signature,
``*_plain``) on a CPU tensor; there is no other fallback. The twins are
also what the tests and ``chip_smoke.py`` hold the kernels against.

Layout: vocab id ``v`` -> word ``(v//4096)*128 + v%128``, bit
``(v%4096)//128``. ``BitMatrix.words`` is ``[N_pad, VP/32]`` int32
holding the JAX package's uint32 bit patterns (torch's uint32 supports
few ops); ``.view(torch.uint32)`` or numpy ``.view(np.uint32)`` gives
them back unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .search import top_k

TILE_BITS = 4096
LANES = 128
PLANES = 32
ROW_BLOCK = 1024  # rows per padding unit and per bucket-fold block
BUCKET = 8  # rows folded into one candidate key by kernel #3
INT32_MIN = -(2 ** 31)

# launches of each CUDA kernel since the last reset: a run can show that
# its main path went through the kernels
LAUNCHES: Dict[str, int] = {"pack": 0, "scores": 0, "bucketed": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BitMatrix:
    """Bit-packed binary matrix [num_rows, num_cols] (rows padded to
    ROW_BLOCK with zero rows; columns padded to a TILE_BITS multiple)."""

    words: torch.Tensor  # [N_pad, num_words] int32 (uint32 bit patterns)
    num_rows: int
    num_cols: int

    @property
    def padded_bits(self) -> int:
        return self.words.shape[1] * 32


def _uses_plain(name: str, *inputs: Tuple[torch.Tensor, torch.dtype]
                ) -> bool:
    """True when the inputs lie on the CPU (the plain version runs).
    For CUDA inputs, check what the kernel takes and return False; raise
    for any other device, a device mismatch, a dtype or a layout the
    kernel does not take."""
    dev = inputs[0][0].device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t, dtype in inputs:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return False


def _launch(name: str, out: torch.Tensor, *args) -> torch.Tensor:
    """Launch kernel ``name`` on the current stream of ``out``'s device,
    raise if the launch failed, and count it."""
    with torch.cuda.device(out.device):
        fn = cuda_build.kernel_fn(name)
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA kernel '{name}' failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
    return out


# -- kernel #1: pack ---------------------------------------------------------
def pack_bits_plain(cols: torch.Tensor, nnz: torch.Tensor, num_cols: int
                    ) -> torch.Tensor:
    """Plain PyTorch pack: [n, nnz_pad] cols -> [N_pad, VP/32] int32."""
    n, nnz_pad = cols.shape
    num_words = _round_up(num_cols, TILE_BITS) // 32
    n_pad = _round_up(max(n, 1), ROW_BLOCK)
    c = cols.long()
    valid = ((torch.arange(nnz_pad, device=cols.device)[None, :]
              < nnz[:, None]) & (c >= 0) & (c < num_cols))
    rows = torch.arange(n, device=cols.device)[:, None].expand(n, nnz_pad)
    c, rows = c[valid], rows[valid]
    word = (c // TILE_BITS) * LANES + c % LANES
    bit = torch.bitwise_left_shift(torch.ones_like(c),
                                   (c % TILE_BITS) // LANES)
    # distinct columns set distinct bits, so the sum is the OR
    acc = torch.zeros(n_pad * num_words, dtype=torch.int64,
                      device=cols.device)
    acc.index_add_(0, rows * num_words + word, bit)
    acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)
    return acc.to(torch.int32).view(n_pad, num_words)


def pack_bits(cols: torch.Tensor, nnz: torch.Tensor, num_cols: int
              ) -> torch.Tensor:
    """Kernel #1 (``csrc/pack.cu``) on CUDA tensors, the plain version on
    CPU tensors."""
    if _uses_plain("pack_bits", (cols, torch.int32), (nnz, torch.int32)):
        return pack_bits_plain(cols, nnz, num_cols)
    n, nnz_pad = cols.shape
    if nnz.shape != (n,):
        raise ValueError(f"pack_bits: nnz shape {tuple(nnz.shape)} != ({n},)")
    num_words = _round_up(num_cols, TILE_BITS) // 32
    n_pad = _round_up(max(n, 1), ROW_BLOCK)
    out = torch.empty((n_pad, num_words), dtype=torch.int32,
                      device=cols.device)
    return _launch("pack", out, cols.data_ptr(), nnz.data_ptr(),
                   out.data_ptr(), n, n_pad, nnz_pad, num_cols, num_words)


# -- kernel #2: exact scores ---------------------------------------------------
def _unpack_rows(words: torch.Tensor) -> torch.Tensor:
    """[R, W] packed words -> [R, 32*W] 0/1 int32 in vocab order."""
    r, w = words.shape
    planes = torch.arange(PLANES, device=words.device).view(1, 1, PLANES, 1)
    bits = (words.view(r, w // LANES, 1, LANES) >> planes) & 1
    return bits.reshape(r, w * 32)


def score_bits_plain(words: torch.Tensor, qT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch scorer: words [N_pad, W], qT [VP, B] bf16 ->
    scores [N_pad, B] f32 (rows unpacked in chunks, f32 product)."""
    n_pad, w = words.shape
    q = qT.float()
    chunk = max(1, (1 << 26) // (w * 32))
    return torch.cat([_unpack_rows(words[s:s + chunk]).float() @ q
                      for s in range(0, n_pad, chunk)], dim=0)


def _pad_queries(qT: torch.Tensor) -> torch.Tensor:
    """Zero-pad the query axis to a multiple of 32 (one warp tile)."""
    b = qT.shape[1]
    b_pad = _round_up(max(b, 1), 32)
    qT = qT if b_pad == b else F.pad(qT, (0, b_pad - b))
    return qT.contiguous()


def _check_queries(name: str, words: torch.Tensor, qT: torch.Tensor):
    if qT.shape[0] != words.shape[1] * 32:
        raise ValueError(f"{name}: qT rows {qT.shape[0]} != packed bits "
                         f"{words.shape[1] * 32}")


def score_bits(words: torch.Tensor, qT: torch.Tensor) -> torch.Tensor:
    """Kernel #2 (``csrc/scores.cu``) on CUDA tensors, the plain version
    on CPU tensors. words [N_pad, W] int32, qT [VP, B] bf16 ->
    [N_pad, B] f32."""
    if _uses_plain("score_bits", (words, torch.int32),
                   (qT, torch.bfloat16)):
        return score_bits_plain(words, qT)
    _check_queries("score_bits", words, qT)
    n_pad, w = words.shape
    b = qT.shape[1]
    qp = _pad_queries(qT)
    out = torch.empty((n_pad, b), dtype=torch.float32, device=words.device)
    return _launch("scores", out, words.data_ptr(), qp.data_ptr(),
                   out.data_ptr(), n_pad, w, b, qp.shape[1])


# -- kernel #3: fused score + bucketed keys -----------------------------------
def bucket_keys_plain(words: torch.Tensor, qT: torch.Tensor, num_rows: int,
                      bucket: int = BUCKET) -> torch.Tensor:
    """Plain PyTorch keys: [N_pad / bucket, B] int32 (see kernel #3)."""
    n_pad = words.shape[0]
    kb = ROW_BLOCK // bucket
    scores = score_bits_plain(words, qT).clamp_min(0.0)
    local = (torch.arange(n_pad, device=words.device, dtype=torch.int32)
             % ROW_BLOCK)[:, None]
    keys = (scores.view(torch.int32) & ~(ROW_BLOCK - 1)) | local
    keys[num_rows:] = INT32_MIN
    b = keys.shape[1]
    return keys.view(n_pad // ROW_BLOCK, bucket, kb, b).amax(dim=1) \
        .reshape(n_pad // bucket, b)


def bucket_keys(words: torch.Tensor, qT: torch.Tensor, num_rows: int,
                bucket: int = BUCKET) -> torch.Tensor:
    """Kernel #3 (``csrc/bucketed.cu``) on CUDA tensors, the plain version
    on CPU tensors. -> keys [N_pad / bucket, B] int32."""
    if _uses_plain("bucket_keys", (words, torch.int32),
                   (qT, torch.bfloat16)):
        return bucket_keys_plain(words, qT, num_rows, bucket)
    _check_queries("bucket_keys", words, qT)
    n_pad, w = words.shape
    kb = ROW_BLOCK // bucket
    if n_pad % ROW_BLOCK or bucket & (bucket - 1) or kb % 8:
        raise ValueError(f"bucket_keys: padded rows {n_pad} must be a "
                         f"multiple of {ROW_BLOCK} and bucket {bucket} a "
                         "power of two <= 128")
    b = qT.shape[1]
    qp = _pad_queries(qT)
    keys = torch.empty((n_pad // bucket, b), dtype=torch.int32,
                       device=words.device)
    return _launch("bucketed", keys, words.data_ptr(), qp.data_ptr(),
                   keys.data_ptr(), n_pad, num_rows, w, b, qp.shape[1], kb)


# -- search entry points -----------------------------------------------------
def pack_ell_device(ell) -> BitMatrix:
    """Pack a binary ELLMatrix where it lives (kernel #1 on the card)."""
    words = pack_bits(ell.cols.contiguous(), ell.nnz.contiguous(),
                      ell.num_cols)
    return BitMatrix(words=words, num_rows=ell.cols.shape[0],
                     num_cols=ell.num_cols)


# The JAX package's pack_ell also packs on the host (C++) and falls back
# there on a device failure; the port packs where the ELL lives and lets
# any failure surface.
pack_ell = pack_ell_device


def prepare_queries(q: torch.Tensor, bitmat: BitMatrix) -> torch.Tensor:
    """q [B, V] -> padded transposed bf16 operand [VP, B] (queries are
    rounded to bf16 exactly as the JAX package rounds them)."""
    qT = q.float().T
    qT = F.pad(qT, (0, 0, 0, bitmat.padded_bits - qT.shape[0]))
    return qT.to(torch.bfloat16).contiguous()


def bitpack_scores(q: torch.Tensor, bitmat: BitMatrix) -> torch.Tensor:
    """scores [B, num_rows] = q @ bits.T (kernel #2)."""
    scores = score_bits(bitmat.words, prepare_queries(q, bitmat))
    return scores[: bitmat.num_rows].T


def _bucketed_keys(q: torch.Tensor, bitmat: BitMatrix,
                   bucket: int = BUCKET) -> torch.Tensor:
    """[N_pad / bucket, B] int32 candidate keys (kernel #3)."""
    return bucket_keys(bitmat.words, prepare_queries(q, bitmat),
                       bitmat.num_rows, bucket)


def bitpack_bucketed_topk(q: torch.Tensor, bitmat: BitMatrix, k: int,
                          bucket: int = BUCKET
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, k] via the fused bucketed kernel.

    Exact up to (a) <= 2^-13 relative score quantization and (b)
    collisions of true top-k rows within one bucket. Falls back to exact
    selection when ``k * bucket > num_rows`` (fewer valid buckets than k
    are possible there). The key decode below serves the kernel and the
    plain path alike: a key's score is the key with its low 10 bits
    cleared (-inf for empty keys), its row the block's first row plus the
    key's local row id; ranking is by decoded score, ties to the lower
    candidate position as in JAX.
    """
    if k * bucket > bitmat.num_rows:
        return bitpack_topk_search(q, bitmat, k=k)
    keys = _bucketed_keys(q, bitmat, bucket)
    m = keys.shape[0]
    kb = ROW_BLOCK // bucket
    idx_mask = ROW_BLOCK - 1
    local = keys & idx_mask
    scores = (keys & ~idx_mask).view(torch.float32)
    scores = torch.where(keys < 0, torch.full_like(scores, float("-inf")),
                         scores)
    block_id = (torch.arange(m, device=keys.device) // kb)[:, None]
    gids = block_id * ROW_BLOCK + local  # [m, B]
    s, pos = top_k(scores.T, min(k, m))
    return torch.gather(gids.T, 1, pos), s


def bitpack_topk_search(q: torch.Tensor, bitmat: BitMatrix, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, k]: kernel #2 scoring + exact top-k."""
    s, i = top_k(bitpack_scores(q, bitmat), k)
    return i, s
