"""Bit-packed binary scoring for bag-of-token search
(counterpart of ``vsearch_tpu/ops/bitpack.py``).

Binary passage rows live bit-packed in device memory (4 KB a row at
V' = 29,523) and are scored by hand-written CUDA kernels
(``csrc/*.cu``): the pack (#1), the exact scorer (#2), the fused
score-and-bucket kernel (#3) and its integer twin over an int8 query
operand (#4). #2 and #3 each have two forms: the gather form
(``bitrow.cuh``) sums a row's set bits, the plane form (``planes.cuh``)
multiplies its bit planes on the tensor cores; rows of at least
``PLANE_MIN_BITS`` set bits in an index of at least ``PLANE_MIN_ROWS``
rows take the plane form (``row_form``). Each
kernel wrapper below launches its kernel on a CUDA
tensor and runs its plain PyTorch twin (same signature, ``*_plain``) on a
CPU tensor; there is no other fallback. The twins are also what the tests
and ``chip_smoke.py`` hold the kernels against.

An index whose packed bits do not fit the device keeps its compact ELL
there instead and is swept block by block (``bitpack_blockwise_topk``):
each block is packed, scored and merged into a running top-k.

Layout: vocab id ``v`` -> word ``(v//4096)*128 + v%128``, bit
``(v%4096)//128``. ``BitMatrix.words`` is ``[N_pad, VP/32]`` int32
holding the JAX package's uint32 bit patterns (torch's uint32 supports
few ops); ``.view(torch.uint32)`` or numpy ``.view(np.uint32)`` gives
them back unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import TRACER
# the benchmark reads ``LAUNCHES`` and ``reset_launch_counts`` here too
from .cuda_build import LAUNCHES, reset_launch_counts  # noqa: F401
from .cuda_build import launch, uses_plain
from .ell import ELLMatrix, widen_cols
from .search import top_k
from .two_stage import exact_rerank

TILE_BITS = 4096
LANES = 128
PLANES = 32
ROW_BLOCK = 1024  # rows per padding unit and per bucket-fold block
BUCKET = 8  # rows folded into one candidate key by kernel #3
BLOCK_BUCKET = 2 * BUCKET  # the fold of the block tier's kernels
INT8_KEY_SHIFT = 10  # low bits of an int8 key hold the local row id
INT32_MIN = -(2 ** 31)

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BitMatrix:
    """Bit-packed binary matrix [num_rows, num_cols] (rows padded to
    ROW_BLOCK with zero rows; columns padded to a TILE_BITS multiple)."""

    words: torch.Tensor  # [N_pad, num_words] int32 (uint32 bit patterns)
    num_rows: int
    num_cols: int
    # mean set bits a row, which with the padded row count picks the form
    # of kernels #2 and #3 (``row_form``); 0 (unknown) keeps the gather form
    mean_bits: float = 0.0

    @property
    def form(self) -> str:
        return row_form(self.mean_bits, self.words.shape[0])

    @property
    def padded_bits(self) -> int:
        return self.words.shape[1] * 32

    @property
    def num_ktiles(self) -> int:
        return self.padded_bits // TILE_BITS


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
    if uses_plain("pack_bits", (cols, torch.int32), (nnz, torch.int32)):
        return pack_bits_plain(cols, nnz, num_cols)
    n, nnz_pad = cols.shape
    if nnz.shape != (n,):
        raise ValueError(f"pack_bits: nnz shape {tuple(nnz.shape)} != ({n},)")
    num_words = _round_up(num_cols, TILE_BITS) // 32
    n_pad = _round_up(max(n, 1), ROW_BLOCK)
    out = torch.empty((n_pad, num_words), dtype=torch.int32,
                      device=cols.device)
    return launch("pack", out, cols.data_ptr(), nnz.data_ptr(),
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


def _check_fold(name: str, n_pad: int, bucket: int) -> int:
    """kb = ROW_BLOCK / bucket key slots a block, as the fold kernels
    take them."""
    kb = ROW_BLOCK // bucket
    if n_pad % ROW_BLOCK or bucket & (bucket - 1) or kb % 8:
        raise ValueError(f"{name}: padded rows {n_pad} must be a multiple "
                         f"of {ROW_BLOCK} and bucket {bucket} a power of "
                         "two <= 128")
    return kb


# -- launch geometry of kernels #2-#4 (csrc/bitrow.cuh) ---------------------
CTA_WARPS = 8  # warps a CTA of kernels #2-#4 (kWarps in bitrow.cuh)


def _query_tiles(name: str, b: int, num_words: int) -> int:
    """Query tiles of 32 for ``b`` queries, after checking that the query
    operand's byte offsets (``2 * v * b_pad``, int32 in the kernels) fit."""
    b_pad = _round_up(max(b, 1), 32)
    if num_words * 32 * b_pad * 2 >= 2 ** 31:
        raise ValueError(f"{name}: the query operand's int32 byte offsets "
                         "would overflow")
    return b_pad // 32


@dataclasses.dataclass(frozen=True)
class FoldGeometry:
    """How a fold kernel launches: CTA x of the ``grid[0]`` along the rows
    owns the ``warps`` consecutive key slots ``(x % (kb // warps)) *
    warps + w`` of 1024-row block ``x // (kb // warps)``, one slot a warp
    (``fold_slot`` in bitrow.cuh); ``grid[1]`` tiles the queries by 32."""

    kb: int
    grid: Tuple[int, int]
    warps: int = CTA_WARPS

    @property
    def total_warps(self) -> int:
        return self.grid[0] * self.grid[1] * self.warps

    def c_args(self) -> Tuple[int, int]:
        """(kb, grid_x), as the C entry points take them."""
        return self.kb, self.grid[0]


def fold_geometry(n_pad: int, bucket: int, b: int, num_words: int
                  ) -> FoldGeometry:
    """The launch geometry of kernel #3 or #4 over ``n_pad`` rows of
    ``num_words`` words folded by ``bucket`` for ``b`` queries."""
    kb = _check_fold("fold_geometry", n_pad, bucket)
    tiles = _query_tiles("fold_geometry", b, num_words)
    grid_x = (n_pad // ROW_BLOCK) * (kb // CTA_WARPS)
    return FoldGeometry(kb=kb, grid=(grid_x, tiles))


INT8_LIST_CAP = 256  # offsets a warp's decode list holds (kListCap)
INT8_TILE_QUERIES = 2048  # queries of one grid row of kernel #4 (kTileQ)


@dataclasses.dataclass(frozen=True)
class Int8FoldGeometry:
    """How kernel #4 launches: CTA x of ``grid[0]`` owns key slots of one
    1024-row block as in ``FoldGeometry``; ``grid[1]`` tiles the queries
    by 2,048, so up to 2,048 queries a warp reads and decodes each row of
    its slot once (``word_passes``: reads of the block's words, one a grid
    row). It sweeps the kept list in ``passes`` passes of up to ``32 *
    lane_queries`` queries; in the first, lane ``g * lanes + c`` (``g <
    groups``) sums queries ``lane_queries`` from ``c * lane_queries`` over
    every ``groups``-th list entry. ``smem_bytes``: the CTA's decode lists,
    and past one pass its best keys."""

    kb: int
    grid: Tuple[int, int]
    lane_queries: int
    passes: int
    lanes: int
    groups: int
    smem_bytes: int
    warps: int = CTA_WARPS

    @property
    def word_passes(self) -> int:
        return self.grid[1]

    @property
    def total_warps(self) -> int:
        return self.grid[0] * self.grid[1] * self.warps

    def c_args(self) -> Tuple[int, int, int]:
        """(kb, lane_q, grid_x), as the C entry point takes them (it tiles
        the queries itself)."""
        return self.kb, self.lane_queries, self.grid[0]


def int8_fold_geometry(n_pad: int, bucket: int, b: int, num_words: int
                       ) -> Int8FoldGeometry:
    """The launch geometry of kernel #4 over ``n_pad`` rows of
    ``num_words`` words folded by ``bucket`` for ``b`` queries: the
    32-query tiles of ``fold_geometry`` become passes inside the warp. A
    lane sums 4 queries at b_pad 32, 8 up to 384, else 16 (the fastest on
    an H100 at 262,144 rows, PERF.md)."""
    kb = _check_fold("int8_fold_geometry", n_pad, bucket)
    b_pad = 32 * _query_tiles("int8_fold_geometry", b, num_words)
    lane_q = 4 if b_pad <= 32 else 8 if b_pad <= 384 else 16
    tile = min(b_pad, INT8_TILE_QUERIES)
    lanes = min(tile, 32 * lane_q) // lane_q
    groups = 1
    while 2 * groups * lanes <= 32:
        groups *= 2
    passes = -(-tile // (32 * lane_q))
    best = CTA_WARPS * passes * lane_q * 32 * 4 if passes > 1 else 0
    return Int8FoldGeometry(
        kb=kb, grid=((n_pad // ROW_BLOCK) * (kb // CTA_WARPS),
                     -(-b_pad // INT8_TILE_QUERIES)),
        lane_queries=lane_q, passes=passes, lanes=lanes, groups=groups,
        smem_bytes=CTA_WARPS * INT8_LIST_CAP * 4 + best)


@dataclasses.dataclass(frozen=True)
class ScoreGeometry:
    """How kernel #2 launches: warp w of CTA x along ``grid[0]`` scores
    the row pair ``2 * (x * warps + w)`` and the next (``scores_kernel``
    in scores.cu; pairs past the last row do nothing); ``grid[1]`` tiles
    the queries by 32."""

    grid: Tuple[int, int]
    warps: int = CTA_WARPS

    @property
    def total_warps(self) -> int:
        return self.grid[0] * self.grid[1] * self.warps

    def c_args(self) -> Tuple[int]:
        """(grid_x,), as the C entry point takes it."""
        return (self.grid[0],)


def score_geometry(n_pad: int, b: int, num_words: int) -> ScoreGeometry:
    """The launch geometry of kernel #2 over ``n_pad`` rows of
    ``num_words`` words for ``b`` queries: one warp a pair of rows."""
    tiles = _query_tiles("score_geometry", b, num_words)
    pairs = (n_pad + 1) // 2
    return ScoreGeometry(grid=(-(-pairs // CTA_WARPS), tiles))


# -- the plane form of kernels #2 and #3 (csrc/planes.cuh) -------------------
# Rows with at least this many set bits on average take the plane form:
# the narrowest width of chip_smoke.py phase 9's crossover table (262,144
# rows, B=32, on an H100) at which the plane form of both #2 and #3 beat
# the gather form (PERF.md §6)
PLANE_MIN_BITS = 192
# ... in a matrix of at least this many padded rows: a CTA runs its rows'
# planes in series, so a grid that leaves most SMs idle loses to the
# gather form's warps. The narrowest row count of the same table's rows
# sweep (768 ids a row) at which the plane form of both #2 and #3 beat
# the gather form; at 4,096 rows #2's gather form is faster (PERF.md §6)
PLANE_MIN_ROWS = 8192
PLANE_WARPS = 17  # 4 warpgroups and a producer warp (planes.cuh)
PLANE_ROWS = 256  # rows of one pass: 64 a warpgroup (kPlaneRows)
PLANE_FILL_BLOCKS = 256  # 1024-row blocks that fill the card unsplit
FORMS = ("gather", "plane")


def row_form(mean_bits: float, n_pad: int) -> str:
    """The form of kernels #2 and #3 for ``n_pad`` rows of ``mean_bits``
    set bits on average: the plane form at or above both
    ``PLANE_MIN_BITS`` and ``PLANE_MIN_ROWS``."""
    return ("plane" if mean_bits >= PLANE_MIN_BITS
            and n_pad >= PLANE_MIN_ROWS else "gather")


def _check_form(name: str, form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"{name}: unknown form {form!r}")


@dataclasses.dataclass(frozen=True)
class PlaneGeometry:
    """How a plane-form kernel launches: CTA x along ``grid[0]`` runs
    ``passes`` passes of ``PLANE_ROWS`` rows from row ``x * rows_per_cta``
    (``plane_rows`` in planes.cuh); for #3, the ``split`` CTAs
    ``x // split`` share a 1024-row block. ``grid[1]`` tiles the queries by
    32; ``nplanes`` bit planes a row lie below the columns' end."""

    grid: Tuple[int, int]
    rows_per_cta: int
    split: int
    nplanes: int
    warps: int = PLANE_WARPS

    @property
    def passes(self) -> int:
        return self.rows_per_cta // PLANE_ROWS

    @property
    def total_warps(self) -> int:
        return self.grid[0] * self.grid[1] * self.warps


def plane_geometry(n_pad: int, b: int, num_words: int, num_cols: int,
                   bucket: int = 0) -> PlaneGeometry:
    """The launch geometry of the plane form over ``n_pad`` rows of
    ``num_words`` words (``num_cols`` valid columns) for ``b`` queries:
    kernel #2 (``bucket`` 0) runs one pass a CTA; kernel #3 gives each
    1024-row block one CTA once there are ``PLANE_FILL_BLOCKS`` blocks,
    else splits it over 2 or 4 CTAs so that small indexes fill the card."""
    tiles = _query_tiles("plane_geometry", b, num_words)
    nplanes = -(-min(max(num_cols, 0), num_words * 32) // LANES)
    nplanes += nplanes % 2  # the kernels run planes in pairs
    if not bucket:
        return PlaneGeometry(grid=(-(-n_pad // PLANE_ROWS), tiles),
                             rows_per_cta=PLANE_ROWS, split=1,
                             nplanes=nplanes)
    kb = _check_fold("plane_geometry", n_pad, bucket)
    if kb > ROW_BLOCK // BUCKET:
        raise ValueError(f"plane_geometry: bucket {bucket} < {BUCKET}")
    blocks = n_pad // ROW_BLOCK
    split = (1 if blocks >= PLANE_FILL_BLOCKS
             else 2 if 2 * blocks >= PLANE_FILL_BLOCKS else 4)
    return PlaneGeometry(grid=(blocks * split, tiles),
                         rows_per_cta=ROW_BLOCK // split, split=split,
                         nplanes=nplanes)


def _check_rows(name: str, words: torch.Tensor, qp: torch.Tensor) -> None:
    """Kernels #2-#4 read rows in 512-byte chunks of 16-byte loads, and
    the query operand 4 bytes at a time."""
    if words.shape[1] % LANES or words.data_ptr() % 16 or qp.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {words.shape[1]} words must be "
                         f"a multiple of {LANES} words, and rows and "
                         "queries 16-byte aligned")


def _fold_keys(keys: torch.Tensor, num_rows: int, bucket: int
               ) -> torch.Tensor:
    """Mask rows >= num_rows to INT32_MIN and max-fold each 1024-row
    block's keys [N_pad, B] to [N_pad / bucket, B]: local rows l and l'
    share slot l % (1024 / bucket), the grouping of JAX's halving fold."""
    n_pad, b = keys.shape
    keys[num_rows:] = INT32_MIN
    return keys.view(n_pad // ROW_BLOCK, bucket, ROW_BLOCK // bucket, b) \
        .amax(dim=1).reshape(n_pad // bucket, b)


@functools.lru_cache(maxsize=16)
def _plane_steps(nplanes: int, device: torch.device) -> torch.Tensor:
    """[2 * nplanes, 64] query rows of the plane form's steps, in the
    order the kernels run them: tile t, half h, plane p below num_cols
    (rows t * 4096 + p * 128 + 64 h + [0, 64))."""
    base = [t * TILE_BITS + p * LANES + h * 64
            for t in range(-(-nplanes // PLANES))
            for h in range(2)
            for p in range(min(PLANES, nplanes - PLANES * t))]
    return (torch.tensor(base, dtype=torch.int64)[:, None]
            + torch.arange(64)).to(device)


@functools.lru_cache(maxsize=16)
def _plane_scales(nplanes: int, device: torch.device) -> torch.Tensor:
    """[2 * nplanes, 1, 1] bf16: 2^64 for the steps of even planes, else
    1 (the fragments of even planes are 2^-63, planes.cuh)."""
    plane = (_plane_steps(nplanes, device)[:, :1] % TILE_BITS) // LANES
    return torch.where(plane % 2 == 0, 2.0 ** 64, 1.0).to(
        torch.bfloat16)[:, :, None]


def _plane_operand(qp: torch.Tensor, nplanes: int) -> torch.Tensor:
    """The plane form's query operand from ``qp`` [VP, b_pad] bf16: the
    slices of the kernels' ring in step order, [b_pad / 32, 2 * nplanes,
    4 KB] as bf16 [.., 2048]. A slice holds 64 query rows x 32 queries as
    wgmma's K-major core matrices (8 queries x 8 rows, 128 B): row 8 kg +
    kk of query 8 ng + nn at byte (kg * 4 + ng) * 128 + nn * 16 + kk * 2.
    The slices of even planes are scaled by 2^64 (exact in bf16, for
    weights below 2^63 in magnitude), to meet their fragments' 2^-63
    (planes.cuh)."""
    steps = _plane_steps(nplanes, qp.device)
    s, b_pad = steps.shape[0], qp.shape[1]
    x = (qp[steps] * _plane_scales(nplanes, qp.device)).view(
        s, 8, 8, b_pad // 32, 4, 8)
    # [s, kg, kk, tile, ng, nn] -> [tile, s, kg, ng, nn, kk]
    return x.permute(3, 0, 1, 4, 5, 2).contiguous().view(b_pad // 32, s,
                                                         2048)


def score_bits(words: torch.Tensor, qT: torch.Tensor,
               num_cols: Optional[int] = None, _form: str = "gather"
               ) -> torch.Tensor:
    """Kernel #2 on CUDA tensors, the plain version on CPU tensors.
    words [N_pad, W] int32, qT [VP, B] bf16 -> [N_pad, B] f32. ``_form``
    picks the gather form (``csrc/scores.cu``) or the plane form
    (``csrc/scores_plane.cu``), which skips the bit planes at or past
    ``num_cols`` (qT must weigh those columns zero; None: all)."""
    _check_form("score_bits", _form)
    if uses_plain("score_bits", (words, torch.int32),
                   (qT, torch.bfloat16)):
        return score_bits_plain(words, qT)
    _check_queries("score_bits", words, qT)
    n_pad, w = words.shape
    b = qT.shape[1]
    qp = _pad_queries(qT)
    _check_rows("score_bits", words, qp)
    out = torch.empty((n_pad, b), dtype=torch.float32, device=words.device)
    if _form == "plane":
        g = plane_geometry(n_pad, b, w, w * 32 if num_cols is None
                           else num_cols)
        qi = _plane_operand(qp, g.nplanes)
        return launch("scores_plane", out, words.data_ptr(), qi.data_ptr(),
                       out.data_ptr(), n_pad, w, g.nplanes, b, qp.shape[1],
                       g.grid[0])
    geom = score_geometry(n_pad, b, w)
    return launch("scores", out, words.data_ptr(), qp.data_ptr(),
                   out.data_ptr(), n_pad, w, b, qp.shape[1], *geom.c_args())


# -- kernel #3: fused score + bucketed keys -----------------------------------
def bucket_keys_plain(words: torch.Tensor, qT: torch.Tensor, num_rows: int,
                      bucket: int = BUCKET) -> torch.Tensor:
    """Plain PyTorch keys: [N_pad / bucket, B] int32 (see kernel #3)."""
    return splice_keys(score_bits_plain(words, qT), num_rows, bucket)


def splice_keys(scores: torch.Tensor, num_rows: int, bucket: int
                ) -> torch.Tensor:
    """Kernel #3's keys from row scores [N_pad, B] f32: each score
    spliced with its local row id, ``(bits(max(s, 0)) & ~1023) | (r %
    1024)``, then folded by ``bucket`` (``_fold_keys``)."""
    n_pad = scores.shape[0]
    local = (torch.arange(n_pad, device=scores.device, dtype=torch.int32)
             % ROW_BLOCK)[:, None]
    keys = (scores.clamp_min(0.0).view(torch.int32)
            & ~(ROW_BLOCK - 1)) | local
    return _fold_keys(keys, num_rows, bucket)


def _plane_keys(kernel: str, words: torch.Tensor, qT: torch.Tensor,
                num_rows: int, bucket: int, num_cols: Optional[int]
                ) -> torch.Tensor:
    """One launch of kernel #3's plane form (``kernel`` "bucketed_plane"),
    or of one of its timing variants (``ops.probes.plane_variant``), on
    CUDA tensors: the same geometry, operand and keys for each."""
    _check_queries(kernel, words, qT)
    n_pad, w = words.shape
    b = qT.shape[1]
    qp = _pad_queries(qT)
    _check_rows(kernel, words, qp)
    g = plane_geometry(n_pad, b, w, w * 32 if num_cols is None
                       else num_cols, bucket)
    qi = _plane_operand(qp, g.nplanes)
    shape = (n_pad // bucket, b)
    keys = (torch.empty(shape, dtype=torch.int32, device=words.device)
            if g.split == 1 else
            torch.full(shape, INT32_MIN, dtype=torch.int32,
                       device=words.device))
    return launch(kernel, keys, words.data_ptr(), qi.data_ptr(),
                   keys.data_ptr(), num_rows, n_pad, w, g.nplanes, b,
                   qp.shape[1], ROW_BLOCK // bucket, g.split, g.grid[0])


def bucket_keys(words: torch.Tensor, qT: torch.Tensor, num_rows: int,
                bucket: int = BUCKET, num_cols: Optional[int] = None,
                _form: str = "gather") -> torch.Tensor:
    """Kernel #3 on CUDA tensors, the plain version on CPU tensors. ->
    keys [N_pad / bucket, B] int32. ``_form`` picks the gather form
    (``csrc/bucketed.cu``) or the plane form (``csrc/bucketed_plane.cu``,
    ``num_cols`` as for ``score_bits``)."""
    _check_form("bucket_keys", _form)
    if uses_plain("bucket_keys", (words, torch.int32),
                   (qT, torch.bfloat16)):
        return bucket_keys_plain(words, qT, num_rows, bucket)
    if _form == "plane":
        return _plane_keys("bucketed_plane", words, qT, num_rows, bucket,
                           num_cols)
    _check_queries("bucket_keys", words, qT)
    n_pad, w = words.shape
    b = qT.shape[1]
    qp = _pad_queries(qT)
    _check_rows("bucket_keys", words, qp)
    geom = fold_geometry(n_pad, bucket, b, w)
    keys = torch.empty((n_pad // bucket, b), dtype=torch.int32,
                       device=words.device)
    return launch("bucketed", keys, words.data_ptr(), qp.data_ptr(),
                   keys.data_ptr(), num_rows, w, b, qp.shape[1],
                   *geom.c_args())


# -- kernel #4: integer score + bucketed keys ---------------------------------
def prepare_queries_int8(q: torch.Tensor, padded_bits: int) -> torch.Tensor:
    """q [B, V] f32 nonneg -> [VP, B] int8, each query scaled so that its
    largest weight is 127 and rounded half to even, as the JAX package
    quantizes it (f32 ``q * (127 / max(max(q), 1e-6))``). Ranking within
    a query is scale-invariant, so the scale costs selection quality only
    through rounding."""
    q = q.float()
    mx = q.amax(dim=1, keepdim=True).clamp_min(1e-6)
    q8T = torch.round(q * (127.0 / mx)).to(torch.int8).T
    return F.pad(q8T, (0, 0, 0, padded_bits - q8T.shape[0])).contiguous()


def int8_bucket_keys_plain(words: torch.Tensor, q8T: torch.Tensor,
                           num_rows: int, bucket: int = BLOCK_BUCKET
                           ) -> torch.Tensor:
    """Plain PyTorch int8 keys: [N_pad / bucket, B] int32 (see kernel #4).

    The row scores are an f32 product of the unpacked 0/1 rows and the
    int8 weights: every sum is an integer below 2^24, so it is exact
    (TF32 keeps the 7-bit weights exact too). The splice wraps like JAX's
    int32 shift."""
    n_pad = words.shape[0]
    acc = score_bits_plain(words, q8T).to(torch.int64)
    local = torch.arange(n_pad, device=words.device) % ROW_BLOCK
    keys = ((acc << INT8_KEY_SHIFT) | local[:, None]) & 0xFFFFFFFF
    keys = torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys)
    return _fold_keys(keys.to(torch.int32), num_rows, bucket)


def int8_bucket_keys(words: torch.Tensor, q8T: torch.Tensor, num_rows: int,
                     bucket: int = BLOCK_BUCKET) -> torch.Tensor:
    """Kernel #4 (``csrc/int8_bucketed.cu``) on CUDA tensors, the plain
    version on CPU tensors. words [N_pad, W] int32, q8T [VP, B] int8 ->
    keys [N_pad / bucket, B] int32. Each call counts its reads of the
    block's words in the open call record (``int8_word_passes``: one up to
    2,048 queries; the plain version reads them once)."""
    if uses_plain("int8_bucket_keys", (words, torch.int32),
                   (q8T, torch.int8)):
        TRACER.count("int8_word_passes", 1)
        return int8_bucket_keys_plain(words, q8T, num_rows, bucket)
    _check_queries("int8_bucket_keys", words, q8T)
    n_pad, w = words.shape
    b = q8T.shape[1]
    geom = int8_fold_geometry(n_pad, bucket, b, w)
    TRACER.count("int8_word_passes", geom.word_passes)
    qp = _pad_queries(q8T)
    _check_rows("int8_bucket_keys", words, qp)
    keys = torch.empty((n_pad // bucket, b), dtype=torch.int32,
                       device=words.device)
    return launch("int8_bucketed", keys, words.data_ptr(), qp.data_ptr(),
                   keys.data_ptr(), num_rows, w, b, qp.shape[1],
                   *geom.c_args())


# -- search entry points -----------------------------------------------------
def pack_ell_device(ell) -> BitMatrix:
    """Pack a binary ELLMatrix where it lives (kernel #1 on the card)."""
    words = pack_bits(ell.cols.contiguous(), ell.nnz.contiguous(),
                      ell.num_cols)
    return BitMatrix(words=words, num_rows=ell.cols.shape[0],
                     num_cols=ell.num_cols, mean_bits=ell_mean_bits(ell))


def ell_mean_bits(ell) -> float:
    """Mean set bits a row of a binary ELL (its ``nnz`` within
    ``nnz_pad``): the width that picks the form of kernels #2 and #3."""
    n, nnz_pad = ell.cols.shape
    return float(ell.nnz.clamp(0, nnz_pad).sum()) / n if n else 0.0


# The JAX package's pack_ell also packs on the host (C++) and falls back
# there on a device failure; the port packs where the ELL lives and lets
# any failure surface.
pack_ell = pack_ell_device


def pack_dense(dense, device="cuda") -> BitMatrix:
    """Pack a dense 0/1 [N, V] host array (tests / small corpora), on
    ``device``."""
    return pack_ell(ELLMatrix.from_dense(dense, device=device))


def _prepare_bf16(q: torch.Tensor, padded_bits: int) -> torch.Tensor:
    qT = q.float().T
    qT = F.pad(qT, (0, 0, 0, padded_bits - qT.shape[0]))
    return qT.to(torch.bfloat16).contiguous()


def prepare_queries(q: torch.Tensor, bitmat: BitMatrix) -> torch.Tensor:
    """q [B, V] -> padded transposed bf16 operand [VP, B] (queries are
    rounded to bf16 exactly as the JAX package rounds them)."""
    return _prepare_bf16(q, bitmat.padded_bits)


def bitpack_scores(q: torch.Tensor, bitmat: BitMatrix) -> torch.Tensor:
    """scores [B, num_rows] = q @ bits.T (kernel #2)."""
    scores = score_bits(bitmat.words, prepare_queries(q, bitmat),
                        bitmat.num_cols, _form=bitmat.form)
    return scores[: bitmat.num_rows].T


def _bucketed_keys(q: torch.Tensor, bitmat: BitMatrix,
                   bucket: int = BUCKET) -> torch.Tensor:
    """[N_pad / bucket, B] int32 candidate keys (kernel #3)."""
    return bucket_keys(bitmat.words, prepare_queries(q, bitmat),
                       bitmat.num_rows, bucket, bitmat.num_cols,
                       _form=bitmat.form)


def _int8_bucketed_keys(q8T: torch.Tensor, bitmat: BitMatrix,
                        bucket: int = BLOCK_BUCKET) -> torch.Tensor:
    """[N_pad / bucket, B] int32 candidate keys (kernel #4). ``q8T`` is a
    ``prepare_queries_int8`` operand: quantize once a batch, not once a
    block."""
    return int8_bucket_keys(bitmat.words, q8T, bitmat.num_rows, bucket)


def _key_scores(keys: torch.Tensor) -> torch.Tensor:
    """f32 scores of kernel #3's keys: the key with its low 10 bits
    cleared, -inf for empty keys."""
    scores = (keys & ~(ROW_BLOCK - 1)).view(torch.float32)
    return torch.where(keys < 0, torch.full_like(scores, float("-inf")),
                       scores)


def _int8_key_scores(keys: torch.Tensor) -> torch.Tensor:
    """f32 scores of kernel #4's keys: the key shifted right (exact
    integers), -inf for empty keys."""
    return torch.where(keys < 0, float("-inf"),
                       (keys >> INT8_KEY_SHIFT).to(torch.float32))


def _key_gids(keys: torch.Tensor, pos: torch.Tensor, kb: int
              ) -> torch.Tensor:
    """Row ids of the keys at candidate positions ``pos`` (any shape, on
    the key axis of ``keys`` [m, B] transposed): the position's 1024-row
    block plus the key's local row id."""
    sel = torch.gather(keys.T, 1, pos)
    return (pos // kb) * ROW_BLOCK + (sel & (ROW_BLOCK - 1))


def bitpack_bucketed_topk(q: torch.Tensor, bitmat: BitMatrix, k: int,
                          bucket: int = BUCKET, row_block: int = ROW_BLOCK,
                          interpret: Optional[bool] = None,
                          approx_final: bool = False,
                          recall_target: float = 0.97
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, k] via the fused bucketed kernel, with the JAX
    package's arguments: ``row_block`` and ``interpret`` are accepted and
    unused (the kernels fold 1024-row blocks), and ``approx_final`` merges
    exactly, as the JAX package does off the TPU.

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
    return _keys_topk(_bucketed_keys(q, bitmat, bucket), k, bucket)


def _keys_topk(keys: torch.Tensor, k: int, bucket: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, min(k, m)] of kernel #3's keys [m, B]."""
    s, pos = top_k(_key_scores(keys).T, min(k, keys.shape[0]))
    return _key_gids(keys, pos, ROW_BLOCK // bucket), s


def bitpack_topk_search(q: torch.Tensor, bitmat: BitMatrix, k: int,
                        interpret: Optional[bool] = None,
                        approx: bool = False, recall_target: float = 0.97
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, k]: kernel #2 scoring + exact top-k. ``interpret``
    is accepted and unused; ``approx`` selects exactly, as the JAX package
    does off the TPU."""
    s, i = top_k(bitpack_scores(q, bitmat), k)
    return i, s


# -- the block tier: an index whose packed bits exceed the device ------------
def blockwise_route(selection: str, n: int, nnz_pad: int, k: int,
                    bucket: int, cand_budget: int) -> Tuple[str, int]:
    """(selection, candidates carried) that ``bitpack_blockwise_topk``
    runs, after the JAX package's own routes: int8 carries
    ``max(cand_budget or 2k, k)`` candidates, and goes to exact when the
    fold would leave fewer than that (``cand * bucket > n``) and to
    bucketed when ``score << 10`` could overflow the int32 key
    (``nnz_pad * 127 >= 2^21``)."""
    if selection not in ("exact", "bucketed", "bucketed_int8"):
        raise ValueError(f"unknown selection {selection!r}")
    if selection != "bucketed_int8":
        return selection, k
    cand = min(max(cand_budget or 2 * k, k), n)
    if cand * bucket > n:
        return "exact", k
    if nnz_pad * 127 >= 1 << (31 - INT8_KEY_SHIFT):
        return "bucketed", k
    return selection, cand


def merge_topk(best_s: torch.Tensor, best_i: torch.Tensor,
               s: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k of the carried best and a block's (scores, global ids),
    concatenated as [carried, block]."""
    s2, sel = top_k(torch.cat([best_s, s], dim=1), k)
    return s2, torch.gather(torch.cat([best_i, ids], dim=1), 1, sel)


def _merge_keys(scores: torch.Tensor, keys: torch.Tensor,
                best_s: torch.Tensor, best_i: torch.Tensor, width: int,
                kb: int, row0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One top-k over [B, m + width]: the block's decoded keys first,
    then the carried best; winners take their row id from the key
    (in the block) or from the carried ids."""
    m = keys.shape[0]
    s2, pos = top_k(torch.cat([scores.T, best_s], dim=1), width)
    gid = _key_gids(keys, pos.clamp_max(m - 1), kb) + row0
    carried = torch.gather(best_i, 1, (pos - m).clamp_min(0))
    return s2, torch.where(pos < m, gid, carried)


def bitpack_blockwise_topk(q: torch.Tensor, cols: torch.Tensor,
                           nnz: torch.Tensor, num_cols: int, k: int,
                           block_rows: int = 1 << 18,
                           selection: str = "bucketed",
                           bucket: int = BLOCK_BUCKET,
                           cand_budget: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, scores) [B, k] over a compact ELL (cols [n, nnz_pad] int16
    bit patterns or int32, nnz [n]) that lives where ``q`` does and whose
    packed form would not fit the device.

    Row blocks of ``block_rows`` (rounded to 1024) are packed (kernel #1)
    one at a time, so only one block's bits (1 GiB at 262,144 rows) are
    live, then scored and merged into a running best:
    - 'exact': kernel #2 and a top-k of the block, merged as
      [carried, block];
    - 'bucketed': kernel #3 at ``bucket``, the decoded keys merged as
      [block, carried] in one top-k (per block 'exact' when
      ``min(k, rows) * bucket`` exceeds the block's rows);
    - 'bucketed_int8': kernel #4 over the int8 query operand, carrying
      ``max(cand_budget or 2k, k)`` candidates, then ``exact_rerank``
      restores f32-exact scores and order (routes: ``blockwise_route``).
    The concatenation orders and the stable top-k are the JAX package's,
    so tied rows survive as they do there. The last block packs only its
    own rows (padded to 1024), where JAX pads it to the full block: the
    valid keys and their order are the same.
    """
    n, nnz_pad = cols.shape
    if n == 0:
        raise ValueError("empty index")
    block_rows = min(_round_up(block_rows, ROW_BLOCK),
                     _round_up(n, ROW_BLOCK))
    k = min(k, n)
    selection, width = blockwise_route(selection, n, nnz_pad, k, bucket,
                                       cand_budget)
    q = q.float()
    b = q.shape[0]
    vp = _round_up(num_cols, TILE_BITS)
    kb = ROW_BLOCK // bucket
    # the query operand is prepared once a batch, not once a block
    if selection == "bucketed_int8":
        q8T = prepare_queries_int8(q, vp)
    else:
        qT = _prepare_bf16(q, vp)
    best_s = torch.full((b, width), float("-inf"), device=q.device)
    best_i = torch.zeros((b, width), dtype=torch.int64, device=q.device)
    for row0 in range(0, n, block_rows):
        rows = min(block_rows, n - row0)
        words = pack_bits(widen_cols(cols[row0:row0 + rows]),
                          nnz[row0:row0 + rows].contiguous(), num_cols)
        if selection == "bucketed_int8":
            keys = int8_bucket_keys(words, q8T, rows, bucket)
            best_s, best_i = _merge_keys(_int8_key_scores(keys), keys,
                                         best_s, best_i, width, kb, row0)
        elif selection == "bucketed" and min(k, rows) * bucket <= rows:
            keys = bucket_keys(words, qT, rows, bucket)
            best_s, best_i = _merge_keys(_key_scores(keys), keys, best_s,
                                         best_i, width, kb, row0)
        else:
            s, ids = top_k(score_bits(words, qT)[:rows].T, min(k, rows))
            best_s, best_i = merge_topk(best_s, best_i, s, ids + row0, k)
    if selection == "bucketed_int8":
        ell = ELLMatrix(cols=cols, nnz=nnz, vals=None, num_cols=num_cols,
                        sentinel_padded=False)
        return exact_rerank(q, ell, best_i, k)
    return best_i, best_s
