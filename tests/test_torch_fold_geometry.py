"""The launch geometry of the fold kernels (#3, #4), computed in Python and
passed to the CUDA entry points: every (1024-row block, key slot) is
folded by exactly one warp, and the grid fills the H100."""
import pytest
import torch

from vsearch_tpu_torch.ops import bitpack as bp
from vsearch_tpu_torch.ops import cuda_build

H100_WARP_SLOTS = 132 * 64  # SMs x resident warps an SM
W = 1024  # words of a row at V' = 29,523


def fold_slots(geom):
    """(1024-row block, key slot) [grid_x, warps] that warp w of CTA x
    folds, as ``fold_slot`` in bitrow.cuh maps them."""
    groups = geom.kb // geom.warps
    x = torch.arange(geom.grid[0])[:, None]
    w = torch.arange(geom.warps)[None, :]
    block = (x // groups).expand(-1, geom.warps)
    return block, (x % groups) * geom.warps + w


@pytest.mark.parametrize("b", [1, 32, 45])
@pytest.mark.parametrize("bucket", [8, 16, 128])
@pytest.mark.parametrize("rows", [1024, 3000, 1 << 18, 1 << 20, 21_015_324])
def test_every_slot_folded_once(rows, bucket, b):
    n_pad = -(-rows // bp.ROW_BLOCK) * bp.ROW_BLOCK
    geom = bp.fold_geometry(n_pad, bucket, b, W)
    kb = bp.ROW_BLOCK // bucket
    assert geom.kb == kb and geom.grid[1] == -(-b // 32)
    block, slot = fold_slots(geom)
    assert block.shape == slot.shape == (geom.grid[0], geom.warps)
    assert int(slot.min()) >= 0 and int(slot.max()) < kb
    flat = (block * kb + slot).flatten()
    assert torch.equal(flat.sort().values, torch.arange(n_pad // bucket))


@pytest.mark.parametrize("bucket", [8, 16])
def test_grid_fills_the_card_at_the_tier_block(bucket):
    """At the tiers' 262,144-row block (bucket 16: block tier, 8: stream
    tier) the kernels launch one warp a key slot, more warps than the card
    holds at once; the first port launched 2,048."""
    geom = bp.fold_geometry(1 << 18, bucket, 32, W)
    assert geom.total_warps == (1 << 18) // bucket >= H100_WARP_SLOTS


def test_query_tiles_and_refusals():
    assert bp.fold_geometry(4096, 8, 45, W).grid[1] == 2
    assert bp.fold_geometry(4096, 8, 0, W).grid[1] == 1
    with pytest.raises(ValueError):
        bp.fold_geometry(4096, 256, 32, W)  # kb = 4 < 8
    with pytest.raises(ValueError):
        bp.fold_geometry(3000, 8, 32, W)  # not padded to 1024
    with pytest.raises(ValueError):
        bp.fold_geometry(4096, 8, 1 << 15, W)  # int32 byte offsets overflow
    assert bp.fold_geometry(4096, 8, 1 << 14, W).grid[1] == 1 << 9


@pytest.mark.parametrize("name,fn", [("bucketed", bp.bucket_keys),
                                     ("int8_bucketed", bp.int8_bucket_keys)])
@pytest.mark.parametrize("n,bucket", [(5000, 16), (5000, 8), (1024, 128),
                                      (3000, 16)])
def test_wrappers_pass_the_geometry(monkeypatch, name, fn, n, bucket):
    """What a wrapper hands its C entry point, without a card: the
    arguments match the ctypes signature, and the geometry is
    ``fold_geometry``'s (#3) or ``int8_fold_geometry``'s (#4)."""
    got = {}
    monkeypatch.setattr(bp, "uses_plain", lambda *a: False)
    monkeypatch.setattr(bp, "launch",
                        lambda n, out, *args: got.update(n=n, args=args)
                        or out)
    rows, b = -(-n // bp.ROW_BLOCK) * bp.ROW_BLOCK, 45
    words = torch.zeros((rows, W), dtype=torch.int32)
    dtype = torch.bfloat16 if name == "bucketed" else torch.int8
    keys = fn(words, torch.zeros((W * 32, b), dtype=dtype), n, bucket)
    assert keys.shape == (rows // bucket, b) and got["n"] == name
    args = got["args"]
    assert len(args) + 1 == len(cuda_build.KERNELS[name].argtypes)
    geom = (bp.int8_fold_geometry if name == "int8_bucketed"
            else bp.fold_geometry)(rows, bucket, b, W)
    assert args[3:7] == (n, W, b, 64)
    assert args[7:] == geom.c_args() == (
        (bp.ROW_BLOCK // bucket, geom.grid[0]) if name == "bucketed" else
        (bp.ROW_BLOCK // bucket, 8, geom.grid[0]))


# -- kernel #4: one read of the words, the queries swept inside the warp ----
@pytest.mark.parametrize("bucket", [8, 16])
@pytest.mark.parametrize("b,lane_q,passes,lanes,groups,tiles", [
    (1, 4, 1, 8, 4, 1), (31, 4, 1, 8, 4, 1), (33, 8, 1, 8, 4, 1),
    (128, 8, 1, 16, 2, 1), (200, 8, 1, 28, 1, 1), (224, 8, 1, 28, 1, 1),
    (256, 8, 1, 32, 1, 1), (288, 8, 2, 32, 1, 1), (600, 16, 2, 32, 1, 1),
    (1024, 16, 2, 32, 1, 1), (2048, 16, 4, 32, 1, 1),
    (2100, 16, 4, 32, 1, 2)])
def test_int8_geometry(bucket, b, lane_q, passes, lanes, groups, tiles):
    """Kernel #4 at the block tier's 262,144-row block: the grid's query
    axis has one row a 2,048 queries, so up to 2,048 queries read the
    words once; a lane sums 4, 8 or 16 queries a load, a pass 32 lanes'
    worth, and the first pass's lanes times its entry groups fit a warp.
    The CTA's shared memory is its 8 decode lists of 256 offsets, and past
    one pass each warp's best keys of a grid row's queries."""
    n_pad = 1 << 18
    geom = bp.int8_fold_geometry(n_pad, bucket, b, W)
    fold = bp.fold_geometry(n_pad, bucket, b, W)
    assert geom.grid == (fold.grid[0], tiles)
    assert geom.c_args() == (bp.ROW_BLOCK // bucket, lane_q, fold.grid[0])
    assert geom.word_passes == tiles and fold.grid[1] == -(-b // 32)
    assert (geom.lane_queries, geom.passes, geom.lanes, geom.groups) == (
        lane_q, passes, lanes, groups)
    tile = min(-(-b // 32) * 32, 2048)
    assert geom.passes == -(-tile // (32 * lane_q))
    assert geom.lanes * geom.groups <= 32 < 2 * geom.lanes * geom.groups
    assert geom.lanes * lane_q == min(tile, 32 * lane_q)
    best = 8 * passes * lane_q * 32 * 4 if passes > 1 else 0
    assert geom.smem_bytes == 8 * 256 * 4 + best <= 227 * 1024
    assert geom.total_warps == (1 << 18) // bucket * tiles
    block, slot = fold_slots(geom)
    flat = (block * geom.kb + slot).flatten()
    assert torch.equal(flat.sort().values, torch.arange(n_pad // bucket))


def test_int8_geometry_refusals():
    with pytest.raises(ValueError):
        bp.int8_fold_geometry(4096, 256, 32, W)  # kb = 4 < 8
    with pytest.raises(ValueError):
        bp.int8_fold_geometry(3000, 16, 32, W)  # not padded to 1024
    with pytest.raises(ValueError):
        bp.int8_fold_geometry(4096, 16, 1 << 15, W)  # byte offsets overflow


@pytest.mark.parametrize("rows,block_rows", [(2500, 1024), (3072, 1024),
                                             (2500, 4096)])
def test_int8_word_passes_counted_once_a_block(rows, block_rows):
    """The block tier's int8 sweep (plain path) counts one read of each
    block's words in the open call record, under the span it runs in."""
    from vsearch_tpu_torch.utils.profiling import TRACER

    gen = torch.Generator().manual_seed(rows)
    cols = torch.randint(0, 300, (rows, 6), generator=gen,
                         dtype=torch.int32).to(torch.int16)
    nnz = torch.randint(1, 7, (rows,), generator=gen, dtype=torch.int32)
    q = torch.rand((3, 300), generator=gen)
    with TRACER.call("test") as call:
        with TRACER.span("launch"):
            bp.bitpack_blockwise_topk(q, cols, nnz, 300, 5,
                                      block_rows=block_rows,
                                      selection="bucketed_int8")
        counts = dict(call.rec.counts)
    assert counts == {"launch/int8_word_passes": -(-rows // block_rows)}
