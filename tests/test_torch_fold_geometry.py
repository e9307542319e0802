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
    ``fold_geometry``'s."""
    got = {}
    monkeypatch.setattr(bp, "_uses_plain", lambda *a: False)
    monkeypatch.setattr(bp, "_launch",
                        lambda n, out, *args: got.update(n=n, args=args)
                        or out)
    rows, b = -(-n // bp.ROW_BLOCK) * bp.ROW_BLOCK, 45
    words = torch.zeros((rows, W), dtype=torch.int32)
    dtype = torch.bfloat16 if name == "bucketed" else torch.int8
    keys = fn(words, torch.zeros((W * 32, b), dtype=dtype), n, bucket)
    assert keys.shape == (rows // bucket, b) and got["n"] == name
    args = got["args"]
    assert len(args) + 1 == len(cuda_build._SIGNATURES[name][1])
    geom = bp.fold_geometry(rows, bucket, b, W)
    assert args[3:7] == (n, W, b, 64)
    assert args[7:] == geom.c_args() == (bp.ROW_BLOCK // bucket,
                                         geom.grid[0])
