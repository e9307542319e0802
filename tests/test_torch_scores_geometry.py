"""The launch geometry of the exact scorer (#2), computed in Python and
passed to the CUDA entry point: every row is scored by exactly one half
of one warp, and the grid fills the H100."""
import pytest
import torch

from vsearch_tpu_torch.ops import bitpack as bp
from vsearch_tpu_torch.ops import cuda_build

H100_WARP_SLOTS = 132 * 64  # SMs x resident warps an SM
W = 1024  # words of a row at V' = 29,523


def scored_rows(geom):
    """Row [grid_x, warps, 2] that half h of warp w of CTA x scores, as
    ``scores_kernel`` in scores.cu maps them."""
    x = torch.arange(geom.grid[0])[:, None, None]
    w = torch.arange(geom.warps)[None, :, None]
    h = torch.arange(2)[None, None, :]
    return 2 * (x * geom.warps + w) + h


@pytest.mark.parametrize("b", [1, 32, 45])
@pytest.mark.parametrize("rows", [7, 1024, 3000, 1 << 16, 1 << 18, 1 << 20])
def test_every_row_scored_once(rows, b):
    # 7 rows: score_bits takes any row count, odd ones included
    n_pad = rows if rows < bp.ROW_BLOCK else \
        -(-rows // bp.ROW_BLOCK) * bp.ROW_BLOCK
    geom = bp.score_geometry(n_pad, b, W)
    assert geom.grid[1] == -(-b // 32)
    flat = scored_rows(geom).flatten()
    assert int(flat.min()) == 0
    # only the last pair may reach past the rows, by at most one CTA
    assert int(flat.max()) < n_pad + 2 * geom.warps
    kept = flat[flat < n_pad]
    assert torch.equal(kept.sort().values, torch.arange(n_pad))


@pytest.mark.parametrize("rows", [1 << 16, 1 << 18])
def test_grid_fills_the_card(rows):
    """One warp a row pair: 32,768 warps at path (b)'s 65,536 rows and
    131,072 at the tiers' 262,144-row block, more than the card holds at
    once; the first port launched one warp a row in CTAs of 8."""
    geom = bp.score_geometry(rows, 32, W)
    assert geom.total_warps == rows // 2 >= H100_WARP_SLOTS


def test_query_tiles_and_refusals():
    assert bp.score_geometry(4096, 45, W).grid == (256, 2)
    assert bp.score_geometry(4096, 0, W).grid[1] == 1
    with pytest.raises(ValueError):
        bp.score_geometry(4096, 1 << 15, W)  # int32 byte offsets overflow
    assert bp.score_geometry(4096, 1 << 14, W).grid[1] == 1 << 9
    with pytest.raises(ValueError):
        bp.score_geometry(4096, 32, 1 << 20)  # one tile, wider rows


@pytest.fixture
def captured(monkeypatch):
    """What a wrapper hands its C entry point, without a card."""
    got = {}
    monkeypatch.setattr(bp, "uses_plain", lambda *a: False)
    monkeypatch.setattr(bp, "launch",
                        lambda n, out, *args: got.update(n=n, args=args)
                        or out)
    return got


@pytest.mark.parametrize("b", [1, 32, 45])
@pytest.mark.parametrize("rows", [7, 1024, 3072])
def test_score_bits_passes_the_geometry(captured, rows, b):
    """The arguments match the ctypes signature, and the geometry is
    ``score_geometry``'s."""
    words = torch.zeros((rows, W), dtype=torch.int32)
    out = bp.score_bits(words, torch.zeros((W * 32, b),
                                           dtype=torch.bfloat16))
    assert out.shape == (rows, b) and out.dtype == torch.float32
    assert captured["n"] == "scores"
    args = captured["args"]
    assert len(args) + 1 == len(cuda_build.KERNELS["scores"].argtypes)
    geom = bp.score_geometry(rows, b, W)
    assert args[3:7] == (rows, W, b, -(-b // 32) * 32)
    assert args[7:] == geom.c_args() == (geom.grid[0],)


def test_score_bits_refuses_what_the_kernel_cannot_read(captured):
    """Rows are read in 512-byte chunks: a width that is not a multiple
    of 128 words is refused before any launch."""
    words = torch.zeros((1024, 100), dtype=torch.int32)
    with pytest.raises(ValueError):
        bp.score_bits(words, torch.zeros((3200, 4), dtype=torch.bfloat16))
    assert "n" not in captured
