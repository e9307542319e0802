"""CUDA kernels #1-#3 of the port against their plain PyTorch versions on
the card. They need an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a) and skip
elsewhere; ``python3 chip_smoke.py`` runs the same checks at the main
path's shapes."""
import numpy as np
import pytest
import torch

from vsearch_tpu_torch.ops import bitpack as bp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def case(dev):
    rng = np.random.default_rng(0)
    n, v, nnz_pad = 3000, 5000, 128
    nnz = rng.integers(0, nnz_pad + 1, size=n).astype(np.int32)
    cols = np.full((n, nnz_pad), v, np.int32)
    for i in range(n):
        cols[i, : nnz[i]] = rng.choice(v, size=int(nnz[i]), replace=False)
    cols[0, :4] = -1
    nnz[-1] = nnz_pad + 3
    return (torch.from_numpy(cols).to(dev), torch.from_numpy(nnz).to(dev),
            v, rng)


def test_pack_bit_identical(case):
    cols, nnz, v, _ = case
    before = bp.LAUNCHES["pack"]
    got = bp.pack_bits(cols, nnz, v)
    torch.cuda.synchronize()
    assert bp.LAUNCHES["pack"] == before + 1
    assert torch.equal(got, bp.pack_bits_plain(cols, nnz, v))


@pytest.mark.parametrize("b", [1, 7, 32, 45])
def test_scores_and_keys(case, b):
    cols, nnz, v, rng = case
    words = bp.pack_bits(cols, nnz, v)
    vp = words.shape[1] * 32
    # dyadic weights: every sum is exact in f32, so results are identical
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(words.device)
    dy[v:] = 0
    qT = dy.to(torch.bfloat16)
    assert torch.equal(bp.score_bits(words, qT),
                       bp.score_bits_plain(words, qT))
    assert torch.equal(bp.bucket_keys(words, qT, cols.shape[0]),
                       bp.bucket_keys_plain(words, qT, cols.shape[0]))
    # random weights: f32 summation order only
    qT = torch.rand((vp, b), device=words.device)
    qT[v:] = 0
    qT = qT.to(torch.bfloat16)
    torch.testing.assert_close(bp.score_bits(words, qT),
                               bp.score_bits_plain(words, qT),
                               rtol=1e-5, atol=1e-5)
