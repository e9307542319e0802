"""The benchmark's arithmetic against counts made by hand."""
import numpy as np
import pytest

from benchmark import blocks, flops

BERT = {"hidden_size": 768, "num_hidden_layers": 12,
        "intermediate_size": 3072}


def test_encoder_forward_by_hand():
    # one 10-token text: per token 12 * (8*768^2 + 4*768*3072 + 4*10*768)
    # + 2*768*29523
    per = 12 * (4_718_592 + 9_437_184 + 30_720) + 45_347_328
    assert flops.encoder_forward_flops(10, BERT, 29523) == 10 * per


def test_k3_bound_by_hand():
    # 1,000 rows of 29,523 bits: 3,690,375 B of words; bf16 operand of 4
    # queries 236,184 B; keys ceil(1000/8) = 125 x 4 queries x 4 B
    nbytes = 1000 * 29523 / 8 + 29523 * 4 * 2 + 125 * 4 * 4
    assert flops.k3_bucketed_s(1000, 5000, 4, 29523) == pytest.approx(
        nbytes / 3.35e12)
    # operations bind when a row has many bits and many queries come
    assert flops.k3_bucketed_s(1, 10 ** 9, 1000, 8) == pytest.approx(
        10 ** 12 / 67e12)


def test_k4_and_k1_bounds_by_hand():
    assert flops.k4_int8_bucketed_s(1600, 100, 2, 64) == pytest.approx(
        (1600 * 8 + 64 * 2 + 100 * 2 * 4) / 3.35e12)
    assert flops.k1_pack_s(10, 70, 64, 4) == pytest.approx(
        (70 * 4 + 10 * 4 + 10 * 8) / 3.35e12)


def test_share_and_blocks():
    assert flops.share(1.0, 4.0) == 25.0 and flops.share(1.0, 0.0) is None
    nnz = np.array([3, 4, 5, 6, 7], dtype=np.int32)
    assert blocks.block_sizes(nnz, 2) == [(2, 7), (2, 11), (1, 7)]
