"""Port parity: the bit-packed first stage of ``vsearch_tpu_torch`` (plain
PyTorch versions of kernels #1-#3 on the CPU) against the JAX package's
Pallas kernels in interpret mode and its C++ host packer."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsearch_tpu.ops import bitpack as jb
from vsearch_tpu.ops.ell import ELLMatrix as JELL
from vsearch_tpu_torch.ops import bitpack as tb
from vsearch_tpu_torch.ops.ell import ELLMatrix as TELL

# random query weights: both sides sum the same bf16 terms in f32, in
# another order, so scores agree to a few f32 ulps of their magnitude
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def ragged_ell(rng, n, v, nnz_pad):
    """Ragged rows: random nnz, sentinel pads, a negative column, a row
    whose nnz exceeds nnz_pad."""
    nnz = rng.integers(0, nnz_pad + 1, size=n).astype(np.int32)
    nnz = np.minimum(nnz, v)
    cols = np.full((n, nnz_pad), v, np.int32)
    for i in range(n):
        cols[i, : nnz[i]] = rng.choice(v, size=int(nnz[i]), replace=False)
    cols[0, :3] = -1
    nnz[-1] = nnz_pad + 9
    return cols, nnz


def both(cols, nnz, v):
    j = JELL(cols=jnp.asarray(cols), nnz=jnp.asarray(nnz), vals=None,
             num_cols=v)
    t = TELL.from_arrays(cols, nnz, None, v, True, device="cpu")
    return j, t


def words_u32(bm):
    return bm.words.numpy().view(np.uint32)


@pytest.mark.parametrize("n,v,nnz_pad", [(7, 300, 128), (1100, 300, 128),
                                         (3, 4097, 256)])
def test_pack_bit_identical(rng, n, v, nnz_pad):
    cols, nnz = ragged_ell(rng, n, v, nnz_pad)
    j, t = both(cols, nnz, v)
    got = tb.pack_ell(t)
    assert got.words.shape[0] % tb.ROW_BLOCK == 0
    assert (got.num_rows, got.num_cols) == (n, v)
    np.testing.assert_array_equal(
        words_u32(got), np.asarray(jb.pack_ell_device(j, interpret=True)
                                   .words))
    # the JAX host packer reads past the row when nnz > nnz_pad (logged in
    # ROADMAP queue 3); with nnz clipped it must agree bit for bit too
    np.testing.assert_array_equal(
        words_u32(got), np.asarray(jb.pack_ell_host(
            cols, np.minimum(nnz, nnz_pad), v).words))


def test_prepare_queries_rounds_like_jax(rng):
    q = rng.normal(size=(3, 300)).astype(np.float32)
    bm = tb.pack_ell(both(*ragged_ell(rng, 5, 300, 128), 300)[1])
    got = tb.prepare_queries(torch.from_numpy(q), bm).float().numpy()
    want = np.asarray(jb.prepare_queries(
        jnp.asarray(q), jb.BitMatrix(words=jnp.zeros(
            (1024, 128), jnp.uint32), num_rows=5, num_cols=300)),
        dtype=np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def packed(rng):
    """2,100 ragged rows at V=420: n not a multiple of 1024, enough rows
    that k * bucket < n takes the bucketed route."""
    v = 420
    cols, nnz = ragged_ell(rng, 2100, v, 128)
    nnz = np.minimum(nnz, 40)  # BoT-like sparsity
    j, t = both(cols, nnz, v)
    return (jb.pack_ell_device(j, interpret=True), tb.pack_ell(t), v)


def test_scores_match(rng, packed):
    jbm, tbm, v = packed
    q = np.abs(rng.normal(size=(5, v))).astype(np.float32)
    want = np.asarray(jb.bitpack_scores(jnp.asarray(q), jbm, interpret=True))
    got = tb.bitpack_scores(torch.from_numpy(q), tbm).numpy()
    assert got.shape == want.shape == (5, 2100)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


def dyadic(rng, shape):
    """Multiples of 1/16 up to 8: exact in bf16, and every sum of up to a
    few hundred of them is exact in f32 whatever the order."""
    return (rng.integers(0, 129, size=shape) / 16.0).astype(np.float32)


def test_bucketed_keys_bit_identical_dyadic(rng, packed):
    jbm, tbm, v = packed
    q = dyadic(rng, (4, v))
    want = np.asarray(jb._bucketed_keys(jnp.asarray(q), jbm, jb.BUCKET,
                                        jb.ROW_BLOCK, True))
    got = tb._bucketed_keys(torch.from_numpy(q), tbm).numpy()
    assert got.shape == want.shape == (3072 // 8, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weights", ["dyadic", "random"])
def test_bucketed_topk_ids(rng, packed, weights):
    jbm, tbm, v = packed
    q = (dyadic(rng, (4, v)) if weights == "dyadic"
         else np.abs(rng.normal(size=(4, v))).astype(np.float32))
    k = 20  # k * bucket = 160 < 2,100 rows: the bucketed route
    ids_j, s_j = jb.bitpack_bucketed_topk(jnp.asarray(q), jbm, k=k,
                                          interpret=True)
    ids_t, s_t = tb.bitpack_bucketed_topk(torch.from_numpy(q), tbm, k=k)
    # decoded scores carry the low-10-bit splice; random weights may move
    # one ulp across it, so they compare to one quantum (2^-13 relative)
    tol = 0 if weights == "dyadic" else 2.0 ** -12
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=tol,
                               atol=0)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))


def test_exact_topk_and_fallback(rng, packed):
    jbm, tbm, v = packed
    q = dyadic(rng, (3, v))
    for fn_j, fn_t, k in (
            (jb.bitpack_topk_search, tb.bitpack_topk_search, 30),
            # k * bucket > rows: the exact fallback
            (jb.bitpack_bucketed_topk, tb.bitpack_bucketed_topk, 300)):
        ids_j, s_j = fn_j(jnp.asarray(q), jbm, k=k, interpret=True)
        ids_t, s_t = fn_t(torch.from_numpy(q), tbm, k=k)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for a CPU tensor; anything
    else launches the kernel or raises."""
    meta = torch.empty((4, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tb.pack_bits(meta, torch.empty(4, dtype=torch.int32,
                                       device="meta"), 300)
    with pytest.raises(ValueError):
        tb.score_bits(meta, torch.empty((4096, 2), dtype=torch.bfloat16,
                                        device="meta"))
    with pytest.raises(ValueError):
        tb.bucket_keys(meta, torch.empty((4096, 2), dtype=torch.bfloat16,
                                         device="meta"), 4)
