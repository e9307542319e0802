"""Port parity: vocab-space primitives, ELL containers and dense top-k of
``vsearch_tpu_torch.ops`` against ``vsearch_tpu.ops`` on the same numpy
inputs (CPU)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from vsearch_tpu.ops import activations as j_act
from vsearch_tpu.ops import ell as j_ell
from vsearch_tpu.ops import search as j_search
from vsearch_tpu.ops import sparse as j_sparse
from vsearch_tpu_torch.ops import activations as t_act
from vsearch_tpu_torch.ops import ell as t_ell
from vsearch_tpu_torch.ops import search as t_search
from vsearch_tpu_torch.ops import sparse as t_sparse

# f32 elementwise and gather-reduce sums: the two packages may add in
# another order, so agreement is to f32 rounding of O(1) values
TOL = dict(rtol=1e-5, atol=1e-5)


def test_elu1p(rng):
    x = rng.normal(size=(4, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(t_act.elu1p(torch.from_numpy(x)).numpy(),
                               np.asarray(j_act.elu1p(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("k", [1, 7, 40, 100])
def test_topk_mask_and_sparsify(rng, k):
    x = rng.normal(size=(3, 40)).astype(np.float32)
    m_t = t_sparse.build_topk_mask(torch.from_numpy(x), k=k).numpy()
    m_j = np.asarray(j_sparse.build_topk_mask(jnp.asarray(x), k=k))
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(
        t_sparse.topk_sparsify(torch.from_numpy(x), k).numpy(),
        np.asarray(j_sparse.topk_sparsify(jnp.asarray(x), k)))


@pytest.mark.parametrize("shift,norm", [(0, False), (5, False), (5, True)])
def test_bow_mask(rng, shift, norm):
    ids = rng.integers(0, 50, size=(4, 12)).astype(np.int32)
    got = t_sparse.build_bow_mask(torch.from_numpy(ids), vocab_size=50,
                                  shift_num=shift, norm=norm).numpy()
    want = np.asarray(j_sparse.build_bow_mask(
        jnp.asarray(ids), vocab_size=50, shift_num=shift, norm=norm))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def sparse_case(rng):
    dense = rng.random((37, 90)).astype(np.float32)
    dense[dense < 0.8] = 0
    q = rng.normal(size=(3, 90)).astype(np.float32)
    return dense, q


@pytest.mark.parametrize("binary", [False, True])
def test_ell_from_dense_and_scipy(sparse_case, binary):
    dense, _ = sparse_case
    for t_m, j_m in (
            (t_ell.ELLMatrix.from_dense(dense, binary=binary, device="cpu"),
             j_ell.ELLMatrix.from_dense(dense, binary=binary)),
            (t_ell.ELLMatrix.from_scipy_csr(sp.csr_matrix(dense),
                                            binary=binary, device="cpu"),
             j_ell.ELLMatrix.from_scipy_csr(sp.csr_matrix(dense),
                                            binary=binary))):
        np.testing.assert_array_equal(t_m.cols.numpy(), np.asarray(j_m.cols))
        np.testing.assert_array_equal(t_m.nnz.numpy(), np.asarray(j_m.nnz))
        assert (t_m.vals is None) == (j_m.vals is None) == binary
        if not binary:
            np.testing.assert_array_equal(t_m.vals.numpy(),
                                          np.asarray(j_m.vals))
        np.testing.assert_array_equal(t_m.to_scipy_csr().toarray(),
                                      j_m.to_scipy_csr().toarray())
        part_t, part_j = t_m.slice_rows(5, 11), j_m.slice_rows(5, 11)
        np.testing.assert_array_equal(part_t.cols.numpy(),
                                      np.asarray(part_j.cols))


@pytest.mark.parametrize("binary,sentinel", [(False, True), (True, True),
                                             (True, False)])
def test_ell_matvec(sparse_case, binary, sentinel):
    dense, q = sparse_case
    j_m = j_ell.ELLMatrix.from_dense(dense, binary=binary)
    if not sentinel:  # pad with column 0 and rely on the nnz mask
        cols = np.asarray(j_m.cols).copy()
        cols[cols == dense.shape[1]] = 0
        j_m = j_ell.ELLMatrix(cols=jnp.asarray(cols), nnz=j_m.nnz,
                              vals=j_m.vals, num_cols=j_m.num_cols)
    t_m = t_ell.ELLMatrix.from_arrays(
        np.asarray(j_m.cols), np.asarray(j_m.nnz),
        None if binary else np.asarray(j_m.vals), j_m.num_cols, sentinel,
        device="cpu")
    want = np.asarray(j_ell.ell_matvec_scores(jnp.asarray(q), j_m))
    got = t_ell.ell_matvec_scores(torch.from_numpy(q), t_m).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    got_c = t_ell.ell_matvec_chunked(torch.from_numpy(q), t_m,
                                     chunk_rows=8).numpy()
    np.testing.assert_allclose(got_c, want, **TOL)


def test_ell_from_topk(rng):
    vals = np.abs(rng.normal(size=(5, 9))).astype(np.float32)
    vals[:, 6:] = 0
    cols = rng.integers(0, 50, size=(5, 9)).astype(np.int32)
    cols[:, 6:] = 50
    t_m = t_ell.ell_from_topk(cols, vals, 50, device="cpu")
    j_m = j_ell.ell_from_topk(cols, vals, 50)
    np.testing.assert_array_equal(t_m.cols.numpy(), np.asarray(j_m.cols))
    np.testing.assert_array_equal(t_m.nnz.numpy(), np.asarray(j_m.nnz))
    np.testing.assert_array_equal(t_m.vals.numpy(), np.asarray(j_m.vals))


def test_dense_topk_search(rng):
    vec = rng.normal(size=(50, 24)).astype(np.float32)
    q = rng.normal(size=(3, 24)).astype(np.float32)
    ids_j, s_j = j_search.dense_topk_search(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(vec, jnp.bfloat16), 6)
    ids_t, s_t = t_search.dense_topk_search(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(vec).bfloat16(), 6)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)


def test_top_k_breaks_ties_like_lax(rng):
    """Bag-of-token scores tie often; the port keeps JAX's lower-index-
    first order so both packages return the same ids."""
    x = rng.integers(0, 4, size=(6, 200)).astype(np.float32)
    s_j, i_j = jax.lax.top_k(jnp.asarray(x), 50)
    s_t, i_t = t_search.top_k(torch.from_numpy(x), 50)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
