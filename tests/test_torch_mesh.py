"""Port parity of the mesh: sharded index search and the sharded rerank of
``vsearch_tpu_torch`` against the JAX package on the same numpy inputs.

JAX runs on its 8-device virtual CPU mesh (``tests/conftest.py``), with
Pallas in interpret mode; the port runs 8 virtual ``cpu`` shards
(``make_mesh(devices=["cpu"] * 8)``) and the kernels' plain twins. Each
test mirrors one of the JAX package's own mesh tests
(``test_index_mesh.py``, ``test_sharded_search.py``,
``test_bitpack_sharded.py``, ``test_collectives.py``,
``test_sharded_rerank.py``, ``test_tp_equivalence.py``) and holds the
port to the JAX package's sharded answer: f32 exact paths at rtol 1e-5,
ids equal where scores are distinct, the JAX tests' own tolerances
elsewhere."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from tests.helpers import make_tokenizer
from vsearch_tpu.index import BoTIndex as JBoT
from vsearch_tpu.index import DenseIndex as JDense
from vsearch_tpu.index import SparseIndex as JSparse
from vsearch_tpu.ops.bitpack import pack_dense as j_pack_dense
from vsearch_tpu.ops.ell import ELLMatrix as JELL
from vsearch_tpu.ops.ell import ell_matvec_chunked as j_matvec
from vsearch_tpu.parallel import sharded_search as jss
from vsearch_tpu.parallel.mesh import make_mesh as j_make_mesh
from vsearch_tpu_torch.index import BoTIndex, DenseIndex, SparseIndex
from vsearch_tpu_torch.ops.bitpack import pack_ell
from vsearch_tpu_torch.ops.ell import ELLMatrix, ell_matvec_chunked
from vsearch_tpu_torch.parallel import sharded_search as tss
from vsearch_tpu_torch.parallel.collectives import (all_gather_objects,
                                                    differentiable_all_gather,
                                                    get_rank,
                                                    get_world_size,
                                                    is_master)
from vsearch_tpu_torch.parallel.mesh import make_mesh

EXACT = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8
    return j_make_mesh(dp=8, tp=1), make_mesh(devices=["cpu"] * 8)


def ids_agree(a_ids, a_s, b_ids, b_s, tol=1e-5):
    """Ids equal wherever the score is not tied with a neighbour."""
    a_ids, b_ids = np.asarray(a_ids), np.asarray(b_ids)
    a_s = np.asarray(a_s, np.float64)
    for q in range(a_ids.shape[0]):
        for j in np.nonzero(a_ids[q] != b_ids[q])[0]:
            tied = np.abs(a_s[q] - a_s[q, j]) <= tol * max(
                np.abs(a_s[q]).max(), 1e-6)
            assert tied.sum() > 1, (q, j, a_ids[q], b_ids[q])


def t_ell(cols, nnz, vals, v, sentinel):
    return ELLMatrix.from_arrays(cols, nnz, vals, v, sentinel, "cpu")


# -- test_index_mesh.py ------------------------------------------------------
def test_dense_index_to_mesh(meshes, rng):
    jm, tm = meshes
    vecs = rng.normal(size=(500, 48)).astype(np.float32)
    q = rng.normal(size=(3, 48)).astype(np.float32)
    j = JDense(dtype=np.float32)
    j.set_vectors(vecs)
    j.to_mesh(jm)
    t = DenseIndex(dtype=torch.float32, device="cpu")
    t.set_vectors(vecs)
    before = t.search(q, k=6)
    t.to_mesh(tm)
    after, want = t.search(q, k=6), j.search(q, k=6)
    np.testing.assert_array_equal(after.ids, before.ids)
    np.testing.assert_array_equal(after.ids, want.ids)
    np.testing.assert_allclose(after.scores, want.scores, **EXACT)
    assert len(t) == 500 and t._shards.parts[0]._base is t.vector


def test_sparse_index_to_mesh(meshes, rng):
    jm, tm = meshes
    mat = sp.random(300, 120, density=0.1, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(21))
    mat.data[:] = np.abs(mat.data)
    q = np.abs(rng.normal(size=(2, 120))).astype(np.float32)
    j = JSparse(search_mode="exact", val_dtype=jnp.float32)
    j.set_vectors(mat)
    j.to_mesh(jm)
    t = SparseIndex(search_mode="exact", device="cpu")
    t.set_vectors(mat)
    before = t.search(q, k=5)
    t.to_mesh(tm)
    after, want = t.search(q, k=5), j.search(q, k=5)
    np.testing.assert_array_equal(after.ids, before.ids)
    np.testing.assert_array_equal(after.ids, want.ids)
    np.testing.assert_allclose(after.scores, want.scores, **EXACT)


def test_bot_index_to_mesh(meshes, rng):
    jm, tm = meshes
    mat = sp.random(250, 90, density=0.15, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(22))
    mat.data[:] = 1.0
    q = np.abs(rng.normal(size=(2, 90))).astype(np.float32)
    j = JBoT(search_mode="exact")
    j.set_vectors(mat)
    j.to_mesh(jm)
    t = BoTIndex(search_mode="exact", device="cpu")
    t.set_vectors(mat)
    before = t.search(q, k=4)
    t.to_mesh(tm)
    assert t._mesh_kind == "ell"
    after, want = t.search(q, k=4), j.search(q, k=4)
    np.testing.assert_array_equal(after.ids, before.ids)
    ids_agree(want.ids, want.scores, after.ids, after.scores)
    np.testing.assert_allclose(after.scores, want.scores, **EXACT)


def _block_rows(seed, n, v, width, lo, hi, sort=True):
    g = np.random.default_rng(seed)
    cols = np.stack([g.choice(v, size=width, replace=False)
                     for _ in range(n)]).astype(np.int32)
    if sort:
        cols = np.sort(cols, axis=1)
    nnz = g.integers(lo, hi, size=n).astype(np.int32)
    return g, cols, nnz


def test_bot_block_tier_to_mesh(meshes):
    """search_mode='block' under a mesh shards the compact ELL (int16 bit
    patterns of the JAX package's uint16) and scores blockwise per
    shard; the answer equals the JAX package's sharded one, and a reload
    drops the sharded state."""
    jm, tm = meshes
    n, v = 330, 400
    g, cols, nnz = _block_rows(33, n, v, 8, 3, 9)
    q = np.abs(g.normal(size=(3, v))).astype(np.float32)
    j = JBoT(search_mode="block")
    j.stream_block_rows = 64
    j.set_ell(JELL(cols=cols, nnz=nnz, vals=None, num_cols=v,
                   sentinel_padded=False), host_cache=(cols, nnz))
    j.to_mesh(jm)
    want = j.search(q, k=7)

    ref = BoTIndex(search_mode="exact", device="cpu")
    ref.set_ell(t_ell(cols, nnz, None, v, False))
    before = ref.search(q, k=7)
    t = BoTIndex(search_mode="block", device="cpu")
    t.stream_block_rows = 64
    t.set_ell(t_ell(cols, nnz, None, v, False))
    t.to_mesh(tm)
    assert t._mesh_ell is not None and t._mesh_kind == "block"
    assert t._mesh_ell.local().cols.dtype == torch.int16  # v <= 65535
    after = t.search(q, k=7)
    ids_agree(want.ids, want.scores, after.ids, after.scores)
    np.testing.assert_allclose(after.scores, want.scores, **EXACT)
    # the exact gather scores f32 queries, the bit-packed sweep bf16 ones
    np.testing.assert_allclose(np.sort(after.scores, axis=1),
                               np.sort(before.scores, axis=1),
                               rtol=2e-2, atol=1e-4)
    np.testing.assert_array_equal(np.sort(after.ids, axis=1)[:, -3:],
                                  np.sort(before.ids, axis=1)[:, -3:])

    t.set_ell(t_ell(cols[:80], nnz[:80], None, v, False))
    assert t._mesh_ell is None and t._mesh is None
    res = t.search(q, k=5)
    assert res.ids.max() < 80


def test_bot_stream_mode_to_mesh_uses_blockwise(meshes):
    """search_mode='stream' + mesh routes to the sharded block tier."""
    jm, tm = meshes
    n, v = 150, 300
    g, cols, nnz = _block_rows(34, n, v, 6, 2, 7, sort=False)
    q = np.abs(g.normal(size=(2, v))).astype(np.float32)
    j = JBoT(search_mode="stream")
    j.set_ell(JELL(cols=cols, nnz=nnz, vals=None, num_cols=v,
                   sentinel_padded=False), host_cache=(cols, nnz))
    j.to_mesh(jm)
    want = j.search(q, k=4)
    t = BoTIndex(search_mode="stream", device="cpu")
    t.set_ell(t_ell(cols, nnz, None, v, False))
    t.to_mesh(tm)
    assert t._mesh_ell is not None
    assert t._oversize_tier() is None  # the mesh owns the rows now
    res = t.search(q, k=4)
    assert res.ids.shape == (2, 4) and res.ids.max() < n
    ids_agree(want.ids, want.scores, res.ids, res.scores)
    np.testing.assert_allclose(res.scores, want.scores, **EXACT)


# -- test_sharded_search.py --------------------------------------------------
def _dense_both(meshes, vecs, q, k, n):
    jm, tm = meshes
    jf = jss.make_sharded_dense_search(jm, k=k, num_rows=n)
    j_ids, j_s = jf(jnp.asarray(q), jss.shard_rows(jm, jnp.asarray(vecs)))
    tf = tss.make_sharded_dense_search(tm, k=k, num_rows=n)
    t_ids, t_s = tf(torch.from_numpy(q),
                    tss.shard_rows(tm, torch.from_numpy(vecs)))
    return np.asarray(j_ids), np.asarray(j_s), t_ids.numpy(), t_s.numpy()


def test_sharded_dense_matches_single(meshes, rng):
    n, d, b, k = 1000, 64, 4, 10
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    sh = tss.shard_rows(meshes[1], torch.from_numpy(vecs))
    assert sh.padded_rows == 1000 and sh.rows_per == 125
    j_ids, j_s, t_ids, t_s = _dense_both(meshes, vecs, q, k, n)
    expect = np.argsort(-(q @ vecs.T), axis=1)[:, :k]
    np.testing.assert_array_equal(t_ids, expect)
    # the JAX package's sharded dense search takes Precision.DEFAULT
    # (bf16 passes on the CPU too), so its scores are held at bf16's step
    ids_agree(t_ids, t_s, j_ids, j_s, tol=2e-2)
    np.testing.assert_allclose(t_s, j_s, rtol=2e-2, atol=5e-2)
    np.testing.assert_allclose(
        t_s, np.take_along_axis(q @ vecs.T, expect, 1), **EXACT)


def test_sharded_dense_with_padding(meshes, rng):
    """Padding rows never surface, even when every real score is negative
    (zero pad rows would otherwise win)."""
    n, d, b, k = 997, 32, 3, 7
    vecs = rng.normal(size=(n, d)).astype(np.float32) - 4.0
    q = np.abs(rng.normal(size=(b, d)).astype(np.float32)) + 0.5
    assert (q @ vecs.T).max() < 0
    sh = tss.shard_rows(meshes[1], torch.from_numpy(vecs))
    assert sh.padded_rows % 8 == 0 and sh.parts[-1].shape[0] == sh.rows_per
    j_ids, j_s, t_ids, t_s = _dense_both(meshes, vecs, q, k, n)
    assert t_ids.max() < n
    expect = np.argsort(-(q @ vecs.T), axis=1)[:, :k]
    np.testing.assert_array_equal(t_ids, expect)
    np.testing.assert_array_equal(t_ids, j_ids)


def _ell_both(meshes, mat, q, k, n, binary=False, chunk=100):
    jm, tm = meshes
    j_sh = jss.shard_ell(jm, JELL.from_scipy_csr(mat, binary=binary))
    jf = jss.make_sharded_ell_search(
        jm, k=k, ell_template=j_sh, num_rows=n,
        score_fn=lambda qq, s: j_matvec(qq, s, chunk_rows=chunk))
    j_ids, j_s = jf(jnp.asarray(q), j_sh)
    t_sh = tss.shard_ell(tm, ELLMatrix.from_scipy_csr(mat, binary=binary,
                                                      device="cpu"))
    tf = tss.make_sharded_ell_search(
        tm, k=k, ell_template=t_sh, num_rows=n,
        score_fn=lambda qq, s: ell_matvec_chunked(qq, s, chunk_rows=chunk))
    t_ids, t_s = tf(torch.from_numpy(q), t_sh)
    return np.asarray(j_ids), np.asarray(j_s), t_ids.numpy(), t_s.numpy()


def test_sharded_ell_with_padding_negative_scores(meshes, rng):
    n, v, k = 777, 160, 9
    mat = sp.random(n, v, density=0.08, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(21))
    mat.data[:] = -np.abs(mat.data) - 0.1
    q = np.abs(rng.normal(size=(3, v))).astype(np.float32) + 0.1
    exact = q @ mat.toarray().T
    assert exact.max() < 0
    j_ids, j_s, t_ids, t_s = _ell_both(meshes, mat, q, k, n)
    assert t_ids.max() < n
    for i in range(3):
        np.testing.assert_array_equal(t_ids[i], np.argsort(-exact[i])[:k])
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_s, j_s, **EXACT)


def test_sharded_ell_matches_single(meshes, rng):
    mat = sp.random(800, 200, density=0.08, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(11))
    mat.data[:] = np.abs(mat.data)
    q = np.abs(rng.normal(size=(3, 200))).astype(np.float32)
    j_ids, j_s, t_ids, t_s = _ell_both(meshes, mat, q, 9, 800)
    exact = q @ mat.toarray().T
    for i in range(3):
        np.testing.assert_array_equal(t_ids[i], np.argsort(-exact[i])[:9])
        np.testing.assert_allclose(t_s[i], np.sort(exact[i])[::-1][:9],
                                   **EXACT)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_s, j_s, **EXACT)


def test_sharded_ell_binary(meshes, rng):
    mat = sp.random(640, 150, density=0.1, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(12))
    mat.data[:] = 1.0
    q = np.abs(rng.normal(size=(2, 150))).astype(np.float32)
    j_ids, j_s, t_ids, t_s = _ell_both(meshes, mat, q, 5, 640, binary=True,
                                       chunk=80)
    exact = q @ mat.toarray().T
    for i in range(2):
        np.testing.assert_array_equal(t_ids[i], np.argsort(-exact[i])[:5])
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_s, j_s, **EXACT)


# -- test_bitpack_sharded.py -------------------------------------------------
def test_sharded_bitpack_matches_single(meshes, rng):
    jm, tm = meshes
    mat = sp.random(300, 200, density=0.12, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(41))
    mat.data[:] = 1.0
    q = np.abs(rng.normal(size=(3, 200))).astype(np.float32)
    j = JBoT(search_mode="bitpack")
    j.set_vectors(mat)
    j.to_mesh(jm)
    want = j.search(q, k=6)
    single = BoTIndex(search_mode="bitpack", device="cpu")
    single.set_vectors(mat)
    res1 = single.search(q, k=6)
    t = BoTIndex(search_mode="bitpack", device="cpu")
    t.set_vectors(mat)
    t.to_mesh(tm)
    assert t._mesh_kind == "bits"
    assert t._shards.padded_rows % (8 * 1024) == 0
    res2 = t.search(q, k=6)
    exact = q @ mat.toarray().T
    for i in range(3):
        np.testing.assert_allclose(np.sort(res2.scores[i])[::-1],
                                   np.sort(exact[i])[::-1][:6],
                                   rtol=5e-3, atol=0.05)
        assert (res2.ids[i] < 300).all() and (res2.ids[i] >= 0).all()
    # both sides take bf16 queries and exact selection per shard
    np.testing.assert_array_equal(res2.ids, res1.ids)
    np.testing.assert_array_equal(res2.scores, res1.scores)
    np.testing.assert_array_equal(res2.ids, want.ids)
    np.testing.assert_allclose(res2.scores, want.scores, **EXACT)


def test_sharded_bucketed_guard_large_k(meshes, rng):
    """k * BUCKET > rows_per falls back to exact per-shard selection
    instead of a crashing merge or lost recall."""
    jm, tm = meshes
    n, v, k = 2000, 256, 300
    dense = (rng.random((n, v)) < 0.1).astype(np.float32)
    q = np.abs(rng.normal(size=(2, v))).astype(np.float32)
    j_bm = jss.shard_bitmat(jm, j_pack_dense(dense))
    j_ids, j_s = jss.make_sharded_bitpack_search(
        jm, k=k, bitmat=j_bm, selection="bucketed")(jnp.asarray(q), j_bm)
    bm = tss.shard_bitmat(tm, pack_ell(ELLMatrix.from_dense(
        dense, binary=True, device="cpu")))
    ids, scores = tss.make_sharded_bitpack_search(
        tm, k=k, bitmat=bm, selection="bucketed")(torch.from_numpy(q), bm)
    ids, scores = ids.numpy(), scores.numpy()
    assert np.isfinite(scores).all() and (ids < n).all()
    exact = q @ dense.T
    for i in range(2):
        assert len(set(ids[i].tolist())) == k
        np.testing.assert_allclose(np.sort(scores[i])[::-1],
                                   np.sort(exact[i])[::-1][:k],
                                   rtol=8e-3, atol=0.05)
    ids_agree(np.asarray(j_ids), np.asarray(j_s), ids, scores)
    np.testing.assert_allclose(scores, np.asarray(j_s), **EXACT)


def test_sharded_bitpack_k_exceeds_rows_raises(meshes, rng):
    jm, tm = meshes
    dense = (rng.random((100, 128)) < 0.1).astype(np.float32)
    j_bm = jss.shard_bitmat(jm, j_pack_dense(dense))
    with pytest.raises(ValueError, match="exceeds index rows"):
        jss.make_sharded_bitpack_search(jm, k=101, bitmat=j_bm)
    bm = tss.shard_bitmat(tm, pack_ell(ELLMatrix.from_dense(
        dense, binary=True, device="cpu")))
    with pytest.raises(ValueError, match="exceeds index rows"):
        tss.make_sharded_bitpack_search(tm, k=101, bitmat=bm)


def test_sharded_blockwise_guards(meshes, rng):
    """k > rows and real-valued ELLs are refused; padding rows never
    surface."""
    jm, tm = meshes
    n, v = 90, 256
    cols = np.stack([rng.choice(v, size=5, replace=False)
                     for _ in range(n)]).astype(np.int32)
    nnz = np.full(n, 5, np.int32)
    ell = tss.shard_ell(tm, t_ell(cols, nnz, None, v, False))
    with pytest.raises(ValueError, match="exceeds index rows"):
        tss.make_sharded_blockwise_search(tm, k=91, num_rows=n,
                                          ell_template=ell)
    ell_v = tss.shard_ell(tm, t_ell(cols, nnz, np.ones((n, 5), np.float32),
                                    v, False))
    with pytest.raises(ValueError, match="binary"):
        tss.make_sharded_blockwise_search(tm, k=5, num_rows=n,
                                          ell_template=ell_v)
    q = np.abs(rng.normal(size=(2, v))).astype(np.float32)
    ids, scores = tss.make_sharded_blockwise_search(
        tm, k=80, num_rows=n, ell_template=ell, block_rows=16,
        selection="exact")(torch.from_numpy(q), ell)
    ids = ids.numpy()
    assert (ids < n).all() and (ids >= 0).all()
    assert np.isfinite(scores.numpy()).all()
    j_ell = jss.shard_ell(jm, JELL(cols=cols, nnz=nnz, vals=None,
                                   num_cols=v, sentinel_padded=False))
    j_ids, j_s = jss.make_sharded_blockwise_search(
        jm, k=80, num_rows=n, ell_template=j_ell, block_rows=16,
        selection="exact")(q, j_ell)
    ids_agree(np.asarray(j_ids), np.asarray(j_s), ids, scores.numpy())
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_s), **EXACT)


def test_sharded_blockwise_int8_rerank_exact_scores(meshes, rng):
    """'bucketed_int8' per shard: int8 candidates, exact f32 rerank, then
    the merge over exact scores; the seeded case recovers the exact
    top-k, as in the JAX package."""
    jm, tm = meshes
    n, v, k, nnz_c = 2560, 256, 5, 12
    cols = np.stack([rng.choice(v, size=nnz_c, replace=False)
                     for _ in range(n)]).astype(np.int32)
    nnz = np.full(n, nnz_c, np.int32)
    q = np.zeros((2, v), np.float32)
    for i in range(2):
        active = rng.choice(v, size=48, replace=False)
        q[i, active] = 0.25 + rng.random(48).astype(np.float32)
    ell = tss.shard_ell(tm, t_ell(cols, nnz, None, v, False))
    ids, scores = tss.make_sharded_blockwise_search(
        tm, k=k, num_rows=n, ell_template=ell,
        selection="bucketed_int8")(torch.from_numpy(q), ell)
    ids, scores = ids.numpy(), scores.numpy()
    assert (ids < n).all() and (ids >= 0).all()
    for i in range(2):
        for j in range(k):
            true = np.float32(q[i, cols[ids[i, j], :nnz_c]].sum())
            np.testing.assert_allclose(scores[i, j], true, rtol=1e-6)
    exact = np.stack([
        np.sort(np.array([q[i, cols[r, :nnz_c]].sum() for r in range(n)],
                         np.float32))[::-1][:k] for i in range(2)])
    np.testing.assert_allclose(np.sort(scores, 1)[:, ::-1], exact,
                               rtol=1e-6)
    j_ell = jss.shard_ell(jm, JELL(cols=cols, nnz=nnz, vals=None,
                                   num_cols=v, sentinel_padded=False))
    j_ids, j_s = jss.make_sharded_blockwise_search(
        jm, k=k, num_rows=n, ell_template=j_ell,
        selection="bucketed_int8")(jnp.asarray(q), j_ell)
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_allclose(scores, np.asarray(j_s), rtol=1e-6)


# -- test_collectives.py -----------------------------------------------------
def test_rank_helpers_single_process():
    """Without a process group: rank 0 of 1, the gather is the identity
    (the two-rank contract is in ``test_torch_distributed.py``)."""
    assert get_rank() == 0 and get_world_size() == 1 and is_master()
    assert all_gather_objects({"a": 1}) == [{"a": 1}]
    x = torch.arange(6.0).view(2, 3).requires_grad_()
    g = differentiable_all_gather(x)
    assert g.shape == (1, 2, 3)
    (g * 2).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full((2, 3), 2.0))


# -- test_sharded_rerank.py --------------------------------------------------
@pytest.fixture(scope="module")
def rerank_pair():
    from vsearch_tpu.retriever import Retriever as JRetriever
    from vsearch_tpu.retriever import RetrieverConfig as JConfig
    from vsearch_tpu_torch.models.convert import vdr_state_dict_from_flax
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
    from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

    tok = make_tokenizer()
    enc = {"type": "vdr", "max_len": 16, "topk": 8, "shift_vocab_num": 5,
           "vocab_size": tok.vocab_size, "hidden_size": 32,
           "num_hidden_layers": 2, "num_attention_heads": 2,
           "intermediate_size": 64, "max_position_embeddings": 64}
    j = JRetriever(JConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                           shared_encoder=True), tokenizer=tok)
    t = Retriever(RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                                  shared_encoder=True),
                  tokenizer=WordPieceTokenizer(dict(tok.vocab)),
                  device="cpu")
    params = jax.tree_util.tree_map(np.asarray,
                                    j.encoder_q.variables["params"])
    t.encoder_q.module.load_state_dict(vdr_state_dict_from_flax(params, 2))
    rng = np.random.default_rng(0)
    words = [w for w in tok.vocab if not w.startswith("[")
             and not w.startswith("#") and len(w) > 2]
    corpus = [" ".join(rng.choice(words, size=8)) for _ in range(40)]
    return j, t, corpus


def test_sharded_rerank_matches_single_device(rerank_pair, meshes):
    j, t, corpus = rerank_pair
    queries = [corpus[3], corpus[17], corpus[31]]
    for r in (j, t):
        r.build_index(corpus, index_type="bag_of_token", batch_size=8)
    base = t.retrieve(queries, k=5, rerank=True, batch_size=8)
    j.to_mesh(meshes[0])
    want = j.retrieve(queries, k=5, rerank=True, batch_size=8)
    t.to_mesh(meshes[1])
    got = t.retrieve(queries, k=5, rerank=True, batch_size=8)
    try:
        np.testing.assert_array_equal(got.ids, base.ids)
        np.testing.assert_allclose(got.scores, base.scores, **EXACT)
        np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
        np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                                   rtol=1e-4, atol=1e-5)
        assert [int(i) for i in got.ids[:, 0]] == [3, 17, 31]
    finally:
        j.encoder_q._mesh = None
        t.encoder_q._mesh = None


def test_mesh_batch_divisibility_error(rerank_pair, meshes):
    j, t, corpus = rerank_pair
    t.encoder_q.to_mesh(meshes[1])
    try:
        with pytest.raises(ValueError, match="not divisible"):
            t.encoder_q.embed(corpus[:3], batch_size=3)
    finally:
        t.encoder_q._mesh = None


# -- test_tp_equivalence.py --------------------------------------------------
def test_sharded_dense_search_on_two_axis_mesh():
    rng = np.random.default_rng(1)
    vectors = rng.normal(size=(64, 32)).astype(np.float32)
    queries = rng.normal(size=(4, 32)).astype(np.float32)
    k = 5
    exact_scores = queries @ vectors.T
    exact_ids = np.argsort(-exact_scores, axis=1)[:, :k]
    jm = j_make_mesh(dp=4, tp=2)
    tm = make_mesh(dp=4, tp=2, devices=["cpu"] * 8)
    for axis in ("dp", "tp"):
        with jm:
            j_sh = jss.shard_rows(jm, jnp.asarray(vectors), axis_name=axis)
            j_ids, _ = jss.make_sharded_dense_search(
                jm, k=k, num_rows=64, axis_name=axis)(
                    jnp.asarray(queries), j_sh)
        sh = tss.shard_rows(tm, torch.from_numpy(vectors), axis_name=axis)
        assert len(sh.parts) == tm.shape[axis]
        ids, scores = tss.make_sharded_dense_search(
            tm, k=k, num_rows=64, axis_name=axis)(
                torch.from_numpy(queries), sh)
        np.testing.assert_array_equal(ids.numpy(), exact_ids,
                                      err_msg=f"axis={axis}")
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_allclose(
            scores.numpy(), np.take_along_axis(exact_scores, exact_ids, 1),
            rtol=1e-5, err_msg=f"axis={axis}")


def test_virtual_shards_share_their_device_budget(monkeypatch):
    """'auto' under a mesh packs the shards' bits only while all the
    shards a device holds fit its budget together: 4 virtual shards of
    one device whose packed rows fit it one by one, but not all four,
    take the block tier's compact ELL instead."""
    n, v = 4096 * 4, 300
    rng = np.random.default_rng(5)
    cols = np.sort(np.stack([rng.choice(v, size=6, replace=False)
                             for _ in range(n)]), axis=1).astype(np.int32)
    idx = BoTIndex(device="cpu")
    monkeypatch.setattr(BoTIndex, "_on_card", lambda self: True)
    idx.set_ell(t_ell(cols, np.full(n, 6, np.int32), None, v, True))
    one_shard = idx._packed_bytes(n // 4)
    mesh = make_mesh(devices=["cpu"] * 4)
    idx.hbm_budget_bytes = 4 * one_shard
    assert not idx._mesh_use_blockwise(mesh, "dp")
    idx.hbm_budget_bytes = 4 * one_shard - 1
    assert idx._mesh_use_blockwise(mesh, "dp")
    idx.to_mesh(mesh)
    assert idx._mesh_kind == "block"


def test_save_and_reload_after_to_mesh(meshes, rng, tmp_path):
    """A sharded index saves its true rows (no shard padding), and a
    reload after ``to_mesh`` drops the sharded state: the new rows are
    searched, k is clamped to them."""
    _, tm = meshes
    vecs = rng.normal(size=(997, 16)).astype(np.float32)
    d = DenseIndex(dtype=torch.float32, device="cpu")
    d.set_vectors(vecs)
    want = d.search(vecs[:3], k=4)
    d.to_mesh(tm)
    assert d._shards.padded_rows == 1000 and len(d) == 997
    # shards on other devices are copies and to_mesh lets ``vector`` go:
    # search and save then read the shards
    d.vector = None
    got = d.search(vecs[:3], k=4)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert "(997, 16)" in str(d)
    d.save(str(tmp_path / "d.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"),
                                  vecs.astype(np.float16))
    d.set_vectors(vecs[:5])
    assert d._mesh is None and len(d) == 5
    assert d.search(vecs[:2], k=9).ids.shape == (2, 5)
    mat = (rng.random((37, 50)) < 0.2).astype(np.float32)
    b = BoTIndex(search_mode="bitpack", device="cpu")
    b.set_vectors(mat)
    b.to_mesh(tm)
    b.save(str(tmp_path / "b.ell.npz"))
    back = BoTIndex(str(tmp_path / "b.ell.npz"), device="cpu")
    assert back.ell.shape == (37, 50)
    np.testing.assert_array_equal(back.ell.to_scipy_csr().toarray(),
                                  mat != 0)
