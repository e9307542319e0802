"""Port parity of dense search: the chunked ``dense_topk_search`` with its
running top-k, ``topk_from_scores`` and ``merge_shard_topk`` against the
JAX package's functions on the same numpy inputs, and ``DenseIndex``
loading without an f32 copy of the whole matrix.

Operands are bf16, as the index stores them. With dyadic values (small
multiples of 1/8) every product and sum is exact in f32, so scores and
ids compare exactly, tie order included. With random values only the
order of f32 summation differs: scores to rtol 1e-6, ids equal wherever a
score is not within that of its neighbour."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsearch_tpu.index import DenseIndex as JDenseIndex
from vsearch_tpu.ops import search as j_search
from vsearch_tpu_torch.index import DenseIndex
from vsearch_tpu_torch.ops import search as t_search

RTOL = 1e-6


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def jax_bf16(x):
    return jnp.asarray(np.asarray(x, np.float32), jnp.bfloat16)


def dyadic(rng, shape):
    return rng.integers(-16, 17, size=shape) / 8.0


def tie_heavy(rng, n=1000, d=16, uniq=40):
    """Rows drawn from ``uniq`` distinct dyadic vectors: whole runs of
    exactly tied scores, spread over every chunk."""
    base = dyadic(rng, (uniq, d))
    return base[rng.integers(0, uniq, size=n)]


def jax_search(q, vecs, k):
    ids, scores = j_search.dense_topk_search(jax_bf16(q), jax_bf16(vecs), k)
    return np.asarray(ids), np.asarray(scores)


def port_search(q, vecs, k, chunk):
    ids, scores = t_search.dense_topk_search(bf16(q), bf16(vecs), k,
                                             chunk_rows=chunk)
    return ids.numpy(), scores.numpy()


def assert_same_topk(ids_a, s_a, ids_b, s_b, rtol=RTOL):
    np.testing.assert_allclose(s_a, s_b, rtol=rtol, atol=rtol)
    scale = max(np.abs(s_b).max(), 1e-6)
    for q, j in zip(*np.nonzero(ids_a != ids_b)):
        near = np.abs(s_b[q] - s_b[q, j]) <= rtol * scale
        assert near.sum() > 1, (q, j)


@pytest.mark.parametrize("chunk", [7, 64, 333, 999, 1000, 4096, None])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_chunked_search_ties_match_jax_exactly(chunk, k):
    """Tie-heavy rows, chunk sizes that do not divide N and k above the
    chunk: ids and scores equal the JAX package's exactly."""
    rng = np.random.default_rng(chunk or 0)
    vecs, q = tie_heavy(rng), dyadic(rng, (5, 16))
    got = port_search(q, vecs, k, chunk)
    want = jax_search(q, vecs, k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("chunk", [50, 512, None])
def test_chunked_search_random_matches_jax(chunk):
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(2000, 48))
    q = rng.normal(size=(7, 48))
    assert_same_topk(*port_search(q, vecs, 64, chunk),
                     *jax_search(q, vecs, 64))


def test_chunk_rows_default_keeps_a_few_gb():
    rows = t_search.dense_chunk_rows(32, 768)
    assert rows * (4 * 768 + 16 * 32) <= t_search.DENSE_CHUNK_BYTES
    assert rows > 100_000  # wiki21m's 21M rows in ~35 chunks


def test_cpu_takes_the_upcast_product():
    v = bf16(np.ones((4, 8)))
    assert t_search.gemm_form(v, v) == t_search.GEMM_UPCAST_F32
    assert t_search.gemm_form(v.float(), v.float()) == \
        t_search.GEMM_UPCAST_F32


def test_topk_from_scores_matches_jax():
    rng = np.random.default_rng(4)
    scores = np.round(rng.normal(size=(6, 300)), 1).astype(np.float32)
    ids, s = t_search.topk_from_scores(torch.from_numpy(scores), 25)
    j_ids, j_s = j_search.topk_from_scores(jnp.asarray(scores), 25)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))


def test_merge_shard_topk_matches_jax():
    """Per-shard top-k lists of a tie-heavy score matrix merge into the
    same global top-k as the JAX package's merge and as one top-k."""
    rng = np.random.default_rng(5)
    scores = np.round(rng.normal(size=(4, 400)), 1).astype(np.float32)
    shards, kl = 5, 30
    per = scores.shape[1] // shards
    ids, vals = [], []
    for s in range(shards):
        i, v = t_search.topk_from_scores(
            torch.from_numpy(scores[:, s * per:(s + 1) * per]), kl)
        ids.append(i + s * per)
        vals.append(v)
    got = t_search.merge_shard_topk(torch.stack(ids), torch.stack(vals), 40)
    want = j_search.merge_shard_topk(
        jnp.asarray(torch.stack(ids).numpy()),
        jnp.asarray(torch.stack(vals).numpy()), 40)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    one = t_search.topk_from_scores(torch.from_numpy(scores), 40)
    np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())


@pytest.mark.parametrize("k", [5, 64, 5000])
def test_dense_index_search_matches_jax(k):
    """``DenseIndex.search`` on both packages, k past the row count
    clamped to it; the port's 'approx' searches exactly, as the JAX
    package does off the TPU."""
    rng = np.random.default_rng(6)
    vecs, q = tie_heavy(rng, n=777), dyadic(rng, (9, 16))
    t_idx, j_idx = DenseIndex(device="cpu"), JDenseIndex()
    t_idx.set_vectors(vecs.astype(np.float32))
    j_idx.set_vectors(vecs.astype(np.float32))
    got, want = t_idx.search(q, k), j_idx.search(q, k)
    assert got.ids.shape == (9, min(k, 777))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    t_idx.selection = "approx"
    np.testing.assert_array_equal(t_idx.search(q, k).ids, want.ids)
    t_idx.selection = "bucketed"
    with pytest.raises(ValueError, match="selection"):
        t_idx.search(q, k)


def _f32_detour(mat):
    """What ``set_vectors`` stored before: an f32 copy, then the index
    dtype."""
    return torch.as_tensor(np.asarray(mat, dtype=np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("src", ["f16", "f32", "f64", "bf16_tensor",
                                 "f16_tensor", "list"])
def test_set_vectors_equals_the_f32_detour(src, monkeypatch):
    """Every source dtype lands as the same bf16 tensor the f32 detour
    gave, converted in row slices (the slice made small here)."""
    from vsearch_tpu_torch.index import base

    monkeypatch.setattr(base, "_UPLOAD_ROWS", 7)
    rng = np.random.default_rng(7)
    mat = rng.normal(size=(50, 12))
    src_mat = {"f16": mat.astype(np.float16), "f32": mat.astype(np.float32),
               "f64": mat, "bf16_tensor": bf16(mat),
               "f16_tensor": torch.from_numpy(mat.astype(np.float16)),
               "list": mat.astype(np.float32).tolist()}[src]
    idx = DenseIndex(device="cpu")
    idx.set_vectors(src_mat)
    ref = (src_mat.float() if torch.is_tensor(src_mat) else src_mat)
    want = _f32_detour(ref.numpy() if torch.is_tensor(ref) else ref)
    assert idx.vector.dtype == torch.bfloat16
    assert torch.equal(idx.vector, want)


def test_set_vectors_keeps_a_device_tensor():
    v = bf16(np.ones((3, 4)))
    idx = DenseIndex(device="cpu")
    idx.set_vectors(v)
    assert idx.vector is v


@pytest.mark.parametrize("ext", [".npy", ".npz", ".pt"])
def test_load_and_round_trip(tmp_path, ext, monkeypatch):
    """f16 and bf16 files load as the same device tensor as before,
    sharded loads stack in file order, and ``save`` round-trips."""
    from vsearch_tpu_torch.index import base

    monkeypatch.setattr(base, "_UPLOAD_ROWS", 16)
    rng = np.random.default_rng(8)
    mat = rng.normal(size=(90, 8)).astype(np.float16)
    want = _f32_detour(mat)
    paths = []
    for i, part in enumerate((mat[:40], mat[40:])):
        p = str(tmp_path / f"shard{i}{ext}")
        if ext == ".npy":
            np.save(p, part)
        elif ext == ".npz":
            np.savez_compressed(p, vectors=part)
        else:
            torch.save(torch.from_numpy(part), p)
        paths.append(p)
    idx = DenseIndex(index_file=str(tmp_path / f"shard*{ext}"), device="cpu")
    assert torch.equal(idx.vector, want)
    if ext == ".pt":  # a bf16 tensor file keeps its dtype on load
        torch.save(bf16(mat), paths[0])
        one = DenseIndex(index_file=paths[0], device="cpu")
        assert torch.equal(one.vector, bf16(mat))
    out = str(tmp_path / f"saved{ext}")
    idx.save(out)
    again = DenseIndex(index_file=out, device="cpu")
    assert torch.equal(again.vector, idx.vector)
    j = JDenseIndex(index_file=out)  # the JAX package reads it too
    np.testing.assert_array_equal(
        np.asarray(j.vector, np.float32), idx.vector.float().numpy())
