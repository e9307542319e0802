"""Port parity for alpha search at scale: ``binary_proxy_search`` and the
``SparseIndex`` bitproxy route against the JAX package on the CPU (its
Pallas kernels in interpret mode, the port's kernels as their plain
versions), on the fixture of ``tests/test_two_stage.py``.

Both packages select candidates from bf16 support scores and re-score
them exactly from the f32 ELL, and break top-k ties toward the lower
position. Scores agree within ``atol=1e-4`` (f32 sums of the same terms
in another order), so ids compare exactly except where two rows' scores
lie within that tolerance of each other (``assert_same_topk``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from vsearch_tpu.index import SparseIndex as JSparse
from vsearch_tpu.ops import bitpack as jb
from vsearch_tpu.ops import two_stage as jts
from vsearch_tpu.ops.ell import ELLMatrix as JELL
from vsearch_tpu_torch.index import BoTIndex, SparseIndex
from vsearch_tpu_torch.ops import bitpack as tb
from vsearch_tpu_torch.ops import two_stage as tts
from vsearch_tpu_torch.ops.ell import ELLMatrix as TELL

TOL = dict(rtol=0, atol=1e-4)


def assert_same_topk(ids, scores, want_ids, want_scores, atol=1e-4):
    """Scores within ``atol``; ids equal at every position whose score is
    not within ``atol`` of another returned score (a near-tie that the
    summation order may swap) and that is not the last (where a row just
    outside may tie)."""
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=atol)
    for r, j in zip(*np.nonzero(ids != want_ids)):
        near = np.abs(np.asarray(scores)[r] - scores[r][j]) <= atol
        assert near.sum() > 1 or j == ids.shape[1] - 1, (r, j)


def random_csr(n, v, density, seed):
    mat = sp.random(n, v, density=density, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(seed))
    mat.data[:] = np.abs(mat.data)
    return mat


@pytest.fixture(scope="module")
def case():
    """2,000 real-valued rows at V=300 (padded to 2,048 packed rows) and 4
    queries, in both packages."""
    mat = random_csr(2000, 300, 0.05, 7)
    q = np.abs(np.random.default_rng(7).normal(size=(4, 300))
               ).astype(np.float32)
    return mat, q, JELL.from_scipy_csr(mat), TELL.from_scipy_csr(
        mat, device="cpu")


def both_proxy(case, k, num_candidates, rows=None):
    mat, q, jell, tell = case
    if rows is not None:
        jell, tell = jell.slice_rows(0, rows), tell.slice_rows(0, rows)
    jbm, tbm = jb.pack_ell(jell), tb.pack_ell(tell)
    np.testing.assert_array_equal(
        tbm.words.numpy().view(np.uint32), np.asarray(jbm.words))
    a = jts.binary_proxy_search(jnp.asarray(q), jell, jbm, k=k,
                                num_candidates=num_candidates)
    b = tts.binary_proxy_search(torch.from_numpy(q), tell, tbm, k=k,
                                num_candidates=num_candidates)
    return [np.asarray(x) for x in a], [x.numpy() for x in b], tbm


@pytest.mark.parametrize("k,num_candidates,rows,route", [
    # capped = min(200, 2048 // 8, 2000) = 200: kernel #3's route
    (5, 200, None, "bucketed"),
    # capped = 256 < k: exact selection over kernel #2's support scores
    (300, 600, None, "fallback"),
    # 100 true rows padded to 1,024: capped = min(120, 128, 100) = 100,
    # from the true rows (the padded count would ask top-k for 120)
    (100, 120, 100, "true_rows"),
])
def test_binary_proxy_search_matches_jax(case, k, num_candidates, rows,
                                         route):
    before = dict(tb.LAUNCHES)
    (ja, js), (ta, ts), tbm = both_proxy(case, k, num_candidates, rows)
    n = rows or 2000
    assert ta.shape == (4, k) and (ta < n).all()
    assert_same_topk(ta, ts, ja, js)
    # exact scores of the returned rows
    dense = case[0].toarray()[:n]
    np.testing.assert_allclose(
        ts, np.take_along_axis(case[1] @ dense.T, ta, axis=1), **TOL)
    assert tb.LAUNCHES == before  # CPU tensors: the plain versions ran
    capped = min(num_candidates, tbm.words.shape[0] // tb.BUCKET,
                 tbm.num_rows)
    assert (capped < k) == (route == "fallback")


def index_pair(mat, mode, threshold=None):
    j = JSparse(search_mode=mode)
    j.set_ell(JELL.from_scipy_csr(mat))
    t = SparseIndex(search_mode=mode, device="cpu")
    t.set_ell(TELL.from_scipy_csr(mat, device="cpu"))
    if threshold is not None:
        j.exact_threshold = t.exact_threshold = threshold
    return j, t


@pytest.mark.parametrize("mode,threshold,proxy", [
    ("auto", None, False),  # 2,000 rows <= 131,072: exact
    ("auto", 1000, True),  # lowered threshold: the proxy
    ("exact", 1000, False),
    ("bitproxy", None, True),
])
def test_sparse_index_routes_match_jax(case, mode, threshold, proxy):
    mat, q = case[0], case[1]
    j, t = index_pair(mat, mode, threshold)
    assert t._use_bitproxy() == j._use_bitproxy() == proxy
    a, b = j.search(q, k=7), t.search(q, k=7)
    assert_same_topk(b.ids, b.scores, a.ids, a.scores)
    assert (t.bitproxy is not None) == proxy


@pytest.mark.parametrize("budget,k,num_candidates", [
    (1, 5, None),  # the cap collapses to k: still exact scores
    (2000, 5, None),  # C = 2000 // 128 = 15
    (None, 5, 2),  # below k -> k
    (None, 5, 10_000),  # above n -> n
])
def test_rerank_budget_and_candidate_clamps_match_jax(budget, k,
                                                      num_candidates):
    """The per-query budget caps the candidates (floored at k) and a
    caller's count clamps into [k, n] (``tests/test_index.py``)."""
    mat = random_csr(200, 80, 0.1, 3)
    q = np.abs(np.random.default_rng(3).normal(size=(2, 80))
               ).astype(np.float32)
    j, t = index_pair(mat, "bitproxy")
    if budget is not None:
        j.rerank_budget = t.rerank_budget = budget
    a = j.search(q, k=k, num_candidates=num_candidates)
    b = t.search(q, k=k, num_candidates=num_candidates)
    assert b.ids.shape == (2, k)
    assert_same_topk(b.ids, b.scores, a.ids, a.scores)
    exact = q @ mat.toarray().T
    np.testing.assert_allclose(
        b.scores, np.take_along_axis(exact, b.ids, axis=1), **TOL)


@pytest.mark.parametrize("cls", [SparseIndex, BoTIndex])
def test_unknown_search_mode_raises(cls):
    with pytest.raises(ValueError, match="unknown search_mode"):
        cls(search_mode="nope", device="cpu")


def test_bot_index_keeps_its_routes():
    with pytest.raises(ValueError, match="bitproxy"):
        BoTIndex(search_mode="bitproxy", device="cpu")


def test_bitproxy_dropped_on_set_ell(case):
    """A reloaded or replaced ELL must not be answered from the old
    corpus's packed support."""
    mat, q = case[0], case[1]
    _, t = index_pair(mat, "bitproxy")
    first = t.search(q, k=3)
    assert t.bitproxy is not None
    other = random_csr(2000, 300, 0.05, 8)
    t.set_ell(TELL.from_scipy_csr(other, device="cpu"))
    assert t.bitproxy is None
    got = t.search(q, k=3)
    j, _ = index_pair(other, "bitproxy")
    np.testing.assert_array_equal(got.ids, j.search(q, k=3).ids)
    assert not np.array_equal(got.ids, first.ids)
    t.set_vectors(mat)
    assert t.bitproxy is None
    t.search(q, k=3)
    t.vector = None
    assert t.bitproxy is None and t.ell is None


def test_zero_value_inside_a_row_matches_jax():
    """``ell_from_topk`` counts ``vals > 0`` as nnz, so a zero inside a
    row masks the row's LAST slot from the support while the rerank still
    weighs every slot; both packages keep that behaviour."""
    from vsearch_tpu.ops.ell import ell_from_topk as j_from_topk
    from vsearch_tpu_torch.ops.ell import ell_from_topk as t_from_topk

    rng = np.random.default_rng(11)
    n, v, kk = 1500, 200, 6
    cols = np.stack([rng.choice(v, kk, replace=False) for _ in range(n)]
                    ).astype(np.int32)
    vals = (0.5 + rng.random((n, kk))).astype(np.float32)
    vals[::3, 2] = 0.0  # a zero inside every third row
    q = np.abs(rng.normal(size=(3, v))).astype(np.float32)
    jell = j_from_topk(cols, vals, v)
    tell = t_from_topk(cols, vals, v, device="cpu")
    assert int(tell.nnz[0]) == kk - 1
    jbm, tbm = jb.pack_ell(jell), tb.pack_ell(tell)
    np.testing.assert_array_equal(tbm.words.numpy().view(np.uint32),
                                  np.asarray(jbm.words))
    for k, c in ((5, 100), (200, 400)):  # bucketed, then the fallback
        a = jts.binary_proxy_search(jnp.asarray(q), jell, jbm, k=k,
                                    num_candidates=c)
        b = tts.binary_proxy_search(torch.from_numpy(q), tell, tbm, k=k,
                                    num_candidates=c)
        assert_same_topk(b[0].numpy(), b[1].numpy(), np.asarray(a[0]),
                         np.asarray(a[1]))
