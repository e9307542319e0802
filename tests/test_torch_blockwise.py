"""Port parity for indexes larger than the device: the int8 operand and
keys of kernel #4 (plain version on the CPU), ``exact_rerank``, the
blockwise sweep of the block tier, ``StreamedBitpackSearcher`` and the
``BoTIndex`` tier dispatch, against the JAX package with its Pallas
kernels in interpret mode.

Inputs are made with numpy. Dyadic query weights (multiples of 1/16) make
every sum exact in any order, so scores compare exactly; random weights
compare to the stated tolerance. Top-k ties break toward the lower
position in both packages, so ids compare exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsearch_tpu.index import BoTIndex as JBoT
from vsearch_tpu.index.streamed import StreamedBitpackSearcher as JStream
from vsearch_tpu.ops import bitpack as jb
from vsearch_tpu.ops import two_stage as jts
from vsearch_tpu.ops.ell import ELLMatrix as JELL
from vsearch_tpu_torch.index import BoTIndex, SparseIndex
from vsearch_tpu_torch.index.streamed import StreamedBitpackSearcher
from vsearch_tpu_torch.ops import bitpack as tb
from vsearch_tpu_torch.ops import two_stage as tts
from vsearch_tpu_torch.ops.ell import ELLMatrix as TELL

# random weights: f32 sums of the same terms in another order
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
V = 500


def bot_rows(seed, n, v=V, nnz_pad=8, lo=4, sentinel=False):
    """Bag-of-token rows of lo..nnz_pad unique ids, padded with 0 (masked
    by nnz) or with the sentinel v."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(lo, nnz_pad + 1, size=n).astype(np.int32)
    cols = np.full((n, nnz_pad), v if sentinel else 0, np.int32)
    for i in range(n):
        cols[i, : nnz[i]] = rng.choice(v, size=nnz[i], replace=False)
    return cols, nnz


def queries(seed, b, v=V, weights="dyadic"):
    rng = np.random.default_rng(seed)
    if weights == "dyadic":
        return (rng.integers(0, 129, size=(b, v)) / 16.0).astype(np.float32)
    return rng.random((b, v)).astype(np.float32)


def tol(weights, kind="f32"):
    if weights == "dyadic":
        return dict(rtol=0, atol=0)
    # bucketed keys carry the low-10-bit splice: one quantum is 2^-13
    return dict(rtol=2.0 ** -12, atol=0) if kind == "key" else SCORE_TOL


# -- kernel #4's operand and keys ---------------------------------------------
@pytest.mark.parametrize("case", ["random", "half_boundaries", "zero_query"])
def test_prepare_queries_int8_matches_jax(case):
    rng = np.random.default_rng(3)
    q = np.abs(rng.normal(size=(4, 300))).astype(np.float32)
    if case == "half_boundaries":
        # scale 1 (max 127) and scale 1/2 (max 254): values land on .5
        q[0] = np.arange(300) % 127 + 0.5
        q[0, 7] = 127.0
        q[1] = (np.arange(300) % 254).astype(np.float32) + 1.0
        q[1, 0] = 254.0
    if case == "zero_query":
        q[2] = 0.0
    got = tb.prepare_queries_int8(torch.from_numpy(q), 4096)
    want = np.asarray(jb.prepare_queries_int8(jnp.asarray(q), 4096))
    assert got.dtype == torch.int8 and got.shape == (4096, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def ragged():
    """2,100 ragged rows at V=420 (n not a multiple of 1024, a negative
    column, a row whose nnz exceeds nnz_pad), packed by both packages."""
    rng = np.random.default_rng(7)
    v, n, nnz_pad = 420, 2100, 64
    nnz = np.minimum(rng.integers(0, nnz_pad + 1, size=n), 40)
    cols = np.full((n, nnz_pad), v, np.int32)
    for i in range(n):
        cols[i, : nnz[i]] = rng.choice(v, size=int(nnz[i]), replace=False)
    cols[0, :3] = -1
    nnz = nnz.astype(np.int32)
    nnz[-1] = nnz_pad + 9
    j = JELL(cols=jnp.asarray(cols), nnz=jnp.asarray(nnz), vals=None,
             num_cols=v)
    t = TELL.from_arrays(cols, nnz, None, v, True, device="cpu")
    return jb.pack_ell_device(j, interpret=True), tb.pack_ell(t), v


@pytest.mark.parametrize("bucket", [8, 16])
def test_int8_keys_bit_identical(ragged, bucket):
    """Random (not dyadic) weights: integer sums agree bit for bit."""
    jbm, tbm, v = ragged
    q = np.abs(np.random.default_rng(bucket).normal(size=(5, v))) \
        .astype(np.float32)
    q8_j = jb.prepare_queries_int8(jnp.asarray(q), jbm.padded_bits)
    want = np.asarray(jb._int8_bucketed_keys(q8_j, jbm, bucket,
                                             jb.ROW_BLOCK, True))
    q8_t = tb.prepare_queries_int8(torch.from_numpy(q), tbm.padded_bits)
    got = tb._int8_bucketed_keys(q8_t, tbm, bucket).numpy()
    assert got.shape == want.shape == (3072 // bucket, 5)
    np.testing.assert_array_equal(got, want)
    # the last 1024-row block holds 52 rows (2,048-2,099): its slots
    # from 52 on fold padding rows only
    kb = 1024 // bucket
    assert (got[2 * kb + 52:] == tb.INT32_MIN).all()
    assert (got[2 * kb: 2 * kb + 52] > tb.INT32_MIN).all()


# -- exact rerank -------------------------------------------------------------
@pytest.mark.parametrize("weights", ["dyadic", "random"])
@pytest.mark.parametrize("layout", ["sentinel", "masked", "vals"])
def test_exact_rerank_matches_jax(layout, weights):
    v, n, k = 200, 300, 10
    cols, nnz = bot_rows(11, n, v=v, nnz_pad=16, lo=1,
                         sentinel=layout != "masked")
    rng = np.random.default_rng(12)
    vals = None
    if layout == "vals":
        vals = (rng.integers(1, 17, size=cols.shape) / 8.0
                if weights == "dyadic" else rng.random(cols.shape))
        vals = np.where(np.arange(16)[None] < nnz[:, None], vals, 0.0) \
            .astype(np.float32)
    q = queries(13, 3, v, weights)
    cand = np.stack([rng.choice(n, size=40, replace=False)
                     for _ in range(3)]).astype(np.int32)
    sentinel = layout != "masked"
    ids_j, s_j = jts.exact_rerank(
        jnp.asarray(q), JELL(cols=jnp.asarray(cols), nnz=jnp.asarray(nnz),
                             vals=None if vals is None
                             else jnp.asarray(vals),
                             num_cols=v, sentinel_padded=sentinel),
        jnp.asarray(cand), k)
    ids_t, s_t = tts.exact_rerank(
        torch.from_numpy(q),
        TELL.from_arrays(cols, nnz, vals, v, sentinel, device="cpu"),
        torch.from_numpy(cand.astype(np.int64)), k)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    r = dict(rtol=0, atol=0) if weights == "dyadic" else dict(rtol=1e-6,
                                                             atol=0)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **r)


# -- the block tier's sweep ---------------------------------------------------
def blockwise_both(cols, nnz, q, k, selection, cand_budget=0):
    ids_j, s_j = jb.bitpack_blockwise_topk(
        jnp.asarray(q), jnp.asarray(cols.astype(np.uint16)),
        jnp.asarray(nnz), num_cols=V, k=k, block_rows=1024,
        selection=selection, cand_budget=cand_budget)
    ids_t, s_t = tb.bitpack_blockwise_topk(
        torch.from_numpy(q), torch.from_numpy(cols.astype(np.int16)),
        torch.from_numpy(nnz), num_cols=V, k=k, block_rows=1024,
        selection=selection, cand_budget=cand_budget)
    return (np.asarray(ids_j), np.asarray(s_j)), (ids_t.numpy(),
                                                  s_t.numpy())


@pytest.mark.parametrize("selection,k,weights,n,cand", [
    ("exact", 10, "dyadic", 2500, 0),
    ("exact", 10, "random", 2500, 0),
    ("bucketed", 16, "dyadic", 2500, 0),
    ("bucketed", 16, "random", 2500, 0),
    # a 52-row tail: kloc * bucket > rows, the per-block exact route
    ("bucketed", 16, "dyadic", 2100, 0),
    ("bucketed_int8", 8, "dyadic", 2500, 0),
    ("bucketed_int8", 8, "random", 2500, 64),
])
def test_blockwise_matches_jax(selection, k, weights, n, cand):
    """Three 1,024-row blocks with a ragged tail."""
    cols, nnz = bot_rows(21, n)
    q = queries(22, 3, weights=weights)
    (ids_j, s_j), (ids_t, s_t) = blockwise_both(cols, nnz, q, k, selection,
                                                cand)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(
        s_t, s_j, **tol(weights, "key" if selection == "bucketed"
                        else "f32"))
    if selection == "bucketed_int8":
        # the rerank returns true rows at their exact f32 scores
        for bq in range(3):
            true = [np.float32(q[bq, cols[r, : nnz[r]]].sum())
                    for r in ids_t[bq]]
            np.testing.assert_allclose(s_t[bq], true, rtol=1e-6)


@pytest.mark.parametrize("selection,n,k", [
    # cand * bucket > n: int8 falls back to exact
    ("bucketed_int8", 70, 10),
    # a 6-row tail shorter than k, exact and bucketed
    ("exact", 1030, 10),
    ("bucketed", 1030, 10),
])
def test_blockwise_fallbacks_match_jax(selection, n, k):
    cols, nnz = bot_rows(25, n, lo=1)
    q = queries(26, 2)
    (ids_j, s_j), (ids_t, s_t) = blockwise_both(cols, nnz, q, k, selection)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(s_t, s_j)


@pytest.mark.parametrize("args,want", [
    (("bucketed_int8", 1 << 20, 128, 100, 16, 0), ("bucketed_int8", 200)),
    (("bucketed_int8", 1 << 20, 128, 100, 16, 50), ("bucketed_int8", 100)),
    (("bucketed_int8", 1 << 20, 128, 100, 16, 300), ("bucketed_int8", 300)),
    (("bucketed_int8", 3000, 128, 100, 16, 0), ("exact", 100)),
    # 16,514 * 127 >= 2^21 > 16,513 * 127
    (("bucketed_int8", 1 << 20, 16514, 100, 16, 0), ("bucketed", 100)),
    (("bucketed_int8", 1 << 20, 16513, 100, 16, 0), ("bucketed_int8", 200)),
    (("bucketed", 1 << 20, 128, 100, 16, 0), ("bucketed", 100)),
    (("exact", 1 << 20, 128, 100, 16, 0), ("exact", 100)),
])
def test_blockwise_route(args, want):
    """The JAX package's routes (bitpack_blockwise_topk's int8 fallbacks),
    on the routing alone."""
    assert tb.blockwise_route(*args) == want


def test_blockwise_overflow_guard_runs_bucketed(monkeypatch):
    """A 16,514-wide ELL cannot take int8 keys: the sweep runs kernel #3's
    route and gives what 'bucketed' gives."""
    cols, nnz = bot_rows(27, 2100)
    cols = np.pad(cols, ((0, 0), (0, 16514 - 8)))
    q = torch.from_numpy(queries(28, 2))
    c, z = torch.from_numpy(cols.astype(np.int16)), torch.from_numpy(nnz)
    want = tb.bitpack_blockwise_topk(q, c, z, V, 8, block_rows=1024,
                                     selection="bucketed")

    def refuse(*a, **kw):
        raise AssertionError("int8 keys launched past the overflow guard")

    monkeypatch.setattr(tb, "int8_bucket_keys", refuse)
    got = tb.bitpack_blockwise_topk(q, c, z, V, 8, block_rows=1024,
                                    selection="bucketed_int8")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="selection"):
        tb.blockwise_route("approx", 100, 8, 5, 16, 0)


# -- the stream tier ----------------------------------------------------------
@pytest.mark.parametrize("weights", ["dyadic", "random"])
@pytest.mark.parametrize("selection", ["exact", "bucketed"])
def test_streamed_matches_jax(selection, weights):
    cols, nnz = bot_rows(31, 2500)
    cols = np.pad(cols, ((0, 0), (0, 8)))  # 8 padding columns to trim
    q = queries(32, 3, weights=weights)
    ids_j, s_j = JStream(cols, nnz, V, block_rows=1024,
                         selection=selection).search(q, 10)
    s = StreamedBitpackSearcher(cols, nnz, V, block_rows=1024,
                                selection=selection, device="cpu")
    assert s.cols.dtype == np.uint16 and s.cols.shape[1] == 8  # trimmed
    assert s.n_blocks == 3
    assert s.bytes_per_sweep == 3 * 1024 * (8 * 2 + 4)
    ids_t, s_t = s.search(q, 10)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    np.testing.assert_allclose(
        s_t, np.asarray(s_j),
        **tol(weights, "key" if selection == "bucketed" else "f32"))


@pytest.mark.parametrize("selection", ["exact", "bucketed"])
def test_streamed_masks_padding_rows(selection):
    """One 1,024-row block over 1,000 rows and all-zero scores: the 24
    padding rows tie with real rows (the bucket fold even prefers them)
    and must be masked to -1.0, as in JAX."""
    cols, nnz = bot_rows(33, 1000)
    q = np.zeros((2, V), np.float32)
    ids_j, s_j = JStream(cols, nnz, V, selection=selection).search(q, 120)
    ids_t, s_t = StreamedBitpackSearcher(
        cols, nnz, V, selection=selection, device="cpu").search(q, 120)
    np.testing.assert_array_equal(ids_t, np.asarray(ids_j))
    np.testing.assert_array_equal(s_t, np.asarray(s_j))
    assert (s_t[ids_t >= 1000] == -1.0).all()


# -- BoTIndex dispatch --------------------------------------------------------
def jax_index(mode, selection, cols, nnz):
    idx = JBoT(search_mode=mode, selection=selection)
    idx.stream_block_rows = 1024
    idx.set_ell(JELL(cols=jnp.asarray(cols), nnz=jnp.asarray(nnz),
                     vals=None, num_cols=V, sentinel_padded=False),
                host_cache=(cols, nnz))
    return idx


def torch_index(mode, selection, cols, nnz):
    idx = BoTIndex(search_mode=mode, selection=selection, device="cpu")
    idx.stream_block_rows = 1024
    idx.set_ell(TELL.from_arrays(cols, nnz, None, V, False, device="cpu"))
    return idx


@pytest.mark.parametrize("selection", ["exact", "bucketed"])
@pytest.mark.parametrize("mode", ["block", "stream"])
def test_bot_tiers_match_jax(mode, selection):
    """The tiers on the CPU give JAX's ids in the same mode; with exact
    selection also the resident path's ids."""
    cols, nnz = bot_rows(41, 2500)
    q = queries(42, 3)
    t = torch_index(mode, selection, cols, nnz)
    assert t._oversize_tier() == mode
    got = t.search(q, k=8)
    want = jax_index(mode, selection, cols, nnz).search(q, k=8)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    if selection == "exact":
        res = torch_index("bitpack", "exact", cols, nnz).search(q, k=8)
        np.testing.assert_array_equal(got.ids, res.ids)
    if mode == "block":
        sel = t._block_selection()
        assert sel == ("bucketed_int8" if selection == "bucketed"
                       else "exact")
        assert t._block_ell[0].dtype == torch.int16  # uint16 patterns
    else:
        assert t._get_streamer().selection == selection


@pytest.mark.parametrize("mode", ["block", "stream"])
def test_set_ell_resets_tier_caches(mode):
    cols, nnz = bot_rows(43, 1500)
    idx = torch_index(mode, "exact", cols, nnz)
    q = queries(44, 1)
    idx.search(q, k=3)
    idx.build_bitpack()
    assert (idx._block_ell if mode == "block" else idx._streamer) \
        is not None
    cols2, nnz2 = bot_rows(45, 80)
    idx.set_ell(TELL.from_arrays(cols2, nnz2, None, V, False,
                                 device="cpu"))
    assert idx._block_ell is None and idx._streamer is None
    assert idx.bitmat is None
    assert idx.search(q, k=3).ids.max() < 80


@pytest.mark.parametrize("mode", ["auto", "exact", "bitpack", "block",
                                  "stream"])
def test_empty_batch_every_mode(mode):
    cols, nnz = bot_rows(46, 50)
    idx = torch_index(mode, "auto", cols, nnz)
    res = idx.search(np.zeros((0, V), np.float32), k=5)
    assert res.ids.shape == res.scores.shape == (0, 5)


@pytest.mark.parametrize("mode", ["block", "stream"])
def test_sparse_index_rejects_tiers(mode):
    with pytest.raises(ValueError, match=mode):
        SparseIndex(search_mode=mode, device="cpu")


def test_auto_never_picks_a_tier_for_a_cpu_ell():
    cols, nnz = bot_rows(47, 300)
    idx = torch_index("auto", "auto", cols, nnz)
    idx.hbm_budget_bytes = 1
    assert idx._oversize_tier() is None
    assert idx.search(queries(48, 2), k=4).ids.shape == (2, 4)


@pytest.mark.parametrize("budget", [
    10 << 20,  # the packed bits fit: resident
    5120 * 512,  # exactly the packed bytes: still resident
    (3 << 30) + (200 << 10),  # the compact ELL fits: block
    1 << 20,  # neither fits: stream
])
def test_tier_decision_matches_jax(monkeypatch, budget):
    """'auto' on the card decides as JAX's 'auto' does on a TPU."""
    cols, nnz = bot_rows(49, 5000)
    j = jax_index("auto", "auto", cols, nnz)
    t = torch_index("auto", "auto", cols, nnz)
    j.hbm_budget_bytes = t.hbm_budget_bytes = budget
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(BoTIndex, "_on_card", lambda self: True)
    assert t._oversize_tier() == j._oversize_tier()
    assert t._packed_bytes() == j._packed_bytes() == 5120 * 512


def test_default_budget_sends_wiki21m_to_the_block_tier(monkeypatch):
    """With no budget set, 3/4 of the card's memory: on an 80 GB card the
    1,048,576-row main path stays resident and 21,015,324 rows go to the
    block tier. (Zero-stride ELLs: shapes only, no memory.)"""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (1 << 30, 80 << 30))
    monkeypatch.setattr(BoTIndex, "_on_card", lambda self: True)
    idx = BoTIndex(device="cpu")
    assert idx._budget() == 60 << 30
    for n, tier in ((1 << 20, None), (21_015_324, "block")):
        idx.set_ell(TELL(cols=torch.zeros(1, 128, dtype=torch.int32)
                         .expand(n, 128),
                         nnz=torch.zeros(1, dtype=torch.int32).expand(n),
                         vals=None, num_cols=29_523, sentinel_padded=True))
        assert idx._oversize_tier() == tier
        assert idx._resolved_selection() == "bucketed"
        assert idx._block_selection() == "bucketed_int8"


@pytest.mark.parametrize("selection", ["approx", "bucketed_approx"])
def test_approx_selections_match_jax_off_tpu(selection):
    cols, nnz = bot_rows(51, 2100)
    q = queries(52, 3)
    want = jax_index("bitpack", selection, cols, nnz).search(q, k=20)
    t = torch_index("bitpack", selection, cols, nnz)
    got = t.search(q, k=20)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    j = jax_index("block", selection, cols, nnz)
    t.search_mode = "block"
    assert t._block_selection() == j._block_selection()
    t.search_mode = j.search_mode = "stream"
    assert t._get_streamer().selection == j._get_streamer().selection


def test_load_index_stream_mode(tmp_path):
    """load_index(search_mode='stream') reaches the index, which keeps the
    ELL on the host and answers as JAX's does."""
    from vsearch_tpu.retriever import Retriever as JRetriever
    from vsearch_tpu_torch.retriever import Retriever

    cols, nnz = bot_rows(53, 1200)
    path = str(tmp_path / "tiny.bot.npz")
    torch_index("auto", "auto", cols, nnz).save(path)
    q = queries(54, 2)
    out = []
    for cls in (JRetriever, Retriever):
        r = cls.__new__(cls)  # no encoders needed to load an index
        r.index = None
        r.device = torch.device("cpu")
        idx = r.load_index(index_file=path, search_mode="stream")
        assert idx.search_mode == "stream"
        idx.stream_block_rows = 1024
        out.append(idx.search(q, k=6))
    assert not idx.ell.cols.is_cuda
    np.testing.assert_array_equal(out[1].ids, out[0].ids)
