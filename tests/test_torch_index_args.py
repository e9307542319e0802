"""The index constructors take the JAX package's arguments in its order
(``fp16`` accepted and unused, ``block_rows`` the sharded exact search's
chunk / 16, ``device`` a keyword at the end of the port's), and
``ops.bitpack.pack_dense`` packs as the JAX package does."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from vsearch_tpu.index import BoTIndex as JBoT
from vsearch_tpu.index import DenseIndex as JDense
from vsearch_tpu.index import SparseIndex as JSparse
from vsearch_tpu.ops import bitpack as jb
from vsearch_tpu_torch.index import BoTIndex, DenseIndex, SparseIndex
from vsearch_tpu_torch.ops import bitpack as tb
from vsearch_tpu_torch.parallel import make_mesh


def dtype_name(dt) -> str:
    return str(dt).rsplit(".", 1)[-1] if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("idx")
    rng = np.random.RandomState(5)
    mat = sp.random(300, 64, density=0.2, format="csr", dtype=np.float32,
                    random_state=rng)
    mat.data[:] = np.abs(mat.data) + 0.1
    sp.save_npz(d / "sparse.npz", mat)
    bot = mat.copy()
    bot.data[:] = 1.0
    sp.save_npz(d / "bot.npz", bot)
    np.save(d / "dense.npy", rng.normal(size=(200, 16)).astype(np.float32))
    q = np.abs(rng.normal(size=(3, 64))).astype(np.float32)
    return {"sparse": str(d / "sparse.npz"), "bot": str(d / "bot.npz"),
            "dense": str(d / "dense.npy"), "q": q}


def same_search(j, t, q, k=7):
    a, b = j.search(q, k=k), t.search(q, k=k)
    np.testing.assert_array_equal(b.ids, a.ids)
    np.testing.assert_allclose(b.scores, a.scores, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cls_j,cls_t,key", [
    (JSparse, SparseIndex, "sparse"), (JBoT, BoTIndex, "bot")])
@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_sparse_indexes_take_jax_arguments(files, cls_j, cls_t, key, call):
    """``SparseIndex(f, None, True, False, 3)`` sets shift=3 in both
    packages (before the repair the port read it as val_dtype=3 with
    low_memory=True and shift=False); keywords name the same fields."""
    f = files[key]
    if call == "positional":
        j = cls_j(f, None, True, False, 3, jnp.float32, 512, "exact")
        t = cls_t(f, None, True, False, 3, torch.float32, 512, "exact",
                  device="cpu")
    else:
        kw = dict(fp16=False, low_memory=True, shift=2, block_rows=128,
                  search_mode="exact", selection="exact")
        j = cls_j(f, **kw)
        t = cls_t(f, **kw, device="cpu")
    for name in ("low_memory", "shift", "block_rows", "search_mode",
                 "selection"):
        assert getattr(t, name) == getattr(j, name), name
    if call == "positional":
        assert dtype_name(t.val_dtype) == dtype_name(j.val_dtype) == \
            "float32"
    assert t.ell.num_cols == j.ell.num_cols == 64 - t.shift
    same_search(j, t, files["q"][:, t.shift:])


@pytest.mark.parametrize("call", ["positional", "keyword"])
def test_dense_index_takes_jax_arguments(files, call):
    if call == "positional":
        j = JDense(files["dense"], None, True, True, jnp.float32)
        t = DenseIndex(files["dense"], None, True, True, torch.float32,
                       device="cpu")
    else:
        j = JDense(files["dense"], fp16=False, low_memory=True)
        t = DenseIndex(files["dense"], fp16=False, low_memory=True,
                       device="cpu")
    assert t.low_memory is j.low_memory is True
    assert dtype_name(t.dtype) == dtype_name(j.dtype)
    q = np.random.default_rng(2).normal(size=(3, 16)).astype(np.float32)
    same_search(j, t, q)


def test_init_index_takes_fp16(files):
    j, t = JSparse(), SparseIndex(device="cpu")
    j.init_index(files["sparse"], True)
    t.init_index(files["sparse"], True)
    same_search(j, t, files["q"])
    d = DenseIndex(device="cpu")
    d.init_index(files["dense"], fp16=False)
    assert d.vector.shape == (200, 16)


def test_block_rows_sets_the_sharded_exact_chunk(files, monkeypatch):
    """A sharded real-valued exact search scores its shards in chunks of
    ``block_rows * 16`` rows (JAX: ``sparse.py`` ``chunk_rows=
    self.block_rows * 16``), and answers as one device does."""
    from vsearch_tpu_torch.ops import ell as tell

    seen = []
    orig = tell.ell_matvec_chunked
    monkeypatch.setattr(tell, "ell_matvec_chunked", lambda q, m,
                        chunk_rows=65536: (seen.append(chunk_rows),
                                           orig(q, m, chunk_rows))[1])
    one = SparseIndex(files["sparse"], search_mode="exact", device="cpu")
    t = SparseIndex(files["sparse"], None, True, False, 0, torch.bfloat16,
                    8, "exact", device="cpu")
    t.to_mesh(make_mesh(devices=["cpu"] * 2))
    a, b = one.search(files["q"], k=7), t.search(files["q"], k=7)
    assert seen and set(seen) == {8 * 16}
    np.testing.assert_array_equal(b.ids, a.ids)
    np.testing.assert_allclose(b.scores, a.scores, rtol=1e-6)


@pytest.mark.parametrize("n,v,density", [(10, 300, 0.3), (1500, 5000, 0.02)])
def test_pack_dense_bit_for_bit(n, v, density):
    dense = (np.random.default_rng(n).random((n, v)) < density
             ).astype(np.float32)
    j, t = jb.pack_dense(dense), tb.pack_dense(dense, device="cpu")
    np.testing.assert_array_equal(t.words.numpy().view(np.uint32),
                                  np.asarray(j.words))
    assert (t.num_rows, t.num_cols) == (j.num_rows, j.num_cols) == (n, v)
    assert t.mean_bits == pytest.approx(dense.sum() / n)


# -- F7: build_bot_ell and BoTIndex.set_ell take the JAX package's arguments
BOT_TEXTS = [f"green tea word{i:05d} word{i + 7:05d} is a drink of mars "
             f"{'water ' * (i % 3)}einstein wrote" for i in range(40)]


@pytest.fixture(scope="module")
def bot_tokenizers():
    from vsearch_tpu.tokenization.wordpiece import WordPieceTokenizer as JTok
    from vsearch_tpu_torch.examples.synthetic_vocab import \
        build_wordpiece_vocab
    from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

    vocab = build_wordpiece_vocab()
    return JTok(dict(vocab)), WordPieceTokenizer(dict(vocab))


def test_build_bot_ell_positional_jax_call(bot_tokenizers):
    """``build_bot_ell(tok, texts, 128, 999, 1024)``: the fifth argument
    is JAX's ``batch_size``, so both packages pad rows to 128 columns
    (before the repair the port read it as ``max_token`` and padded to
    1,024)."""
    from vsearch_tpu.index.bot_build import build_bot_ell as jbuild
    from vsearch_tpu_torch.index.bot_build import build_bot_ell

    tj, tt = bot_tokenizers
    j = jbuild(tj, BOT_TEXTS, 128, 999, 1024)
    t = build_bot_ell(tt, BOT_TEXTS, 128, 999, 1024, device="cpu")
    assert t.cols.shape == tuple(j.cols.shape) == (len(BOT_TEXTS), 128)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    np.testing.assert_array_equal(t.nnz.numpy(), np.asarray(j.nnz))


@pytest.mark.parametrize("device", [False, True])
def test_build_bot_ell_keyword_jax_call(bot_tokenizers, device):
    """Every JAX keyword, ``return_host=True`` giving ``(ell, cols, nnz)``;
    ``device=False`` keeps a host ELL, ``device=True`` asks for the card
    (which raises here, with no card)."""
    from vsearch_tpu.index.bot_build import build_bot_ell as jbuild
    from vsearch_tpu_torch.index.bot_build import build_bot_ell

    tj, tt = bot_tokenizers
    kw = dict(max_len=64, shift=999, batch_size=16, max_token=200,
              num_workers=1, vocab_size=tt.vocab_size, return_host=True)
    ell_j, cols_j, nnz_j = jbuild(tj, BOT_TEXTS, **kw, device=device)
    if device and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_bot_ell(tt, BOT_TEXTS, **kw, device=device)
        return
    ell, cols, nnz = build_bot_ell(tt, BOT_TEXTS, **kw, device=device)
    assert isinstance(cols, np.ndarray) and isinstance(nnz, np.ndarray)
    assert ell.cols.device.type == ("cuda" if device else "cpu")
    assert cols.shape == cols_j.shape == (len(BOT_TEXTS), 256)
    np.testing.assert_array_equal(cols, cols_j)
    np.testing.assert_array_equal(nnz, nnz_j)
    np.testing.assert_array_equal(ell.cols.cpu().numpy(),
                                  np.asarray(ell_j.cols))


def test_set_ell_takes_host_cache(bot_tokenizers, monkeypatch):
    """``BoTIndex.set_ell(ell, host_cache=(cols, nnz))`` in both packages;
    the port's stream tier reads the cache in place of the ELL's copy, and
    both search to the same ids."""
    from vsearch_tpu.index.bot_build import build_bot_ell as jbuild
    from vsearch_tpu_torch.index.bot_build import build_bot_ell

    tj, tt = bot_tokenizers
    ell_j, cols_j, nnz_j = jbuild(tj, BOT_TEXTS, 64, 999,
                                  return_host=True)
    ell, cols, nnz = build_bot_ell(tt, BOT_TEXTS, 64, 999,
                                   return_host=True, device=False)
    j = JBoT()
    j.set_ell(ell_j, host_cache=(cols_j, nnz_j))
    t = BoTIndex(search_mode="stream", device="cpu")
    t.stream_block_rows = 16
    t.set_ell(ell, host_cache=(cols, nnz))
    from vsearch_tpu_torch.index import streamed

    given = []

    class Seen(streamed.StreamedBitpackSearcher):
        def __init__(self, c, n, *args, **kw):
            given.append((c, n))
            super().__init__(c, n, *args, **kw)

    monkeypatch.setattr(streamed, "StreamedBitpackSearcher", Seen)
    t._get_streamer()
    assert given[0][0] is cols and given[0][1] is nnz
    q = (np.random.default_rng(4).integers(0, 9, size=(3, ell.num_cols))
         / 4.0).astype(np.float32)
    a, b = j.search(q, k=5), t.search(q, k=5)
    np.testing.assert_array_equal(b.ids, np.asarray(a.ids))
    np.testing.assert_allclose(b.scores, np.asarray(a.scores), rtol=1e-6)
    t.set_ell(ell)  # a new ELL drops the cache
    assert t._host_cache is None


# -- A.3: the other public functions called JAX-style ------------------------
def test_ell_matvec_scores_takes_block_rows(files):
    from vsearch_tpu.ops import ell as jell
    from vsearch_tpu_torch.ops import ell as tell

    j, t = JSparse(files["sparse"]), SparseIndex(files["sparse"],
                                                 device="cpu")
    q = files["q"]
    want = np.asarray(jell.ell_matvec_scores(jnp.asarray(q), j.ell, 64))
    got = tell.ell_matvec_scores(torch.from_numpy(q), t.ell, 64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def bitmats():
    dense = (np.random.default_rng(9).random((1100, 300)) < 0.05
             ).astype(np.float32)
    q = (np.random.default_rng(10).integers(0, 17, size=(3, 300)) / 8.0
         ).astype(np.float32)
    return jb.pack_dense(dense), tb.pack_dense(dense, device="cpu"), q


def test_bitmatrix_num_ktiles(bitmats):
    jbm, tbm, _ = bitmats
    assert tbm.num_ktiles == jbm.num_ktiles == 1


@pytest.mark.parametrize("approx", [False, True])
def test_bitpack_searches_take_jax_arguments(bitmats, approx):
    """``bitpack_bucketed_topk(q, bm, k, bucket, row_block, interpret,
    approx_final, recall_target)`` and ``bitpack_topk_search(q, bm, k,
    interpret, approx, recall_target)`` positionally: off the TPU both
    packages select exactly, so ids are equal and scores within 1e-5."""
    jbm, tbm, q = bitmats
    for fn, args in (("bitpack_bucketed_topk", (10, 8, 1024, True, approx,
                                                0.9)),
                     ("bitpack_topk_search", (10, True, approx, 0.9))):
        ids_j, s_j = getattr(jb, fn)(jnp.asarray(q), jbm, *args)
        ids_t, s_t = getattr(tb, fn)(torch.from_numpy(q), tbm, *args)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("approx", [False, True])
def test_dense_topk_search_takes_jax_arguments(approx):
    """``dense_topk_search(q, v, k, precision, approx, recall_target)``
    positionally: JAX's fourth parameter is ``precision`` (the port's
    ``chunk_rows`` is keyword-only after it), accepted and unused."""
    import jax

    from vsearch_tpu.ops import search as jsearch
    from vsearch_tpu_torch.ops import search as tsearch

    rng = np.random.default_rng(11)
    v = rng.normal(size=(70, 16)).astype(np.float32)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    hi = jax.lax.Precision.HIGHEST
    ids_j, s_j = jsearch.dense_topk_search(jnp.asarray(q), jnp.asarray(v),
                                           9, hi, approx, 0.95)
    ids_t, s_t = tsearch.dense_topk_search(torch.from_numpy(q),
                                           torch.from_numpy(v), 9, hi,
                                           approx, 0.95)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(TypeError):
        tsearch.dense_topk_search(torch.from_numpy(q), torch.from_numpy(v),
                                  9, hi, approx, 0.95, 7)


def test_trace_takes_create_perfetto_link(tmp_path):
    """``trace(log_dir, create_perfetto_link)`` in the JAX package's order,
    ``device`` a keyword after it."""
    import inspect

    from vsearch_tpu.utils import profiling as jprof
    from vsearch_tpu_torch.utils import profiling as tprof

    jp = list(inspect.signature(jprof.trace).parameters)
    tp = list(inspect.signature(tprof.trace).parameters)
    assert tp[:len(jp)] == jp
    with tprof.trace(str(tmp_path), False, device="cpu"):
        torch.ones(4).sum()
    assert (tmp_path / "trace.json").is_file()


@pytest.mark.parametrize("depth", [None, 0, 2])
def test_pipeline_window_equals_jax(depth):
    """``pipeline_window(device_results, fetch, depth)``: the same results
    and the same interleaving of production and fetches."""
    from vsearch_tpu.models import encoder_base as jbase
    from vsearch_tpu_torch.models import encoder_base as tbase

    def drain(mod):
        events = []

        def produce():
            for i in range(12):
                events.append(("put", i))
                yield i

        out = mod.pipeline_window(produce(), lambda x: (
            events.append(("fetch", x)), 2 * x)[1], depth)
        return out, events

    assert drain(tbase) == drain(jbase)
    assert tbase.PIPELINE_DEPTH == jbase.PIPELINE_DEPTH
