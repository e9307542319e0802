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
