"""The plane form of kernels #2 and #3 (``csrc/planes.cuh``) without a
card: its launch geometry and query operand, computed in Python and passed
to the CUDA entry points; the crossover rule that picks it; the row width
``BitMatrix`` carries to it through packing, the bitproxy index and the
mesh; and the bitproxy search over rows of a few hundred ids against the
JAX package (its Pallas kernels in interpret mode, the port's wrappers on
CPU tensors running the plain versions)."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from vsearch_tpu.ops import bitpack as jb
from vsearch_tpu.ops import two_stage as jts
from vsearch_tpu.ops.ell import ELLMatrix as JELL
from vsearch_tpu_torch.index import SparseIndex
from vsearch_tpu_torch.ops import bitpack as bp
from vsearch_tpu_torch.ops import two_stage as tts
from vsearch_tpu_torch.ops.ell import ELLMatrix as TELL
from vsearch_tpu_torch.parallel import make_mesh
from vsearch_tpu_torch.parallel import sharded_search as ss

W = 1024  # words of a row at V' = 29,523


def plane_rows(geom, n_pad):
    """The rows [grid_x, rows_per_cta] that CTA x runs, pass after pass,
    as ``plane_rows`` in planes.cuh maps them (#2: row0 = 256 x; #3: the
    part x % split of block x // split)."""
    x = torch.arange(geom.grid[0])[:, None]
    r = torch.arange(geom.rows_per_cta)[None, :]
    if geom.split == 1 and geom.rows_per_cta == bp.PLANE_ROWS:
        return x * bp.PLANE_ROWS + r
    block, part = x // geom.split, x % geom.split
    return block * bp.ROW_BLOCK + part * geom.rows_per_cta + r


@pytest.mark.parametrize("b", [1, 32, 45])
@pytest.mark.parametrize("rows", [1000, 3000, 32_768, 1 << 18, 2_000_000])
def test_scores_plane_covers_every_row_once(rows, b):
    n_pad = -(-rows // bp.ROW_BLOCK) * bp.ROW_BLOCK
    geom = bp.plane_geometry(n_pad, b, W, 29_523)
    assert geom.grid[1] == -(-b // 32) and geom.passes == 1
    got = plane_rows(geom, n_pad).flatten()
    got = got[got < n_pad]  # the kernel neither reads nor writes past it
    assert torch.equal(got.sort().values, torch.arange(n_pad))


@pytest.mark.parametrize("bucket", [8, 16, 128])
@pytest.mark.parametrize("rows", [1000, 3000, 32_768, 1 << 17, 1 << 18,
                                  2_000_000])
def test_bucketed_plane_folds_each_block_in_its_ctas(rows, bucket):
    """Every row is run once, by a CTA of its own 1024-row block; a block
    is one CTA's once the index has PLANE_FILL_BLOCKS blocks, else split
    over 2 or 4 CTAs whose slots are max-folded in device memory."""
    n_pad = -(-rows // bp.ROW_BLOCK) * bp.ROW_BLOCK
    geom = bp.plane_geometry(n_pad, 32, W, 29_523, bucket)
    blocks = n_pad // bp.ROW_BLOCK
    assert geom.grid[0] == blocks * geom.split
    assert geom.passes * bp.PLANE_ROWS * geom.split == bp.ROW_BLOCK
    want_split = (1 if blocks >= bp.PLANE_FILL_BLOCKS
                  else 2 if 2 * blocks >= bp.PLANE_FILL_BLOCKS else 4)
    assert geom.split == want_split
    rows_of = plane_rows(geom, n_pad)
    assert torch.equal(rows_of.flatten().sort().values, torch.arange(n_pad))
    owner = torch.arange(geom.grid[0])[:, None] // geom.split
    assert torch.equal(rows_of // bp.ROW_BLOCK, owner.expand_as(rows_of))


@pytest.mark.parametrize("num_cols,nplanes", [
    (29_523, 232), (27_623, 216), (5000, 40), (4096, 32), (1, 2), (0, 0)])
def test_planes_past_num_cols_are_skipped(num_cols, nplanes):
    """Planes that start at or past num_cols are skipped, as the TPU
    kernel skips them (24 of 256 at V' = 29,523: the kernels run planes
    in pairs, so an odd count takes one zero plane more)."""
    w = max(-(-num_cols // bp.TILE_BITS), 1) * bp.LANES
    assert bp.plane_geometry(1024, 7, w, num_cols).nplanes == nplanes
    assert bp._plane_steps(nplanes, torch.device("cpu")).shape == \
        (2 * nplanes, 64)


def test_plane_geometry_rejects_buckets_below_8():
    with pytest.raises(ValueError, match="bucket"):
        bp.plane_geometry(1 << 18, 32, W, 29_523, 4)


@pytest.mark.parametrize("num_cols,b", [(29_523, 32), (5000, 40)])
def test_plane_operand_is_the_rings_slices(num_cols, b):
    """Slice j of query tile i holds query rows ``steps[j]`` of queries
    32 i .. 32 i + 31 as wgmma's K-major core matrices: row 8 kg + kk of
    query 8 ng + nn at element ((kg * 4 + ng) * 8 + nn) * 8 + kk; the
    slices of even planes are scaled by 2^64, exactly."""
    vp = -(-num_cols // bp.TILE_BITS) * bp.TILE_BITS
    gen = torch.Generator().manual_seed(0)
    qp = bp._pad_queries(torch.randn(vp, b, generator=gen)
                         .to(torch.bfloat16))
    nplanes = -(-num_cols // bp.LANES)
    qi = bp._plane_operand(qp, nplanes)
    steps = bp._plane_steps(nplanes, qp.device)
    assert qi.shape == (qp.shape[1] // 32, 2 * nplanes, 2048)
    assert qi.dtype == torch.bfloat16 and qi.is_contiguous()
    kg, kk, ng, nn = torch.meshgrid(*[torch.arange(8), torch.arange(8),
                                      torch.arange(4), torch.arange(8)],
                                    indexing="ij")
    off = ((kg * 4 + ng) * 8 + nn) * 8 + kk
    plane = (steps[:, 0] % bp.TILE_BITS) // bp.LANES
    scale = torch.where(plane % 2 == 0, 2.0 ** 64, 1.0)[:, None]
    for tile in range(qi.shape[0]):
        want = qp[steps[:, (8 * kg + kk).flatten()],
                  (32 * tile + 8 * ng + nn).flatten()].float() * scale
        assert torch.equal(qi[tile][:, off.flatten()].float(), want)
    # step order: tile, half, plane; the first planes of tile 0
    assert steps[0, 0] == 0 and steps[1, 0] == 128
    planes0 = min(32, nplanes)
    assert steps[planes0, 0] == 64  # the second half of plane 0


@pytest.mark.parametrize("bits,n_pad,form", [
    (bp.PLANE_MIN_BITS, bp.PLANE_MIN_ROWS, "plane"),
    (bp.PLANE_MIN_BITS - 1, bp.PLANE_MIN_ROWS, "gather"),
    (768, bp.PLANE_MIN_ROWS - bp.ROW_BLOCK, "gather"),
    (768, 4096, "gather"),  # the bitproxy fallback's rows
    (768, 32_768, "plane"),  # the cross-modal image index
    (768, 2_000_896, "plane"),  # 2,000,000 alpha rows, padded
    (78, 2_000_896, "gather"),  # bag-of-token rows
])
def test_crossover_rule(bits, n_pad, form):
    assert bp.row_form(bits, n_pad) == form
    words = torch.zeros((n_pad, 128), dtype=torch.int32)
    assert bp.BitMatrix(words=words, num_rows=n_pad, num_cols=4096,
                        mean_bits=bits).form == form
    # a BitMatrix made without a width keeps the gather form
    assert bp.BitMatrix(words=words, num_rows=n_pad,
                        num_cols=4096).form == "gather"


def dense_rows(n, v, ids, seed):
    """``n`` real-valued rows of exactly ``ids`` distinct columns of
    ``v`` (weights 0.5 + U[0, 1)), as scipy CSR."""
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(v, size=ids, replace=False))
                     for _ in range(n)])
    vals = (0.5 + rng.random((n, ids))).astype(np.float32)
    return sp.csr_matrix((vals.ravel(), cols.ravel(),
                          np.arange(0, n * ids + 1, ids)), shape=(n, v))


@pytest.fixture(scope="module")
def wide():
    """2,048 rows of 300 ids at V=5,000 (above the crossover width) and 7
    queries, in both packages."""
    mat = dense_rows(2048, 5000, 300, 11)
    q = np.abs(np.random.default_rng(11).normal(size=(7, 5000))
               ).astype(np.float32)
    return mat, q, JELL.from_scipy_csr(mat), TELL.from_scipy_csr(
        mat, device="cpu")


@pytest.fixture
def small_plane_rows(monkeypatch):
    """Let an index of any row count take the plane form by its width
    alone, so that ``wide``'s 2,048 rows run the plane form's path."""
    monkeypatch.setattr(bp, "PLANE_MIN_ROWS", bp.ROW_BLOCK)


def test_width_carried_by_the_pack_and_the_index(wide, small_plane_rows):
    mat, _, _, tell = wide
    bm = bp.pack_ell_device(tell)
    assert bm.mean_bits == 300.0 and bm.form == "plane"
    assert bp.ell_mean_bits(tell) == 300.0
    idx = SparseIndex(search_mode="bitproxy", device="cpu")
    idx.set_ell(tell)
    idx.search(wide[1], k=5)
    assert idx.bitproxy.mean_bits == 300.0 and idx.bitproxy.form == "plane"
    # ragged rows: the mean of nnz within nnz_pad
    sparse = TELL.from_scipy_csr(dense_rows(100, 500, 40, 1), device="cpu")
    assert bp.pack_ell_device(sparse).form == "gather"


@pytest.mark.parametrize("selection", ["bucketed", "exact"])
def test_width_carried_to_the_mesh_shards(wide, monkeypatch, selection,
                                          small_plane_rows):
    """``shard_bitmat`` and ``pack_shards`` give every shard the whole
    index's width, so each shard takes the form of that width at its own
    row count; the sharded search runs it."""
    _, q, _, tell = wide
    mesh = make_mesh(devices=["cpu"] * 4)
    whole = bp.pack_ell_device(tell)
    for shards in (ss.shard_bitmat(mesh, whole), ss.pack_shards(mesh, tell)):
        assert all(p.mean_bits == 300.0 for p in shards.parts)
    seen = []
    for name in ("score_bits", "bucket_keys"):
        fn = getattr(bp, name)
        monkeypatch.setattr(bp, name, lambda *a, _fn=fn, **kw: (
            seen.append(kw.get("_form")), _fn(*a, **kw))[1])
    search = ss.make_sharded_bitpack_search(
        mesh, 5, ss.shard_bitmat(mesh, whole), selection=selection)
    ids, _ = search(torch.from_numpy(q), ss.shard_bitmat(mesh, whole))
    assert ids.shape == (7, 5) and seen and set(seen) == {"plane"}


@pytest.mark.parametrize("packed", [False, True])
def test_width_carried_by_bot_index_to_mesh(wide, packed, small_plane_rows):
    """``BoTIndex.to_mesh`` shards its packed bits (``shard_bitmat``) or
    packs each shard (``pack_shards``); either way every shard keeps the
    index's width, and the sharded search answers as one device does."""
    from vsearch_tpu_torch.index import BoTIndex

    mat, q = wide[0], wide[1]
    one = BoTIndex(search_mode="bitpack", selection="bucketed", device="cpu")
    one.set_ell(TELL.from_scipy_csr(mat, binary=True, device="cpu"))
    idx = BoTIndex(search_mode="bitpack", selection="bucketed", device="cpu")
    idx.set_ell(TELL.from_scipy_csr(mat, binary=True, device="cpu"))
    if packed:
        idx.build_bitpack()
        assert idx.bitmat.form == "plane"
    idx.to_mesh(make_mesh(devices=["cpu"] * 2))
    assert idx._mesh_kind == "bits"
    assert [p.mean_bits for p in idx._shards.parts] == [300.0, 300.0]
    a, b = one.search(q, k=5), idx.search(q, k=5)
    np.testing.assert_array_equal(b.ids, a.ids)
    np.testing.assert_array_equal(b.scores, a.scores)


def test_plane_form_on_cpu_runs_the_plain_version(wide):
    tell = wide[3]
    bm = bp.pack_ell_device(tell)
    qT = bp.prepare_queries(torch.from_numpy(wide[1]), bm)
    want = bp.score_bits_plain(bm.words, qT)
    before = dict(bp.LAUNCHES)
    for form in bp.FORMS:
        assert torch.equal(bp.score_bits(bm.words, qT, 5000, _form=form),
                           want)
        assert torch.equal(
            bp.bucket_keys(bm.words, qT, 2048, 8, 5000, _form=form),
            bp.splice_keys(want, 2048, 8))
    assert bp.LAUNCHES == before
    with pytest.raises(ValueError, match="form"):
        bp.score_bits(bm.words, qT, _form="dense")
    with pytest.raises(ValueError, match="form"):
        bp.bucket_keys(bm.words, qT, 2048, _form="dense")


@pytest.mark.parametrize("k,num_candidates", [(10, 64), (300, 600)])
def test_bitproxy_at_dense_rows_matches_jax(wide, k, num_candidates,
                                            small_plane_rows):
    """The port's bitproxy search over 300-id rows (the plane form's
    rows) against JAX's ``binary_proxy_search``: bucketed candidates
    (capped = 64) and the exact fallback (capped 256 < k)."""
    _, q, jell, tell = wide
    jbm, tbm = jb.pack_ell(jell), bp.pack_ell(tell)
    assert tbm.form == "plane"
    np.testing.assert_array_equal(tbm.words.numpy().view(np.uint32),
                                  np.asarray(jbm.words))
    ja, js = jts.binary_proxy_search(jnp.asarray(q), jell, jbm, k=k,
                                     num_candidates=num_candidates)
    ta, ts = tts.binary_proxy_search(torch.from_numpy(q), tell, tbm, k=k,
                                     num_candidates=num_candidates)
    ja, js, ta, ts = (np.asarray(x) for x in (ja, js, ta, ts))
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
    for r, j in zip(*np.nonzero(ta != ja)):
        near = np.abs(ts[r] - ts[r][j]) <= 1e-4
        assert near.sum() > 1 or j == k - 1, (r, j)
