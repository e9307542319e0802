"""CUDA kernels #1-#4 of the port against their plain PyTorch versions on
the card. They need an NVIDIA GPU with ``nvcc`` (Hopper, sm_90a) and skip
elsewhere; ``python3 chip_smoke.py`` runs the same checks at the main
path's shapes."""
import functools

import numpy as np
import pytest
import torch

from vsearch_tpu_torch.ops import bitpack as bp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def case(dev):
    rng = np.random.default_rng(0)
    n, v, nnz_pad = 3000, 5000, 128
    nnz = rng.integers(0, nnz_pad + 1, size=n).astype(np.int32)
    cols = np.full((n, nnz_pad), v, np.int32)
    for i in range(n):
        cols[i, : nnz[i]] = rng.choice(v, size=int(nnz[i]), replace=False)
    cols[0, :4] = -1
    nnz[-1] = nnz_pad + 3
    return (torch.from_numpy(cols).to(dev), torch.from_numpy(nnz).to(dev),
            v, rng)


def test_pack_bit_identical(case):
    cols, nnz, v, _ = case
    before = bp.LAUNCHES["pack"]
    got = bp.pack_bits(cols, nnz, v)
    torch.cuda.synchronize()
    assert bp.LAUNCHES["pack"] == before + 1
    assert torch.equal(got, bp.pack_bits_plain(cols, nnz, v))


@pytest.mark.parametrize("b", [1, 7, 32, 45])
def test_scores_and_keys(case, b):
    cols, nnz, v, rng = case
    words = bp.pack_bits(cols, nnz, v)
    vp = words.shape[1] * 32
    # dyadic weights: every sum is exact in f32, so results are identical
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(words.device)
    dy[v:] = 0
    qT = dy.to(torch.bfloat16)
    assert torch.equal(bp.score_bits(words, qT),
                       bp.score_bits_plain(words, qT))
    assert torch.equal(bp.bucket_keys(words, qT, cols.shape[0]),
                       bp.bucket_keys_plain(words, qT, cols.shape[0]))
    # random weights: f32 summation order only
    qT = torch.rand((vp, b), device=words.device)
    qT[v:] = 0
    qT = qT.to(torch.bfloat16)
    torch.testing.assert_close(bp.score_bits(words, qT),
                               bp.score_bits_plain(words, qT),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [1, 7, 32, 45])
def test_int8_keys_and_bucket16(case, b):
    """Kernel #4 is bit-identical with any weights (integer sums); kernel
    #3 at the block tier's bucket 16 under dyadic weights."""
    cols, nnz, v, rng = case
    n = cols.shape[0]
    words = bp.pack_bits(cols, nnz, v)
    vp = words.shape[1] * 32
    q = torch.from_numpy(np.abs(rng.normal(size=(b, v))).astype(np.float32))
    q8T = bp.prepare_queries_int8(q.to(words.device), vp)
    before = bp.LAUNCHES["int8_bucketed"]
    got = bp.int8_bucket_keys(words, q8T, n, 16)
    torch.cuda.synchronize()
    assert bp.LAUNCHES["int8_bucketed"] == before + 1
    assert torch.equal(got, bp.int8_bucket_keys_plain(words, q8T, n, 16))
    assert torch.equal(bp.int8_bucket_keys(words, q8T, n, 8),
                       bp.int8_bucket_keys_plain(words, q8T, n, 8))
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(words.device)
    dy[v:] = 0
    qT = dy.to(torch.bfloat16)
    assert torch.equal(bp.bucket_keys(words, qT, n, 16),
                       bp.bucket_keys_plain(words, qT, n, 16))


@pytest.fixture(scope="module", params=["ragged", "wide"])
def fold_case(request, dev):
    """Packed rows for the fold kernels: a ragged row count (3000 rows, or
    2053 rows of 1280 words, so a row ends in a part-filled 2 KB load of
    the warp), an all-zero row and a row with every vocab bit set (more
    set bits than a warp's decode list holds)."""
    rng = np.random.default_rng(1)
    n, v = (3000, 5000) if request.param == "ragged" else (2053, 40000)
    nnz_pad = 128
    nnz = rng.integers(0, nnz_pad + 1, size=n).astype(np.int32)
    cols = np.full((n, nnz_pad), v, np.int32)
    for i in range(n):
        cols[i, : nnz[i]] = rng.choice(v, size=int(nnz[i]), replace=False)
    nnz[5] = 0
    words = bp.pack_bits(torch.from_numpy(cols).to(dev),
                         torch.from_numpy(nnz).to(dev), v)
    full = bp.pack_bits_plain(torch.arange(v, dtype=torch.int32)[None],
                              torch.tensor([v], dtype=torch.int32), v)
    words[n - 2] = full[0].to(dev)
    assert v > 256  # a warp's decode list holds 256 (kListCap, bitrow.cuh)
    return words, n, v, rng


@pytest.mark.parametrize("bucket", [8, 16, 128])
@pytest.mark.parametrize("b", [1, 7, 31, 32, 33, 45, 200, 224, 256, 600,
                               1024, 2100])
def test_fold_kernels_bit_identical(fold_case, b, bucket):
    """Kernels #3 (dyadic weights) and #4 (any weights) equal their plain
    versions bit for bit, each in one launch. #4 sweeps every query inside
    the warp, 4, 8 or 16 a lane: one pass up to 512 queries (1-4 list
    entries a warp load), two at 600 and 1,024, where the row longer than
    the decode list is decoded again for the second pass, and at 2,100
    two tiles of queries along the grid."""
    words, n, v, rng = fold_case
    vp = words.shape[1] * 32
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(words.device)
    dy[v:] = 0
    qT = dy.to(torch.bfloat16)
    before = dict(bp.LAUNCHES)
    got = bp.bucket_keys(words, qT, n, bucket)
    torch.cuda.synchronize()
    assert bp.LAUNCHES["bucketed"] == before["bucketed"] + 1
    assert torch.equal(got, bp.bucket_keys_plain(words, qT, n, bucket))
    q = torch.from_numpy(np.abs(rng.normal(size=(b, v))).astype(np.float32))
    q8T = bp.prepare_queries_int8(q.to(words.device), vp)
    got = bp.int8_bucket_keys(words, q8T, n, bucket)
    torch.cuda.synchronize()
    assert bp.LAUNCHES["int8_bucketed"] == before["int8_bucketed"] + 1
    assert torch.equal(got, bp.int8_bucket_keys_plain(words, q8T, n, bucket))


@pytest.mark.parametrize("b", [1, 7, 32, 45])
def test_scores_share_the_fold_order(fold_case, b):
    """Kernel #2 on the fold kernels' rows (the odd row count included):
    equal to its plain version under dyadic weights; under random bf16
    weights its scores, spliced and folded as ``bucket_keys_plain`` does,
    equal kernel #3's keys bit for bit, so the two sum in one order."""
    words, n, v, rng = fold_case
    vp = words.shape[1] * 32
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(words.device)
    dy[v:] = 0
    qT = dy.to(torch.bfloat16)
    before = bp.LAUNCHES["scores"]
    got = bp.score_bits(words, qT)
    torch.cuda.synchronize()
    assert bp.LAUNCHES["scores"] == before + 1
    assert torch.equal(got, bp.score_bits_plain(words, qT))
    assert torch.equal(bp.score_bits(words[:n], qT), got[:n])
    qr = torch.from_numpy(rng.normal(size=(vp, b)).astype(np.float32))
    qr[v:] = 0
    qT = qr.to(words.device, torch.bfloat16)
    scores = bp.score_bits(words, qT)
    for bucket in (8, 16):
        assert torch.equal(bp.splice_keys(scores, n, bucket),
                           bp.bucket_keys(words, qT, n, bucket))


@functools.lru_cache(maxsize=2)
def rows_of_768_ids(n, v=29523, kk=768):
    """``n`` rows of exactly ``kk`` distinct ids of ``v`` (weights 0.5 +
    U[0, 1)) and 8 queries of 768 ids, from a seed."""
    rng = np.random.default_rng(9)
    cols = np.concatenate([
        np.argpartition(rng.random((256, v)), kk, axis=1)[:, :kk]
        for _ in range(n // 256)]).astype(np.int32)
    vals = (0.5 + rng.random((n, kk))).astype(np.float32)
    q = np.zeros((8, v), np.float32)
    for i in range(8):
        q[i, rng.choice(v, 768, replace=False)] = rng.random(768)
    return cols, vals, q


@pytest.mark.parametrize("n", [4096, bp.PLANE_MIN_ROWS])
@pytest.mark.parametrize("k,num_candidates,kernel", [
    # capped = min(256, n // 8, rows) = 256 >= k, and 256 * 8 <= rows:
    # kernel #3's route
    (10, 256, "bucketed"),
    # capped = min(500, n // 8) = 500 < k: kernel #2
    (600, 500, "scores"),
])
def test_bitproxy_card_matches_cpu_at_768_ids(dev, k, num_candidates,
                                              kernel, n):
    """Alpha search through the binary-support proxy on rows of 768
    distinct ids (``embed_sparse``'s top-k at BERT width, more set bits a
    row than the kernels' decode list holds): the pack is bit-identical,
    kernel #3's keys are bit-identical under dyadic weights, and the
    search on the card equals the search on the CPU (ids up to f32 near
    ties, scores within 1e-5 relative). The rows are above the crossover
    width, so an index of ``PLANE_MIN_ROWS`` rows runs the plane form and
    one of 4,096 rows the gather form (``row_form``); both forms are held
    to the plain versions under dyadic weights."""
    from vsearch_tpu_torch.ops import two_stage as ts
    from vsearch_tpu_torch.ops.ell import ELLMatrix

    v, kk = 29523, 768
    cols, vals, q = rows_of_768_ids(n)
    nnz = np.full(n, kk, np.int32)
    rng = np.random.default_rng(n)
    form = "plane" if n >= bp.PLANE_MIN_ROWS else "gather"
    kernel += "_plane" if form == "plane" else ""
    out = []
    for d in ("cpu", dev):
        ell = ELLMatrix.from_arrays(cols, nnz, vals, v, False, d)
        bm = bp.pack_ell(ell)
        assert bm.form == form
        before = dict(bp.LAUNCHES)
        ids, scores = ts.binary_proxy_search(
            torch.from_numpy(q).to(d), ell, bm, k=k,
            num_candidates=num_candidates)
        if d == dev:
            torch.cuda.synchronize()
            assert bp.LAUNCHES[kernel] == before[kernel] + 1
        out.append((bm.words.cpu(), ids.cpu().numpy(),
                    scores.cpu().numpy()))
    (w_c, i_c, s_c), (w_g, i_g, s_g) = out
    assert torch.equal(w_g, w_c)
    np.testing.assert_allclose(s_g, s_c, rtol=1e-5, atol=0)
    for r, j in zip(*np.nonzero(i_g != i_c)):
        near = np.abs(s_c[r] - s_c[r, j]) <= 1e-5 * abs(s_c[r, j])
        assert near.sum() > 1 or j == k - 1, (r, j)
    words = w_g.to(dev)
    dy = torch.from_numpy((rng.integers(0, 129, size=(words.shape[1] * 32,
                                                      8)) / 16.0)
                          .astype(np.float32)).to(dev)
    dy[v:] = 0
    qT = dy.to(torch.bfloat16)
    assert torch.equal(bp.bucket_keys(words, qT, n),
                       bp.bucket_keys_plain(words, qT, n))
    assert torch.equal(bp.score_bits(words, qT),
                       bp.score_bits_plain(words, qT))
    for form in bp.FORMS:
        assert torch.equal(bp.bucket_keys(words, qT, n, 8, v, _form=form),
                           bp.bucket_keys_plain(words, qT, n)), form
        assert torch.equal(bp.score_bits(words, qT, v, _form=form),
                           bp.score_bits_plain(words, qT)), form


@pytest.mark.parametrize("name", ["scores_plane", "bucketed_plane"])
def test_plane_shared_memory_fits_the_card(dev, name):
    """A plane-form CTA (4 warpgroups and a producer warp, the ring of
    query slices in dynamic shared memory, #3's slots) takes one tile of
    32 queries whatever B, so its registers and shared memory are the
    same at any B; the CUDA runtime fits at least one on an SM."""
    from vsearch_tpu_torch.ops import cuda_build

    assert cuda_build.occupancy(name) >= 1


def dense_words(dev, n, v, ids, seed):
    """Packed rows of exactly ``ids`` distinct columns of ``v``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cols = torch.rand((n, v), generator=gen, device=dev).argsort(dim=1)
    cols = cols[:, :ids].sort(dim=1).values.to(torch.int32)
    return bp.pack_bits(cols, torch.full((n,), ids, dtype=torch.int32,
                                         device=dev), v)


@pytest.fixture(scope="module", params=["ragged", "768 ids"])
def plane_case(request, dev):
    """(words, rows, columns): the ragged shape of the kernel checks
    (2,500 rows of 0-128 ids, V=5,000) and 8,192 rows of 768 ids at
    V'=29,523 (the plane form's rows)."""
    if request.param == "ragged":
        rng = np.random.default_rng(1)
        n, v, nnz_pad = 2500, 5000, 128
        nnz = rng.integers(0, nnz_pad + 1, size=n).astype(np.int32)
        cols = np.full((n, nnz_pad), v, np.int32)
        for i in range(n):
            cols[i, : nnz[i]] = rng.choice(v, size=int(nnz[i]),
                                           replace=False)
        return bp.pack_bits(torch.from_numpy(cols).to(dev),
                            torch.from_numpy(nnz).to(dev), v), n, v
    return dense_words(dev, 8192, 29_523, 768, 3), 8192, 29_523


@pytest.mark.parametrize("b", [1, 7, 32, 45])
def test_plane_forms_match_plain(plane_case, b):
    """The plane forms of #2 and #3 equal their plain versions bit for bit
    under dyadic weights; under real weights #2 within f32 rounding and
    #3's keys within 2^-12 of their scale; #3's keys are #2's plane
    scores spliced and folded, bit for bit."""
    words, n, v = plane_case
    dev, vp = words.device, words.shape[1] * 32
    rng = np.random.default_rng(b)
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(dev)
    dy[v:] = 0
    dy = dy.to(torch.bfloat16)
    before = dict(bp.LAUNCHES)
    assert torch.equal(bp.score_bits(words, dy, v, _form="plane"),
                       bp.score_bits_plain(words, dy))
    for bucket in (8, 16):
        assert torch.equal(
            bp.bucket_keys(words, dy, n, bucket, v, _form="plane"),
            bp.bucket_keys_plain(words, dy, n, bucket))
    torch.cuda.synchronize()
    assert bp.LAUNCHES["scores_plane"] == before["scores_plane"] + 1
    assert bp.LAUNCHES["bucketed_plane"] == before["bucketed_plane"] + 2
    assert bp.LAUNCHES["scores"] == before["scores"]
    qr = torch.rand((vp, b), device=dev)
    qr[v:] = 0
    qT = qr.to(torch.bfloat16)
    got, want = bp.score_bits(words, qT, v, _form="plane"), \
        bp.score_bits_plain(words, qT)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    dec = lambda kk: (kk & ~1023).view(torch.float32).clamp_min(0)
    keys = bp.bucket_keys(words, qT, n, 8, v, _form="plane")
    ref = bp.bucket_keys_plain(words, qT, n)
    assert float((dec(keys) - dec(ref)).abs().max()) <= \
        2.0 ** -12 * float(dec(ref).max())
    for bucket in (8, 16):
        assert torch.equal(
            bp.splice_keys(got, n, bucket),
            bp.bucket_keys(words, qT, n, bucket, v, _form="plane"))


def test_forms_give_equal_candidates_at_768_ids(dev):
    """On one index of 768-id rows the two forms pick the same candidate
    rows, apart from rows whose keys tie: a row whose score lies within
    the keys' 2^-12 of another candidate's, or of the cut."""
    n, v = 65_536, 29_523
    words = dense_words(dev, n, v, 768, 5)
    plane = bp.BitMatrix(words=words, num_rows=n, num_cols=v,
                         mean_bits=768.0)
    gather = bp.BitMatrix(words=words, num_rows=n, num_cols=v)
    assert (plane.form, gather.form) == ("plane", "gather")
    q = torch.rand((32, v), device=dev)
    before = dict(bp.LAUNCHES)
    ids_p, s_p = bp.bitpack_bucketed_topk(q, plane, k=256)
    ids_g, s_g = bp.bitpack_bucketed_topk(q, gather, k=256)
    torch.cuda.synchronize()
    assert bp.LAUNCHES["bucketed_plane"] == before["bucketed_plane"] + 1
    assert bp.LAUNCHES["bucketed"] == before["bucketed"] + 1
    scale = float(s_g.max())
    assert float((s_p - s_g).abs().max()) <= 2.0 ** -12 * scale
    for r, j in zip(*torch.nonzero(ids_p != ids_g).cpu().numpy().T):
        tol = 2.0 ** -12 * scale
        near = (s_g[r] - s_g[r, j]).abs() <= tol
        assert int(near.sum()) > 1 or float(s_g[r, j] - s_g[r, -1]) <= tol, \
            (r, j)
