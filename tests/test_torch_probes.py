"""The port's probes (``vsearch_tpu_torch/scripts``) and their kernels
(``vsearch_tpu_torch/ops/probes.py``): the plain twins of P1, P2 and P5
against the JAX package's own functions for the same work (its Pallas
kernels in interpret mode; the TPU probe scripts themselves claim the TPU
at import and are not imported), each probe's ``main`` end to end at a
tiny size on the CPU with its JSON keys, and the kernels on the card
(``cuda``, skipped here)."""
import json

import numpy as np
import pytest
import torch

from vsearch_tpu_torch.ops import bitpack as tb
from vsearch_tpu_torch.ops import probes


def jax_modules():
    """(jax, jax.numpy, the JAX package's bitpack), imported by the tests
    that compare with them: the card's machine, which runs this file's
    ``cuda`` tests, has no JAX."""
    import jax
    import jax.numpy as jnp

    from vsearch_tpu.ops import bitpack as jb

    return jax, jnp, jb

@pytest.fixture(scope="module")
def rng():
    # this file's own (conftest.py's, which imports JAX, is not loaded on
    # the card's machine)
    return np.random.default_rng(0)


# random weights: both sides sum the same bf16 terms in f32 in another
# order, so decoded scores agree to a few f32 ulps of their size
KEY_RTOL = 1e-6


def distinct_ell(rng, n, v, nnz_pad):
    """Rows of distinct ids, ragged nnz, sentinel pads, a negative id and
    a row whose nnz exceeds nnz_pad."""
    nnz = rng.integers(0, nnz_pad + 1, size=n).astype(np.int32)
    cols = np.full((n, nnz_pad), v, np.int32)
    for i in range(n):
        cols[i, : nnz[i]] = rng.choice(v, size=int(nnz[i]), replace=False)
    cols[0, :3] = -1
    nnz[-1] = nnz_pad + 9
    return cols, nnz


@pytest.mark.parametrize("s,l", [(8, 128), (3, 5), (16, 256)])
def test_bitcast_plain_is_layout_a_of_jax(rng, s, l):
    """P1's plain twin against ``jax.lax.bitcast_convert_type`` (u32 ->
    bf16 adds a trailing axis of the two halves), laid out as layout A:
    the low half at row 2s, the high half at row 2s + 1."""
    jax, jnp, _ = jax_modules()
    x = rng.integers(0, 2 ** 32, size=(s, l), dtype=np.uint64).astype(
        np.uint32)
    halves = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(x), jnp.bfloat16)).view(np.uint16)  # [s, l, 2]
    want = halves.transpose(0, 2, 1).reshape(2 * s, l)
    got = probes.bitcast_rows(torch.from_numpy(x.view(np.int32)))
    assert got.dtype == torch.bfloat16 and got.shape == (2 * s, l)
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16), want)


def test_bitcast_probe_reads_layout_a():
    from vsearch_tpu_torch.scripts import probe_bitcast_layout as p

    jax, jnp, _ = jax_modules()
    x = p.layout_words()
    got = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(x.numpy().view(np.uint32)), jnp.bfloat16),
        np.float32)[:, 0]
    np.testing.assert_allclose(got[:, 0], 1.0 + np.arange(p.S) / 256,
                               atol=1e-2)
    np.testing.assert_allclose(got[:, 1], 2.0 + np.arange(p.S) / 256,
                               atol=1e-2)
    assert p.main(["--device", "cpu"])["layout"] == "A"


@pytest.fixture(scope="module")
def packed(rng):
    """2,500 rows over V = 5,000 (two 4,096-id tiles), nnz_pad 16, packed
    by the JAX package's Pallas pack in interpret mode and by P2's plain
    twin."""
    _, jnp, jb = jax_modules()
    n, v, nnz_pad = 2500, 5000, 16
    cols, nnz = distinct_ell(rng, n, v, nnz_pad)
    jwords = np.asarray(jb._pack_fn(n, nnz_pad, v, True)(
        jnp.asarray(cols), jnp.asarray(nnz)))
    words_t = probes.pack_bits_t(torch.from_numpy(cols),
                                 torch.from_numpy(nnz), v)
    return cols, nnz, v, jwords, words_t


def test_pack_t_plain_is_jax_pack_transposed(packed):
    _, _, _, jwords, words_t = packed
    assert words_t.shape == (jwords.shape[1], jwords.shape[0])
    np.testing.assert_array_equal(words_t.numpy().view(np.uint32),
                                  jwords.T)


def test_pack_t_plain_is_pack_transposed(packed):
    cols, nnz, v, _, words_t = packed
    assert torch.equal(words_t, tb.pack_bits(torch.from_numpy(cols),
                                             torch.from_numpy(nnz), v).T)


def jax_keys(q, jwords, n, v, bucket):
    _, jnp, jb = jax_modules()
    bm = jb.BitMatrix(words=jnp.asarray(jwords), num_rows=n, num_cols=v)
    return np.asarray(jb._bucketed_keys(jnp.asarray(q), bm, bucket,
                                        jb.ROW_BLOCK, True))


@pytest.mark.parametrize("bucket", [8, 1])
def test_keys_t_plain_bit_identical_to_jax_dyadic(rng, packed, bucket):
    cols, nnz, v, jwords, words_t = packed
    n = cols.shape[0]
    q = (rng.integers(0, 129, size=(5, v)) / 16.0).astype(np.float32)
    qT = tb._prepare_bf16(torch.from_numpy(q), words_t.shape[0] * 32)
    got = probes.bucket_keys_t(words_t, qT, n, bucket).numpy()
    np.testing.assert_array_equal(got, jax_keys(q, jwords, n, v, bucket))


def test_keys_t_plain_matches_jax_scores(rng, packed):
    cols, nnz, v, jwords, words_t = packed
    n = cols.shape[0]
    q = rng.random((7, v)).astype(np.float32)
    qT = tb._prepare_bf16(torch.from_numpy(q), words_t.shape[0] * 32)
    got = probes.bucket_keys_t(words_t, qT, n).numpy()
    want = jax_keys(q, jwords, n, v, 8)
    dec = lambda k: np.where(k < 0, 0, k & ~1023).view(np.float32)  # noqa
    np.testing.assert_allclose(dec(got), dec(want), rtol=KEY_RTOL,
                               atol=KEY_RTOL * dec(want).max())
    assert ((got < 0) == (want < 0)).all()


def test_timing_variants_twin_is_the_function(rng, packed):
    """On the CPU the plane form's timing variants run the function they
    time, kernel #3's plain version."""
    cols, nnz, v, _, words_t = packed
    words = words_t.T.contiguous()
    q = torch.from_numpy(rng.random((3, v)).astype(np.float32))
    qT = tb._prepare_bf16(q, words.shape[1] * 32)
    want = tb.bucket_keys_plain(words, qT, cols.shape[0])
    for kernel in probes.PLANE_VARIANTS:
        assert torch.equal(probes.plane_variant(kernel, words, qT,
                                                cols.shape[0], 8, v), want)
    with pytest.raises(ValueError, match="plane_variant"):
        probes.plane_variant("bucketed_plane", words, qT, cols.shape[0])


# -- each probe end to end, tiny, on the CPU ---------------------------------
TINY = {
    "probe_bitcast_layout": ([], ["layout", "interleaved_A", "blocked_B",
                                  "check", "ms", "bound_ms"]),
    "probe_pack": (["--rows", "2000", "--vocab", "3000"],
                   ["packT", "pack", "words_t_equals_words_T"]),
    "probe_scorer_variants": (
        ["--rows", "1500", "--b", "4", "--dense-rows", "1024",
         "--check-rows", "256"],
        ["small_check", "rows", "v3_equals_v0", "plane_split"]),
    "probe_int8_scorer": (["--rows", "2048", "--b", "4"],
                          ["bf16_b16_ms", "int8_b16_ms", "int8_b32_tfs",
                           "cand_recall_c100", "cand_recall_c400"]),
    "probe_block_parts": (["--rows", "2048", "--b", "4"],
                          ["pack_ms", "keys_ms", "topk_f32_ms",
                           "topk_int_ms", "topk_int_matches", "merge_ms",
                           "block_iter_ms", "topk_approx"]),
    "probe_block_b2048": (["--rows", "3000", "--block-rows", "2048",
                           "--b-scale", "512"],
                          ["b1024_bkt16_qps", "b2048_bkt32_sweep_s",
                           "b1024_bkt32_recall"]),
    "bitpack_regret_probe": (["--sizes", "1500,3000", "--b", "4"],
                             ["rows", "b", "k"]),
    "probe_alpha_sweep": (["--rows", "3000", "--b", "4", "--c-list",
                           "256,512", "--iters", "1"],
                          ["rows", "proxy_form", "nnz"]),
    "probe_stream": (["--rows", "2500", "--rows-a", "2000", "--b-list",
                      "4", "--iters", "1"], ["stage_a", "stage_b"]),
    "probe_embed_mfu": (["--b", "2", "--l", "8", "--layers", "1",
                         "--hidden", "32", "--heads", "2",
                         "--intermediate", "64", "--vocab", "1200",
                         "--dtype", "float32"],
                        ["full_tfs", "bert_tfs", "head_naive_tfs",
                         "head_chunked_tfs", "stack_split_tfs",
                         "stack_fused_tfs", "fused_within_atol"]),
    "probe_serve_load": (["--num-passages", "200", "--layers", "1",
                          "--hidden", "32", "--heads", "2",
                          "--intermediate", "64", "--duration", "0.3",
                          "--phases", "2x1,1x1r", "--warmup-max", "1"],
                         ["healthz_rtt_ms", "phases", "server_stats",
                          "device_calls_per_request"]),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_probe_main_on_the_cpu(name, tmp_path, capsys):
    import importlib

    argv, keys = TINY[name]
    out = str(tmp_path / "out.json")
    mod = importlib.import_module(f"vsearch_tpu_torch.scripts.{name}")
    res = mod.main(argv + ["--device", "cpu", "--out", out])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(res))
    with open(out) as f:
        assert json.load(f) == json.loads(lines[-1])
    assert res["device"] == "cpu"
    assert not set(keys) - set(res), set(keys) - set(res)
    flags = [v for k, v in _flat(res) if k.endswith(
        ("bit_identical", "bit_identical_dyadic", "_equals_words_T",
         "decoded_within", "matches_resident", "fused_within_atol",
         "topk_int_matches", "v3_equals_v0", "ok"))]
    assert all(flags), res
    # a CPU run times nothing on the device (bounds are computed)
    assert all(v is None for k, v in _flat(res)
               if k.endswith(("_ms", "_tfs", "qps")) and v != "n/a"
               and k not in ("bound_ms", "healthz_rtt_ms")), res


def _flat(d, pre=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _flat(v, k)
    elif isinstance(d, list):
        for v in d:
            yield from _flat(v, pre)
    else:
        yield pre, d


# -- the kernels on the card --------------------------------------------------
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bitcast_kernel(dev):
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 128), dtype=torch.int32,
                      device=dev)
    before = tb.LAUNCHES["bitcast_rows"]
    got = probes.bitcast_rows(x)
    torch.cuda.synchronize()
    assert tb.LAUNCHES["bitcast_rows"] == before + 1
    # bit patterns: random words hold NaNs, which torch.equal calls unequal
    assert torch.equal(got.view(torch.int16),
                       probes.bitcast_rows_plain(x).view(torch.int16))


@pytest.mark.cuda
def test_pack_t_kernel(dev, rng):
    cols, nnz = distinct_ell(rng, 3000, 5000, 128)
    c, z = torch.from_numpy(cols).to(dev), torch.from_numpy(nnz).to(dev)
    got = probes.pack_bits_t(c, z, 5000)
    assert torch.equal(got, probes.pack_bits_t_plain(c, z, 5000))
    assert torch.equal(got, tb.pack_bits(c, z, 5000).T)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32, 45])
def test_keys_t_kernel(dev, rng, b):
    cols, nnz = distinct_ell(rng, 3000, 5000, 128)
    c, z = torch.from_numpy(cols).to(dev), torch.from_numpy(nnz).to(dev)
    words = tb.pack_bits(c, z, 5000)
    words_t = probes.pack_bits_t(c, z, 5000)
    vp = words.shape[1] * 32
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(dev)
    dy[5000:] = 0
    dyT = dy.to(torch.bfloat16)
    assert torch.equal(probes.bucket_keys_t(words_t, dyT, 3000),
                       probes.bucket_keys_t_plain(words_t, dyT, 3000))
    qT = torch.rand((vp, b), device=dev).to(torch.bfloat16)
    # the gather form's order of summation: equal keys for any weights
    assert torch.equal(probes.bucket_keys_t(words_t, qT, 3000),
                       tb.bucket_keys(words, qT, 3000))


@pytest.mark.cuda
def test_plane_timing_variants_launch(dev, rng):
    cols, nnz = distinct_ell(rng, 8192, 5000, 512)
    c, z = torch.from_numpy(cols).to(dev), torch.from_numpy(nnz).to(dev)
    words = tb.pack_bits(c, z, 5000)
    qT = torch.rand((words.shape[1] * 32, 32), device=dev).to(
        torch.bfloat16)
    for name in probes.PLANE_VARIANTS:
        before = tb.LAUNCHES[name]
        keys = probes.plane_variant(name, words, qT, 8192, 8, 5000)
        torch.cuda.synchronize()
        assert tb.LAUNCHES[name] == before + 1
        assert keys.shape == (1024, 32)
