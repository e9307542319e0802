"""The port's probes (``vsearch_tpu_torch/scripts``) and their kernels
(``vsearch_tpu_torch/ops/probes.py``): the plain twins of P1, P2 and P5
against the JAX package's own functions for the same work (its Pallas
kernels in interpret mode; the TPU probe scripts themselves claim the TPU
at import and are not imported), P5's launch geometry and the shared
launch path (``cuda_build.launch`` over a fake library), each probe's
``main`` end to end at a tiny size on the CPU with its JSON keys, and the
kernels on the card (``cuda``, skipped here)."""
import json

import numpy as np
import pytest
import torch

from vsearch_tpu_torch.ops import bitpack as tb
from vsearch_tpu_torch.ops import cuda_build, probes


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


# -- P5's launch geometry and the shared launch path, without a card --------
@pytest.mark.parametrize("bucket", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [1, 32, 45, 1024])
def test_keys_t_geometry(bucket, b):
    """One CTA per 256 rows (4 a 1024-row block) whatever the bucket and
    the batch: no query axis; the lists of ``KEYS_T_CAP`` ids a row and
    the rows' state in dynamic shared memory, two CTAs an SM."""
    n_pad, w = 2_000_896, 1024
    g = probes.keys_t_geometry(n_pad, bucket, b, w)
    assert g.grid == n_pad // 256 == 4 * (n_pad // tb.ROW_BLOCK)
    assert g.tiles == -(-b // 32) and g.queries == 32 and g.warps == 8
    assert g.cap == probes.KEYS_T_CAP == 192
    assert g.smem == 192 * 256 * 2 + 3 * 4 * 256 == 101_376
    assert 2 * (g.smem + 1024) <= 233_472  # the H100's shared memory an SM
    assert g.c_args() == (192, n_pad // 256, 101_376)


@pytest.mark.parametrize("n_pad,bucket,b,w", [
    (1000, 8, 32, 128),         # padded rows not a multiple of 1024
    (0, 8, 32, 128),            # no rows
    (2048, 16, 32, 128),        # the block tier's bucket: not taken
    (2048, 3, 32, 128),
    (2048, 8, 32, 2056),        # a vocabulary past 65,536 ids
    (2048, 8, 32, 12),          # words not in whole groups of 8
    (2048, 8, -1, 128)])
def test_keys_t_geometry_refuses(n_pad, bucket, b, w):
    with pytest.raises(ValueError, match="keys_t_geometry"):
        probes.keys_t_geometry(n_pad, bucket, b, w)


@pytest.mark.parametrize("kernel,fn", [
    ("bucketed_t", probes.bucket_keys_t),
    ("bucketed_t_decode_only", probes.bucket_keys_t_decode_only)])
def test_keys_t_wrappers_pass_the_geometry(monkeypatch, kernel, fn):
    """What P5 and its variant hand their C entry points, without a card:
    the arguments match the ctypes signature, the geometry is
    ``keys_t_geometry``'s and the state is the device's."""
    got = {}
    monkeypatch.setattr(probes, "uses_plain", lambda *a: False)
    monkeypatch.setattr(probes, "launch", lambda n, out, *args:
                        got.update(n=n, args=args) or out)
    monkeypatch.setattr(probes, "_KEYS_T_STATE", {})
    w, n_pad, b = 256, 3072, 45
    words_t = torch.zeros((w, n_pad), dtype=torch.int32)
    keys = fn(words_t, torch.zeros((w * 32, b), dtype=torch.bfloat16),
              3000, 4)
    assert keys.shape == (n_pad // 4, b) and got["n"] == kernel
    args = got["args"]
    assert len(args) + 1 == len(cuda_build.KERNELS[kernel].argtypes)
    assert args[3] == probes._KEYS_T_STATE[None].data_ptr()
    assert args[4:10] == (3000, n_pad, w, b, 64, 4)
    assert args[10:] == probes.keys_t_geometry(n_pad, 4, b, w).c_args()


class _FakeFn:
    """A C function of a fake kernel library: counts how often its
    signature is set and how often it is called."""

    def __init__(self):
        object.__setattr__(self, "typed", 0)
        object.__setattr__(self, "calls", [])

    def __setattr__(self, name, value):
        if name == "argtypes":
            object.__setattr__(self, "typed", self.typed + 1)
        object.__setattr__(self, name, value)

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeLib:
    def __init__(self):
        self.lookups = 0
        self.fn = _FakeFn()

    def __getattr__(self, name):
        if name.startswith("vs_"):
            self.lookups += 1
            return self.fn
        raise AttributeError(name)


@pytest.fixture
def fake_launch(monkeypatch):
    """``cuda_build.launch`` over a fake library of P1 on CPU tensors: the
    current device and stream stubbed (-1 is a CPU tensor's index), and
    each device guard that ``launch`` enters recorded."""
    lib = _FakeLib()
    monkeypatch.setattr(cuda_build, "_libs", {"bitcast_rows": lib})
    monkeypatch.setattr(cuda_build, "_fns", {})
    monkeypatch.setattr(cuda_build, "build_all",
                        lambda *a, **k: pytest.fail("built a library"))
    monkeypatch.setattr(cuda_build, "_raw_stream", lambda index: 1234 + index)
    guards = []

    class Guard:
        def __init__(self, index):
            guards.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(torch.cuda, "device", Guard)
    return lib, guards


def test_launch_resolves_a_kernel_once(monkeypatch, fake_launch):
    """A kernel's C function is looked up and typed once for many calls,
    each call passes the current stream's raw handle, enters no device
    guard on the current device, and counts once."""
    lib, guards = fake_launch
    monkeypatch.setattr(cuda_build, "_current_device", lambda: -1)
    out = torch.empty(4)
    before = cuda_build.LAUNCHES["bitcast_rows"]
    for i in range(50):
        assert cuda_build.launch("bitcast_rows", out, i, 2, 3, 4) is out
    assert lib.lookups == 1 and lib.fn.typed == 1
    assert lib.fn.calls == [(i, 2, 3, 4, 1233) for i in range(50)]
    assert cuda_build.LAUNCHES["bitcast_rows"] == before + 50
    assert guards == []


def test_launch_guards_another_device(monkeypatch, fake_launch):
    """A tensor on another device than the current one (a mesh shard on
    ``cuda:i``) is launched inside a guard of its own device, on its
    device's stream, and still counts once a call."""
    lib, guards = fake_launch
    monkeypatch.setattr(cuda_build, "_current_device", lambda: 3)
    out = torch.empty(4)
    before = cuda_build.LAUNCHES["bitcast_rows"]
    for _ in range(3):
        cuda_build.launch("bitcast_rows", out, 1, 2, 3, 4)
    assert guards == [-1, -1, -1]
    assert lib.lookups == 1 and lib.fn.typed == 1
    assert [c[-1] for c in lib.fn.calls] == [1233] * 3
    assert cuda_build.LAUNCHES["bitcast_rows"] == before + 3


def test_launch_raises_on_a_failed_launch(monkeypatch, fake_launch):
    lib, _ = fake_launch
    monkeypatch.setattr(cuda_build, "_current_device", lambda: -1)
    monkeypatch.setattr(_FakeFn, "__call__", lambda self, *a: 9)
    before = cuda_build.LAUNCHES["bitcast_rows"]
    with pytest.raises(RuntimeError, match="cudaError 9"):
        cuda_build.launch("bitcast_rows", torch.empty(1), 1, 2, 3, 4)
    assert cuda_build.LAUNCHES["bitcast_rows"] == before


# -- each probe end to end, tiny, on the CPU ---------------------------------
TINY = {
    "probe_bitcast_layout": ([], ["layout", "interleaved_A", "blocked_B",
                                  "check", "ms", "bound_ms"]),
    "probe_pack": (["--rows", "2000", "--vocab", "3000"],
                   ["packT", "pack", "words_t_equals_words_T"]),
    "probe_scorer_variants": (
        ["--rows", "1500", "--b", "4", "--dense-rows", "1024",
         "--check-rows", "256", "--long-rows", "1024"],
        ["small_check", "rows", "v3_equals_v0", "plane_split", "v3_split",
         "v3_long_rows", "long_check"]),
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
    "probe_launch_cost": (["--calls", "400", "--large", "64,1024"],
                          ["host_us_a_call", "calls", "s2_shape", "p1"]),
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
         "topk_int_matches", "v3_equals_v0", "equals_gather", "ok"))]
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
@pytest.mark.parametrize("s,l,offset", [(8, 128, 0), (4099, 1030, 0),
                                        (4096, 1024, 0), (300, 128, 1)])
def test_bitcast_kernel(dev, s, l, offset):
    """P1 bit for bit: the probe's shape, a ragged one (rows off 16
    bytes, a masked tail), a large aligned one (16-byte loads) and one
    that starts off 16 bytes (``offset`` words into its buffer)."""
    buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (s * l + offset,),
                        dtype=torch.int32, device=dev)
    x = buf[offset:].view(s, l)
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


@pytest.fixture(scope="module")
def long_rows(rng):
    """3,000 rows (ragged: 3,072 padded) of 0-600 distinct ids over V =
    5,000, most of them longer than P5's lists (``KEYS_T_CAP``)."""
    cols, nnz = distinct_ell(rng, 3000, 5000, 600)
    return cols, np.minimum(nnz, 600)


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [1, 2, 4, 8])
@pytest.mark.parametrize("b", [1, 32, 45, 1024])
def test_keys_t_kernel(dev, rng, long_rows, b, bucket):
    cols, nnz = long_rows
    c, z = torch.from_numpy(cols).to(dev), torch.from_numpy(nnz).to(dev)
    words = tb.pack_bits(c, z, 5000)
    words_t = probes.pack_bits_t(c, z, 5000)
    vp = words.shape[1] * 32
    dy = torch.from_numpy((rng.integers(0, 129, size=(vp, b)) / 16.0)
                          .astype(np.float32)).to(dev)
    dy[5000:] = 0
    dyT = dy.to(torch.bfloat16)
    assert torch.equal(probes.bucket_keys_t(words_t, dyT, 3000, bucket),
                       probes.bucket_keys_t_plain(words_t, dyT, 3000,
                                                  bucket))
    qT = torch.rand((vp, b), device=dev).to(torch.bfloat16)
    before = probes.keys_t_long_rows(dev)
    got = probes.bucket_keys_t(words_t, qT, 3000, bucket)
    # every row past the lists' capacity took the long path, once
    assert probes.keys_t_long_rows(dev) - before == int(
        (nnz > probes.KEYS_T_CAP).sum())
    # the gather form's order of summation: equal keys for any weights
    assert torch.equal(got, tb.bucket_keys(words, qT, 3000, bucket))


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
