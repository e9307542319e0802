"""Card-only checks of the paths slices 5-7 added: chunked dense search
with the bf16 GEMM's f32 output against the CPU's upcast route and
float64, the DPR and cross-modal encoders on the card against the same
weights on the CPU, train steps on the card against the CPU's, and the
sharded resident and block-tier bag-of-token searches over two virtual
shards of the card against the unsharded ones. They need an NVIDIA GPU
and skip elsewhere; they import no JAX, so they run on the card with
``--noconftest``. ``python3 chip_smoke.py`` phases 11-13 run the same
paths at full size."""
import numpy as np
import pytest
import torch

from vsearch_tpu_torch.ops import search as so
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

pytestmark = pytest.mark.cuda

TEXTS = ["green tea is a drink", "the red planet mars has ice water",
         "a big dog runs fast in the city", "dog"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vsearch_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.fixture(scope="module")
def tok():
    words = sorted({w for t in TEXTS for w in t.split()})
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)}
    return WordPieceTokenizer(vocab)


@pytest.mark.parametrize("chunk", [7, 333, None])
def test_dense_search_on_the_card_equals_the_cpu(dev, chunk):
    """Dyadic bf16 rows with whole runs of ties: the bf16 GEMM with f32
    output gives the CPU's ids and scores exactly."""
    rng = np.random.default_rng(1)
    base = rng.integers(-16, 17, size=(40, 64)) / 8.0
    vecs = torch.from_numpy(base[rng.integers(0, 40, size=5000)]
                            .astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy((rng.integers(-16, 17, size=(9, 64)) / 8.0)
                         .astype(np.float32)).to(torch.bfloat16)
    assert so.gemm_form(q.to(dev), vecs.to(dev)) == so.GEMM_BF16_F32
    got = so.dense_topk_search(q.to(dev), vecs.to(dev), 100,
                               chunk_rows=chunk)
    want = so.dense_topk_search(q, vecs, 100, chunk_rows=chunk)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_dense_search_random_against_float64(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    vecs = torch.randn((300_000, 768), generator=g, device=dev) \
        .to(torch.bfloat16)
    q = torch.randn((32, 768), generator=g, device=dev).to(torch.bfloat16)
    ids, scores = so.dense_topk_search(q, vecs, 100, chunk_rows=65_536)
    ref = q.double() @ vecs.double().T
    want_s, want_i = torch.topk(ref, 100, dim=1)
    top = want_s[:, :1].abs()
    assert ((scores.double() - want_s).abs() <= 1e-5 * top).all()
    differ = ids != want_i
    assert int(differ.sum()) <= 2 * 32  # near-ties only


def _pair(cls_name, cfg, tok, dev):
    from vsearch_tpu_torch.models.registry import get_encoder_classes

    cfg_cls, enc_cls = get_encoder_classes(cls_name)
    cpu = enc_cls(cfg_cls.from_dict(cfg), tokenizer=tok, seed=3,
                  device="cpu")
    gpu = enc_cls(cfg_cls.from_dict(cfg), tokenizer=tok,
                  state_dict=cpu.module.state_dict(), device=dev)
    return cpu, gpu


BERT = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128, "max_position_embeddings": 64}


@pytest.mark.parametrize("kind", ["dpr", "vdr_crossmodal_text"])
def test_text_encoders_on_the_card_equal_the_cpu(dev, tok, kind):
    cfg = dict(BERT, vocab_size=tok.vocab_size, max_len=32, topk=8)
    cpu, gpu = _pair(kind, cfg, tok, dev)
    a, b = cpu.embed(TEXTS, batch_size=3), gpu.embed(TEXTS, batch_size=3)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def test_image_encoder_on_the_card_equals_the_cpu(dev, tok):
    cfg = {"resolution": 64, "patch_size": 16, "width": 64, "layers": 2,
           "heads": 4, "topk": 16, "num_valid_tokens": 200}
    cpu, gpu = _pair("vdr_crossmodal_image", cfg, tok, dev)
    assert all(p.dtype == torch.float32 for p in gpu.module.parameters())
    pixels = np.random.default_rng(4).normal(size=(5, 64, 64, 3)) \
        .astype(np.float32)
    a, b = cpu.embed(pixels, batch_size=2), gpu.embed(pixels, batch_size=2)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)


def _train_step_run(dev, tok, dtype, steps=3, remat=False):
    """``steps`` train steps of a tiny VDR bi-encoder (separate q and p,
    dropout 0, weights from seed 3 on the CPU) on ``dev``: losses, grad
    norms and the final weights."""
    from vsearch_tpu_torch.models import vdr
    from vsearch_tpu_torch.train import optim, step
    from vsearch_tpu_torch.train.loss import VDRLossConfig

    cfg = dict(BERT, vocab_size=tok.vocab_size, max_len=32, topk=8,
               shift_vocab_num=5, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, dtype=dtype)
    mods = {}
    for side, seed in (("q", 3), ("p", 4)):
        ref = vdr.VDREncoder(vdr.VDREncoderConfig.from_dict(cfg),
                             tokenizer=tok, seed=seed, device="cpu")
        mods[side] = ref.module.float().to(dev)
    module = torch.nn.ModuleDict(mods)
    applies = [step.make_encoder_apply(mods[s], remat=remat) for s in "qp"]
    tx = optim.get_optimizer([module], learning_rate=1e-3,
                             schedule=optim.get_schedule_warmup(1, 1e-3))
    state = step.TrainState.create(module, tx)
    fn = step.make_train_step(*applies, step.TrainStepConfig(
        vocab_size=tok.vocab_size, shift_vocab_num=5,
        loss=VDRLossConfig(topk=8)))
    rng = np.random.default_rng(5)
    q = rng.integers(5, tok.vocab_size, size=(4, 16))
    p = rng.integers(5, tok.vocab_size, size=(8, 32))
    p[:4, :8] = q[:, :8]
    p[:, 20:] = 0
    batch = step.TrainBatch(torch.from_numpy(q).to(dev),
                            torch.from_numpy(p).to(dev))
    out = []
    for i in range(steps):
        state, m = fn(state, batch, i)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, {k: v.float().cpu() for k, v in module.state_dict().items()}


def test_train_steps_on_the_card_equal_the_cpu(dev, tok):
    """f32, TF32 off: the step's loss and unclipped global norm on the card
    equal the CPU's (rtol 1e-4 over 3 steps; the weights are not compared,
    since Adam's first update, ~lr x sign(g), turns rounding in near-zero
    gradients into lr-sized differences); in bf16 compute the weights stay
    f32 and the loss agrees to bf16 rounding; remat changes nothing."""
    cpu, _ = _train_step_run("cpu", tok, "float32")
    gpu, _ = _train_step_run(dev, tok, "float32")
    np.testing.assert_allclose(np.array(gpu), np.array(cpu), rtol=1e-4)
    bf16, w_bf16 = _train_step_run(dev, tok, "bfloat16")
    assert all(v.dtype == torch.float32 for v in w_bf16.values())
    np.testing.assert_allclose(np.array(bf16)[:, 0], np.array(cpu)[:, 0],
                               rtol=3e-2)
    remat, _ = _train_step_run(dev, tok, "bfloat16", remat=True)
    np.testing.assert_allclose(np.array(remat), np.array(bf16), rtol=1e-5)


def _bot_rows(n, v, seed):
    """Binary rows of up to 64 distinct ascending ids (sentinel-padded to
    64) and dyadic queries: every kernel sum is exact, so shards must give
    the unsharded scores bit for bit."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, v, size=(n, 64)), axis=1)
    ids[:, 1:][ids[:, 1:] == ids[:, :-1]] = v  # repeats -> sentinel
    cols = np.sort(ids, axis=1).astype(np.int32)
    nnz = (cols < v).sum(axis=1).astype(np.int32)
    q = (rng.integers(0, 33, size=(8, v)) / 16.0).astype(np.float32)
    return cols, nnz, q


@pytest.mark.parametrize("selection", ["bucketed", "exact"])
def test_sharded_resident_search_equals_unsharded(dev, selection):
    """Kernels #1 and #3 (or #2) on each of two shards of one card, merged,
    against the same index unsharded."""
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.ops import bitpack as bp
    from vsearch_tpu_torch.ops.ell import ELLMatrix
    from vsearch_tpu_torch.parallel.mesh import make_mesh

    cols, nnz, q = _bot_rows(300_000, 3000, 4)
    idx = BoTIndex(search_mode="bitpack", selection=selection, device=dev)
    idx.set_ell(ELLMatrix.from_arrays(cols, nnz, None, 3000, True, dev))
    want = idx.search(q, k=100)
    idx.to_mesh(make_mesh(devices=[dev] * 2))
    bp.reset_launch_counts()
    got = idx.search(q, k=100)
    kernel = "bucketed" if selection == "bucketed" else "scores"
    assert bp.LAUNCHES[kernel] == 2
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("selection", ["exact", "bucketed"])
def test_sharded_block_tier_equals_unsharded(dev, selection):
    """The block tier on two shards of one card against the unsharded
    block tier. 'exact' (kernels #1 and #2 a block) gives the same ids and
    scores bit for bit. 'bucketed' selects by int8 scores (#1 and #4 a
    block), carrying 2k candidates a shard, then reranks them exactly:
    every score is its row's exact sum, and the shards' recall against
    exact search is at least the unsharded one's less 0.01 (each shard
    carries as many candidates as the whole unsharded sweep)."""
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.ops import bitpack as bp
    from vsearch_tpu_torch.ops.ell import ELLMatrix
    from vsearch_tpu_torch.parallel.mesh import make_mesh

    cols, nnz, q = _bot_rows(300_000, 3000, 5)
    if selection == "bucketed":  # real-valued weights, as embeddings give
        q = np.abs(np.random.default_rng(9).normal(size=q.shape)) \
            .astype(np.float32)
    idx = BoTIndex(search_mode="block", selection=selection, device=dev)
    idx.stream_block_rows = 1 << 16
    idx.set_ell(ELLMatrix.from_arrays(cols, nnz, None, 3000, True, "cpu"))
    want = idx.search(q, k=100)
    idx.to_mesh(make_mesh(devices=[dev] * 2))
    bp.reset_launch_counts()
    got = idx.search(q, k=100)
    kernel = "scores" if selection == "exact" else "int8_bucketed"
    assert bp.LAUNCHES[kernel] == 2 * 3 and bp.LAUNCHES["pack"] == 2 * 3
    if selection == "exact":
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.scores, want.scores)
        return
    qp = np.concatenate([q, np.zeros((q.shape[0], 1), q.dtype)], axis=1)
    exact = qp[:, cols].astype(np.float64).sum(axis=2)  # sentinel -> 0
    kth = np.sort(exact, axis=1)[:, -100]
    recall = [np.mean(np.take_along_axis(exact, r.ids, 1)
                      >= kth[:, None] - 1e-4) for r in (want, got)]
    np.testing.assert_allclose(got.scores,
                               np.take_along_axis(exact, got.ids, 1),
                               rtol=1e-5)
    assert recall[1] >= recall[0] - 0.01, recall
