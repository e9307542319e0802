"""Card-only checks of the paths slices 5 and 6 added: chunked dense
search with the bf16 GEMM's f32 output against the CPU's upcast route and
float64, the DPR and cross-modal encoders on the card against the same
weights on the CPU, and train steps on the card against the CPU's. They
need an NVIDIA GPU and skip elsewhere; they import no JAX, so they run
on the card with ``--noconftest``. ``python3 chip_smoke.py`` phases 11
and 12 run the same paths at full size."""
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
    got = so.dense_topk_search(q.to(dev), vecs.to(dev), 100, chunk)
    want = so.dense_topk_search(q, vecs, 100, chunk)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_dense_search_random_against_float64(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    vecs = torch.randn((300_000, 768), generator=g, device=dev) \
        .to(torch.bfloat16)
    q = torch.randn((32, 768), generator=g, device=dev).to(torch.bfloat16)
    ids, scores = so.dense_topk_search(q, vecs, 100, 65_536)
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
