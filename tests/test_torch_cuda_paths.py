"""Card-only checks of the paths slice 5 added: chunked dense search with
the bf16 GEMM's f32 output against the CPU's upcast route and float64,
and the DPR and cross-modal encoders on the card against the same weights
on the CPU. They need an NVIDIA GPU and skip elsewhere; they import no
JAX, so they run on the card with ``--noconftest``. ``python3
chip_smoke.py`` phase 11 runs the same paths at full size."""
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
