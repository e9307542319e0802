"""granite-4.0-h as SVDR's encoder in the port (``models/granite_hybrid.py``,
``models/vdr.py``'s granite trunk, ``ops/ssd.py``), held on the CPU to the
benchmark's plain reference (``benchmark/reference/granite_vdr.py``) at a
tiny size on seeded random weights: hidden 64, 4 Mamba-2 heads of 16 and
d_state 16, one attention layer in a 3-layer pattern, a 1,200-entry
vocabulary, texts up to 40 tokens. The chunk-scan kernel itself runs on
the card only (the ``cuda`` tests, at granite-4.0-h-micro's widths)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.reference import granite_vdr as ref
from benchmark.reference.vdr import full_f32
from vsearch_tpu_torch.models.bert import BertConfig
from vsearch_tpu_torch.models.granite_hybrid import GraniteHybridConfig
from vsearch_tpu_torch.models.vdr import (TRUNKS, VDREncoder, VDREncoderConfig,
                                          VDRModule)
from vsearch_tpu_torch.ops import bitpack
from vsearch_tpu_torch.ops.ssd import ssd_chunk, ssd_chunk_plain
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

SHIFT = 16
VOCAB = 1200
MAX_LEN = 40
TOPK = 32
# the same f32 function summed in other orders (the port's batched matrix
# products and chunked max against the reference's step-by-step state and
# per-block head): differences of a few f32 ulps of the largest terms
# (~1e-7 read), far below one bf16 step (~4e-3)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _vocab():
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    while len(vocab) < SHIFT:
        vocab[f"[unused{len(vocab)}]"] = len(vocab)
    for i in range(VOCAB - SHIFT):
        vocab[f"w{i:04d}"] = len(vocab)
    return vocab


WORDS = [w for w in _vocab() if w.startswith("w")]


def _texts(rng, n, lo=1, hi=MAX_LEN - 2):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def _enc_dict(max_len=MAX_LEN):
    g = dataclasses.asdict(GraniteHybridConfig.tiny(vocab_size=VOCAB))
    return dict(g, type="vdr", trunk="granite_hybrid", max_len=max_len,
                shift_vocab_num=SHIFT, topk=TOPK, norm=False)


def _ref_cfg():
    d = _enc_dict()
    d["layer_types"] = list(d["layer_types"])
    return d


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(_vocab())


@pytest.fixture(scope="module")
def encoder(tok):
    return VDREncoder(VDREncoderConfig.from_dict(_enc_dict()), tokenizer=tok,
                      seed=3, device="cpu")


def _state(enc):
    return {k: v.float() for k, v in enc.module.state_dict().items()}


def _ids(tok, texts, max_len=MAX_LEN):
    return tok.encode_batch(texts, max_length=max_len)


# -- the chunk scan ----------------------------------------------------------
def _scan_inputs(gen, b, length, heads, d_head, d_state, k=4, scale=1.0):
    inner = heads * d_head
    conv_dim = inner + 2 * d_state
    proj = torch.randn(b, length, 2 * inner + 2 * d_state + heads,
                       generator=gen) * scale
    bound = 1 / math.sqrt(k)
    conv_w = (torch.rand(conv_dim, k, generator=gen) * 2 - 1) * bound
    conv_b = (torch.rand(conv_dim, generator=gen) * 2 - 1) * bound
    dt = torch.exp(torch.rand(heads, generator=gen)
                   * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(1 + 15 * torch.rand(heads, generator=gen))
    d = torch.ones(heads) + 0.1 * torch.randn(heads, generator=gen)
    return proj, conv_w, conv_b, dt_bias, a_log, d


@pytest.mark.parametrize("length", [1, 5, 17, 40, 64])
def test_ssd_chunk_plain_matches_recurrence(length):
    """The kernel's twin (the quadratic single-chunk form) against the
    reference's step-by-step recurrence, both f32: only the order of the
    sums differs."""
    gen = torch.Generator().manual_seed(length)
    heads, d_head, d_state = 4, 16, 16
    args = _scan_inputs(gen, 3, length, heads, d_head, d_state)
    got = ssd_chunk_plain(*args, heads, d_head, d_state)
    cfg = {"mamba_n_heads": heads, "mamba_d_head": d_head,
           "mamba_d_state": d_state}
    with full_f32():
        want = ref.ssd_scan(*args, cfg)
    torch.testing.assert_close(got, want, **F32_TOL)


def test_ssd_chunk_refuses_past_one_chunk():
    gen = torch.Generator().manual_seed(0)
    args = _scan_inputs(gen, 1, 65, 4, 16, 16)
    with pytest.raises(ValueError, match="chunk"):
        ssd_chunk(*args, 4, 16, 16, chunk=64)


def test_ssd_chunk_takes_the_plain_form_on_the_cpu():
    gen = torch.Generator().manual_seed(1)
    args = _scan_inputs(gen, 2, 9, 4, 16, 16)
    before = dict(bitpack.LAUNCHES)
    torch.testing.assert_close(ssd_chunk(*args, 4, 16, 16),
                               ssd_chunk_plain(*args, 4, 16, 16),
                               rtol=0, atol=0)
    assert bitpack.LAUNCHES == before  # no launch counted off the card


# -- the encoder against the reference ----------------------------------------
def test_config_selects_the_trunk():
    """A config dict's ``trunk`` names an entry of ``TRUNKS``, whose
    config class the trunk's keys build and whose module lives under its
    ``attr``; BERT by default, an unknown name refused."""
    bert = VDREncoderConfig.from_dict({"type": "vdr", "vocab_size": 500})
    assert bert.trunk == "bert" and type(bert.bert) is BertConfig
    assert bert.out_dim == 500 - bert.shift_vocab_num
    assert VDREncoderConfig(bert=BertConfig.tiny()).trunk == "bert"
    g = VDREncoderConfig.from_dict(_enc_dict())
    assert g.trunk == "granite_hybrid" and g.out_dim == VOCAB - SHIFT
    assert type(g.bert) is TRUNKS["granite_hybrid"].config
    assert g.bert.layer_types == ("mamba", "attention", "mamba")
    for cfg in (BertConfig.tiny(), g.bert):
        trunk = TRUNKS[VDREncoderConfig(bert=cfg).trunk]
        module = VDRModule(VDREncoderConfig(bert=cfg))
        assert isinstance(getattr(module, trunk.attr), trunk.module)
    with pytest.raises(ValueError, match="trunk"):
        VDREncoderConfig.from_dict({"type": "vdr", "trunk": "t5"})


def test_state_dict_is_hf_granite_layout(encoder):
    keys = set(encoder.module.state_dict())
    assert {"model.embed_tokens.weight", "model.norm.weight",
            "model.layers.0.mamba.in_proj.weight",
            "model.layers.0.mamba.conv1d.weight",
            "model.layers.0.mamba.A_log", "model.layers.1.self_attn.q_proj.weight",
            "model.layers.1.shared_mlp.input_linear.weight",
            "ln.weight", "ln.bias"} <= keys
    assert not any(k.startswith("lm_head") for k in keys)  # tied head


def test_embed_matches_reference(encoder, tok):
    rng = np.random.default_rng(5)
    texts = _texts(rng, 12)
    got = torch.from_numpy(encoder.embed(texts, batch_size=5))
    want = ref.embed_texts(_state(encoder), _ids(tok, texts), _ref_cfg(),
                           "cpu", batch=4)
    torch.testing.assert_close(got, want, **F32_TOL)
    # each row keeps its top-k and its own tokens' columns
    assert bool(((got > 0).sum(1) >= TOPK).all())


def test_embed_sparse_matches_reference(encoder, tok):
    rng = np.random.default_rng(6)
    texts = _texts(rng, 9)
    cols, vals = encoder.embed_sparse(texts, batch_size=4,
                                      activate_lexical=True)
    want = ref.embed_texts(_state(encoder), _ids(tok, texts), _ref_cfg(),
                           "cpu")
    v = VOCAB - SHIFT
    for r in range(len(texts)):
        keep = cols[r] < v
        dense = torch.zeros(v)
        dense[torch.from_numpy(cols[r][keep]).long()] = torch.from_numpy(
            vals[r][keep])
        torch.testing.assert_close(dense, want[r], **F32_TOL)


@pytest.mark.parametrize("bucket_mates", [0, 1, 6])
def test_padding_and_batch_rows_leave_a_row_unchanged(encoder, bucket_mates):
    """A row embedded alone, and in a batch padded to a longer bucket with
    other rows (and empty rows): the trunk is causal and the padding lies
    to the right, so no valid position sees it. The tolerance leaves room
    only for f32 sums that a batch of another shape may order otherwise."""
    rng = np.random.default_rng(11 + bucket_mates)
    row = _texts(rng, 1, 3, 6)
    alone = encoder.embed(row, batch_size=1)
    others = _texts(rng, bucket_mates, 30, 38)
    mixed = encoder.embed(others + row + others[:1], batch_size=16)
    torch.testing.assert_close(torch.from_numpy(mixed[len(others)]),
                               torch.from_numpy(alone[0]), rtol=1e-6,
                               atol=1e-6)


# -- beta search through the retriever ----------------------------------------
@pytest.fixture(scope="module")
def retriever(tok):
    rng = np.random.default_rng(21)
    corpus = _texts(rng, 40, 4, 30)
    enc = _enc_dict()
    r = Retriever(RetrieverConfig(encoder_q=dict(enc, max_len=24),
                                  encoder_p=dict(enc), shared_encoder=False),
                  tokenizer=tok, seed=7, device="cpu")
    r.build_index(corpus, batch_size=8, index_type="bag_of_token")
    r.index.search_mode = "bitpack"  # the card's first stage, plain here
    return r, corpus


def test_beta_search_matches_reference_scoring(retriever, tok):
    """``retrieve(rerank=True)`` against the reference's exact scoring: the
    first stage's candidates are the reference's exact bag-of-token top-k
    by their reference scores, but for candidates that trade places with
    one within 2^-8 of its score (the bit-packed first stage scores a bf16
    copy of the query, each weight rounded by at most 2^-9 of itself, as
    on the card); each reranked score is the reference's rescoring of that
    candidate, in descending order."""
    r, corpus = retriever
    queries = _texts(np.random.default_rng(22), 5, 2, 10)
    k = 8
    res = r.retrieve(queries, k=k, rerank=True, batch_size=4)
    q = ref.embed_texts(_state(r.encoder_q), _ids(tok, queries, 24),
                        _ref_cfg(), "cpu")
    p = ref.embed_texts(_state(r.encoder_p), _ids(tok, corpus), _ref_cfg(),
                        "cpu")
    bags = torch.zeros(len(corpus), VOCAB - SHIFT)
    for i, ids in enumerate(_ids(tok, corpus)):
        own = [t - SHIFT for t in ids if t >= SHIFT]
        bags[i, own] = 1.0
    first = q @ bags.T  # exact bag-of-token scores
    ids, scores = np.asarray(res.ids), np.asarray(res.scores)
    for b in range(len(queries)):
        got_first = torch.sort(first[b, ids[b]], descending=True).values
        want_first = torch.topk(first[b], k).values
        assert bool((got_first >= want_first * (1 - 2 ** -8)).all()), (
            got_first, want_first)
        rescored = (p[ids[b]] * q[b]).sum(1)
        torch.testing.assert_close(torch.from_numpy(scores[b]).float(),
                                   rescored, **F32_TOL)
        assert bool((np.diff(scores[b]) <= 0).all())


def test_rerank_forward_counts_its_tokens(retriever, tok):
    """The call record counts each forward's real and padding tokens: the
    rerank's real tokens are its distinct candidates' token counts."""
    r, corpus = retriever
    queries = _texts(np.random.default_rng(23), 3, 2, 10)
    res = r.retrieve(queries, k=6, rerank=True, batch_size=4)
    counts = r.last_timings.counts
    uniq = np.unique(np.asarray(res.ids))
    real = sum(len(t) for t in _ids(tok, [corpus[i] for i in uniq]))
    assert counts["rerank/forward/tokens"] == real
    q_real = sum(len(t) for t in _ids(tok, queries, 24))
    assert counts["query_embed/forward/tokens"] == q_real
    for stage in ("query_embed", "rerank"):
        pad = counts[f"{stage}/forward/pad_tokens"]
        assert pad > 0 and (pad + counts[f"{stage}/forward/tokens"]) % 4 == 0
    # the seconds of the record are as before: no count among them
    assert not any(key.endswith("tokens") for key in r.last_timings)


# -- the kernel on the card ----------------------------------------------------
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("length", [32, 64, 100, 128, 256])
def test_ssd_chunk_kernel_matches_plain(dev, length):
    """The kernel at granite-4.0-h-micro's widths (64 heads of 64, d_state
    128, one group, a 4-tap conv) in bf16 against its plain twin on the
    same inputs: both compute in f32 from the same bf16 values and round
    the result to bf16 once, so they differ by the f32 sums' order and at
    most one bf16 step of the largest values (2^-8 of them)."""
    gen = torch.Generator().manual_seed(length)
    args = [t.to(dev, torch.bfloat16) for t in
            _scan_inputs(gen, 4, length, 64, 64, 128)]
    before = bitpack.LAUNCHES["ssd_chunk"]
    got = ssd_chunk(*args, 64, 64, 128)
    torch.cuda.synchronize()
    assert bitpack.LAUNCHES["ssd_chunk"] == before + 1
    want = ssd_chunk_plain(*args, 64, 64, 128)
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 ** -8 * scale, (err, scale)
