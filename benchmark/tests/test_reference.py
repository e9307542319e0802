"""The frozen plain reference against the port's CPU path at a tiny size,
in float32: the same embeddings and the same exact bag-of-token scores."""
import numpy as np
import pytest
import torch

from benchmark import corpus as corpus_mod
from benchmark import vocab as vocab_mod
from benchmark import weights as weights_mod
from benchmark.reference import vdr as ref

BERT = {"vocab_size": 30522, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 512, "type_vocab_size": 2,
        "layer_norm_eps": 1e-12}
CFG = dict(BERT, shift_vocab_num=999, topk=64)


@pytest.fixture(scope="module")
def setup():
    from vsearch_tpu_torch.models.bert import BertConfig
    from vsearch_tpu_torch.models.vdr import VDREncoder, VDREncoderConfig
    from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

    vocab = vocab_mod.build_vocab()
    sd = weights_mod.make_encoders(BERT, 1, 3, "cpu", torch.float32)[0]
    enc = VDREncoder(VDREncoderConfig(
        bert=BertConfig(**{k: v for k, v in BERT.items()}), max_len=64,
        shift_vocab_num=999, topk=64), tokenizer=WordPieceTokenizer(vocab),
        device="cpu")
    enc.module.load_state_dict(sd)
    rng = np.random.default_rng(1)
    words = [corpus_mod.word_draws(rng, n) for n in (3, 9, 20, 40)]
    return vocab, sd, enc, words


def test_embeddings_match_the_port_in_float32(setup):
    vocab, sd, enc, words = setup
    names = vocab_mod.word_list()
    texts = [" ".join(names[j] for j in w.tolist()) for w in words]
    got = enc.embed(texts, topk=64, activate_lexical=True)
    table = vocab_mod.word_token_ids(vocab)
    toks = [corpus_mod.token_ids(w, table, vocab["[CLS]"], vocab["[SEP]"],
                                 64) for w in words]
    want = ref.embed_texts(sd, toks, CFG, "cpu").numpy()
    assert ((got > 0) == (want > 0)).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the control's fp8 products move the values by far more
    low = ref.embed_texts(sd, toks, CFG, "cpu", precision="fp8").numpy()
    assert np.abs(low - want).max() > 100 * np.abs(got - want).max()


def test_bot_scores_match_the_port_exact_search(setup):
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.ops.ell import ELLMatrix

    vocab, sd, enc, words = setup
    table = vocab_mod.word_token_ids(vocab)
    c = corpus_mod.make_corpus(
        500, {"kind": "fixed", "words": 30}, 9, "cpu", 999, table,
        keep_words=False, col_dtype=torch.int32)
    index = BoTIndex(device="cpu", search_mode="exact")
    index.set_ell(ELLMatrix(cols=c.cols, nnz=c.nnz, vals=None,
                            num_cols=c.num_cols, sentinel_padded=True))
    q = torch.rand(3, c.num_cols) * (torch.rand(3, c.num_cols) < 0.05)
    res = index.search(q.numpy(), k=10)
    for r in range(3):
        s, ids, vals = ref.exact_topk(q[r], c.cols, 10)
        np.testing.assert_allclose(res.scores[r], vals.numpy(), rtol=1e-5)
        np.testing.assert_allclose(s[res.ids[r]].numpy(), res.scores[r],
                                   rtol=1e-5)
