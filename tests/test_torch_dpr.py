"""Port parity of DPR dense retrieval: the DPR encoder against the JAX
package's on the same weights (JAX init carried over by
``models.convert.dpr_state_dict_from_flax``, and a random
``transformers.BertModel`` read by both packages' ``convert_dpr_params``),
checkpoints both ways, and dense ``Retriever`` build + retrieve.

f32 on the CPU; only summation order differs, through 2 layers:
embeddings to rtol 1e-5 / atol 1e-5. The dense index stores bf16, as in
the JAX package, so an embedding that differs in the last f32 bits can
round to the neighbouring bf16 value: index rows and scores are held to
rtol 1e-2 (a bf16 step is 2^-8), ids exactly."""
import json

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_tokenizer
from vsearch_tpu.models import dpr as j_dpr
from vsearch_tpu.models import hf_convert
from vsearch_tpu.retriever import Retriever as JRetriever
from vsearch_tpu.retriever import RetrieverConfig as JConfig
from vsearch_tpu_torch.models import convert
from vsearch_tpu_torch.models import dpr as t_dpr
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

TOL = dict(rtol=1e-5, atol=1e-5)
TEXTS = ["green tea is a drink", "the red planet mars has ice water",
         "einstein wrote the famous theory of relativity and physics of "
         "space and time", "dog"]
CORPUS = TEXTS + ["a big dog runs fast in the city",
                  "the river water runs slow and is small",
                  "physics is the theory of space and time and light",
                  "what is the speed of light"]
QUERIES = ["green tea drink", "theory of relativity", "mars ice water",
           "dog runs fast"]
_TOK = make_tokenizer()


def enc_dict(**over):
    d = {"type": "dpr", "max_len": 32, "vocab_size": _TOK.vocab_size,
         "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 128, "max_position_embeddings": 64}
    d.update(over)
    return d


def port_tok():
    return WordPieceTokenizer(dict(_TOK.vocab))


@pytest.fixture(scope="module")
def pair():
    """(JAX DPR encoder, port DPR encoder) on the JAX init's weights."""
    j = j_dpr.DPREncoder(j_dpr.DPREncoderConfig.from_dict(enc_dict()),
                         tokenizer=_TOK, rng=jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(np.asarray, j.variables["params"])
    t = t_dpr.DPREncoder(t_dpr.DPREncoderConfig.from_dict(enc_dict()),
                         state_dict=convert.dpr_state_dict_from_flax(
                             params, 2),
                         tokenizer=port_tok(), device="cpu")
    return j, t


@pytest.mark.parametrize("batch_size", [3, 4])
def test_embed_matches_jax(pair, batch_size):
    j, t = pair
    got = t.embed(TEXTS, batch_size=batch_size)
    assert got.shape == (len(TEXTS), 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, j.embed(TEXTS, batch_size=batch_size),
                               **TOL)


def test_config_from_dict():
    cfg = t_dpr.DPREncoderConfig.from_dict(enc_dict(dtype="bfloat16"))
    assert cfg.out_dim == 64 and cfg.bert.dtype == torch.bfloat16
    assert cfg.type == "dpr"


def test_convert_dpr_params_from_hf_bert():
    """A random ``transformers.BertModel`` (with its pooler) read by both
    packages' converters: the same [CLS] vectors, equal to HF's own."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.BertModel(transformers.BertConfig(
        vocab_size=_TOK.vocab_size, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64)).eval()
    sd = {f"bert_model.{k}": v for k, v in hf.state_dict().items()}
    cfg = enc_dict()
    t = t_dpr.DPREncoder(t_dpr.DPREncoderConfig.from_dict(cfg),
                         state_dict=convert.convert_dpr_params(sd),
                         tokenizer=port_tok(), device="cpu")
    # a plain BertModel state dict (no prefix) reads the same
    plain = convert.convert_dpr_params(hf.state_dict())
    assert plain.keys() == t.module.state_dict().keys()
    j_cfg = j_dpr.DPREncoderConfig.from_dict(cfg)
    j = j_dpr.DPREncoder(j_cfg, tokenizer=_TOK, variables={
        "params": hf_convert.convert_dpr_params(
            hf_convert.torch_state_dict_to_numpy(sd), j_cfg.bert)})
    got = t.embed(TEXTS, batch_size=4)
    np.testing.assert_allclose(got, j.embed(TEXTS, batch_size=4), **TOL)
    enc = t.encode(TEXTS)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(enc["input_ids"]).long(),
                  attention_mask=torch.from_numpy(
                      enc["attention_mask"]).long()).last_hidden_state[:, 0]
    np.testing.assert_allclose(got, want.numpy(), **TOL)


def port_retriever(shared: bool, seed: int = 3):
    return Retriever(RetrieverConfig(encoder_q=enc_dict(),
                                     encoder_p=enc_dict(max_len=48),
                                     shared_encoder=shared),
                     tokenizer=port_tok(), seed=seed, device="cpu")


@pytest.mark.parametrize("shared", [True, False])
def test_pretrained_round_trip(tmp_path, shared):
    """``save_pretrained`` -> ``from_pretrained`` is bit-identical in the
    port, and the JAX package reads the directory to the same
    embeddings."""
    r = port_retriever(shared)
    r.save_pretrained(str(tmp_path))
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["encoder_q"]["type"] == "dpr"
    assert "compat_pad_pooling" not in cfg["encoder_q"]
    back = Retriever.from_pretrained(str(tmp_path), device="cpu")
    assert type(back.encoder_q) is t_dpr.DPREncoder
    assert (back.encoder_p is back.encoder_q) == shared
    j = JRetriever.from_pretrained(str(tmp_path))
    for enc in ("encoder_q", "encoder_p"):
        want = getattr(r, enc).embed(TEXTS, batch_size=4)
        np.testing.assert_array_equal(
            getattr(back, enc).embed(TEXTS, batch_size=4), want)
        np.testing.assert_allclose(np.asarray(getattr(j, enc).embed(
            TEXTS, batch_size=4), np.float32), want, **TOL)


@pytest.fixture(scope="module")
def retrievers():
    """(JAX, port) dense retrievers with the same q and p weights."""
    j = JRetriever(JConfig(encoder_q=enc_dict(),
                           encoder_p=enc_dict(max_len=48),
                           shared_encoder=False), tokenizer=_TOK)
    t = port_retriever(shared=False)
    for name in ("encoder_q", "encoder_p"):
        params = jax.tree_util.tree_map(
            np.asarray, getattr(j, name).variables["params"])
        getattr(t, name).module.load_state_dict(
            convert.dpr_state_dict_from_flax(params, 2))
    return j, t


@pytest.mark.parametrize("k", [3, 8, 50])
def test_dense_build_and_retrieve_match_jax(retrievers, k):
    """``build_index("dense")`` + ``retrieve``: bf16 index rows equal, ids
    equal, scores to the tolerance (k past the rows clamps)."""
    j, t = retrievers
    j.build_index(CORPUS, batch_size=3, index_type="dense")
    t.build_index(CORPUS, batch_size=3, index_type="dense")
    np.testing.assert_allclose(t.index.vector.float().numpy(),
                               np.asarray(j.index.vector, np.float32),
                               rtol=1e-2, atol=1e-5)
    got, want = t.retrieve(QUERIES, k=k), j.retrieve(QUERIES, k=k)
    assert got.ids.shape == (len(QUERIES), min(k, len(CORPUS)))
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=1e-2, atol=1e-3)
