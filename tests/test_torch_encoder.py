"""Port parity: BERT, the VDR module and the VDR encoder of
``vsearch_tpu_torch`` against ``vsearch_tpu`` in f32 on the CPU. Weights
are made by the JAX package's init and carried over by the port's
bridge (``models.convert``)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.helpers import make_tokenizer, tiny_bert_config
from vsearch_tpu.models import bert as j_bert
from vsearch_tpu.models import hf_convert
from vsearch_tpu.models import vdr as j_vdr
from vsearch_tpu_torch.models import bert as t_bert
from vsearch_tpu_torch.models import convert
from vsearch_tpu_torch.models import vdr as t_vdr
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

# f32 end to end on both sides (HIGHEST precision in JAX, no TF32 here);
# only summation order differs, through 2 layers and a vocab projection
TOL = dict(rtol=1e-4, atol=1e-5)
TEXTS = ["green tea is a drink", "the red planet mars has ice water",
         "einstein wrote the famous theory of relativity and physics of "
         "space and time", "dog"]


_TOK = make_tokenizer()


@pytest.fixture(scope="module")
def tok():
    return _TOK


def enc_dict(tok, **over):
    d = {"type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
         **{k: v for k, v in vars(tiny_bert_config(tok.vocab_size)).items()
            if k in ("vocab_size", "hidden_size", "num_hidden_layers",
                     "num_attention_heads", "intermediate_size",
                     "max_position_embeddings")}}
    d.update(over)
    return d


_PAIRS = {}


def pair(tok, **over):
    """(JAX encoder, port encoder) with the same weights, built once per
    config so JAX compiles each embed shape once per module."""
    if () not in _PAIRS:
        _PAIRS[()] = _make_pair(tok)
    key = tuple(sorted(over.items()))
    if key not in _PAIRS:
        _PAIRS[key] = _make_pair(tok, **over)
    return _PAIRS[key]


def _make_pair(tok, **over):
    d = enc_dict(tok, **over)
    # one JAX init serves every config: the options change no weights
    base = _PAIRS[()][0].variables if () in _PAIRS else None
    j = j_vdr.VDREncoder(j_vdr.VDREncoderConfig.from_dict(d), tokenizer=tok,
                         variables=base, rng=jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, j.variables["params"])
    t = t_vdr.VDREncoder(
        t_vdr.VDREncoderConfig.from_dict(d),
        state_dict=convert.vdr_state_dict_from_flax(
            params, j.config.bert.num_hidden_layers),
        tokenizer=WordPieceTokenizer(dict(tok.vocab)), device="cpu")
    return j, t


def batch(tok, texts=TEXTS, max_len=32):
    ids = np.zeros((len(texts), max_len), np.int32)
    mask = np.zeros_like(ids)
    for i, row in enumerate(tok.encode_batch(texts, max_length=max_len)):
        ids[i, :len(row)], mask[i, :len(row)] = row, 1
    return ids, np.zeros_like(ids), mask


def test_bert_forward(tok):
    cfg_j = tiny_bert_config(tok.vocab_size)
    model = j_bert.BertModel(cfg_j)
    ids, tt, mask = batch(tok)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(ids))["params"]
    want = np.asarray(jax.jit(model.apply)(
        {"params": params}, jnp.asarray(ids), jnp.asarray(tt),
        jnp.asarray(mask)))
    # the JAX tree -> HF layout (port names) via the VDR bridge
    vdr_params = {"word_embeddings": params["embeddings"]["word_embeddings"],
                  "bert": params, "ln": {"scale": np.ones(32),
                                         "bias": np.zeros(32)}}
    sd = convert.vdr_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, vdr_params),
        cfg_j.num_hidden_layers)
    t_model = t_bert.BertModel(t_bert.BertConfig(
        **{f.name: getattr(cfg_j, f.name)
           for f in dataclasses.fields(cfg_j) if f.name != "dtype"}))
    t_model.load_state_dict({k[len("bert_model."):]: v for k, v in sd.items()
                             if k.startswith("bert_model.")})
    with torch.no_grad():
        got = t_model.eval()(*(torch.from_numpy(a).long()
                               for a in (ids, tt, mask))).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


@pytest.mark.parametrize("over", [
    {}, {"compat_pad_pooling": True}, {"pooling": "mean"},
    {"pooling": "mean", "pooling_topk": 3}, {"norm": True}],
    ids=["max", "compat_pad", "mean", "mean_topk", "norm"])
def test_vdr_module_forward(tok, over):
    j, t = pair(tok, **over)
    ids, tt, mask = batch(tok)
    want = np.asarray(jax.jit(j.module.apply)(
        j.variables, jnp.asarray(ids), jnp.asarray(tt), jnp.asarray(mask)))
    with torch.no_grad():
        got = t.module(*(torch.from_numpy(a).long()
                         for a in (ids, tt, mask))).numpy()
    assert got.shape == want.shape == (len(TEXTS), tok.vocab_size - 5)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("topk", ["cfg", 0, None, 1000])
def test_embed(tok, topk):
    j, t = pair(tok)
    for lex in (True, False):
        np.testing.assert_allclose(
            t.embed(TEXTS, batch_size=3, topk=topk, activate_lexical=lex),
            j.embed(TEXTS, batch_size=3, topk=topk, activate_lexical=lex),
            **TOL)
    np.testing.assert_array_equal(t.embed(TEXTS, bow=True),
                                  j.embed(TEXTS, bow=True))


@pytest.mark.parametrize("lexical", [False, True])
def test_embed_sparse(tok, lexical):
    j, t = pair(tok)
    cj, vj = j.embed_sparse(TEXTS, batch_size=3, activate_lexical=lexical)
    ct, vt = t.embed_sparse(TEXTS, batch_size=3, activate_lexical=lexical)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(vt, vj, **TOL)
    # device form: rows padded to a multiple of batch_size
    cd, vd = t.embed_sparse(TEXTS, batch_size=3, activate_lexical=lexical,
                            return_device=True)
    assert cd.shape[0] == 6 and torch.is_tensor(vd)
    np.testing.assert_array_equal(cd[:4].numpy(), ct)


def test_disentangle(tok):
    j, t = pair(tok)
    dj, dt = j.disentangle("green tea drink", topk=8), \
        t.disentangle("green tea drink", topk=8)
    assert list(dt) == list(dj)
    np.testing.assert_allclose(list(dt.values()), list(dj.values()), **TOL)


def test_hf_state_dict_bridge(tok):
    """An HF-layout state dict loads into the port directly and into the
    JAX package through its own converter: both give one embedding."""
    _, t = pair(tok)
    hf = {k: v.numpy() for k, v in t.module.state_dict().items()}
    cfg_j = j_vdr.VDREncoderConfig.from_dict(enc_dict(tok))
    j = j_vdr.VDREncoder(cfg_j, variables={"params": hf_convert
                                           .convert_vdr_params(hf, cfg_j.bert)},
                         tokenizer=tok)
    # plain BertModel keys (no prefix, no head LayerNorm) load as well
    plain = {k[len("bert_model."):]: v for k, v in hf.items()
             if k.startswith("bert_model.")}
    sd = convert.vdr_state_dict_from_hf(plain, 32)
    assert torch.equal(sd["ln.weight"], torch.ones(32))
    t2 = t_vdr.VDREncoder(t_vdr.VDREncoderConfig.from_dict(enc_dict(tok)),
                          state_dict=convert.vdr_state_dict_from_hf(hf, 32),
                          tokenizer=t.tokenizer, device="cpu")
    np.testing.assert_allclose(t2.embed(TEXTS), j.embed(TEXTS), **TOL)


def test_bf16_compute_config():
    """bf16 compute resolves tanh GELU, as the JAX package serves."""
    cfg = t_vdr.VDREncoderConfig.from_dict({"dtype": "bfloat16"})
    assert cfg.bert.dtype == torch.bfloat16 and cfg.bert.gelu_approximate
    assert not t_bert.BertConfig().gelu_approximate
