"""Checkpoints of the port: ``save_pretrained``/``from_pretrained`` in the
reference's HF layout, read back by the port bit for bit and by the JAX
package (its ``_from_torch_dir``) to the same embeddings (f32 on the CPU,
``atol=1e-5``); a JAX-native directory is refused with a clear error."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_tokenizer, tiny_bert_config
from vsearch_tpu.retriever import Retriever as JRetriever
from vsearch_tpu.retriever import RetrieverConfig as JConfig
from vsearch_tpu_torch.models.convert import vdr_state_dict_from_flax
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

TEXTS = ["green tea drink", "theory of relativity", "mars ice water"]


def enc_dict(tok):
    return {"type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
            **{k: v for k, v in vars(tiny_bert_config(tok.vocab_size)).items()
               if k in ("vocab_size", "hidden_size", "num_hidden_layers",
                        "num_attention_heads", "intermediate_size",
                        "max_position_embeddings")}}


def port_retriever(shared, seed=4):
    tok = make_tokenizer()
    enc = enc_dict(tok)
    return Retriever(RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                                     shared_encoder=shared),
                     tokenizer=WordPieceTokenizer(dict(tok.vocab)),
                     seed=seed, device="cpu")


def embeddings(r):
    return (r.encoder_q.embed(TEXTS, batch_size=4),
            r.encoder_p.embed(TEXTS, batch_size=4))


@pytest.mark.parametrize("shared", [True, False])
def test_round_trip_is_bit_identical(tmp_path, shared):
    r = port_retriever(shared)
    r.save_pretrained(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["config.json",
                                            "pytorch_model.bin", "vocab.txt"]
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["encoder_q"]["compat_pad_pooling"] is False
    sd = torch.load(str(tmp_path / "pytorch_model.bin"), weights_only=True)
    assert any(k.startswith("encoder_p.") for k in sd) == (not shared)
    back = Retriever.from_pretrained(str(tmp_path), device="cpu")
    assert back.config.shared_encoder == shared
    assert (back.encoder_p is back.encoder_q) == shared
    assert back.encoder_q.tokenizer.vocab == r.encoder_q.tokenizer.vocab
    for a, b in zip(embeddings(r), embeddings(back)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("shared", [True, False])
def test_port_checkpoint_loads_in_jax(tmp_path, shared):
    """The JAX package reads the port's directory as a reference
    checkpoint and embeds as the port does."""
    r = port_retriever(shared)
    r.save_pretrained(str(tmp_path))
    j = JRetriever.from_pretrained(str(tmp_path))
    assert j.encoder_q.config.compat_pad_pooling is False
    for a, b in zip(embeddings(r), embeddings(j)):
        np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=1e-5)


def test_reference_style_directory_defaults_to_compat_pooling(tmp_path):
    """A config.json that leaves compat_pad_pooling unset (a reference
    checkpoint) loads with the reference's pooling, in both packages."""
    r = port_retriever(False)
    r.save_pretrained(str(tmp_path))
    path = tmp_path / "config.json"
    cfg = json.loads(path.read_text())
    for name in ("encoder_q", "encoder_p"):
        del cfg[name]["compat_pad_pooling"]
    path.write_text(json.dumps(cfg))
    t = Retriever.from_pretrained(str(tmp_path), device="cpu")
    j = JRetriever.from_pretrained(str(tmp_path))
    for enc in (t.encoder_q, t.encoder_p, j.encoder_q, j.encoder_p):
        assert enc.config.compat_pad_pooling is True
    # a batch of unequal lengths, where pooling over pads matters
    texts = ["green tea", "einstein wrote the famous theory of relativity"]
    a = t.encoder_q.embed(texts, batch_size=2)
    np.testing.assert_allclose(np.asarray(j.encoder_q.embed(texts,
                                                            batch_size=2)),
                               a, rtol=0, atol=1e-5)
    assert not np.allclose(a, r.encoder_q.embed(texts, batch_size=2))


def test_jax_native_directory_is_refused(tmp_path):
    tok = make_tokenizer()
    enc = enc_dict(tok)
    j = JRetriever(JConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                           shared_encoder=True), tokenizer=tok)
    j.save_pretrained(str(tmp_path))
    with pytest.raises(ValueError, match="JAX-native checkpoint") as e:
        Retriever.from_pretrained(str(tmp_path), device="cpu")
    assert "save_pretrained" in str(e.value)
    # converted the way the message says, it loads
    t = port_retriever(True)
    params = jax.tree_util.tree_map(np.asarray,
                                    j.encoder_q.variables["params"])
    t.encoder_q.module.load_state_dict(vdr_state_dict_from_flax(params, 2))
    t.save_pretrained(str(tmp_path / "converted"))
    back = Retriever.from_pretrained(str(tmp_path / "converted"),
                                     device="cpu")
    np.testing.assert_allclose(back.encoder_q.embed(TEXTS),
                               np.asarray(j.encoder_q.embed(TEXTS)),
                               rtol=0, atol=1e-5)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="config.json"):
        Retriever.from_pretrained(str(tmp_path), device="cpu")
