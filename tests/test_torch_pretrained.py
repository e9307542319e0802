"""Checkpoints of the port: ``save_pretrained``/``from_pretrained`` in the
reference's HF layout, read back by the port bit for bit and by the JAX
package (its ``_from_torch_dir``) to the same embeddings (f32 on the CPU,
``atol=1e-5``); a JAX-native directory is refused with a clear error."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_tokenizer, tiny_bert_config
from vsearch_tpu.retriever import Retriever as JRetriever
from vsearch_tpu.retriever import RetrieverConfig as JConfig
from vsearch_tpu_torch.models.convert import vdr_state_dict_from_flax
from vsearch_tpu_torch.models.vdr import TRUNKS
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

TEXTS = ["green tea drink", "theory of relativity", "mars ice water"]


def enc_dict(tok):
    return {"type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
            **{k: v for k, v in vars(tiny_bert_config(tok.vocab_size)).items()
               if k in ("vocab_size", "hidden_size", "num_hidden_layers",
                        "num_attention_heads", "intermediate_size",
                        "max_position_embeddings")}}


def _granite():
    from tests.test_torch_granite import WORDS, _enc_dict, _vocab
    return _enc_dict(), _vocab(), [" ".join(WORDS[i::97][:12])
                                   for i in range(3)]


def _bert():
    tok = make_tokenizer()
    return enc_dict(tok), dict(tok.vocab), TEXTS


# a tiny encoder dict, vocabulary and texts for each of ``TRUNKS``
TINY = {"bert": _bert, "granite_hybrid": _granite}


def port_retriever(shared, seed=4, trunk="bert"):
    enc, vocab, _ = TINY[trunk]()
    return Retriever(RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                                     shared_encoder=shared),
                     tokenizer=WordPieceTokenizer(vocab),
                     seed=seed, device="cpu")


def embeddings(r, texts=TEXTS):
    return (r.encoder_q.embed(texts, batch_size=4),
            r.encoder_p.embed(texts, batch_size=4))


@pytest.mark.parametrize("trunk", list(TRUNKS))
@pytest.mark.parametrize("shared", [True, False])
def test_round_trip_is_bit_identical(tmp_path, shared, trunk):
    """Over every trunk: what ``save_pretrained`` wrote,
    ``from_pretrained`` reads back to the same weights."""
    r = port_retriever(shared, trunk=trunk)
    texts = TINY[trunk]()[2]
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
    assert back.encoder_q.config.trunk == trunk
    for a, b in zip(embeddings(r, texts), embeddings(back, texts)):
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


def _write_safetensors(path, tensors, metadata=None):
    """A ``.safetensors`` file written byte by byte: ``tensors`` maps a
    name to (dtype string, shape, little-endian bytes)."""
    import struct

    header, offset, blobs = {}, 0, []
    for name, (dtype, shape, raw) in tensors.items():
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    if metadata is not None:
        header["__metadata__"] = metadata
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.parametrize("shared", [True, False])
def test_safetensors_checkpoint_loads_as_in_jax(tmp_path, shared):
    """A checkpoint whose weights are ``model.safetensors`` (written by
    the ``safetensors`` package) loads in the port and in the JAX package
    to the same embeddings; it wins over a ``pytorch_model.bin`` beside
    it, as in the JAX package."""
    st = pytest.importorskip("safetensors.numpy")
    r = port_retriever(shared)
    r.save_pretrained(str(tmp_path))
    sd = torch.load(str(tmp_path / "pytorch_model.bin"), weights_only=True)
    st.save_file({k: v.numpy() for k, v in sd.items()},
                 str(tmp_path / "model.safetensors"))
    port_retriever(shared, seed=9).save_pretrained(str(tmp_path / "other"))
    os.replace(tmp_path / "other" / "pytorch_model.bin",
               tmp_path / "pytorch_model.bin")  # other weights, ignored
    t = Retriever.from_pretrained(str(tmp_path), device="cpu")
    j = JRetriever.from_pretrained(str(tmp_path))
    for a, b, c in zip(embeddings(t), embeddings(j), embeddings(r)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(a, c)


def test_bf16_safetensors_read_without_the_package(tmp_path):
    """A BF16 ``model.safetensors`` written byte by byte loads the weights
    that a ``pytorch_model.bin`` of the same bf16-rounded tensors gives;
    F16 and I64 read as written, and other dtypes are refused."""
    from vsearch_tpu_torch.biencoder import read_safetensors

    r = port_retriever(False)
    r.save_pretrained(str(tmp_path / "bin"))
    sd = torch.load(str(tmp_path / "bin" / "pytorch_model.bin"),
                    weights_only=True)
    rounded = {k: v.bfloat16() for k, v in sd.items()}
    torch.save(rounded, str(tmp_path / "bin" / "pytorch_model.bin"))
    shutil.copytree(tmp_path / "bin", tmp_path / "st")
    os.remove(tmp_path / "st" / "pytorch_model.bin")
    _write_safetensors(tmp_path / "st" / "model.safetensors", {
        k: ("BF16", v.shape, v.view(torch.int16).numpy().tobytes())
        for k, v in rounded.items()}, metadata={"format": "pt"})
    a = Retriever.from_pretrained(str(tmp_path / "bin"), device="cpu")
    b = Retriever.from_pretrained(str(tmp_path / "st"), device="cpu")
    for ea, eb in ((a.encoder_q, b.encoder_q), (a.encoder_p, b.encoder_p)):
        sa, sb = ea.module.state_dict(), eb.module.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            torch.testing.assert_close(sb[k], sa[k], rtol=0, atol=0)
    for x, y in zip(embeddings(a), embeddings(b)):
        np.testing.assert_array_equal(x, y)

    half = np.array([[1.5, -2.25], [65504.0, 0.0]], np.float16)
    longs = np.array([3, -(1 << 40), 7], np.int64)
    _write_safetensors(tmp_path / "mixed.safetensors", {
        "h": ("F16", half.shape, half.astype("<f2").tobytes()),
        "i": ("I64", longs.shape, longs.astype("<i8").tobytes()),
        "s": ("F32", (), np.float32(0.5).tobytes())})
    got = read_safetensors(str(tmp_path / "mixed.safetensors"))
    assert got["h"].dtype == torch.float16 and got["i"].dtype == torch.int64
    np.testing.assert_array_equal(got["h"].numpy(), half)
    np.testing.assert_array_equal(got["i"].numpy(), longs)
    assert got["s"].shape == () and float(got["s"]) == 0.5
    _write_safetensors(tmp_path / "f64.safetensors", {
        "d": ("F64", (1,), np.float64(1.0).tobytes())})
    with pytest.raises(ValueError, match="dtype F64"):
        read_safetensors(str(tmp_path / "f64.safetensors"))
