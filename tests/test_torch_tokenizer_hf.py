"""``get_tokenizer`` resolves as the JAX package's does: the C++ tokenizer
when a vocab file resolves, then HF ``AutoTokenizer`` (wrapped in
``HFTokenizerAdapter``) for ``prefer`` 'auto' and 'hf', 'hf' raising
when that fails, and ``FileNotFoundError`` when nothing resolves. The HF
tokenizer loads from a local directory (a ``vocab.txt`` and a
``tokenizer_config.json`` naming ``BertTokenizerFast``); nothing is
downloaded."""
import json
import sys

import pytest

pytest.importorskip("transformers")

from vsearch_tpu import tokenization as jtok  # noqa: E402
from vsearch_tpu_torch import tokenization as ttok  # noqa: E402
from vsearch_tpu_torch.examples.synthetic_vocab import \
    build_wordpiece_vocab  # noqa: E402

TEXTS = ["What is GREEN tea good for?", "einstein wrote the theory",
         "word00042 runs fast, naïve café", ""]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_tok")
    vocab = build_wordpiece_vocab()
    (d / "vocab.txt").write_text("".join(
        w + "\n" for w, _ in sorted(vocab.items(), key=lambda kv: kv[1])))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizerFast", "do_lower_case": True}))
    return str(d)


@pytest.fixture
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


def test_hf_adapter_equals_jax(hf_dir, offline):
    j = jtok.get_tokenizer(hf_dir, prefer="hf")
    t = ttok.get_tokenizer(hf_dir, prefer="hf")
    assert isinstance(t, ttok.HFTokenizerAdapter)
    assert isinstance(j, jtok.HFTokenizerAdapter)
    assert (t.vocab_size, t.pad_id, t.cls_id, t.sep_id, t.unk_id) == \
        (j.vocab_size, j.pad_id, j.cls_id, j.sep_id, j.unk_id)
    for max_length in (256, 6):
        assert t.encode_batch(TEXTS, max_length=max_length) == \
            j.encode_batch(TEXTS, max_length=max_length)
    ids = t.encode_batch(TEXTS)
    for row in ids:
        assert t.convert_ids_to_tokens(row) == j.convert_ids_to_tokens(row)
        assert t.decode(row) == j.decode(row)
        assert t.decode(row, skip_special=False) == \
            j.decode(row, skip_special=False)
    assert t.encode(TEXTS[0], max_length=8) == j.encode(TEXTS[0],
                                                        max_length=8)
    toks = t.convert_ids_to_tokens(ids[0])
    assert t.convert_tokens_to_ids(toks) == j.convert_tokens_to_ids(toks)


def test_hf_ids_equal_the_native_tokenizer(hf_dir, offline):
    """The same vocabulary through HF and through the port's own C++
    tokenizer ('auto' resolves the vocab file first) gives equal ids."""
    hf = ttok.get_tokenizer(hf_dir, prefer="hf")
    native = ttok.get_tokenizer(hf_dir, prefer="auto")
    assert type(native).__name__ == "NativeWordPieceTokenizer"
    assert hf.encode_batch(TEXTS, max_length=32) == \
        [list(r) for r in native.encode_batch(TEXTS, max_length=32)]


@pytest.mark.parametrize("pkg", [jtok, ttok], ids=["jax", "port"])
def test_without_transformers(hf_dir, monkeypatch, tmp_path, pkg):
    """With ``transformers`` unimportable, 'hf' raises, 'auto' resolves
    natively, 'python' and a value outside the four fall through to the
    pure-Python tokenizer, and 'auto' without a vocab file raises
    ``FileNotFoundError``: the same in both packages."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.delenv("VSEARCH_TPU_VOCAB", raising=False)
    with pytest.raises(ImportError):
        pkg.get_tokenizer(hf_dir, prefer="hf")
    assert type(pkg.get_tokenizer(hf_dir, prefer="auto")).__name__ == \
        "NativeWordPieceTokenizer"
    for prefer in ("python", "spam"):
        assert isinstance(pkg.get_tokenizer(hf_dir, prefer=prefer),
                          pkg.WordPieceTokenizer)
    with pytest.raises(FileNotFoundError):
        pkg.get_tokenizer(str(tmp_path / "missing"), prefer="auto")
