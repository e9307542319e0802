"""The port's small leftover modules against the JAX package's:
``utils/vis.py`` (``wordcloud`` is not installed here, so its text
fallback), the ``visual=``/``save_file=`` options of ``BiEncoder.explain``
and of every encoder's ``disentangle``, and ``index/index_utils.py``."""
import numpy as np
import pytest

from tests.helpers import make_tokenizer
from tests.test_torch_crossmodal import image_pair, text_pair
from vsearch_tpu.index.index_utils import get_first_unique_n as j_unique
from vsearch_tpu.utils.vis import wordcloud_from_dict as j_cloud
from vsearch_tpu_torch.index.index_utils import get_first_unique_n
from vsearch_tpu_torch.utils.vis import wordcloud_from_dict

FALLBACK = "[vsearch-tpu] wordcloud unavailable; top tokens: "


def _no_wordcloud():
    try:
        import wordcloud  # noqa: F401
    except ImportError:
        return
    pytest.fail("wordcloud is installed: these tests check the fallback")


@pytest.mark.parametrize("log_scale", [False, True])
@pytest.mark.parametrize("d", [
    {"tea": 2.0, "green": 1.5, "zero": 0.0, "neg": -1.0},
    {f"w{i}": float(i) for i in range(30)},
    {"a": 0.0, "b": -2.0}])
def test_wordcloud_text_fallback_matches_jax(d, log_scale, capsys, tmp_path):
    _no_wordcloud()
    out = tmp_path / "cloud.png"
    assert j_cloud(d, max_words=5, log_scale=log_scale,
                   save_file=str(out)) is None
    want = capsys.readouterr().out
    assert wordcloud_from_dict(d, max_words=5, log_scale=log_scale,
                               save_file=str(out)) is None
    assert capsys.readouterr().out == want
    assert not out.exists()
    assert want.startswith(FALLBACK) == any(v > 0 for v in d.values())


@pytest.mark.parametrize("items,n", [([3, 1, 3, 2, 1, 5], 3),
                                     ("abracadabra", 10), ([], 2),
                                     ([7, 7, 7], 1)])
def test_get_first_unique_n_matches_jax(items, n):
    assert list(get_first_unique_n(items, n)) == list(j_unique(items, n))


def _printed(capsys) -> list:
    line = capsys.readouterr().out.strip()
    assert line.startswith(FALLBACK), line
    return [kv.rsplit(":", 1)[0] for kv in line[len(FALLBACK):].split(", ")]


def test_explain_and_disentangle_visual(capsys, tmp_path):
    """``visual=True`` draws (here: prints) what the call returns, which
    is the same with and without it."""
    _no_wordcloud()
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
    from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

    tok = make_tokenizer()
    enc = {"type": "vdr", "max_len": 16, "topk": 8, "shift_vocab_num": 5,
           "vocab_size": tok.vocab_size, "hidden_size": 32,
           "num_hidden_layers": 1, "num_attention_heads": 2,
           "intermediate_size": 64}
    r = Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc,
                                  shared_encoder=True),
                  tokenizer=WordPieceTokenizer(dict(tok.vocab)),
                  device="cpu")
    q, p = "green tea drink", "green tea is a drink"
    plain = r.explain(q, p, topk=8)
    capsys.readouterr()
    save = str(tmp_path / "explain.png")
    assert r.explain(q, p, topk=8, visual=True, save_file=save) == plain
    assert plain and _printed(capsys) == list(plain)[:20]
    d = r.encoder_q.disentangle(q, topk=8)
    capsys.readouterr()
    assert r.encoder_q.disentangle(q, topk=8, visual=True) == d
    assert _printed(capsys) == list(d)[:20]


def test_crossmodal_disentangle_visual(capsys):
    _no_wordcloud()
    _, t = text_pair(False)
    d = t.disentangle("green tea drink", topk=8)
    capsys.readouterr()
    assert t.disentangle("green tea drink", topk=8, visual=True) == d
    assert _printed(capsys) == list(d)[:20]
    _, img, _ = image_pair()
    pixels = np.random.default_rng(2).random((1, 64, 64, 3)).astype(
        np.float32)
    d = img.disentangle(pixels, topk=8)
    capsys.readouterr()
    assert img.disentangle(pixels, topk=8, visual=True) == d
    assert _printed(capsys) == list(d)[:20]
