"""A rendered passage tokenizes back to the ids the benchmark gives the
reference: [CLS], one id a word, [SEP]."""
import pytest

from benchmark import corpus as corpus_mod
from benchmark import vocab as vocab_mod


def _tokenizers(vocab):
    from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer
    out = [WordPieceTokenizer(vocab)]
    try:
        from vsearch_tpu_torch.tokenization.native import \
            NativeWordPieceTokenizer
        out.append(NativeWordPieceTokenizer(vocab))
    except (OSError, RuntimeError):
        pass
    return out


@pytest.fixture(scope="module")
def corpus():
    tok = vocab_mod.word_token_ids(vocab_mod.build_vocab())
    spec = {"kind": "lognormal", "median": 50, "sigma": 0.45, "min": 8,
            "max": 126}
    return corpus_mod.make_corpus(300, spec, 5, "cpu", 999, tok,
                                  keep_words=True)


def test_rendered_passages_tokenize_to_their_ids(corpus):
    vocab = vocab_mod.build_vocab()
    table = vocab_mod.word_token_ids(vocab)
    data = corpus_mod.RenderedCorpus(corpus)
    assert len(data) == 300
    rows = list(range(0, 300, 7))
    texts = [data[i] for i in rows]
    for tok in _tokenizers(vocab):
        got = tok.encode_batch(texts, max_length=256)
        for i, ids in zip(rows, got):
            want = corpus_mod.token_ids(corpus.passage_words(i), table,
                                        vocab["[CLS]"], vocab["[SEP]"], 256)
            assert ids == want.tolist()


def test_every_word_is_one_token():
    vocab = vocab_mod.build_vocab()
    words = vocab_mod.word_list()
    assert len(vocab) == vocab_mod.VOCAB_SIZE
    assert all(w in vocab for w in words)
    table = vocab_mod.word_token_ids(vocab)
    assert table.min() >= 999  # above the VDR shift
