"""The same seed gives the same corpus, queries and arrivals; every seed
gives the same arrivals and the same set of query lengths."""
import numpy as np
import torch

from benchmark import corpus as corpus_mod
from benchmark import harness
from benchmark import vocab as vocab_mod

SEED = 2 ** 31 + 7


def _corpus(seed, keep=True):
    tok = vocab_mod.word_token_ids(vocab_mod.build_vocab())
    spec = {"kind": "lognormal", "median": 20, "sigma": 0.4, "min": 4,
            "max": 40}
    return corpus_mod.make_corpus(2000, spec, seed, "cpu", 999, tok,
                                  keep_words=keep, chunk_rows=700)


def test_corpus_repeats_from_its_seed():
    a, b, c = _corpus(SEED), _corpus(SEED), _corpus(SEED + 1)
    assert torch.equal(a.cols, b.cols) and torch.equal(a.nnz, b.nnz)
    assert np.array_equal(a.words, b.words)
    assert not torch.equal(a.cols, c.cols)


def test_corpus_rows_are_the_unique_shifted_ids_of_their_words():
    c = _corpus(SEED)
    tok = vocab_mod.word_token_ids(vocab_mod.build_vocab())
    v = c.num_cols
    for i in (0, 17, 1999):
        want = np.unique(tok[c.passage_words(i).astype(np.int64)] - 999)
        row = c.cols[i].numpy()
        assert np.array_equal(row[:c.nnz[i]], want)
        assert (row[c.nnz[i]:] == v).all()
        assert len(c.passage_words(i)) == c.lengths[i]


def test_queries_and_arrivals_repeat_and_keep_their_shape():
    traffic = harness.find_cell(harness.load_benchmark(),
                                "msmarco-first-stage").traffic
    a = corpus_mod.make_queries(traffic, SEED, 2.0)
    b = corpus_mod.make_queries(traffic, SEED, 2.0)
    c = corpus_mod.make_queries(traffic, SEED + 1, 2.0)
    assert a.texts == b.texts and np.array_equal(a.due, b.due)
    assert np.array_equal(a.due, c.due)  # the same arrivals
    assert sorted(map(len, a.words)) == sorted(map(len, c.words))
    assert a.texts != c.texts
    assert a.due[0] < 0 < a.due[-1]  # the lead comes before the window
