"""Port parity of the training data pipeline and config: the port's copies
of ``config.py`` and ``data/*`` give exactly what the JAX package's give on
the same files, seeds and samples (datasets and their filters, iterator
batch orders, resume offsets, multi-set sampling, batch tensors, the RAG
dataset, every file under ``conf/``)."""
import glob
import json
import os
import random

import numpy as np
import pytest

from tests.helpers import make_tokenizer
from vsearch_tpu import config as j_config
from vsearch_tpu import data as j_data
from vsearch_tpu.data import iterators as j_it
from vsearch_tpu.data.rag_dataset import RAGDataset as JRAGDataset
from vsearch_tpu_torch import config as t_config
from vsearch_tpu_torch import data as t_data
from vsearch_tpu_torch.data import iterators as t_it
from vsearch_tpu_torch.data.rag_dataset import RAGDataset
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf")
_TOK = make_tokenizer()


def write_jsonl(path, n):
    """Samples with every field variant the loader handles: answers as a
    list, a bare string and absent; no hard negatives; no positives;
    curly quotes and newlines for ``_normalize``."""
    rows = []
    for i in range(n):
        row = {"question": f"question’s number {i}\nnext",
               "positive_ctxs": [{"text": f"positive passage {i} tea",
                                  "title": f"title {i}"},
                                 {"text": f"second positive {i}"}],
               "negative_ctxs": [{"text": f"negative {i} a"},
                                 {"text": f"negative {i} b"}],
               "hard_negative_ctxs": [{"text": f"hard negative {i}"}]}
        if i % 4 == 0:
            row["answers"] = [f"answer {i}"]
        elif i % 4 == 1:
            row["answer"] = f"answer {i}"
        if i % 5 == 3:
            row["hard_negative_ctxs"] = []
        if i % 7 == 6:
            row["positive_ctxs"] = []
        rows.append(row)
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")


def samples_of(ds):
    return [dict(query=s.query, answers=s.answers,
                 pos=[(p.text, p.title) for p in s.positive_passages],
                 neg=[(p.text, p.title) for p in s.negative_passages],
                 hard=[(p.text, p.title) for p in s.hard_negative_passages])
            for s in ds]


@pytest.mark.parametrize("req_pos,req_hard", [(True, True), (True, False),
                                              (False, False)])
@pytest.mark.parametrize("norm", [True, False])
def test_dataset_filtering_matches_jax(tmp_path, req_pos, req_hard, norm):
    path = tmp_path / "train.jsonl"
    write_jsonl(path, 30)
    j = j_data.BiEncoderDataset(str(path), norm=norm)
    t = t_data.BiEncoderDataset(str(path), norm=norm)
    for ds in (j, t):
        ds.load_data(require_positive=req_pos, require_hard_negative=req_hard)
    assert samples_of(t) == samples_of(j)
    assert t.calc_total_data_len() == j.calc_total_data_len() == 30
    t.load_data(req_pos, req_hard, start_pos=5, end_pos=17)
    j.load_data(req_pos, req_hard, start_pos=5, end_pos=17)
    assert samples_of(t) == samples_of(j)


class ListDataset(list):
    def load_data(self, *a, **k):
        pass

    def max_iterations_num(self):  # unused: iterators wrap datasets
        raise AssertionError


def _drain(it, epoch):
    out = []
    for batch in it.iterate_ds_data(epoch=epoch):
        out.append(batch if not isinstance(batch, tuple)
                   else (list(batch[0]), batch[1]))
    return out


@pytest.mark.parametrize("n,bs,shards,strict", [(23, 4, 1, False),
                                                (23, 4, 3, True),
                                                (10, 3, 2, False),
                                                (7, 8, 1, True)])
@pytest.mark.parametrize("offset", [0, 2])
def test_sharded_iterator_orders_match_jax(n, bs, shards, strict, offset):
    data = ListDataset(range(n))
    for shard in range(shards):
        kw = dict(shard_id=shard, num_shards=shards, batch_size=bs,
                  shuffle_seed=17, offset=offset, strict_batch_size=strict)
        j = j_it.ShardedDataIterator(data, **kw)
        t = t_it.ShardedDataIterator(data, **kw)
        assert t.max_iterations == j.max_iterations
        for epoch in (0, 1):
            assert _drain(t, epoch) == _drain(j, epoch)
        assert (list(t.iterate_ds_sampled_data(5, epoch=2, skip=1))
                == list(j.iterate_ds_sampled_data(5, epoch=2, skip=1)))


@pytest.mark.parametrize("rates", [None, [1.0, 0.5], [0.25, 1.0, 2.0]])
@pytest.mark.parametrize("offset", [0, 3])
def test_multiset_sampling_and_resume_match_jax(rates, offset):
    sizes = [16, 24, 9][: 2 if rates is None or len(rates) == 2 else 3]
    datasets = [ListDataset(f"{k}{i}" for i in range(m))
                for k, m in zip("abc", sizes)]

    def build(mod):
        return mod.get_data_iterator(datasets, batch_size=4, shuffle_seed=3,
                                     offset=offset, sampling_rates=rates)

    j, t = build(j_it), build(t_it)
    assert t.max_its_pr_ds == j.max_its_pr_ds
    assert t.get_max_iterations() == j.get_max_iterations()
    for epoch in (1, 2):  # the offset applies to the first epoch only
        got, want = _drain(t, epoch), _drain(j, epoch)
        assert got == want and len(got) == (t.get_max_iterations()
                                            - (offset if epoch == 1 else 0))
    t.set_start_iteration(5)
    j.set_start_iteration(5)
    assert _drain(t, 3) == _drain(j, 3)


def test_local_shards_match_jax(tmp_path):
    path = tmp_path / "train.jsonl"
    write_jsonl(path, 30)
    out = []
    for mod, ds_cls in ((j_it, j_data.BiEncoderDataset),
                        (t_it, t_data.BiEncoderDataset)):
        it = mod.get_data_iterator([ds_cls(str(path))], batch_size=3,
                                   shuffle_seed=2, num_shards=2, shard_id=1,
                                   local_shards=True,
                                   require_hard_negative=False)
        out.append([(samples_of(b), src) for b, src in
                    it.iterate_ds_data(epoch=0)])
    assert out[0] == out[1]


def _samples(mod, n=5):
    p = mod.BiEncoderPassage
    return [mod.BiEncoderSample(
        query=f"what is green tea {i}", answers=[f"tea {i}"],
        positive_passages=[p(f"green tea passage {i}", "tea"),
                           p(f"the other positive {i}")],
        negative_passages=[p(f"negative {i} a"), p(f"negative {i} b")]
        if i != 2 else [],
        hard_negative_passages=[p(f"hard {i}", "title")] if i != 2 else [])
        for i in range(n)]


@pytest.mark.parametrize("kw", [
    dict(num_hard_negatives=1, num_other_negatives=0),
    dict(num_hard_negatives=1, num_other_negatives=1, insert_title=True),
    dict(num_hard_negatives=3, num_other_negatives=0, shuffle=False),
    dict(num_hard_negatives=0, num_other_negatives=2,
         shuffle_positives=True, insert_title=True)])
def test_create_biencoder_batch_matches_jax(kw):
    tok_t = WordPieceTokenizer(dict(_TOK.vocab))
    got = t_data.create_biencoder_batch(tok_t, tok_t, _samples(t_data),
                                        q_max_len=12, p_max_len=16,
                                        rng=random.Random(5), **kw)
    want = j_data.create_biencoder_batch(_TOK, _TOK, _samples(j_data),
                                         q_max_len=12, p_max_len=16,
                                         rng=random.Random(5), **kw)
    for field in ("q_tensor", "p_tensor"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert (got.q_texts, got.p_texts, got.answers) == (
        want.q_texts, want.p_texts, want.answers)
    assert got.p_tensor.shape[1] == 16 and (got.p_tensor[:, -1] == 0).any()


def test_rag_dataset_matches_jax(tmp_path):
    rows = [{"question": "who made relativity", "answers": ["einstein"],
             "ctxs": [{"text": "einstein wrote relativity", "title": "e"},
                      {"text": "a dog runs fast"},
                      {"text": "the theory of einstein"}]},
            {"query": "where is mars", "answer": "mars",
             "contexts": [{"contents": "red planet"}]},
            {"answers": ["x"], "ctxs": []},
            {"question": "tea", "answers": ["green"],
             "ctxs": [{"text": "green tea"}, {"text": "black coffee"}]}]
    path = tmp_path / "rag.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    for kw in (dict(), dict(max_ctxs=1), dict(norm=False)):
        for req in ((True, False), (False, False), (True, True)):
            t, j = RAGDataset(str(path), **kw), JRAGDataset(str(path), **kw)
            t.load_data(*req)
            j.load_data(*req)
            assert samples_of(t) == samples_of(j)
    assert t.calc_total_data_len() == 4


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, CONF)
    for p in glob.glob(os.path.join(CONF, "**", "*.yaml"), recursive=True)))
def test_load_config_matches_jax(path):
    """Every file under conf/: the root itself, or its group option
    swapped in, plus value overrides."""
    root = os.path.join(CONF, "train_ir_cfg.yaml")
    group = os.path.dirname(path)
    over = ["train.learning_rate=1e-5", "mesh.dp=2", "seed=7",
            "train_datasets=[nq_train]"]
    if group:
        option = os.path.splitext(os.path.basename(path))[0]
        over.insert(0, f"{group}={option}")
    got = t_config.load_config(root, over)
    assert got == j_config.load_config(root, over)
    if group:
        expect = j_config._load_yaml(os.path.join(CONF, path))
        if group == "train":
            expect["learning_rate"] = 1e-5
        assert got[group] == expect
    assert got["train"]["learning_rate"] == 1e-5
    with pytest.raises(KeyError, match="unknown config group"):
        t_config.load_config(root, ["trian.batch_size=3"])
