"""Port parity of evaluation: answer matching, qa.csv parsing, retrieval
metrics and the two scoring CLIs (``cli.score.eval_wiki21m`` and
``cli.score.eval_beir``) against the JAX package on the same inputs and
files. Matching and metrics are exact; the CLIs must print the same JSON
(their numbers are rounded to 2 and 4 decimals; the encoders agree to
~1e-6, far from a rank flip on these inputs)."""
import importlib.util
import json
import sys

import numpy as np
import pytest

from tests.helpers import make_tokenizer
from vsearch_tpu.eval import qa_utils as j_qa
from vsearch_tpu.eval import retrieval_eval as j_re
from vsearch_tpu_torch.eval import qa_utils as t_qa
from vsearch_tpu_torch.eval import retrieval_eval as t_re

ASCII = ["The Eiffel Tower is in Paris, France.",
         "Albert Einstein (1879-1955) wrote 'On the Electrodynamics'!",
         "rock'n'roll & jazz: 3.14 vs. 2,718 -- x+y=z?",
         "New York's 2nd-largest borough\nis Brooklyn"]
UNICODE = ["Café crème brûlée à Montréal",
           "Zürich’s “Großmünster” – 12th century…",
           "naïve coöperation, São Paulo; Ångström ÅÄÖ",
           "Ελληνικά and 日本語 text: señor Müller"]
ANSWERS = [["paris"], ["Einstein"], ["3.14"], ["brooklyn"], ["montréal"],
           ["großmünster"], ["são paulo"], ["müller"], ["tower is"],
           ["zzz", "jazz"], ["rock ' n"], ["12th century"], []]


@pytest.mark.parametrize("text", ASCII + UNICODE)
def test_tokenizer_and_has_answer_match_jax(text):
    t, j = t_qa.SimpleTokenizer(), j_qa.SimpleTokenizer()
    assert t.tokenize(text) == j.tokenize(text)
    assert t.words(text, uncased=True) == j.words(text, uncased=True)
    rt, rj = t.rich_tokenize(text), j.rich_tokenize(text)
    assert rt.offsets() == rj.offsets() and rt.untokenize() == \
        rj.untokenize() and rt.ngrams(n=2) == rj.ngrams(n=2)
    for ans in ANSWERS:
        for mt in ("string", "regex"):
            assert t_qa.has_answer(ans, text, mt) == \
                j_qa.has_answer(ans, text, mt), (ans, mt)
    for pat in (r"\bparis\b", r"[0-9]+\.[0-9]+", r"caf", r"(unclosed",
                r"münster"):
        assert t_qa.regex_match(text, pat) == j_qa.regex_match(text, pat)


def _fallback_module(monkeypatch):
    """A fresh copy of the port's ``qa_utils`` imported with ``regex``
    made unimportable: the ``re`` branch."""
    monkeypatch.setitem(sys.modules, "regex", None)
    spec = importlib.util.spec_from_file_location("qa_fallback",
                                                  t_qa.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_re_fallback_agrees_on_ascii(monkeypatch):
    fb = _fallback_module(monkeypatch)
    assert fb._regex is None and t_qa._regex is not None
    for text in ASCII:
        assert fb.SimpleTokenizer().tokenize(text) == \
            t_qa.SimpleTokenizer().tokenize(text)
        for ans in ANSWERS:
            for mt in ("string", "regex"):
                assert fb.has_answer(ans, text, mt) == \
                    t_qa.has_answer(ans, text, mt)


def test_parse_qa_csv_matches_jax(tmp_path):
    p = tmp_path / "qa.csv"
    p.write_text("who wrote it?\t['Einstein', \"Bohr's\"]\n\n"
                 "where is paris\t['France']\n"
                 "no answers\n", encoding="utf-8")
    assert t_qa.parse_qa_csv_file(str(p)) == j_qa.parse_qa_csv_file(str(p))
    assert t_qa.parse_qa_csv_file(str(p))[0] == ("who wrote it?",
                                                 ["Einstein", "Bohr's"])


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        ranked = rng.integers(0, 3, size=12).astype(float).tolist()
        ideal = rng.integers(0, 3, size=5).astype(float).tolist()
        for k in (1, 5, 10, 20):
            assert t_re.ndcg_at_k(ranked, ideal, k) == \
                j_re.ndcg_at_k(ranked, ideal, k)
            assert t_re.dcg_at_k(ranked, k) == j_re.dcg_at_k(ranked, k)
    run = {f"q{i}": [f"d{j}" for j in rng.permutation(30)[:20]]
           for i in range(8)}
    qrels = {f"q{i}": {f"d{j}": float(rng.integers(1, 3))
                       for j in rng.choice(30, size=3, replace=False)}
             for i in range(7)}
    qrels["q0"]["d99"] = 0.0
    for ks in ((1, 5, 10, 20, 100), (3,)):
        assert t_re.evaluate_rankings(run, qrels, ks) == \
            j_re.evaluate_rankings(run, qrels, ks)


CORPUS = ["the eiffel tower is in paris france",
          "albert einstein wrote the theory of relativity",
          "green tea is a drink from china",
          "the red planet mars has ice water",
          "a big dog runs fast in the city",
          "the river water runs slow and is small",
          "physics is the theory of space and time and light",
          "what is the speed of light in water"]
QA = [("who wrote relativity", ["einstein"]), ("tea drink", ["china"]),
      ("red planet", ["mars"]), ("dog in the city", ["dog"]),
      ("speed of light", ["nothing here"])]


def _run_main(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_wiki21m_cli_matches_jax(tmp_path, capsys):
    from vsearch_tpu.cli.score import eval_wiki21m as j_cli
    from vsearch_tpu_torch.cli.score import eval_wiki21m as t_cli

    (tmp_path / "c.jsonl").write_text(
        "".join(json.dumps({"title": f"t{i}", "text": t}) + "\n"
                for i, t in enumerate(CORPUS)))
    (tmp_path / "qa.csv").write_text(
        "".join(f"{q}\t{a!r}\n" for q, a in QA))
    rng = np.random.default_rng(4)
    results = [{"question": q, "ids": rng.permutation(len(CORPUS))
                .tolist(), "scores": [1.0] * len(CORPUS)} for q, _ in QA]
    (tmp_path / "r.json").write_text(json.dumps(results))
    argv = ["--result_file", str(tmp_path / "r.json"), "--text_file",
            str(tmp_path / "c.jsonl"), "--qa_file", str(tmp_path / "qa.csv")]
    got = _run_main(t_cli.main, argv, capsys)
    assert got == _run_main(j_cli.main, argv, capsys)
    assert list(got) == ["top1", "top5", "top10", "top20", "top100"]
    assert got["top100"] == 80.0  # 4 of 5 answers occur in the corpus


@pytest.mark.parametrize("kind", ["vdr", "dpr"])
def test_eval_beir_cli_matches_jax(tmp_path, capsys, kind):
    """A port checkpoint scored by both packages' ``eval_beir`` (the JAX
    package reads the port's HF-layout directory)."""
    from vsearch_tpu.cli.score import eval_beir as j_cli
    from vsearch_tpu_torch.cli.score import eval_beir as t_cli
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
    from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

    tok = make_tokenizer()
    enc = {"type": kind, "max_len": 32, "vocab_size": tok.vocab_size,
           "hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "intermediate_size": 128,
           "max_position_embeddings": 64}
    if kind == "vdr":
        enc.update(topk=16, shift_vocab_num=5)
    Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc,
                              shared_encoder=True),
              tokenizer=WordPieceTokenizer(dict(tok.vocab)), seed=2,
              device="cpu").save_pretrained(str(tmp_path / "ckpt"))
    (tmp_path / "corpus.jsonl").write_text("".join(
        json.dumps({"_id": f"d{i}", "title": "", "text": t}) + "\n"
        for i, t in enumerate(CORPUS)))
    (tmp_path / "queries.jsonl").write_text("".join(
        json.dumps({"_id": f"q{i}", "text": q}) + "\n"
        for i, (q, _) in enumerate(QA)))
    (tmp_path / "qrels.tsv").write_text(
        "query-id\tcorpus-id\tscore\n" + "".join(
            f"q{i}\td{(3 * i + 1) % len(CORPUS)}\t1\n"
            for i in range(len(QA))))
    argv = ["--checkpoint", str(tmp_path / "ckpt"),
            "--corpus_file", str(tmp_path / "corpus.jsonl"),
            "--query_file", str(tmp_path / "queries.jsonl"),
            "--qrels_file", str(tmp_path / "qrels.tsv"), "--ks", "1,3,10",
            "--batch_size", "4"]
    got = _run_main(t_cli.main, argv + ["--device", "cpu"], capsys)
    assert got == _run_main(j_cli.main, argv, capsys)
    assert set(got) == {f"{m}@{k}" for m in ("ndcg", "recall", "mrr")
                        for k in (1, 3, 10)}
    assert got["recall@10"] == 1.0  # every document is ranked
