"""The repo's own tools on the port (``vsearch_tpu_torch.examples``)
against the JAX package's: the synthetic vocabulary (``bench.py``), the
convergence demo's task and training file (``scripts/tpu_train_demo.py``,
imported as it is), the quick start on a tiny model whose JAX weights
are carried across by ``models.convert``, a tiny demo run, and the
wiki21m pipeline scripts run through ``bash`` on the CPU."""
import ast
import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
from vsearch_tpu.retriever import Retriever as JRetriever
from vsearch_tpu.retriever import RetrieverConfig as JConfig
from vsearch_tpu.tokenization.wordpiece import WordPieceTokenizer as JTok
from vsearch_tpu_torch.examples import quick_start, synthetic_vocab, \
    train_demo
from vsearch_tpu_torch.models.convert import vdr_state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DEMO = os.path.join(ROOT, "scripts", "tpu_train_demo.py")
SCRIPTS = os.path.join(ROOT, "vsearch_tpu_torch", "examples", "svdr_wiki21m")
SCORE_RTOL = 1e-5  # f32 scores through two packages' summation orders


def load_jax_demo():
    spec = importlib.util.spec_from_file_location("tpu_train_demo", JAX_DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_vocab_equals_bench():
    assert synthetic_vocab.BASE_WORDS == bench._BASE_WORDS
    mine, theirs = (synthetic_vocab.build_wordpiece_vocab(),
                    bench.build_wordpiece_vocab())
    assert list(mine.items()) == list(theirs.items())
    assert len(mine) == 30522


@pytest.mark.parametrize("topics,seed", [(16, 0), (128, 0), (40, 3)])
def test_demo_task_equals_jax(topics, seed):
    assert train_demo.make_task(topics, 48, seed) == \
        load_jax_demo().make_task(topics, 48, seed)


def test_demo_train_file_equals_jax(tmp_path, monkeypatch):
    """The JAX demo's ``main`` writes its training file, then stops where
    it would build its retriever; the port's file has the same bytes."""
    import vsearch_tpu.retriever as jret
    import vsearch_tpu.tokenization.native as jnative

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop

    monkeypatch.setattr(jret, "Retriever", stop)
    monkeypatch.setattr(jnative, "NativeWordPieceTokenizer", stop)
    monkeypatch.setattr(sys, "argv", [JAX_DEMO, "--num-topics", "24",
                                      "--out", str(tmp_path / "jax")])
    with pytest.raises(Stop):
        load_jax_demo().main()
    queries, passages = train_demo.make_task(24, words_per_passage=48)
    train_demo.write_train_file(str(tmp_path / "port.jsonl"), queries,
                                passages)
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax" / "train.jsonl").read_bytes()


@pytest.fixture(scope="module")
def quick_pair():
    """The quick start's tiny retriever, and the same configuration built
    in JAX, whose weights the port's copy then takes."""
    t = quick_start.make_tiny_retriever(device="cpu")
    vocab = synthetic_vocab.build_wordpiece_vocab()
    j = JRetriever(JConfig(encoder_q=dict(t.config.encoder_q),
                           encoder_p=dict(t.config.encoder_p),
                           shared_encoder=True), tokenizer=JTok(vocab))
    params = jax.tree_util.tree_map(np.asarray,
                                    j.encoder_q.variables["params"])
    t.encoder_q.module.load_state_dict(vdr_state_dict_from_flax(params, 2))
    return j, t


def jax_quick_start(j):
    """The JAX quick start's calls (``examples/quick_start.py:56-73``)."""
    q_emb = j.encoder_q.embed([quick_start.QUERY])
    p_emb = j.encoder_p.embed(quick_start.PASSAGES)
    j.build_index(quick_start.PASSAGES, index_type="sparse")
    alpha = j.retrieve([quick_start.QUERY], k=3)
    j.build_index(quick_start.PASSAGES, index_type="bag_of_token")
    beta = j.retrieve([quick_start.QUERY], k=3, rerank=True)
    top = dict(list(j.explain(quick_start.QUERY, quick_start.PASSAGES[0],
                              topk=32).items())[:5])
    return {"scores": np.asarray(q_emb @ p_emb.T), "alpha": alpha,
            "beta": beta, "explain": top}


def assert_same_run(got, want):
    np.testing.assert_allclose(got["scores"], want["scores"],
                               rtol=SCORE_RTOL, atol=SCORE_RTOL)
    for key in ("alpha", "beta"):
        np.testing.assert_array_equal(np.asarray(got[key].ids),
                                      np.asarray(want[key].ids))
        np.testing.assert_allclose(np.asarray(got[key].scores),
                                   np.asarray(want[key].scores),
                                   rtol=SCORE_RTOL, atol=SCORE_RTOL)
    assert list(got["explain"]) == list(want["explain"])
    np.testing.assert_allclose(list(got["explain"].values()),
                               list(want["explain"].values()),
                               rtol=SCORE_RTOL)


def test_quick_start_equals_jax(quick_pair, capsys):
    """The tiny model with the JAX weights gives the JAX package's scores,
    alpha and beta ids and ``explain`` top tokens, and prints the JAX
    quick start's four lines."""
    j, t = quick_pair
    got = quick_start.run(t)
    want = jax_quick_start(j)
    assert_same_run(got, want)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "scores", "alpha search ids", "beta search ids", "top attributions"]
    assert lines[2] == "beta search ids: " + str(
        np.asarray(want["beta"].ids)[0].tolist())


def test_quick_start_checkpoint_equals_jax(quick_pair, tmp_path):
    """``main --checkpoint`` on the CPU against the JAX package's
    ``Retriever.from_pretrained`` of the same directory (both then take
    the C++ tokenizer over its ``vocab.txt``)."""
    _, t = quick_pair
    t.save_pretrained(str(tmp_path / "ckpt"))
    got = quick_start.main(["--checkpoint", str(tmp_path / "ckpt"),
                            "--device", "cpu"])
    assert_same_run(got, jax_quick_start(
        JRetriever.from_pretrained(str(tmp_path / "ckpt"))))


def test_quick_start_tiny_main(capsys):
    """Without a checkpoint ``main`` builds the tiny random model from its
    seed: the same results as ``run`` on ``make_tiny_retriever``."""
    got = quick_start.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("(no checkpoint given; using a tiny random model)")
    want = quick_start.run(quick_start.make_tiny_retriever(device="cpu"))
    np.testing.assert_array_equal(got["scores"], want["scores"])
    np.testing.assert_array_equal(got["beta"].ids, want["beta"].ids)
    assert got["scores"].shape == (1, 3) and np.isfinite(got["scores"]).all()


def jax_demo_keys():
    """The keys of the JSON line of ``scripts/tpu_train_demo.py``."""
    tree = ast.parse(open(JAX_DEMO).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "out"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no out = {...} in the JAX demo")


def test_train_demo_tiny_run(capsys):
    """16 topics, 1 layer of 64, B=8 for 4 epochs (8 steps) on the CPU:
    the JSON line has the JAX demo's keys, and top-1 rises (observed:
    0.5 before, 0.75 after by alpha and 0.875 by beta search)."""
    out = train_demo.main(["--num-topics", "16", "--layers", "1",
                           "--hidden", "64", "--batch-size", "8",
                           "--epochs", "4", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert list(out) == jax_demo_keys()
    assert out["steps"] == 8 and out["device"] == "cpu"
    assert out["model"] == "1L-64H-30522V"
    assert out["top1_after"] > out["top1_before"]
    assert out["top1_beta_after"] > out["top1_before"]


def test_demo_initialization():
    """At the demo's width (4 layers of 256; 48 of its topics) a random
    VDR from the port's BERT initialization already finds the topics'
    passages by their words, and one from the JAX package's does not, as
    the JAX demo's run starts (observed on the CPU: top-1 1.0 and
    0.125)."""
    from vsearch_tpu_torch.retriever import Retriever
    from vsearch_tpu_torch.tokenization.native import \
        NativeWordPieceTokenizer

    tok = NativeWordPieceTokenizer(synthetic_vocab.build_wordpiece_vocab())
    queries, passages = train_demo.make_task(48, 48)
    bert_init = Retriever(train_demo.demo_config(4, 256), tokenizer=tok,
                          device="cpu")
    jax_init = train_demo.make_retriever(4, 256, tok, "cpu")
    assert train_demo.top1(bert_init, queries, passages) >= 0.5
    assert train_demo.top1(jax_init, queries, passages) <= 0.2


def test_wiki21m_scripts_on_the_cpu(tmp_path):
    """The three scripts through ``bash`` with ``DEVICE=cpu``: the build,
    then beta search, whose result file equals the ``beta_search`` CLI's
    in-process run on the same inputs, then scoring."""
    from vsearch_tpu_torch.cli.search import beta_search
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
    from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

    d = tmp_path
    enc = {"type": "vdr", "max_len": 32, "topk": 32, "shift_vocab_num": 999,
           "vocab_size": 30522, "hidden_size": 32, "num_hidden_layers": 1,
           "num_attention_heads": 2, "intermediate_size": 64,
           "max_position_embeddings": 64}
    Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc,
                              shared_encoder=True),
              tokenizer=WordPieceTokenizer(
                  synthetic_vocab.build_wordpiece_vocab()),
              seed=1, device="cpu").save_pretrained(str(d / "ckpt"))
    queries, passages = train_demo.make_task(48, 12)
    with open(d / "corpus.jsonl", "w") as f:
        f.writelines(json.dumps({"text": p}) + "\n" for p in passages)
    with open(d / "q.jsonl", "w") as f:
        f.writelines(json.dumps({"question": q}) + "\n" for q in queries)
    with open(d / "qa.csv", "w") as f:
        f.writelines(f"{q}\t{[p.split()[0]]!r}\n"
                     for q, p in zip(queries, passages))
    env = dict(os.environ, DEVICE="cpu", PYTHON=sys.executable,
               HF_HUB_OFFLINE="1", VSEARCH_TPU_VOCAB=str(d / "ckpt" /
                                                         "vocab.txt"),
               CKPT=str(d / "ckpt"), TEXT=str(d / "corpus.jsonl"),
               INDEX=str(d / "bot.npz"), SAVE=str(d / "beta.json"),
               QUERY=str(d / "q.jsonl"), RESULT=str(d / "beta.json"),
               QA=str(d / "qa.csv"))

    def script(name, **extra):
        out = subprocess.run(["bash", os.path.join(SCRIPTS, name)],
                             cwd=ROOT, env=dict(env, **extra),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    script("build_binary_token_index.sh", SAVE=str(d / "bot.npz"))
    script("beta_search.sh")
    beta_search.main(["--checkpoint", str(d / "ckpt"), "--query_file",
                      str(d / "q.jsonl"), "--text_file",
                      str(d / "corpus.jsonl"), "--index_file",
                      str(d / "bot.npz"), "--save_file", str(d / "ref.json"),
                      "--num_rerank", "100", "--device", "cpu"])
    got = json.loads((d / "beta.json").read_text())
    want = json.loads((d / "ref.json").read_text())
    assert [r["ids"] for r in got] == [r["ids"] for r in want]
    assert len(got) == 48 and len(got[0]["ids"]) == 48  # k clamped to rows
    np.testing.assert_allclose([r["scores"] for r in got],
                               [r["scores"] for r in want], rtol=1e-6)
    acc = json.loads(script("score_wiki21m.sh").strip().splitlines()[-1])
    assert list(acc) == ["top1", "top5", "top10", "top20", "top100"]
    vals = list(acc.values())
    assert all(a <= b for a, b in zip(vals, vals[1:])) and vals[-1] == 100.0
