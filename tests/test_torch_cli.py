"""The port's CLIs end to end on the CPU (``--device cpu``): a port
counterpart of each case of ``tests/test_cli.py`` that needs no ``eval``
module and no mesh, each result file held against in-process
``retrieve``, and index files written by either package's CLIs loaded by
the other package's ``load_index`` with equal answers (ids equal, scores
to the f16 rounding of the files)."""
import json

import numpy as np
import pytest

from tests.helpers import make_tokenizer, tiny_bert_config
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

CORPUS = [
    {"text": "green tea is a drink", "title": "tea"},
    {"text": "the red planet mars has ice water", "title": "mars"},
    {"text": "einstein wrote the theory of relativity", "title": "re"},
    {"text": "a big dog runs fast in the city", "title": "dog"},
    {"text": "the river water runs slow", "title": "river"},
    {"text": "physics is the theory of space and time", "title": "phys"},
]
QUERIES = ["who wrote the theory of relativity", "green tea drink"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    (d / "corpus.jsonl").write_text(
        "\n".join(json.dumps(r) for r in CORPUS) + "\n")
    (d / "queries.jsonl").write_text("\n".join(
        json.dumps({"question": q}) for q in QUERIES) + "\n")
    tok = make_tokenizer()
    enc = {
        "type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
        **{k: v for k, v in vars(tiny_bert_config(tok.vocab_size)).items()
           if k in ("vocab_size", "hidden_size", "num_hidden_layers",
                    "num_attention_heads", "intermediate_size",
                    "max_position_embeddings")},
    }
    cfg = RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                          shared_encoder=True)
    Retriever(cfg, tokenizer=WordPieceTokenizer(dict(tok.vocab)),
              device="cpu").save_pretrained(str(d / "ckpt"))
    return d


def ckpt(workdir):
    return Retriever.from_pretrained(str(workdir / "ckpt"), device="cpu")


def build_bot(workdir, name, *extra):
    from vsearch_tpu_torch.cli.build_index.binary_token_index import main

    path = str(workdir / name)
    main(["--text_file", str(workdir / "corpus.jsonl"), "--save_file", path,
          "--num_shift", "5", "--tokenizer", str(workdir / "ckpt"),
          "--num_workers", "1", *extra, *CPU])
    return path


def build_embedded(workdir, kind, name):
    if kind == "sparse":
        from vsearch_tpu_torch.cli.build_index.sparse_index import main
    else:
        from vsearch_tpu_torch.cli.build_index.dense_index import main
    path = str(workdir / name)
    main(["--checkpoint", str(workdir / "ckpt"),
          "--text_file", str(workdir / "corpus.jsonl"),
          "--save_file", path, "--batch_size", "4", *CPU])
    return path


def read_results(path):
    with open(path) as f:
        res = json.load(f)
    return (np.asarray([r["ids"] for r in res]),
            np.asarray([r["scores"] for r in res], np.float32))


def test_checkpoint_self_contained(workdir):
    """from_pretrained works with no tokenizer argument (dir vocab)."""
    emb = ckpt(workdir).encoder_q.embed(["green tea"])
    assert emb.shape[0] == 1


@pytest.mark.parametrize("name", ["bot.npz", "bot.ell.npz"])
def test_binary_token_index_cli(workdir, name):
    import scipy.sparse as sp

    path = build_bot(workdir, name)
    r = ckpt(workdir)
    r.load_index(index_file=path, index_type="bag_of_token")
    assert len(r.index) == len(CORPUS)
    if name == "bot.npz":
        assert sp.load_npz(path).shape[0] == len(CORPUS)


@pytest.mark.parametrize("kind,name,search", [
    ("sparse", "sparse_index.npz", "search_sparse_index"),
    ("dense", "dense_index.pt", "search_dense_index")])
def test_build_then_search_matches_in_process(workdir, kind, name, search):
    import importlib

    idx = build_embedded(workdir, kind, name)
    results = str(workdir / f"{kind}_results.json")
    importlib.import_module(f"vsearch_tpu_torch.cli.search.{search}").main(
        ["--checkpoint", str(workdir / "ckpt"),
         "--query_file", str(workdir / "queries.jsonl"),
         "--index_file", idx, "--save_file", results,
         "--batch_size_q", "2", "--topk", "3", *CPU])
    ids, scores = read_results(results)
    assert ids.shape == (2, 3)
    r = ckpt(workdir)
    r.load_index(index_file=idx, index_type=kind)
    want = r.retrieve(QUERIES, k=3, batch_size=2)
    np.testing.assert_array_equal(ids, want.ids)
    np.testing.assert_array_equal(scores, want.scores)


def test_sharded_build_then_glob_search(workdir):
    for shard in range(2):
        build_bot(workdir, f"bot_shard{shard}.npz", "--num_shard", "2",
                  "--shard_id", str(shard))
    r = ckpt(workdir)
    r.load_index(index_file=str(workdir / "bot_shard*.npz"),
                 index_type="bag_of_token")
    assert len(r.index) == len(CORPUS)


def test_beta_search_cli(workdir):
    from vsearch_tpu_torch.cli.search.beta_search import main as beta

    idx = build_bot(workdir, "bot2.npz")
    results = str(workdir / "beta_results.json")
    beta(["--checkpoint", str(workdir / "ckpt"),
          "--query_file", str(workdir / "queries.jsonl"),
          "--text_file", str(workdir / "corpus.jsonl"),
          "--index_file", idx, "--save_file", results,
          "--batch_size_q", "2", "--topk", "3", "--num_rerank", "3", *CPU])
    ids, scores = read_results(results)
    assert ids.shape == (2, 3)
    r = ckpt(workdir)
    r.load_index(index_file=idx, data_file=str(workdir / "corpus.jsonl"),
                 index_type="bag_of_token")
    want = r.retrieve(QUERIES, k=3, rerank=True, batch_size=2)
    np.testing.assert_array_equal(ids, want.ids)
    np.testing.assert_array_equal(scores, want.scores)


def test_convert_checkpoint_cli(workdir, tmp_path):
    from vsearch_tpu_torch.cli.convert_checkpoint import main

    out = tmp_path / "converted"
    main(["--torch_dir", str(workdir / "ckpt"), "--out", str(out), *CPU])
    a, b = ckpt(workdir), Retriever.from_pretrained(str(out), device="cpu")
    np.testing.assert_array_equal(b.encoder_q.embed(QUERIES),
                                  a.encoder_q.embed(QUERIES))


def serve_args(workdir, *argv):
    from vsearch_tpu_torch.cli.serve import make_parser

    ap = make_parser()
    return ap, ap.parse_args(["--checkpoint", str(workdir / "ckpt"),
                              *argv, *CPU])


def test_serve_warmup_without_data_file(workdir):
    """--warmup on a BoT index loaded without --data_file warms plain
    search instead of failing in the rerank."""
    from vsearch_tpu_torch.cli.serve import prepare_retriever

    idx = build_bot(workdir, "bot_serve.npz")
    ap, args = serve_args(workdir, "--index_file", idx,
                          "--index_type", "bag_of_token", "--warmup")
    r = prepare_retriever(args, ap)
    assert r.index is not None


def test_serve_selection_bucketed_accepted_for_bot(workdir):
    from vsearch_tpu_torch.cli.serve import prepare_retriever

    idx = build_bot(workdir, "bot_sel.npz")
    ap, args = serve_args(workdir, "--index_file", idx,
                          "--index_type", "bag_of_token",
                          "--selection", "bucketed")
    assert prepare_retriever(args, ap).index.selection == "bucketed"


def test_serve_selection_validation(workdir, capsys):
    """--selection on a dense or real-valued sparse index (whose search
    reads no selection policy) and --selection without --index_file fail
    fast instead of being silently dropped."""
    from vsearch_tpu_torch.cli.serve import prepare_retriever

    for kind, name in (("dense", "dense_serve.pt"),
                       ("sparse", "sparse_serve.npz")):
        idx = build_embedded(workdir, kind, name)
        for sel in ("bucketed", "approx", "exact"):
            ap, args = serve_args(workdir, "--index_file", idx,
                                  "--index_type", kind, "--selection", sel)
            with pytest.raises(SystemExit):
                prepare_retriever(args, ap)
            assert "bag-of-token indexes only" in capsys.readouterr().err
    ap, args = serve_args(workdir, "--selection", "exact")
    with pytest.raises(SystemExit):
        prepare_retriever(args, ap)


def test_serve_rerank_budget_knob(workdir, monkeypatch):
    from vsearch_tpu_torch.cli.serve import prepare_retriever
    from vsearch_tpu_torch.index import SparseIndex

    idx = build_embedded(workdir, "sparse", "sparse_budget.npz")
    argv = ["--index_file", idx, "--index_type", "sparse",
            "--rerank_budget", "65536"]
    # a 6-row index resolves to exact scoring, where the budget is never
    # read: rejected
    ap, args = serve_args(workdir, *argv)
    with pytest.raises(SystemExit):
        prepare_retriever(args, ap)
    # the bitproxy route reads it: accepted
    ap, args = serve_args(workdir, *argv, "--search_mode", "bitproxy")
    assert prepare_retriever(args, ap).index.rerank_budget == 65536
    monkeypatch.setattr(SparseIndex, "_use_bitproxy", lambda self: True)
    ap, args = serve_args(workdir, *argv)
    assert prepare_retriever(args, ap).index.rerank_budget == 65536
    ap, args = serve_args(workdir, "--rerank_budget", "1")
    with pytest.raises(SystemExit):
        prepare_retriever(args, ap)


def test_serve_rerank_budget_rejected_on_bitpack_bot(workdir, monkeypatch):
    from vsearch_tpu_torch.cli.serve import prepare_retriever
    from vsearch_tpu_torch.index import BoTIndex

    idx = build_bot(workdir, "bot_budget.bot.npz")
    monkeypatch.setattr(BoTIndex, "_use_bitpack", lambda self: True)
    ap, args = serve_args(workdir, "--index_file", idx,
                          "--rerank_budget", "65536")
    with pytest.raises(SystemExit):
        prepare_retriever(args, ap)


def test_read_queries_rejects_missing_field(tmp_path):
    from vsearch_tpu_torch.cli.common import read_queries

    p = tmp_path / "q.jsonl"
    p.write_text('{"_id": "q1", "query_text": "oops"}\n')
    with pytest.raises(ValueError, match="question/query/text"):
        read_queries(str(p))


def test_serve_search_mode_passthrough_and_validation(workdir):
    from vsearch_tpu_torch.cli.serve import prepare_retriever

    idx = build_bot(workdir, "bot_mode.npz")
    ap, args = serve_args(workdir, "--index_file", idx,
                          "--index_type", "bag_of_token",
                          "--search_mode", "stream")
    r = prepare_retriever(args, ap)
    assert r.index.search_mode == "stream"
    assert r.index._oversize_tier() == "stream"
    didx = build_embedded(workdir, "dense", "dense_mode.pt")
    ap, args = serve_args(workdir, "--index_file", didx, "--index_type",
                          "dense", "--search_mode", "block")
    with pytest.raises(ValueError, match="dense"):
        prepare_retriever(args, ap)
    ap, args = serve_args(workdir, "--search_mode", "stream")
    with pytest.raises(SystemExit):
        prepare_retriever(args, ap)


def test_serve_rerank_budget_message_names_oversize_tier(
        workdir, monkeypatch, capsys):
    from vsearch_tpu_torch.cli.serve import prepare_retriever
    from vsearch_tpu_torch.index import BoTIndex

    idx = build_bot(workdir, "bot_tiermsg.bot.npz")
    monkeypatch.setattr(BoTIndex, "_use_bitpack", lambda self: True)
    monkeypatch.setattr(BoTIndex, "_oversize_tier", lambda self: "block")
    ap, args = serve_args(workdir, "--index_file", idx,
                          "--rerank_budget", "65536")
    with pytest.raises(SystemExit):
        prepare_retriever(args, ap)
    err = capsys.readouterr().err
    assert "'block' tier" in err
    assert "the exact bit-packed scorer" not in err


def test_serve_mesh_not_ported(workdir, capsys):
    """--mesh_dp above the machine's card count (none here) exits with the
    mesh arithmetic."""
    from vsearch_tpu_torch.cli.serve import prepare_retriever

    ap, args = serve_args(workdir, "--mesh_dp", "2")
    with pytest.raises(SystemExit):
        prepare_retriever(args, ap)
    assert ("mesh dp=2 x tp=1 needs 2 devices but only 0 are available"
            in capsys.readouterr().err)


@pytest.fixture
def two_host_cards(monkeypatch):
    """``make_mesh``'s default devices are two host devices (the CPU
    stands in for a machine with two cards)."""
    import torch

    from vsearch_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "_default_devices",
                        lambda tp=1, device=None: (
                            [torch.device("cpu")] * 2, None, 0))


def test_serve_mesh_dp_shards_index_and_rerank(workdir, two_host_cards):
    """--mesh_dp 2 shards the index and the rerank's embeds over the
    machine's first two cards; the answers equal the unsharded ones."""
    from vsearch_tpu_torch.cli.serve import prepare_retriever

    idx = build_bot(workdir, "bot_mesh.bot.npz")
    argv = ["--index_file", idx, "--data_file",
            str(workdir / "corpus.jsonl"), "--index_type", "bag_of_token"]
    ap, args = serve_args(workdir, *argv, "--mesh_dp", "2", "--warmup")
    sharded = prepare_retriever(args, ap)
    assert sharded.index._mesh is not None
    assert sharded.encoder_p._mesh is not None
    ap, args = serve_args(workdir, *argv)
    single = prepare_retriever(args, ap)
    for rerank in (False, True):
        a = single.retrieve(QUERIES, k=3, rerank=rerank, batch_size=4)
        b = sharded.retrieve(QUERIES, k=3, rerank=rerank, batch_size=4)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_allclose(b.scores, a.scores, rtol=1e-6)


def test_serve_rerank_budget_refused_with_mesh_dp(workdir, two_host_cards,
                                                  capsys):
    from vsearch_tpu_torch.cli.serve import prepare_retriever

    idx = build_embedded(workdir, "sparse", "sparse_mesh_budget.npz")
    ap, args = serve_args(workdir, "--index_file", idx, "--index_type",
                          "sparse", "--search_mode", "bitproxy",
                          "--rerank_budget", "65536", "--mesh_dp", "2")
    with pytest.raises(SystemExit):
        prepare_retriever(args, ap)
    assert "no effect with --mesh_dp" in capsys.readouterr().err


def test_serve_main_exits_cleanly_on_sigterm():
    """SIGTERM ends ``cli.serve.main`` as Ctrl-C does: serve_forever
    returns, ``server_close()`` ends the dispatcher thread, exit code 0."""
    import os
    import subprocess
    import sys

    code = (
        "import os, signal, threading\n"
        "from vsearch_tpu_torch import serve as srv\n"
        "from vsearch_tpu_torch.cli import serve as cli\n"
        "made = []\n"
        "orig = srv.serve\n"
        "def serve(retriever, **kw):\n"
        "    s = orig(None, host='127.0.0.1', port=0)\n"
        "    made.append(s)\n"
        "    threading.Timer(0.5, os.kill,\n"
        "                    (os.getpid(), signal.SIGTERM)).start()\n"
        "    return s\n"
        "srv.serve = serve\n"
        "cli.prepare_retriever = lambda args, ap: None\n"
        "cli.main(['--checkpoint', 'unused'])\n"
        "t = made[0].service._coalescer._thread\n"
        "t.join(5)\n"
        "print('dispatcher alive:', t.is_alive())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("dispatcher alive: False")


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind,name", [
    ("bag_of_token", "x.npz"), ("bag_of_token", "x.ell.npz"),
    ("sparse", "x.npz"), ("dense", "x.pt")])
def test_cli_index_files_cross_packages(workdir, tmp_path, writer, kind,
                                        name):
    """An index file written by one package's CLI loads in the other's
    ``load_index`` and answers as the writer's own package does on it."""
    import importlib

    from vsearch_tpu.retriever import Retriever as JRetriever

    pkg = "vsearch_tpu" if writer == "jax" else "vsearch_tpu_torch"
    path = str(tmp_path / name)
    tail = CPU if writer == "torch" else []
    if kind == "bag_of_token":
        importlib.import_module(
            f"{pkg}.cli.build_index.binary_token_index").main(
            ["--text_file", str(workdir / "corpus.jsonl"),
             "--save_file", path, "--num_shift", "5",
             "--tokenizer", str(workdir / "ckpt"), "--num_workers", "1",
             *tail])
    else:
        importlib.import_module(
            f"{pkg}.cli.build_index.{kind}_index").main(
            ["--checkpoint", str(workdir / "ckpt"),
             "--text_file", str(workdir / "corpus.jsonl"),
             "--save_file", path, "--batch_size", "4", *tail])
    j = JRetriever.from_pretrained(str(workdir / "ckpt"))
    t = ckpt(workdir)
    for r in (j, t):
        r.load_index(index_file=path, index_type=kind)
    a, b = j.retrieve(QUERIES, k=3), t.retrieve(QUERIES, k=3)
    np.testing.assert_array_equal(b.ids, a.ids)
    tol = 2e-2 if kind == "dense" else 1e-4  # dense: bf16 vectors
    np.testing.assert_allclose(b.scores, np.asarray(a.scores), rtol=tol,
                               atol=tol)
