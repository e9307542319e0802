"""The port's bench (``vsearch_tpu_torch/bench.py``) against ``bench.py``:
its data and FLOP count equal ``bench.py``'s functions, its resident
section returns the JAX package's ``BoTIndex.search`` on the same
passages and queries (its Pallas kernels in interpret mode), its recall
helpers equal numpy transcriptions of ``bench.py``'s, the train, scale,
alpha, over-card and embed sections run at tiny widths on the CPU, and
``main`` prints one JSON line with ``bench.py``'s keys; on the card, the
resident section equals the CPU's (``cuda``, skipped here)."""
import ast
import json
import os

import numpy as np
import pytest
import torch

import bench
from vsearch_tpu_torch import bench as tbench
from vsearch_tpu_torch.examples import synthetic_vocab
from vsearch_tpu_torch.index import BoTIndex
from vsearch_tpu_torch.models.bert import BertConfig
from vsearch_tpu_torch.ops.ell import ELLMatrix
from vsearch_tpu_torch.scripts import common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
V = 30522 - 999
# both packages sum the same bf16 query weights over the same 0/1 rows in
# f32, in another order: scores agree to a few f32 ulps of their size
SCORE_RTOL = 1e-6
TINY_BERT = BertConfig(vocab_size=2048, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=128)


@pytest.mark.parametrize("n,seed", [(64, 0), (300, 5)])
def test_corpus_and_vocab_equal_bench(n, seed):
    assert synthetic_vocab.make_corpus(n, seed=seed) == \
        bench.make_corpus(n, seed=seed)
    assert list(synthetic_vocab.build_wordpiece_vocab().items()) == \
        list(bench.build_wordpiece_vocab().items())


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("b,h,layers", [(32, 768, 12), (64, 768, 12),
                                        (3, 64, 2)])
def test_train_flops_equal_bench(b, h, layers, remat):
    args = (b, 32, 2 * b, 256, h, layers, 4 * h, 30522 - 999, remat)
    assert tbench._analytic_train_flops(*args) == \
        bench._analytic_train_flops(*args)


def passages_ell(n: int):
    """Both packages' bag-of-token build over ``bench.py``'s first ``n``
    passages: (texts, cols, nnz), the two builds asserted equal."""
    from vsearch_tpu.index.bot_build import build_bot_ell as jbuild
    from vsearch_tpu.tokenization.native import NativeWordPieceTokenizer

    texts = bench.make_corpus(n)
    jtok = NativeWordPieceTokenizer(bench.build_wordpiece_vocab())
    _, jc, jz = jbuild(jtok, texts, max_len=128, shift=999,
                       return_host=True, device=False)
    tok, kind = tbench.get_bench_tokenizer()
    assert kind == "native-c++"
    _, cols, nnz = tbench.build_section(tok, texts, 32, chunks=4, passes=1)
    np.testing.assert_array_equal(cols, jc)
    np.testing.assert_array_equal(nnz, jz)
    return texts, cols, nnz


@pytest.mark.parametrize("selection", ["exact", "bucketed"])
def test_resident_section_equals_jax_search(selection):
    """2,048 passages through the resident section (kernel #1 and #2, or
    #3 with ``selection="bucketed"``, as their plain versions) and through
    the JAX package's ``BoTIndex.search`` (its kernels in interpret
    mode): the same ids but for ties, scores within ``SCORE_RTOL``, and
    the same recall by ``bench.py``'s own count."""
    import jax.numpy as jnp

    from vsearch_tpu.index import BoTIndex as JBoTIndex
    from vsearch_tpu.ops.ell import ELLMatrix as JELL

    _, cols, nnz = passages_ell(2048)
    q = common.make_queries(256, V, 1, CPU)
    index = BoTIndex(search_mode="bitpack", selection=selection, device=CPU)
    index.set_ell(ELLMatrix.from_arrays(cols, nnz, None, V, True,
                                        device=CPU), host_cache=(cols, nnz))
    got = tbench.resident_section(index, q, 128, 100, cols)
    assert got["search_mode"] == "bitpack"
    assert got["selection"] == selection
    assert got["search_qps"] > 0 and got["pack_steady_s"] > 0
    jidx = JBoTIndex(search_mode="bitpack")
    jidx.selection = selection
    jidx.set_ell(JELL(cols=jnp.asarray(cols), nnz=jnp.asarray(nnz),
                      vals=None, num_cols=V, sentinel_padded=True),
                 host_cache=(cols, nnz))
    q8 = q[:8].numpy()
    want = jidx.search(q8, k=100)
    assert_same_topk(got["ids"], got["scores"], want.ids, want.scores)
    assert got["search_recall_vs_exact"] == \
        bench_host_recall(q8, want.ids, cols, 100)


def assert_same_topk(ids, scores, want_ids, want_scores):
    """Scores within ``SCORE_RTOL``; ids equal but where a score ties
    with another of the same query's."""
    np.testing.assert_allclose(scores, want_scores, rtol=SCORE_RTOL)
    scale = float(np.abs(want_scores).max())
    for i, j in zip(*np.nonzero(ids != want_ids)):
        assert np.sum(np.abs(want_scores[i] - want_scores[i, j])
                      <= SCORE_RTOL * scale) > 1, (i, j)


def bench_host_recall(q, got_ids, cols_np, topk):
    """``bench.py``:423-435 as written there."""
    nr = len(q)
    qpad = np.concatenate([q[:nr], np.zeros((nr, 1), np.float32)], axis=1)
    recalls = []
    for i in range(nr):
        exact_scores = qpad[i][cols_np].sum(axis=1)
        kth = np.partition(-exact_scores, topk - 1)
        kth_score = -kth[topk - 1]
        tol = 1e-2 * max(abs(kth_score), 1.0)
        ok = exact_scores[got_ids[i]] >= kth_score - tol
        recalls.append(float(np.mean(ok)))
    return float(np.mean(recalls))


def bench_device_recall(sc, ids, topk, tol):
    """``bench.py``:543-548 (and :610-615) in numpy; ``tol`` 1e-3 there,
    1e-2 in the over-card section (:667)."""
    kth = -np.sort(-sc, axis=1)[:, topk - 1]
    got = np.take_along_axis(sc, ids, axis=1)
    tol = tol * np.maximum(kth, 1.0)
    return float(np.mean(got >= (kth - tol)[:, None]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_recall_equals_bench(seed):
    """Rows of 1-12 ids of 40 (sentinel-padded), queries of whole
    numbers (ties at the k-th), returned ids partly off the top."""
    rng = np.random.default_rng(seed)
    v, n, k = 40, 500, 20
    nnz = rng.integers(1, 13, n)
    cols = np.full((n, 16), v, np.int32)
    for r in range(n):
        cols[r, :nnz[r]] = rng.choice(v, nnz[r], replace=False)
    q = rng.integers(0, 4, (5, v)).astype(np.float32)
    ids = rng.integers(0, n, (5, k))
    want = bench_host_recall(q, ids, cols, k)
    assert 0.0 < want < 1.0
    assert tbench.host_recall(q, ids, cols, k) == want


@pytest.mark.parametrize("tol", [1e-3, 1e-2])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_recall_equals_bench(seed, tol):
    rng = np.random.default_rng(seed)
    sc = (rng.integers(0, 400, (8, 3000)) / 100).astype(np.float32)
    sc[:, :50] += 40.0  # some rows of each query score above the k-th
    ids = np.concatenate([np.tile(np.arange(50), (8, 1)),
                          rng.integers(0, 3000, (8, 50))], axis=1)
    want = bench_device_recall(sc, ids, 100, tol)
    assert 0.0 < want < 1.0
    assert common.recall_at(torch.from_numpy(ids), torch.from_numpy(sc),
                            100, tol) == pytest.approx(want, abs=1e-7)


def test_train_section_takes_finite_steps():
    out = tbench.train_section(CPU, 2, 0, bert=TINY_BERT,
                               shapes=((4, False), (4, True)), l_q=8,
                               l_p=16)
    assert set(out) == {f"train_{key}_b4" for key in (
        "hbm_gb", "steps_per_s", "tflops", "last_loss")}
    assert out["train_hbm_gb_b4"] is None  # no card
    assert np.isfinite(out["train_last_loss_b4"])
    assert out["train_steps_per_s_b4"] > 0 and out["train_tflops_b4"] > 0


def test_scale_alpha_and_embed_sections_run_on_the_cpu():
    """The card's sections at a tiny size with the plain versions: 4,096
    rows (k * bucket 8 below them, so #3 selects), recall against exact
    scores far above chance (100 of 4,096 rows; the alpha proxy's 512
    buckets cap its candidates at 512 here, not C), and an embed rate."""
    q = common.make_queries(256, V, 1, CPU)
    chunks = tbench.query_chunks(q, 128)
    assert len(chunks) == 2
    scale = tbench.scale_section(chunks, V, 4096, 100, CPU, 2)
    alpha = tbench.alpha_section(chunks, V, 4096, 100, CPU, 3)
    assert scale["scale_search_qps"] > 0 and alpha["alpha_scale_qps"] > 0
    assert scale["scale_search_recall"] >= 0.9
    assert alpha["alpha_scale_recall"] >= 0.8
    assert alpha["alpha_rerank_candidates"] == tbench.ALPHA_C
    assert tbench.embed_section(CPU, 0, bert=TINY_BERT, b=4, l=16,
                                iters=2) > 0


def test_oversize_section_block_tier_on_the_cpu(monkeypatch):
    """5,000 stratified rows through the block tier on the CPU, in blocks
    of 1,024 rows: tier 'block', recall 1.0 against the exact gather."""
    monkeypatch.setattr(BoTIndex, "stream_block_rows", 1024)
    q = common.make_queries(64, V, 1, CPU)
    out = tbench.oversize_section(q, V, 5000, 100, CPU, 7,
                                  search_mode="block")
    assert out["oversize_tier"] == "block"
    assert out["oversize_recall_vs_exact"] == 1.0
    assert out["oversize_qps"] > 0


def bench_keys():
    """The keys of ``bench.py``'s JSON line: its ``out`` literal and its
    train section's."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "out"):
            keys |= {k.value for k in node.value.keys if k is not None}
    assert "metric" in keys
    return keys | {f"train_{key}_b{b}" for b in (32, 64)
                   for key in ("hbm_gb", "steps_per_s", "tflops")}


def test_main_prints_one_json_line_with_bench_keys(capsys):
    out = tbench.main(["--device", "cpu", "--num-passages", "2048",
                       "--num-queries", "256", "--skip-embed-bench"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == out
    assert list(line)[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert bench_keys() - {"compile_cache"} <= set(line)
    assert "compile_cache" not in line
    for key, x in line.items():
        assert x is None or isinstance(x, str) or np.isfinite(x), key
    assert line["device"] == "cpu" and line["search_mode"] == "exact"
    assert line["index_rows"] == 2048 and line["search_recall_vs_exact"] > 0.9
    # the card's sections skipped off the card
    assert line["oversize_tier"] is None and line["scale_search_qps"] == 0.0
    assert line["train_steps_per_s_b32"] is None


# -- the card -----------------------------------------------------------------
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_resident_section_card_equals_cpu(dev):
    """The resident section over 8,192 passages: kernels #1 and #2 on the
    card against their plain versions on the CPU, the same queries."""
    from vsearch_tpu_torch.ops import bitpack as tb

    tok, _ = tbench.get_bench_tokenizer()
    _, cols, nnz = tbench.build_section(tok, bench.make_corpus(8192), 32,
                                        chunks=1, passes=1)
    q = common.make_queries(256, V, 1, dev)
    got = {}
    for d, mode in ((dev, "auto"), (CPU, "bitpack")):
        index = BoTIndex(search_mode=mode, device=d)
        index.set_ell(ELLMatrix.from_arrays(cols, nnz, None, V, True,
                                            device=d))
        before = tb.LAUNCHES["scores"]
        got[d.type] = tbench.resident_section(index, q.to(d), 128, 100,
                                              cols)
        assert (tb.LAUNCHES["scores"] > before) == (d.type == "cuda")
    assert got["cuda"]["search_mode"] == "bitpack"
    assert_same_topk(got["cuda"]["ids"], got["cuda"]["scores"],
                     got["cpu"]["ids"], got["cpu"]["scores"])
