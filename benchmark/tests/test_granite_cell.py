"""The granite-4.0-h cell (``beir-nq-granite-rerank``): found by name, run
end to end at a tiny size on the CPU (``tiny_granite.py``) and through the
sweep's calls, its new per-layer readers reading the run, the reference
loading nothing of the port, and a corrupted rerank coming out not
correct."""
import json

import numpy as np
import pytest

from benchmark import corpus_granite, harness
from benchmark.tests.test_imports import FORBIDDEN, _top_modules
from benchmark.tests.tiny import run_tiny
from benchmark.tests.tiny_granite import CELL, tiny_granite_cell

NEW = ("ssd_chunk_roofline", "mfu.granite", "rerank_pad_share")


def test_the_cell_resolves_by_name():
    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, CELL)
    assert cell.config_name == "granite-h-micro-beir-nq" and cell.chips == 1
    assert cell.config["reduced"] == []
    assert cell.traffic["generator"] == "open_loop_search_granite"
    assert {m["name"] for m in cell.end_to_end} == {"qps", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= names and "mfu.rerank" not in names
    for m in cell.per_layer:
        assert callable(harness.load_reader(m["name"]))
    # granite-4.0-h-micro's published widths, all 40 layers
    cfg = cell.config
    assert (cfg["hidden_size"], cfg["vocab_size"], cfg["mamba_n_heads"],
            cfg["mamba_d_head"], cfg["mamba_d_state"],
            cfg["shared_intermediate_size"]) == (2048, 100352, 64, 64, 128,
                                                 8192)
    assert len(cfg["layer_types"]) == cfg["num_hidden_layers"] == 40
    assert [i for i, k in enumerate(cfg["layer_types"])
            if k == "attention"] == [5, 15, 25, 35]


def test_the_sweep_runs_the_generator():
    """``benchmark.sweep``'s calls: the generator's ``prepare``, then a
    window through ``serve_window`` and ``window_metrics``, over the
    sweep's own queries (``corpus.make_queries``, BERT's vocabulary),
    which the window swaps for this cell's words at the same due times."""
    import time

    from benchmark import corpus, vocab_granite

    cell = tiny_granite_cell()
    gen = harness.load_generator(cell.traffic["generator"])
    spec = harness.RunSpec(cell=cell, seed=5, seconds=1.0, trace=False,
                           device="cpu", process_start=time.time(),
                           log=lambda m: None)
    sys_ = gen.prepare(spec)
    queries = corpus.make_queries(cell.traffic, 6, 1.0)
    res = gen.serve_window(sys_, cell.traffic, queries, 1.0)
    m = gen.window_metrics(res)
    assert m["requests"] > 0 and not m["failed_mask"].any()
    assert sys_["recorder"].calls
    np.testing.assert_array_equal(res["due"], queries.due)
    words = set(vocab_granite.word_list())
    served = res["loop"].texts
    assert served != queries.texts
    assert all(set(t.split()) <= words for t in served)
    # the schedule's lengths, in the window's own order
    assert (sorted(len(t.split()) for t in served)
            == sorted(len(t.split()) for t in queries.texts))
    # a window at another schedule is refused, not served
    other = dict(cell.traffic, rate_qps=2 * cell.traffic["rate_qps"])
    with pytest.raises(ValueError, match="schedule"):
        gen.serve_window(sys_, cell.traffic,
                         corpus.make_queries(other, 6, 1.0), 1.0)


def test_a_tiny_traced_run_is_correct_and_reads_its_metrics():
    cell = tiny_granite_cell()
    out = run_tiny(cell, seconds=2.0, trace=True)
    assert out.correct, out.checks
    got = harness.per_layer_values(cell, out.layers)
    # every listed reader finds its layer in the run, but the kernels'
    # shares: no kernel runs on the CPU
    listed = {m["name"] for m in cell.per_layer}
    assert listed - set(got) == {"ssd_chunk_roofline",
                                 "k3_bucketed_roofline.rerank"}
    assert got["mfu.granite"]["value"] > 0
    assert 0 < got["rerank_pad_share"]["value"] < 100
    counts = [c["counts"] for c in out.layers["calls"]]
    assert all(c.get("rerank/forward/tokens", 0) > 0 for c in counts)
    json.dumps(got)


def test_a_corrupted_rerank_is_not_correct(monkeypatch):
    from vsearch_tpu_torch.index import SearchResults
    from vsearch_tpu_torch.retriever import Retriever

    rerank = Retriever._beta_rerank

    def altered(self, *a, **kw):
        res = rerank(self, *a, **kw)
        return SearchResults(res.ids, np.asarray(res.scores) * 1.01)

    monkeypatch.setattr(Retriever, "_beta_rerank", altered)
    out = run_tiny(tiny_granite_cell(), seconds=1.0)
    assert not out.correct
    over = {c["name"] for c in out.checks if c["value"] > c["limit"]}
    assert "rerank_err.p10" in over


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_modules("import benchmark.reference.granite_vdr\n"
                        "import benchmark.checks_granite\n"
                        "import benchmark.corpus_granite\n"
                        "import benchmark.weights_granite\n"
                        "import benchmark.flops_granite\n")
    assert not mods & (FORBIDDEN | {"vsearch_tpu_torch"})


@pytest.mark.parametrize("tokens", [1, 9, 100, 256])
def test_the_kernel_bound_counts_what_the_inputs_need(tokens):
    from benchmark import flops_granite

    cfg = harness.find_cell(harness.load_benchmark(), CELL).config
    pair_ops, other_ops, nbytes = flops_granite.ssd_chunk_work(tokens, cfg)
    pairs = tokens * (tokens + 1) // 2
    assert pair_ops == pairs * (256 + 8192)
    assert other_ops == tokens * 8 * 4352 + tokens * 2 * 4096
    assert nbytes == tokens * 2 * (4352 + 64 + 4096)
    s = flops_granite.ssd_chunk_s([tokens, tokens], cfg)
    assert s == pytest.approx(36 * 2 * max(
        nbytes / 3.35e12, pair_ops / 989e12, other_ops / 67e12))
