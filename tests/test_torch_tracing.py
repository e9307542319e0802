"""The port's tracer (``vsearch_tpu_torch/utils/profiling.py`` ``Tracer``)
in the serving path, on the CPU: the call record of a retrieve and of a
beta rerank, the coalescer's queue wait, the spans in an all-thread
profiler trace on the dispatcher's thread, no ``record_function`` while
no profiler records, and ``/stats``'s totals."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from tests.helpers import make_tokenizer, tiny_bert_config
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.serve import RetrieverService, SearchCoalescer
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer
from vsearch_tpu_torch.utils.profiling import TRACER, Tracer, trace

CORPUS = ["green tea is a drink", "the red planet mars",
          "einstein theory of relativity", "a dog runs in the city",
          "the river water runs slow", "physics of space and light"]
QUERIES = ["green tea", "mars water", "dog in the city"]
STAGES = ("query_embed", "first_stage", "rerank")


@pytest.fixture(scope="module")
def retriever():
    tok = WordPieceTokenizer(dict(make_tokenizer().vocab))
    enc = {"type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
           **{k: v for k, v in vars(tiny_bert_config(tok.vocab_size)).items()
              if k in ("vocab_size", "hidden_size", "num_hidden_layers",
                       "num_attention_heads", "intermediate_size",
                       "max_position_embeddings")}}
    r = Retriever(RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                                  shared_encoder=True),
                  tokenizer=tok, device="cpu")
    r.build_index(CORPUS, batch_size=4, index_type="bag_of_token")
    # the bit-packed first stage (plain versions on the CPU), as on the card
    r.index.search_mode = "bitpack"
    return r


def _check_nesting(rec):
    """Each span at most its parent; a parent's children sum to at most
    it (1 ns of float rounding)."""
    for key, t in rec.items():
        assert t >= 0.0, key
        if "/" in key and not key.startswith("serve/"):
            parent = key.rsplit("/", 1)[0]
            assert parent in rec, key
            assert t <= rec[parent] + 1e-9, (key, t, rec[parent])
    for parent in rec:
        kids = [t for key, t in rec.items()
                if key.rsplit("/", 1)[0] == parent and "/" in key]
        assert sum(kids) <= rec[parent] + 1e-9, parent


def test_retrieve_record_nests(retriever):
    retriever.retrieve(QUERIES, k=3, batch_size=2)
    rec = dict(retriever.last_timings)
    assert {"query_embed", "first_stage"} <= set(rec)
    assert "rerank" not in rec
    assert {"query_embed/tokenize", "query_embed/forward",
            "query_embed/forward/upload", "query_embed/to_host",
            "first_stage/query", "first_stage/budget",
            "first_stage/launch", "first_stage/to_host"} <= set(rec)
    _check_nesting(rec)


def test_beta_rerank_record_nests(retriever):
    retriever.retrieve(QUERIES, k=4, rerank=True, batch_size=2)
    rec = dict(retriever.last_timings)
    assert set(STAGES) <= set(rec)
    assert {"rerank/fetch", "rerank/tokenize", "rerank/forward",
            "rerank/forward/upload", "rerank/rescore",
            "rerank/rescore/upload", "rerank/to_host"} <= set(rec)
    # the encoder's spans land under the stage that called it
    assert {"query_embed/tokenize", "rerank/tokenize"} <= set(rec)
    assert "tokenize" not in rec
    _check_nesting(rec)


def test_repeated_children_are_summed():
    tr = Tracer()
    with tr.call("retrieve"):
        with tr.span("rerank"):
            for _ in range(3):
                with tr.span("tokenize"):
                    time.sleep(0.002)
        rec = tr.record()
    assert rec["rerank/tokenize"] >= 0.006
    assert tr.totals["rerank/tokenize"][0] == 3
    assert tr.totals["retrieve"][0] == 1
    assert tr.record() == {}  # no call open any more


def test_a_call_inside_a_call_opens_no_record():
    tr = Tracer()
    with tr.call("serve/call") as outer:
        with tr.call("retrieve") as inner:
            with tr.span("first_stage"):
                pass
        assert inner is None
        assert set(tr.record()) == {"first_stage"}
    assert outer.rec == {"first_stage": outer.rec["first_stage"]}
    assert "retrieve" not in tr.totals


def _echo_search(delay, seen):
    def search(queries, k, rerank, n_real=None):
        seen.append((list(queries[:n_real]), dict(TRACER.record())))
        time.sleep(delay)
        ids = np.zeros((len(queries), k), dtype=np.int64)
        return ids, ids.astype(np.float32)
    return search


def test_queue_wait_of_a_lone_request_is_short():
    seen = []
    co = SearchCoalescer(_echo_search(0.0, seen))
    try:
        co.submit(["alone"], k=2, rerank=False)
    finally:
        co.close()
    (queries, rec), = seen
    assert queries == ["alone"]
    assert 0.0 <= rec["serve/queue_wait"] < 0.005


def test_queue_wait_behind_a_busy_call():
    """A request queued behind a 50 ms call waits it out; a chunk of three
    queries counts its wait three times."""
    seen = []
    co = SearchCoalescer(_echo_search(0.05, seen))
    first = threading.Thread(target=co.submit, args=(["first"], 2, False))
    try:
        first.start()
        while not seen:  # the first call has started
            time.sleep(0.001)
        co.submit(["a", "b", "c"], k=2, rerank=False)
        first.join()
    finally:
        co.close()
    (q1, _), (q2, rec) = seen
    assert q1 == ["first"] and q2 == ["a", "b", "c"]
    assert rec["serve/queue_wait"] >= 3 * 0.04


def test_stats_carry_the_span_totals(retriever):
    service = RetrieverService(retriever, default_k=2)
    try:
        before = TRACER.summary().get("serve/call", {"count": 0})["count"]
        service.search(["green tea"], rerank=True)
        stats = service.stats()
    finally:
        service.close()
    spans = stats["spans"]
    assert spans["serve/call"]["count"] == before + 1
    for path in ("serve/queue_wait", "serve/select", "query_embed",
                 "first_stage", "rerank", "rerank/tokenize"):
        assert spans[path]["count"] >= 1 and spans[path]["total_s"] >= 0.0
    json.dumps(stats)


def test_no_record_function_without_a_profiler(retriever, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    retriever.retrieve(QUERIES, k=3, rerank=True)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        retriever.retrieve(QUERIES, k=3, rerank=True)
    assert "query_embed#" in " ".join(entered)


def test_spans_lie_in_the_dispatchers_range_of_an_all_thread_trace(
        retriever, tmp_path):
    """``trace`` records every thread: a search through the coalescer
    inside it leaves the call's spans on the dispatcher's thread, nested
    in its ``serve/call`` range and tagged with its id."""
    service = RetrieverService(retriever, default_k=3)
    try:
        tid = service._coalescer._thread.native_id
        with trace(str(tmp_path), device="cpu"):
            service.search(["green tea", "mars water"], rerank=True)
    finally:
        service.close()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    calls = [e for e in ann if e["name"].startswith("serve/call#")]
    assert len(calls) == 1 and calls[0]["tid"] == tid
    call = calls[0]
    call_id, *labels = call["name"][len("serve/call#"):].split()
    assert labels == ["n_real=2", "batch=2"]
    end = call["ts"] + call["dur"]
    mine = [e for e in ann if e["name"].endswith(f"#{call_id}")
            and e is not call]
    names = {e["name"].split("#")[0] for e in mine}
    assert set(STAGES) | {"query_embed/tokenize", "rerank/fetch",
                          "rerank/to_host", "first_stage/to_host"} <= names
    for e in mine:
        assert e["tid"] == tid
        assert call["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end + 1
