"""The readers of the program's spans read what their docstrings say from
a synthetic window, and nothing from a program without the spans."""
import pytest

from benchmark import harness


def _call(real, **timings):
    base = {"query_embed": 0.02, "first_stage": 0.03}
    return {"real": real, "timings": {**base, **timings}}


LAYERS = {"kind": "serve", "calls": [
    _call(2, **{"serve/queue_wait": 0.010, "query_embed/tokenize": 0.001,
                "query_embed/to_host": 0.004, "first_stage/to_host": 0.020,
                "rerank/fetch": 0.003, "rerank/tokenize": 0.030,
                "rerank/to_host": 0.0005}),
    _call(6, **{"serve/queue_wait": 0.090, "query_embed/tokenize": 0.003,
                "query_embed/to_host": 0.006, "first_stage/to_host": 0.010,
                "rerank/fetch": 0.005, "rerank/tokenize": 0.050,
                "rerank/to_host": 0.0015}),
]}

# the means of a call, in ms; the queue wait a real query: (10 + 90) / 8
EXPECTED = {
    "queue_wait_ms": 12.5,
    "query_tokenize_ms": 2.0,
    "query_to_host_ms": 5.0,
    "first_stage_to_host_ms": 15.0,
    "rerank_fetch_ms": 4.0,
    "rerank_tokenize_ms": 40.0,
    "rerank_to_host_ms": 1.0,
}
ALIASES = ("queue_wait_ms", "query_tokenize_ms", "query_to_host_ms",
           "first_stage_to_host_ms")


@pytest.mark.parametrize("name", sorted(EXPECTED) + [
    f"{n}.rerank" for n in ALIASES])
def test_reader_reads_its_span(name):
    read = harness.load_reader(name)
    assert read(LAYERS) == pytest.approx(EXPECTED[name.split(".")[0]])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_the_span(name):
    """The parent's call records hold the three stages alone; a window of
    no calls, or a run that serves nothing, reads None too."""
    read = harness.load_reader(name)
    assert read({"kind": "serve", "calls": [_call(3), _call(1)]}) is None
    assert read({"kind": "serve", "calls": []}) is None
    assert read({"kind": "train"}) is None


def test_queue_wait_weights_each_real_query():
    """A call of 6 real queries counts six times a call of one: the mean
    of the calls' per-query waits would read (0.005 + 0.015) / 2 = 10 ms."""
    read = harness.load_reader("queue_wait_ms")
    layers = {"kind": "serve", "calls": [
        _call(1, **{"serve/queue_wait": 0.005}),
        _call(6, **{"serve/queue_wait": 0.090})]}
    assert read(layers) == pytest.approx(1e3 * 0.095 / 7)


def test_every_span_metric_is_in_the_benchmark():
    names = {m["name"] for m in harness.load_benchmark()["per_layer"]}
    assert set(EXPECTED) | {f"{n}.rerank" for n in ALIASES} <= names
