"""The open loop sends on its schedule whatever the server's backlog, and
times each request from when it was due, not from when it was sent."""
import threading
import time

import numpy as np

from benchmark import corpus as corpus_mod
from benchmark.generators import open_loop_search as gen


class SlowService:
    """One request at a time, ``delay`` seconds each."""

    def __init__(self, recorder, default_k=10, delay=0.05):
        self.delay = delay
        self._lock = threading.Lock()
        self.search_timer = type("T", (), {"total_steps": 0,
                                           "total_items": 0})()

    def search(self, queries, k=None, rerank=False):
        with self._lock:
            time.sleep(self.delay)
            self.search_timer.total_steps += 1
            self.search_timer.total_items += len(queries)
        return {"ids": [[1, 2]], "scores": [[2.0, 1.0]]}

    def close(self):
        pass


def test_latency_counts_the_wait_from_the_due_time():
    due = np.arange(-0.05, 0.5, 0.01)  # 100/s against 20/s served
    queries = corpus_mod.Queries(texts=["q"] * len(due),
                                 words=[np.zeros(1)] * len(due), due=due)
    traffic = {"k": 2, "rerank": False, "clients": 64, "lead_seconds": 0.05}
    sys_ = {"service_cls": SlowService, "recorder": None}
    res = gen.serve_window(sys_, traffic, queries, 0.5)
    m = gen.window_metrics(res)
    loop = res["loop"]
    w = res["in_window"]
    assert len(w) == 50 and not loop.errors
    # sends kept to the schedule though the server fell behind
    assert m["late_max_s"] < 0.05
    # the last request due waited for every one before it
    lat = loop.t_done[w] - (res["counters"]["open"][0] + due[w])
    assert lat[-1] > 0.05 * 50 - 0.5 - 0.05
    assert np.all(np.diff(lat) > 0)
    assert m["latency_p95_ms"] > 1000 and m["qps"] < 25
    assert m["backlog_ratio"] > 2


def test_a_traced_runs_per_layer_latency_leaves_out_the_profiled_stretch():
    due = np.linspace(0.0, 9.9, 100)
    lat = np.where(due < 6.0, 0.1, 2.0)  # the profiler's stop stalls the rest
    m = {"latency_s": lat}
    traffic = {"trace_start": 0.6, "trace_seconds": 2}
    traced = gen.per_layer_latency(m, due, 10.0, traffic, traced=True)
    assert traced == {"p50": 100.0, "p95": 100.0}
    whole = gen.per_layer_latency(m, due, 10.0, traffic, traced=False)
    assert whole["p50"] == 100.0 and whole["p95"] == 2000.0
