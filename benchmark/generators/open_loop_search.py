"""Served SVDR search under an open loop: independent users send one query
a request on a fixed schedule to ``RetrieverService.search`` (the port's
serving layer, its ``SearchCoalescer`` merging what queued behind each
device call into the next), whatever the system's backlog.

A run: the port's kernels, the tokenizer, the weights and the corpus are
made (set-up), the index is put on the card, every power-of-two batch of
the coalescer is searched once, then the schedule starts ``lead_seconds``
before the window so the window opens on a loaded system. Each request is
timed from when it was due to its answer. After the window, the memory
peak is read, the port is freed, and a sample of the window's answers is
held to the plain reference (``checks.py``).
"""
from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .. import corpus as corpus_mod
from .. import vocab as vocab_mod
from .. import weights as weights_mod
from ..trace import CALL_PREFIX, Profiler, stretch_bounds

WAIT_PAST_CLOSE_S = 60.0  # how long an answer due in the window is awaited


def encoder_dict(model: Dict, max_len: int) -> Dict:
    """The port's VDR encoder config of ``model`` (``configs/*.json``)."""
    bert = model["bert"]
    return {"type": "vdr", "model_id": model["model_id"], "max_len": max_len,
            "norm": False, "shift_vocab_num": model["shift_vocab_num"],
            "topk": model["topk"], "pooling": "max", "pooling_topk": 0,
            "vocab_size": bert["vocab_size"],
            "hidden_size": bert["hidden_size"],
            "num_hidden_layers": bert["num_hidden_layers"],
            "num_attention_heads": bert["num_attention_heads"],
            "intermediate_size": bert["intermediate_size"],
            "max_position_embeddings": bert["max_position_embeddings"],
            "type_vocab_size": bert["type_vocab_size"],
            "layer_norm_eps": bert["layer_norm_eps"],
            "dtype": model["dtype"]}


def make_tokenizer(vocab):
    """The port's C++ WordPiece tokenizer over the vocabulary, else its
    Python one."""
    try:
        from vsearch_tpu_torch.tokenization.native import \
            NativeWordPieceTokenizer
        return NativeWordPieceTokenizer(vocab), "native"
    except (OSError, RuntimeError, ImportError) as exc:
        from vsearch_tpu_torch.tokenization.wordpiece import \
            WordPieceTokenizer
        return WordPieceTokenizer(vocab), f"python ({exc})"


class RecordingRetriever:
    """The port's ``Retriever`` as the service sees it, with each device
    call recorded: its span (``last_timings``, read after the call), its
    batch, and a profiler range ``bench.call#<n>`` around it. ``settle``
    adds each call's real queries, which the service counts."""

    def __init__(self, retriever, lengths: Optional[np.ndarray],
                 p_max_len: int):
        self._r = retriever
        self._lengths = lengths
        self._p_max = p_max_len
        self.calls: List[Dict] = []
        self.timer = None  # the serving service's ``search_timer``

    def __getattr__(self, name):
        return getattr(self._r, name)

    def retrieve(self, queries, k: int = 5, rerank: bool = False, **kw):
        import torch

        seq = len(self.calls)
        items = self.timer.total_items
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"{CALL_PREFIX}{seq}"):
            res = self._r.retrieve(queries, k=k, rerank=rerank, **kw)
        t1 = time.perf_counter()
        rec = {"seq": seq, "t0": t0, "t1": t1, "batch": len(queries),
               "items_before": items, "queries": queries,
               "timings": dict(self._r.last_timings)}
        if rerank and self._lengths is not None:
            rec["ids"] = np.asarray(res.ids)
        self.calls.append(rec)
        return res

    def settle(self, first: int) -> None:
        """Each call from ``first`` on gets its real queries (the rest of
        its batch is the coalescer's padding), their token counts and,
        with the rerank, its distinct candidates' token counts. The
        service's timer adds a call's real queries once it returns, so
        they are what it counted before the next call began."""
        calls = self.calls[first:]
        ends = [c["items_before"] for c in calls[1:]]
        for c, end in zip(calls, ends + [self.timer.total_items]):
            real = end - c.pop("items_before")
            queries = c.pop("queries")[:real]
            c["real"] = real
            c["q_tokens"] = [len(q.split()) + 2 for q in queries]
            ids = c.pop("ids", None)
            if ids is not None:
                uniq = np.unique(ids[:real])
                c["p_tokens"] = np.minimum(self._lengths[uniq] + 2,
                                           self._p_max).tolist()


class OpenLoop:
    """Clients that each take the next due request, call
    ``service.search`` and record when they sent it and got the answer."""

    def __init__(self, service, texts: List[str], k: int, rerank: bool,
                 clients: int):
        n = len(texts)
        self.service, self.texts, self.k, self.rerank = \
            service, texts, k, rerank
        self.t_send = np.full(n, np.nan)
        self.t_done = np.full(n, np.nan)
        self.ids: List[Optional[np.ndarray]] = [None] * n
        self.scores: List[Optional[np.ndarray]] = [None] * n
        self.errors: Dict[int, str] = {}
        self._work: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._watch = set()
        self._watch_left = threading.Event()
        self._threads = [threading.Thread(target=self._client, daemon=True,
                                          name=f"bench-client-{i}")
                         for i in range(clients)]
        for t in self._threads:
            t.start()

    def watch(self, indices):
        """Set ``all_watched_done`` once every request of ``indices`` is
        answered or failed."""
        self._watch = set(int(i) for i in indices)
        if not self._watch:
            self._watch_left.set()

    def _client(self):
        while True:
            i = self._work.get()
            if i is None:
                return
            self.t_send[i] = time.perf_counter()
            try:
                out = self.service.search([self.texts[i]], k=self.k,
                                          rerank=self.rerank)
                self.ids[i] = np.asarray(out["ids"][0], dtype=np.int64)
                self.scores[i] = np.asarray(out["scores"][0],
                                            dtype=np.float64)
            except Exception as exc:  # a failed request is recorded
                self.errors[i] = repr(exc)
            self.t_done[i] = time.perf_counter()
            with self._lock:
                self._watch.discard(i)
                if not self._watch:
                    self._watch_left.set()

    def send(self, i: int):
        self._work.put(i)

    def all_watched_done(self, timeout: Optional[float] = None) -> bool:
        return self._watch_left.wait(timeout)

    def close(self):
        for _ in self._threads:
            self._work.put(None)
        for t in self._threads:
            t.join(timeout=WAIT_PAST_CLOSE_S)


def build(spec, log) -> Dict:
    """The system under test and the benchmark's inputs of one run, with
    the seconds of each part of the set-up."""
    parts = {}
    t = time.perf_counter()
    import torch
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.ops import bitpack
    from vsearch_tpu_torch.ops.ell import ELLMatrix
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
    from vsearch_tpu_torch.serve import RetrieverService
    parts["imports"] = time.perf_counter() - t

    cfg, traffic, seed = spec.cell.config, spec.cell.traffic, spec.seed
    model, corpus_cfg = cfg["model"], cfg["corpus"]
    dev = torch.device(spec.device)
    t = time.perf_counter()
    if dev.type == "cuda":
        from vsearch_tpu_torch.ops import cuda_build
        cuda_build.build_all()
    parts["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    vocab = vocab_mod.build_vocab()
    tokenizer, tok_kind = make_tokenizer(vocab)
    tok_table = vocab_mod.word_token_ids(vocab)
    parts["tokenizer"] = time.perf_counter() - t
    log(f"tokenizer: {tok_kind}")

    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    parts["cuda_context"] = time.perf_counter() - t

    t = time.perf_counter()
    dtype = getattr(torch, model["dtype"])
    sd_q, sd_p = weights_mod.make_encoders(model["bert"], 2, seed, dev,
                                           dtype)
    rcfg = RetrieverConfig(
        encoder_q=encoder_dict(model, model["q_max_len"]),
        encoder_p=encoder_dict(model, model["p_max_len"]),
        shared_encoder=False)
    retriever = Retriever(rcfg, tokenizer=tokenizer, seed=0, device=dev)
    retriever.encoder_q.module.load_state_dict(sd_q)
    retriever.encoder_p.module.load_state_dict(sd_p)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["encoders"] = time.perf_counter() - t

    t = time.perf_counter()
    rerank = bool(traffic["rerank"])
    shift = model["shift_vocab_num"]
    corpus = corpus_mod.make_corpus(
        corpus_cfg["passages"], corpus_cfg["passage_words"], seed + 1, dev,
        shift, tok_table, keep_words=rerank,
        col_dtype=getattr(torch, cfg["index"]["ell_dtype"]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["corpus"] = time.perf_counter() - t

    t = time.perf_counter()
    index = BoTIndex(device=dev, search_mode=cfg["index"]["search_mode"])
    for key, value in cfg["index"].get("attributes", {}).items():
        setattr(index, key, value)
    index.set_ell(ELLMatrix(cols=corpus.cols, nnz=corpus.nnz, vals=None,
                            num_cols=corpus.num_cols, sentinel_padded=True))
    if rerank:
        index.data = corpus_mod.RenderedCorpus(corpus)
    if cfg["index"]["pack_at_setup"]:
        index.build_bitpack()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    retriever.index = index
    retriever.index_type = index.index_type
    parts["pack"] = time.perf_counter() - t

    recorder = RecordingRetriever(
        retriever, corpus.lengths if rerank else None, model["p_max_len"])
    return {"torch": torch, "dev": dev, "parts": parts, "corpus": corpus,
            "retriever": retriever, "recorder": recorder,
            "service_cls": RetrieverService, "index": index,
            "bitpack": bitpack,
            "weights": (sd_q, sd_p), "tok_table": tok_table,
            "vocab": vocab, "tokenizer": tokenizer}


def warm_up(sys_: Dict, traffic: Dict, texts: List[str], log) -> None:
    """Every power-of-two batch the service's coalescer can send, once;
    with the rerank, its first batches (which cover every length bucket
    of the passages) rerank too."""
    r, k = sys_["retriever"], int(traffic["k"])
    rerank = bool(traffic["rerank"])
    service = sys_["service_cls"](sys_["recorder"])
    top = service._coalescer._max_queries
    service.close()
    bp = sys_["bitpack"]
    before = dict(bp.LAUNCHES)
    b = 1
    while b <= top:
        r.retrieve(texts[:b], k=k,
                   rerank=rerank and b <= int(traffic["warm_rerank_batch"]))
        b *= 2
    launched = {n: c - before.get(n, 0) for n, c in bp.LAUNCHES.items()
                if c - before.get(n, 0)}
    log(f"warm-up launches: {launched}")


def serve_window(sys_: Dict, traffic: Dict, queries, seconds: float,
                 prof: Optional[Profiler] = None) -> Dict:
    """The open loop over ``queries`` through a fresh ``RetrieverService``
    of the built system: the schedule starts its lead before the window,
    runs on past the window's close until every request due in the window
    is answered (or its tail ends), and each request due in the window is
    awaited up to ``WAIT_PAST_CLOSE_S`` past the close. With ``prof``, the
    traffic's stretch of the window is profiled."""
    service = sys_["service_cls"](sys_["recorder"],
                                  default_k=int(traffic["k"]))
    recorder = sys_["recorder"]
    if recorder is not None:
        recorder.timer = service.search_timer
        first = len(recorder.calls)
    loop = OpenLoop(service, queries.texts, int(traffic["k"]),
                    bool(traffic["rerank"]), int(traffic["clients"]))
    due = queries.due
    in_window = np.nonzero((due >= 0) & (due < seconds))[0]
    loop.watch(in_window)
    t_zero = time.perf_counter() + float(traffic["lead_seconds"])
    timer = service.search_timer
    counters = {}
    marks = [(0.0, "open"), (seconds, "close")]
    if prof is not None:
        start, length = stretch_bounds(seconds, traffic)
        marks += [(start, "trace_on"), (start + length, "trace_off")]
    marks.sort()

    def mark(what: str) -> None:
        if what == "trace_on":
            prof.start()
        elif what == "trace_off":
            prof.stop_recording()
        else:
            counters[what] = (time.perf_counter(), time.time(),
                              timer.total_steps, timer.total_items)

    for i, d in enumerate(due.tolist()):
        while marks and d >= marks[0][0]:
            _wait_until(t_zero + marks[0][0])
            mark(marks.pop(0)[1])
        _wait_until(t_zero + d)
        loop.send(i)
        if d >= seconds and loop.all_watched_done(0):
            break
    for at, what in marks:  # the schedule ended before these
        _wait_until(t_zero + at)
        mark(what)
    done_in_time = loop.all_watched_done(
        max(0.0, t_zero + seconds + WAIT_PAST_CLOSE_S - time.perf_counter()))
    loop.close()
    service.close()
    if recorder is not None:
        recorder.settle(first)
    loop.service = None  # the port is freed with the system
    # how late each request reached ``service.search`` against its due time
    lateness = loop.t_send - (t_zero + due)
    return {"loop": loop, "counters": counters, "in_window": in_window,
            "done_in_time": done_in_time, "lateness": lateness,
            "due": due, "seconds": seconds}


def window_metrics(res: Dict) -> Dict:
    """The window's end-to-end numbers: queries answered in it a second,
    and the latency from each due request's due time to its answer (a
    failed or unanswered request counts as the longest wait)."""
    loop, due, seconds = res["loop"], res["due"], res["seconds"]
    in_window = res["in_window"]
    w0 = res["counters"]["open"][0]
    failed = np.zeros(len(due), dtype=bool)
    failed[list(loop.errors)] = True
    lat = loop.t_done[in_window] - (w0 + due[in_window])
    bad = np.isnan(lat) | failed[in_window]
    lat = np.where(bad, WAIT_PAST_CLOSE_S + seconds, lat)
    done = np.isfinite(loop.t_done) & ~failed
    in_win_done = done & (loop.t_done >= w0) & (loop.t_done < w0 + seconds)
    late = res["lateness"][in_window]
    late = late[np.isfinite(late)]
    q = len(lat) // 4
    return {"qps": float(in_win_done.sum()) / seconds,
            "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "latency_s": lat, "failed_mask": bad, "requests": int(len(lat)),
            "late_max_s": float(late.max()) if len(late) else 0.0,
            "late_p95_s": float(np.percentile(late, 95)) if len(late)
            else 0.0,
            # backlog: the last quarter's median latency over the first's
            "backlog_ratio": (float(np.median(lat[-q:]) / np.median(lat[:q]))
                              if q else 1.0)}


def per_layer_latency(m: Dict, due, seconds: float, traffic: Dict,
                      traced: bool) -> Dict:
    """The window's p50 and p95 latency (ms) for the cells that report them
    per layer: in a traced run over the requests due before the profiler
    starts, since its stop stalls the sender."""
    lat = m["latency_s"]
    if traced:
        lat = lat[due < stretch_bounds(seconds, traffic)[0]]
    return {"p50": float(np.percentile(lat, 50)) * 1e3,
            "p95": float(np.percentile(lat, 95)) * 1e3}


def prepare(spec) -> Dict:
    """Build the system and warm it up; the set-up's parts in
    ``sys_["parts"]``."""
    sys_ = build(spec, spec.log)
    torch, dev = sys_["torch"], sys_["dev"]
    t = time.perf_counter()
    warm = corpus_mod.make_queries(spec.cell.traffic, spec.seed + 1, 1.0)
    warm_up(sys_, spec.cell.traffic, warm.texts, spec.log)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # the set-up's objects (vocabulary, corpus lists, queries) need no
    # more collecting: keep the collector's full passes from walking them
    gc.collect()
    gc.freeze()
    sys_["parts"]["warm_up"] = time.perf_counter() - t
    return sys_


def run(spec) -> "Outcome":
    from .. import checks
    from ..harness import Outcome

    log = spec.log
    traffic, cfg = spec.cell.traffic, spec.cell.config
    seconds = float(spec.seconds)
    queries = corpus_mod.make_queries(traffic, spec.seed, seconds)
    sys_ = prepare(spec)
    torch, dev = sys_["torch"], sys_["dev"]
    prof = Profiler(dev) if spec.trace else None
    res = serve_window(sys_, traffic, queries, seconds, prof)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    setup_s = res["counters"]["open"][1] - spec.process_start
    log("setup parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sys_["parts"].items())
        + f"; lead traffic {traffic['lead_seconds']}; setup_s {setup_s:.3f}")
    m = window_metrics(res)
    log(f"generator lateness in the window: max {m['late_max_s']:.6f} s, "
        f"p95 {m['late_p95_s']:.6f} s over {m['requests']} requests; "
        f"backlog ratio {m['backlog_ratio']:.3f}; every answer in: "
        f"{res['done_in_time']}")
    loop = res["loop"]
    if loop.errors:
        log(f"{len(loop.errors)} requests failed; the first: "
            f"{next(iter(loop.errors.items()))}")
    e2e = {k: m[k] for k in ("qps", "latency_p50_ms", "latency_p95_ms")}
    e2e["setup_s"] = setup_s
    w0 = res["counters"]["open"][0]
    in_window = res["in_window"]
    corpus = sys_["corpus"]
    layers = {
        "kind": "serve",
        "window_s": seconds,
        "calls": [c for c in sys_["recorder"].calls
                  if w0 <= c["t0"] < w0 + seconds],
        "timer": (res["counters"]["open"][2:], res["counters"]["close"][2:]),
        "rerank": bool(traffic["rerank"]),
        "model": cfg["model"],
        "num_cols": corpus.num_cols,
        "rows": corpus.rows,
        "set_bits": int(corpus.nnz_host.sum(dtype=np.int64)),
        "nnz": corpus.nnz_host,
        "block_rows": int(getattr(sys_["index"], "stream_block_rows", 0)),
        "tier": cfg["index"]["tier"],
        "trace": None,
        "latency_ms": per_layer_latency(m, queries.due[in_window], seconds,
                                        traffic, spec.trace),
    }
    calls = layers["calls"]
    if calls:
        real = sum(c["real"] for c in calls)
        log(f"window calls {len(calls)}, real queries a call "
            f"{real / len(calls):.2f}, call seconds "
            f"{sum(c['t1'] - c['t0'] for c in calls) / len(calls):.4f}, "
            f"query tokens a query "
            f"{sum(sum(c['q_tokens']) for c in calls) / real:.3f}, "
            f"candidate tokens a query "
            f"{sum(sum(c.get('p_tokens', [])) for c in calls) / real:.2f}, "
            f"distinct candidates a query "
            f"{sum(len(c.get('p_tokens', [])) for c in calls) / real:.2f}")
    outcome = Outcome(correct=False, attempted=int(len(in_window)),
                      failed=int(m["failed_mask"].sum()), end_to_end=e2e,
                      layers=layers, memory_peak_bytes=peak, checks=[])
    if prof is not None:
        data = prof.read()
        layers["trace"] = data
        outcome.busy_s = data.busy_s
        outcome.window_s = data.window_s
        outcome.breakdown = data.breakdown()

    # free the port, then hold a sample of the window's answers to the
    # plain reference
    keep = {k: sys_[k] for k in ("corpus", "weights", "tok_table", "vocab")}
    del sys_
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = checks.draw_sample(in_window[~m["failed_mask"]], queries,
                                spec.seed, int(traffic["check_sample"]))
    served = ([loop.ids[i] for i in sample], [loop.scores[i] for i in sample])
    t = time.perf_counter()
    numbers = checks.compare(cfg, traffic, keep["corpus"], keep["weights"],
                             keep["tok_table"], keep["vocab"],
                             [queries.words[i] for i in sample], served, dev)
    log(f"reference check of {len(sample)} requests took "
        f"{time.perf_counter() - t:.3f} s; its numbers: {numbers}")
    outcome.checks = checks.against_limits(numbers, traffic["limits"])
    outcome.correct = (outcome.failed == 0 and res["done_in_time"]
                       and len(sample) > 0
                       and all(c["value"] <= c["limit"]
                               for c in outcome.checks))
    return outcome
def _wait_until(t: float) -> None:
    dt = t - time.perf_counter()
    if dt > 0:
        time.sleep(dt)
