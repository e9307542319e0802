"""Served SVDR beta search with granite-4.0-h as both encoders, under the
open loop of ``open_loop_search.py``: independent users send one query a
request on a fixed schedule to ``RetrieverService.search`` whatever the
system's backlog; each request's 100 first-stage candidates are
re-embedded by the passage encoder and rescored.

The loop, the recorded calls, the window's numbers and the warm-up are
``open_loop_search``'s (its model-free parts); this module builds the
granite system: ``vocab_granite``'s 100,352-entry vocabulary through the
port's WordPiece tokenizer, ``weights_granite``'s weights on the card,
``corpus_granite``'s passages over the same words, and the port's
``Retriever`` with the granite trunk (``trunk: granite_hybrid``) on each
side. Each recorded call also keeps its record's counts (each encoder
forward's real and padding tokens). After the window the port is freed
and a sample of the window's answers is held to the granite reference
(``checks_granite.py``).
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np

# the trunk this cell needs: a port without it fails here, at once
from vsearch_tpu_torch.models import granite_hybrid  # noqa: F401

from .. import corpus_granite, vocab_granite, weights_granite
from ..trace import Profiler
# ``benchmark.sweep`` runs a generator's ``prepare``, ``serve_window`` and
# ``window_metrics``
from .open_loop_search import (OpenLoop, RecordingRetriever,  # noqa: F401
                               make_tokenizer, per_layer_latency, warm_up,
                               window_metrics)
from .open_loop_search import serve_window as serve_queries

# the configuration file's keys that the trunk reads (the model's own
# ``config.json`` names)
TRUNK_KEYS = (
    "vocab_size", "hidden_size", "shared_intermediate_size", "layer_types",
    "num_attention_heads", "num_key_value_heads", "attention_multiplier",
    "embedding_multiplier", "residual_multiplier", "logits_scaling",
    "mamba_n_heads", "mamba_d_head", "mamba_d_state", "mamba_n_groups",
    "mamba_d_conv", "mamba_chunk_size", "mamba_conv_bias", "mamba_proj_bias",
    "attention_bias", "rms_norm_eps", "position_embedding_type")


def encoder_dict(cfg: Dict, max_len: int) -> Dict:
    """The port's VDR encoder config over the granite trunk of ``cfg``
    (``configs/*.json``)."""
    model = cfg["model"]
    out = {k: cfg[k] for k in TRUNK_KEYS}
    out.update(type="vdr", trunk="granite_hybrid",
               model_id=cfg["name"], max_len=max_len, norm=False,
               shift_vocab_num=model["shift_vocab_num"], topk=model["topk"],
               pooling="max", pooling_topk=0, dtype=model["dtype"])
    return out


class CountingRetriever(RecordingRetriever):
    """``RecordingRetriever`` whose call records also hold the port's
    counts of the call (``counts``: real and padding tokens of each
    encoder's forwards by span path); a port without them gives {}."""

    def retrieve(self, queries, k: int = 5, rerank: bool = False, **kw):
        res = super().retrieve(queries, k=k, rerank=rerank, **kw)
        self.calls[-1]["counts"] = dict(
            getattr(self._r.last_timings, "counts", {}))
        return res


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
    vocab = vocab_granite.build_vocab()
    tokenizer, tok_kind = make_tokenizer(vocab)
    tok_table = vocab_granite.word_token_ids(vocab)
    parts["tokenizer"] = time.perf_counter() - t
    log(f"tokenizer: {tok_kind}")

    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    parts["cuda_context"] = time.perf_counter() - t

    t = time.perf_counter()
    dtype = getattr(torch, model["dtype"])
    sd_q, sd_p = weights_granite.make_encoders(cfg, 2, seed, dev, dtype,
                                               model["initializer_range"])
    rcfg = RetrieverConfig(
        encoder_q=encoder_dict(cfg, model["q_max_len"]),
        encoder_p=encoder_dict(cfg, model["p_max_len"]),
        shared_encoder=False)
    retriever = Retriever(rcfg, tokenizer=tokenizer, seed=0, device=dev)
    # the modules take the benchmark's tensors themselves (no second copy)
    retriever.encoder_q.module.load_state_dict(sd_q, assign=True)
    retriever.encoder_p.module.load_state_dict(sd_p, assign=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["encoders"] = time.perf_counter() - t

    t = time.perf_counter()
    rerank = bool(traffic["rerank"])
    corpus = corpus_granite.make_corpus(
        corpus_cfg["passages"], corpus_cfg["passage_words"], seed + 1, dev,
        model["shift_vocab_num"], tok_table, keep_words=rerank,
        col_dtype=getattr(torch, cfg["index"]["ell_dtype"]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["corpus"] = time.perf_counter() - t

    t = time.perf_counter()
    index = BoTIndex(device=dev, search_mode=cfg["index"]["search_mode"])
    index.set_ell(ELLMatrix(cols=corpus.cols, nnz=corpus.nnz, vals=None,
                            num_cols=corpus.num_cols, sentinel_padded=True))
    if rerank:
        index.data = corpus_granite.GraniteRenderedCorpus(corpus)
    if cfg["index"]["pack_at_setup"]:
        index.build_bitpack()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    retriever.index = index
    retriever.index_type = index.index_type
    parts["pack"] = time.perf_counter() - t

    recorder = CountingRetriever(
        retriever, corpus.lengths if rerank else None, model["p_max_len"])
    return {"torch": torch, "dev": dev, "parts": parts, "corpus": corpus,
            "retriever": retriever, "recorder": recorder,
            "service_cls": RetrieverService, "index": index,
            "bitpack": bitpack,
            "weights": (sd_q, sd_p), "tok_table": tok_table,
            "vocab": vocab, "tokenizer": tokenizer}


def serve_window(sys_: Dict, traffic: Dict, queries, seconds: float,
                 prof=None) -> Dict:
    """``benchmark.sweep``'s window: its ``queries`` come from
    ``corpus.make_queries``, whose BERT-vocabulary words this vocabulary
    splits into characters, so the window serves this cell's own queries
    (``corpus_granite.make_queries``) at the same due times instead, their
    words drawn from the run's seed and the window's number."""
    sys_["windows"] = sys_.get("windows", 0) + 1
    own = corpus_granite.make_queries(traffic, sys_["seed"] + sys_["windows"],
                                      seconds)
    if not np.array_equal(own.due, queries.due):
        raise ValueError("the window's queries follow another schedule")
    return serve_queries(sys_, traffic, own, seconds, prof)


def prepare(spec) -> Dict:
    """Build the system and warm it up; the set-up's parts in
    ``sys_["parts"]``."""
    sys_ = build(spec, spec.log)
    sys_["seed"] = spec.seed
    torch, dev = sys_["torch"], sys_["dev"]
    t = time.perf_counter()
    warm = corpus_granite.make_queries(spec.cell.traffic, spec.seed + 1, 1.0)
    warm_up(sys_, spec.cell.traffic, warm.texts, spec.log)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    sys_["parts"]["warm_up"] = time.perf_counter() - t
    return sys_


def run(spec) -> "Outcome":
    from .. import checks_granite
    from ..harness import Outcome

    log = spec.log
    traffic, cfg = spec.cell.traffic, spec.cell.config
    seconds = float(spec.seconds)
    queries = corpus_granite.make_queries(traffic, spec.seed, seconds)
    sys_ = prepare(spec)
    torch, dev = sys_["torch"], sys_["dev"]
    bp = sys_["bitpack"]
    prof = Profiler(dev) if spec.trace else None
    before = dict(bp.LAUNCHES)
    res = serve_queries(sys_, traffic, queries, seconds, prof)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launched = {n: c - before.get(n, 0) for n, c in bp.LAUNCHES.items()
                if c - before.get(n, 0)}
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    setup_s = res["counters"]["open"][1] - spec.process_start
    log("setup parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sys_["parts"].items())
        + f"; lead traffic {traffic['lead_seconds']}; setup_s {setup_s:.3f}")
    log(f"kernel launches from the lead to the tail: {launched}")
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
        "model": cfg,
        "num_cols": corpus.num_cols,
        "rows": corpus.rows,
        "set_bits": int(corpus.nnz_host.sum(dtype=np.int64)),
        "nnz": corpus.nnz_host,
        "block_rows": int(getattr(sys_["index"], "stream_block_rows", 0)),
        "tier": cfg["index"]["tier"],
        "trace": None,
        "latency_ms": per_layer_latency(m, queries.due[in_window], seconds,
                                        traffic, spec.trace),
        "trunk": "granite_hybrid",
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
    sample = checks_granite.draw_sample(in_window[~m["failed_mask"]],
                                        queries, spec.seed,
                                        int(traffic["check_sample"]))
    served = ([loop.ids[i] for i in sample], [loop.scores[i] for i in sample])
    t = time.perf_counter()
    numbers = checks_granite.compare(
        cfg, traffic, keep["corpus"], keep["weights"], keep["tok_table"],
        keep["vocab"], [queries.words[i] for i in sample], served, dev)
    log(f"reference check of {len(sample)} requests took "
        f"{time.perf_counter() - t:.3f} s; its numbers: {numbers}")
    outcome.checks = checks_granite.against_limits(numbers, traffic["limits"])
    outcome.correct = (outcome.failed == 0 and res["done_in_time"]
                       and len(sample) > 0
                       and all(c["value"] <= c["limit"]
                               for c in outcome.checks))
    return outcome
