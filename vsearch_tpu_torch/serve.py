"""HTTP search/embed endpoints (counterpart of ``vsearch_tpu/serve.py``,
with the same scheduling).

A ``Retriever`` + index behind a threaded stdlib HTTP server with request
COALESCING: a first stage walks the whole index whatever the batch size,
so while one device call runs, every request that queued behind it is
drained and merged into the NEXT single call. Under concurrency the card
sees a few big batches instead of a serialized stream of small ones.

Threads: one dispatcher thread (``SearchCoalescer``) owns the card for
searches, so their kernels go to that thread's current CUDA stream; the
HTTP handler threads only parse, validate and wait for it. ``/embed`` (and
every search when coalescing is off) runs on the request's thread under
the service lock, which every device search takes too, so no two threads
drive the encoders at once.

Endpoints:
  POST /search  {"queries": [...], "k": 5, "rerank": false,
                 "return_texts": false}
  POST /embed   {"texts": [...], "sparse": true}
  GET  /healthz
  GET  /stats

``/stats`` is the operator's view of the process: the rolling step
timers (``search``, ``embed``), the coalescer's counters, and ``spans``,
the tracer's cumulative ``{"count", "total_s"}`` per span path
(``utils.profiling.TRACER``). Each coalesced device call is a
``serve/call`` span; ``serve/select`` is the dispatcher's drain and choice
of the call's requests and their padding; ``serve/queue_wait`` counts real
queries and sums each one's wait from its chunk's enqueue in ``submit`` to
the start of the call that serves it (its ``total_s / count`` is the mean
wait); below them the retriever's stages (``query_embed``,
``first_stage``, ``rerank``) and their parts (``<stage>/<child>``). A span
outside any call (an ``/embed``'s encoder spans) counts under its own
name.
"""
from __future__ import annotations

import json
import logging
import queue
import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from .utils.profiling import TRACER, StepTimer

logger = logging.getLogger(__name__)


class BadRequest(ValueError):
    """Raised by request-validation sites only. The HTTP layer keys its
    400 branch on exactly this type: server-side bugs that happen to
    surface as ValueError/TypeError/KeyError from device code must not
    masquerade as client errors to monitoring and retry policies."""


class SearchCoalescer:
    """Merge concurrent search requests into single device calls.

    One dispatcher thread owns the device (so no lock is needed on the
    search path). Each wakeup drains everything already queued, groups
    by (k, rerank) — different groups can't share a device program —
    and runs ONE retrieve for the chosen group. No artificial wait is
    added: an idle server dispatches a lone request immediately;
    batching emerges exactly when the device is the bottleneck.

    Fairness: requests larger than ``max_queries`` split into chunks
    that schedule independently, and each wakeup serves the smallest
    pending group first (bounded by MAX_PASS_OVER so big requests
    can't starve) — a batch-256 request adds at most one small call's
    latency to singletons arriving behind it, not its whole runtime.

    Tenant fairness: requests may carry a tenant id; the tenant that
    LEADS each device call rotates round-robin over tenants with
    pending work, so a flood of small requests from one tenant cannot
    monopolize wakeups against another tenant's trickle. Within the
    leading tenant the size-fair policy above applies unchanged, and
    same-group requests from other tenants still co-ride in the same
    call (search latency is flat in batch size, so co-riding is free
    throughput, not a fairness cost). Single-tenant traffic schedules
    exactly as before.
    """

    # a buffered request may be passed over (smaller traffic served
    # first) at most this many times before its group runs regardless —
    # bounds tail latency under a continuous stream of small requests
    MAX_PASS_OVER = 2
    # the tenant field is untrusted client input: the rotation (scanned
    # every device call) and the per-tenant lead counters (serialized by
    # /stats) must stay bounded no matter how many distinct tenant
    # strings arrive. Beyond this many live tenants, idle ones are
    # evicted from the rotation; if every slot has buffered work, new
    # arrivals fold into the default "-" bucket for scheduling/stats.
    MAX_TENANTS = 64

    def __init__(self, search_fn, max_queries: int = 256):
        self._search_fn = search_fn
        self._max_queries = max_queries
        self._q: queue.Queue = queue.Queue()
        self._passed_over = 0  # dispatcher-thread only
        # round-robin lead rotation (dispatcher-thread only): tenants
        # in first-seen order; index of the last call's lead tenant.
        # "-" (untagged traffic / overflow fold bucket) is a permanent
        # member so folding always has a schedulable target.
        self._tenant_order: list = ["-"]
        self._rr_pos = 0
        self.device_calls = 0  # observability: compare vs request count
        self.tenant_leads: Dict[str, int] = defaultdict(int)
        self.evicted_tenant_leads = 0  # leads of since-evicted tenants
        # close() and submit() enqueue under this lock, so every request
        # lands before the close sentinel or is refused
        self._enqueue_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="search-coalescer")
        self._thread.start()

    def close(self):
        """Answer the requests already queued, then end the dispatcher
        thread, which drops its hold on the search function (and through
        it the retriever and its device memory). Later submits raise."""
        with self._enqueue_lock:
            if not self._closed:
                self._closed = True
                self._q.put(None)
        self._thread.join()

    def submit(self, queries, k: int, rerank: bool,
               tenant: str = "-"):
        if isinstance(queries, str):
            # list('text') would explode a bare string into characters
            queries = [queries]
        queries = list(queries)
        if not queries:
            # validate before enqueueing: a bad request must fail alone,
            # never inside a merged device call
            raise BadRequest("queries must be a non-empty list")
        # fairness: a request bigger than one device call's budget is
        # split into chunks that enqueue as independent items, so
        # traffic arriving behind a giant batch interleaves with its
        # chunks instead of waiting out one huge call
        # string queries and precomputed embedding vectors cannot share
        # a device call (process_query branches on the element type), so
        # the kind joins the group key. Each item carries its enqueue
        # time, the start of its queue wait
        kind = "str" if isinstance(queries[0], str) else "vec"
        step = self._max_queries
        pending = []
        with self._enqueue_lock:
            if self._closed:
                raise RuntimeError("the search coalescer is closed")
            for start in range(0, len(queries), step):
                done = threading.Event()
                slot: Dict[str, Any] = {}
                self._q.put((queries[start: start + step], (k, kind),
                             rerank, done, slot, tenant,
                             time.perf_counter_ns()))
                pending.append((done, slot))
        for done, _ in pending:
            done.wait()
        for _, slot in pending:
            if "error" in slot:
                raise slot["error"]
        if len(pending) == 1:
            slot = pending[0][1]
            return slot["ids"], slot["scores"]
        return (np.concatenate([s["ids"] for _, s in pending]),
                np.concatenate([s["scores"] for _, s in pending]))

    def _admit(self, pending) -> Dict[str, str]:
        """Map each pending item's raw tenant string to its bounded
        scheduling key. Known tenants map to themselves; a new tenant
        joins the rotation if a slot is free, else replaces an IDLE
        (no buffered work) tenant in place — keeping the rr cursor's
        position meaningful — else folds into the "-" bucket. The
        rotation therefore never exceeds MAX_TENANTS entries regardless
        of how many distinct tenant strings clients send."""
        raw_pending = {it[5] for it in pending}
        keys: Dict[str, str] = {}
        # iterate in pending (first-seen) order — set order would make
        # rotation membership, and thus the lead, hash-dependent
        for t in dict.fromkeys(it[5] for it in pending):
            if t in self._tenant_order:
                keys[t] = t
            elif len(self._tenant_order) < self.MAX_TENANTS:
                self._tenant_order.append(t)
                keys[t] = t
            else:
                for i, old in enumerate(self._tenant_order):
                    if old != "-" and old not in raw_pending:
                        self._tenant_order[i] = t
                        self.evicted_tenant_leads += \
                            self.tenant_leads.pop(old, 0)
                        keys[t] = t
                        break
                else:  # every slot busy: fold into the default bucket
                    keys[t] = "-"
        return keys

    def _next_lead(self, pending, keys: Dict[str, str]) -> str:
        """Round-robin lead tenant: the first tenant at or after the
        rotation cursor that has buffered work. Membership is bounded
        by ``_admit`` (idle tenants cost one skip per wakeup)."""
        have = {keys[item[5]] for item in pending}
        n = len(self._tenant_order)
        for off in range(n):
            t = self._tenant_order[(self._rr_pos + off) % n]
            if t in have:
                self._rr_pos = (self._rr_pos + off + 1) % n
                return t
        raise AssertionError("pending tenants missing from rotation")

    def _select(self, pending):
        """Pick the items for the next device call from the buffered
        requests: the round-robin lead tenant's (k, rerank) group with
        the fewest total queries runs first (a giant request's chunks
        then add at most one small call's latency to singletons behind
        them, not the whole giant), smallest requests first within the
        group, topped up with other tenants' same-group requests as
        free co-riders, up to one call's query budget. The oldest
        buffered item is passed over at most MAX_PASS_OVER times
        before it is forced regardless of tenant or size."""
        keys = self._admit(pending)
        groups: Dict[Any, list] = defaultdict(list)
        for item in pending:
            groups[(item[1], item[2])].append(item)
        oldest = pending[0]
        if self._passed_over >= self.MAX_PASS_OVER:
            # force the oldest ITEM itself into the call (forcing only
            # its group is not enough: an oversized request sharing a
            # group with a stream of singletons would still lose the
            # smallest-first fill every time), then top up with its
            # group's smallest co-riders
            key = (oldest[1], oldest[2])
            items, total = [oldest], len(oldest[0])
            for it in sorted(groups[key], key=lambda it: len(it[0])):
                if it is oldest:
                    continue
                if total + len(it[0]) > self._max_queries:
                    break
                items.append(it)
                total += len(it[0])
            self._passed_over = 0
            self.tenant_leads[keys[oldest[5]]] += 1
            return items
        lead = self._next_lead(pending, keys)
        lead_groups: Dict[Any, list] = defaultdict(list)
        for item in pending:
            if keys[item[5]] == lead:
                lead_groups[(item[1], item[2])].append(item)
        key = min(lead_groups, key=lambda g: sum(len(it[0])
                                                 for it in lead_groups[g]))
        items, total = [], 0
        for it in sorted(lead_groups[key], key=lambda it: len(it[0])):
            if items and total + len(it[0]) > self._max_queries:
                break
            items.append(it)
            total += len(it[0])
        # co-riders: other tenants' requests in the SAME group share
        # the device call for free (latency is flat in batch size)
        chosen = {id(it) for it in items}
        riders = [it for it in groups[key] if id(it) not in chosen]
        for it in sorted(riders, key=lambda it: len(it[0])):
            if total + len(it[0]) > self._max_queries:
                break
            items.append(it)
            total += len(it[0])
        if any(it is oldest for it in items):
            self._passed_over = 0
        else:
            self._passed_over += 1
        self.tenant_leads[lead] += 1
        return items

    @staticmethod
    def _bucket(n: int) -> int:
        """Round the merged batch up to a power of two: few distinct batch
        sizes means few distinct kernel grids and GEMM shapes, and the
        same merged calls as the JAX package makes. Padding repeats the
        last query (< 2x compute) and results are sliced."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _batch(self, items):
        """The call's queries, padded to ``_bucket``, and the real count."""
        queries = [q for it in items for q in it[0]]
        n = len(queries)
        return queries + [queries[-1]] * (self._bucket(n) - n), n

    def _run_group(self, items, k: int, rerank: bool, batch=None):
        padded, n = batch or self._batch(items)
        with TRACER.call("serve/call", n_real=n, batch=len(padded)) as call:
            TRACER.add("serve/queue_wait",
                       sum((call.t0 - it[6]) * len(it[0]) for it in items),
                       count=n)
            # n_real tells the backend how many rows are real queries (the
            # rest is power-of-two padding) so /stats doesn't count padding
            ids, scores = self._search_fn(padded, k, rerank, n_real=n)
        self.device_calls += 1
        row = 0
        for it in items:
            m = len(it[0])
            it[4]["ids"] = ids[row: row + m]
            it[4]["scores"] = scores[row: row + m]
            row += m

    def _loop(self):
        pending: list = []  # buffered items, FIFO by arrival
        closing = False
        while True:
            if not pending and not closing:
                pending.append(self._q.get())
            with TRACER.span("serve/select"):
                while True:  # drain everything already queued
                    try:
                        pending.append(self._q.get_nowait())
                    except queue.Empty:
                        break
                if any(it is None for it in pending):
                    # close(): nothing is enqueued after its sentinel, so
                    # the buffer now holds the last requests to answer
                    closing = True
                    pending = [it for it in pending if it is not None]
                if not pending:
                    return
                items = self._select(pending)
                chosen = {id(it) for it in items}
                pending = [it for it in pending if id(it) not in chosen]
                batch = self._batch(items)
            (k, _kind), rerank = items[0][1], items[0][2]
            try:
                try:
                    self._run_group(items, k, rerank, batch)
                except Exception:
                    if len(items) == 1:
                        raise
                    # isolate a poisoned request: retry each alone
                    # so one bad payload can't fail its co-riders.
                    # Log it — a systematically failing merge (e.g. a
                    # device fault) would otherwise silently
                    # serialize every request
                    logger.warning(
                        "merged device call of %d requests failed; "
                        "retrying individually", len(items),
                        exc_info=True)
                    for it in items:
                        try:
                            self._run_group([it], k, rerank)
                        except Exception as exc:
                            it[4]["error"] = exc
            except Exception as exc:
                for it in items:
                    it[4].setdefault("error", exc)
            finally:
                for it in items:
                    it[3].set()


class RetrieverService:
    """Thread-safe facade over a Retriever + index."""

    def __init__(self, retriever, default_k: int = 10,
                 coalesce: bool = True):
        self.retriever = retriever
        self.default_k = default_k
        self.search_timer = StepTimer(window=256)
        self.embed_timer = StepTimer(window=256)
        self._lock = threading.Lock()
        self._coalescer = (SearchCoalescer(self._device_search)
                           if coalesce else None)

    def close(self):
        """End the dispatcher thread once queued searches are answered."""
        if self._coalescer is not None:
            self._coalescer.close()

    def _device_search(self, queries, k: int, rerank: bool,
                       n_real: Optional[int] = None):
        # n_real = count of real queries in a coalesced batch (the rest
        # is power-of-two padding); time by real work or /stats inflates
        with self._lock, \
                self.search_timer.step(items=n_real or len(queries)):
            res = self.retriever.retrieve(queries, k=k, rerank=rerank)
        return np.asarray(res.ids), np.asarray(res.scores)

    def search(self, queries, k: Optional[int] = None,
               rerank: bool = False, return_texts: bool = False,
               tenant: Optional[str] = None) -> Dict[str, Any]:
        # validate here, not (only) in the coalescer, so the
        # --no_coalesce lock path rejects bad payloads with the same
        # message instead of dying deep inside encode()
        if isinstance(queries, str):
            # list('text') would explode a bare string into characters
            queries = [queries]
        queries = list(queries)
        if not queries:
            raise BadRequest("queries must be a non-empty list")
        if k is not None:
            if not isinstance(k, (int, np.integer)) or isinstance(
                    k, bool):
                # a string/float k would otherwise surface as a
                # TypeError deep in the search path (a 500)
                raise BadRequest("k must be an integer")
            if k <= 0:
                # `k or default` would silently turn an explicit k=0
                # into default_k results
                raise BadRequest("k must be >= 1")
        k = k or self.default_k
        if tenant is not None and not isinstance(tenant, str):
            raise BadRequest("tenant must be a string")
        if self._coalescer is not None:
            ids, scores = self._coalescer.submit(queries, k,
                                                 bool(rerank),
                                                 tenant=tenant or "-")
        else:
            ids, scores = self._device_search(queries, k, rerank)
        out = {
            "ids": np.asarray(ids).tolist(),
            "scores": np.asarray(scores).tolist(),
        }
        if return_texts and self.retriever.index is not None:
            out["texts"] = [
                [self.retriever.index.get_sample(int(i)) for i in row]
                for row in np.asarray(ids)]
        return out

    def embed(self, texts, sparse: bool = True) -> Dict[str, Any]:
        if isinstance(texts, str):
            texts = [texts]
        texts = list(texts)
        if not texts:
            raise BadRequest("texts must be a non-empty list")
        with self._lock, self.embed_timer.step(items=len(texts)):
            enc = self.retriever.encoder_q
            if sparse and hasattr(enc, "embed_sparse"):
                cols, vals = enc.embed_sparse(texts)
                keep = [np.nonzero(v > 0)[0] for v in vals]
                return {"sparse": True,
                        "dims": [c[kp].tolist()
                                 for c, kp in zip(cols, keep)],
                        "values": [v[kp].tolist()
                                   for v, kp in zip(vals, keep)]}
            emb = enc.embed(texts)
            return {"sparse": False, "embeddings": emb.tolist()}

    def stats(self) -> Dict[str, Any]:
        out = {"search": self.search_timer.summary(),
               "embed": self.embed_timer.summary(),
               "spans": TRACER.summary()}
        if self._coalescer is not None:
            out["coalesced_device_calls"] = self._coalescer.device_calls
            leads = self._coalescer.tenant_leads
            if leads and (len(leads) > 1 or "-" not in leads):
                # only surface the breakdown once tenants are in play;
                # cardinality is bounded by the coalescer's MAX_TENANTS
                # rotation cap, so serializing in full is safe
                out["tenant_device_leads"] = dict(leads)
                if self._coalescer.evicted_tenant_leads:
                    out["evicted_tenant_device_leads"] = \
                        self._coalescer.evicted_tenant_leads
        return out


def make_handler(service: RetrieverService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _reply(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._reply(200, service.stats())
                else:
                    self._reply(404, {"error": "not found"})
            except Exception as exc:  # keep monitoring endpoints alive
                logger.exception("GET failed")
                self._reply(500, {"error": str(exc)})

        def do_POST(self):
            try:
                try:
                    length = int(self.headers.get("Content-Length",
                                                  "0"))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, TypeError) as exc:
                    raise BadRequest(f"invalid JSON body: {exc}")
                if not isinstance(req, dict):
                    raise BadRequest("request body must be a JSON "
                                     "object")
                if self.path == "/search":
                    if "queries" not in req:
                        raise BadRequest("missing 'queries'")
                    out = service.search(
                        req["queries"], k=req.get("k"),
                        rerank=bool(req.get("rerank", False)),
                        return_texts=bool(req.get("return_texts",
                                                  False)),
                        tenant=req.get("tenant"))
                    self._reply(200, out)
                elif self.path == "/embed":
                    if "texts" not in req:
                        raise BadRequest("missing 'texts'")
                    out = service.embed(req["texts"],
                                        sparse=bool(req.get("sparse",
                                                            True)))
                    self._reply(200, out)
                else:
                    self._reply(404, {"error": "not found"})
            except BadRequest as exc:
                # only validation-site raises take this branch: a
                # server-side bug surfacing as ValueError/TypeError
                # must be a 500, not a "client error"
                logger.exception("bad request")
                self._reply(400, {"error": str(exc)})
            except Exception as exc:
                # server-side faults (no index, device errors) must not
                # masquerade as client errors — monitoring and client
                # retry policies key on the status class
                logger.exception("request failed")
                self._reply(500, {"error": str(exc)})

    return Handler


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: with more clients than
    # that connecting at once, the kernel drops their connection
    # attempts and each retries after TCP's 1 s SYN timeout, which shows
    # as ~1 s tail latency under concurrent load
    request_queue_size = 128
    service: Optional[RetrieverService] = None

    def server_close(self):
        # unlike the JAX package, closing the server also ends the
        # service's dispatcher thread, which would otherwise hold the
        # retriever (its weights and index on the card) for the life of
        # the process
        super().server_close()
        if self.service is not None:
            self.service.close()


def serve(retriever, host: str = "0.0.0.0", port: int = 8080,
          default_k: int = 10, coalesce: bool = True
          ) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .serve_forever())."""
    service = RetrieverService(retriever, default_k=default_k,
                               coalesce=coalesce)
    server = _Server((host, port), make_handler(service))
    server.service = service
    logger.info("serving retriever on %s:%d", host, port)
    return server
