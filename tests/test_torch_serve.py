"""The port's HTTP serving layer (``vsearch_tpu_torch/serve.py``): a port
counterpart of each case of ``tests/test_serve.py`` but the mesh ones
(live server thread on 127.0.0.1, port 0, and urllib round trips; the
coalescer's merging, splitting, starvation bound, poisoned-request
isolation, tenant rotation and cardinality cap), plus one case that sends
the same request script to the JAX package's ``RetrieverService`` and to
the port's over equal weights (ids equal, scores within 1e-4: f32 on the
CPU in two frameworks)."""
import json
import threading
import urllib.request

import numpy as np
import pytest

from tests.helpers import make_tokenizer, tiny_bert_config
from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig
from vsearch_tpu_torch.serve import serve
from vsearch_tpu_torch.tokenization.wordpiece import WordPieceTokenizer

CORPUS = ["green tea is a drink", "the red planet mars",
          "einstein theory of relativity", "a dog runs in the city"]


@pytest.fixture(scope="module")
def server():
    tok = WordPieceTokenizer(dict(make_tokenizer().vocab))
    enc = {
        "type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
        **{k: v for k, v in vars(tiny_bert_config(tok.vocab_size)).items()
           if k in ("vocab_size", "hidden_size", "num_hidden_layers",
                    "num_attention_heads", "intermediate_size",
                    "max_position_embeddings")},
    }
    cfg = RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                          shared_encoder=True)
    r = Retriever(cfg, tokenizer=tok, device="cpu")
    r.build_index(CORPUS, batch_size=4, index_type="bag_of_token")
    srv = serve(r, host="127.0.0.1", port=0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def test_healthz(server):
    assert _get(server + "/healthz") == {"status": "ok"}


def test_search_endpoint(server):
    out = _post(server + "/search",
                {"queries": ["green tea"], "k": 2,
                 "return_texts": True})
    assert len(out["ids"][0]) == 2
    assert len(out["scores"][0]) == 2
    assert len(out["texts"][0]) == 2
    assert all(isinstance(t, str) for t in out["texts"][0])


def test_search_with_rerank(server):
    out = _post(server + "/search",
                {"queries": ["einstein relativity"], "k": 3,
                 "rerank": True})
    assert len(out["ids"][0]) == 3
    s = out["scores"][0]
    assert s == sorted(s, reverse=True)


def test_embed_endpoint_sparse(server):
    out = _post(server + "/embed", {"texts": ["green tea"],
                                    "sparse": True})
    assert out["sparse"] is True
    assert len(out["dims"][0]) == len(out["values"][0]) > 0


def test_embed_endpoint_dense(server):
    out = _post(server + "/embed", {"texts": ["green tea"],
                                    "sparse": False})
    assert out["sparse"] is False
    assert len(out["embeddings"][0]) > 100


def test_stats_and_errors(server):
    stats = _get(server + "/stats")
    assert stats["search"]["steps"] >= 2
    # malformed request -> 400
    req = urllib.request.Request(
        server + "/search", data=b'{"nope": 1}',
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_coalescer_merges_concurrent_requests():
    """While a device call is in flight, queued requests must merge
    into ONE next call (a per-request lock would serialize them)."""
    import time

    from vsearch_tpu_torch.serve import SearchCoalescer

    calls = []

    def slow_search(queries, k, rerank, n_real=None):
        calls.append(len(queries))
        time.sleep(0.05)  # device busy: followers pile up
        ids = np.asarray([[hash(q) % 97] * k for q in queries])
        return ids, ids.astype(np.float32)

    co = SearchCoalescer(slow_search)
    results = {}

    def client(i):
        ids, scores = co.submit([f"q{i}a", f"q{i}b"], k=3, rerank=False)
        results[i] = np.asarray(ids)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 8
    for i, ids in results.items():
        assert ids.shape == (2, 3)
        # each row carries its own query's payload (no cross-request mixup)
        assert ids[0, 0] == hash(f"q{i}a") % 97
        assert ids[1, 0] == hash(f"q{i}b") % 97
    # 8 requests -> far fewer device calls (first leader + merged rest)
    assert len(calls) < 8
    # batches pad up to power-of-two buckets (anti-retrace), so the
    # backend may see more rows than real queries, never fewer
    assert sum(calls) >= 16
    assert all(c == co._bucket(c) for c in calls)


def test_coalescer_isolates_poisoned_requests():
    """One bad payload in a merged batch must not fail its co-riders:
    the group retries each request alone and only the bad one errors."""
    import time

    from vsearch_tpu_torch.serve import SearchCoalescer

    def search(queries, k, rerank, n_real=None):
        if any(q == "BAD" for q in queries):
            raise RuntimeError("poison")
        time.sleep(0.05)
        ids = np.asarray([[1] * k for _ in queries])
        return ids, ids.astype(np.float32)

    co = SearchCoalescer(search)
    results = {}

    def client(i, text):
        try:
            results[i] = co.submit([text], k=2, rerank=False)
        except Exception as exc:
            results[i] = exc

    threads = [threading.Thread(target=client, args=(i, t)) for i, t in
               enumerate(["ok1", "BAD", "ok2", "ok3", "BAD", "ok4"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, t in enumerate(["ok1", "BAD", "ok2", "ok3", "BAD", "ok4"]):
        if t == "BAD":
            assert isinstance(results[i], RuntimeError)
        else:
            ids, _ = results[i]
            assert np.asarray(ids).shape == (1, 2)


def test_coalescer_splits_giant_requests():
    """A request larger than max_queries runs as several device calls
    (each within one call's budget) and still returns every row in
    order."""
    from vsearch_tpu_torch.serve import SearchCoalescer

    calls = []

    def search(queries, k, rerank, n_real=None):
        calls.append(len(queries))
        ids = np.asarray([[hash(q) % 97] * k for q in queries])
        return ids, ids.astype(np.float32)

    co = SearchCoalescer(search, max_queries=4)
    queries = [f"q{i}" for i in range(10)]
    ids, scores = co.submit(queries, k=2, rerank=False)
    assert np.asarray(ids).shape == (10, 2)
    for i, q in enumerate(queries):
        assert ids[i][0] == hash(q) % 97
    assert len(calls) >= 3  # 10 queries / budget 4
    assert all(c <= co._bucket(4) for c in calls)


def test_coalescer_small_requests_jump_giant_chunks():
    """A singleton arriving while a giant request's first chunk is on
    the device must be served before the giant's remaining chunks
    (FIFO coalescing would add the giant's whole latency to everything
    queued behind it)."""
    import time

    from vsearch_tpu_torch.serve import SearchCoalescer

    call_log = []
    first_chunk_running = threading.Event()

    def search(queries, k, rerank, n_real=None):
        call_log.append(list(queries))
        first_chunk_running.set()
        time.sleep(0.08)  # device busy: the rest piles up
        ids = np.asarray([[1] * k for _ in queries])
        return ids, ids.astype(np.float32)

    co = SearchCoalescer(search, max_queries=2)
    order = []

    def giant():
        co.submit([f"g{i}" for i in range(6)], k=2, rerank=False)
        order.append("giant")

    def single():
        first_chunk_running.wait(timeout=5)
        co.submit(["single"], k=2, rerank=False)
        order.append("single")

    tg = threading.Thread(target=giant)
    ts = threading.Thread(target=single)
    tg.start()
    ts.start()
    tg.join()
    ts.join()
    single_call = next(i for i, c in enumerate(call_log)
                       if "single" in c)
    last_giant_call = max(i for i, c in enumerate(call_log)
                          if any(q.startswith("g") for q in c))
    assert single_call < last_giant_call
    assert order[0] == "single"


def test_coalescer_starvation_bound():
    """A continuous stream of singletons must not starve a big request:
    after MAX_PASS_OVER pass-overs its group runs regardless."""
    import time

    from vsearch_tpu_torch.serve import SearchCoalescer

    call_log = []
    stop = threading.Event()

    def search(queries, k, rerank, n_real=None):
        call_log.append(len(queries))
        time.sleep(0.03)
        ids = np.asarray([[1] * k for _ in queries])
        return ids, ids.astype(np.float32)

    co = SearchCoalescer(search, max_queries=8)

    def spammer():
        while not stop.is_set():
            co.submit(["small"], k=2, rerank=False)

    spam_threads = [threading.Thread(target=spammer) for _ in range(3)]
    for t in spam_threads:
        t.start()
    time.sleep(0.1)  # spammers saturate the dispatcher
    t0 = time.time()
    ids, _ = co.submit([f"big{i}" for i in range(8)], k=2, rerank=False)
    big_wait = time.time() - t0
    stop.set()
    for t in spam_threads:
        t.join()
    assert np.asarray(ids).shape == (8, 2)
    # pass-over bound: the big call runs within MAX_PASS_OVER + its own
    # call (~4 x 0.03 s); a starved request would wait the full 5 s
    assert big_wait < 1.0


def test_search_empty_queries_rejected(server):
    req = urllib.request.Request(
        server + "/search", data=b'{"queries": []}',
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_coalescer_propagates_errors():
    from vsearch_tpu_torch.serve import SearchCoalescer

    def broken(queries, k, rerank, n_real=None):
        raise RuntimeError("device on fire")

    co = SearchCoalescer(broken)
    with pytest.raises(RuntimeError, match="device on fire"):
        co.submit(["q"], k=1, rerank=False)


@pytest.mark.parametrize("rerank", [False, True])
def test_concurrent_http_search_matches_serial(server, rerank):
    """Concurrent /search responses must be identical to one-at-a-time
    responses (coalescing is invisible to clients): on the CPU, ids and
    scores equal."""
    queries = ["green tea", "red planet", "einstein relativity",
               "dog city"]
    serial = [_post(server + "/search", {"queries": [q], "k": 2,
                                         "rerank": rerank})
              for q in queries]
    results = {}

    def client(i):
        results[i] = _post(server + "/search",
                           {"queries": [queries[i]], "k": 2,
                            "rerank": rerank})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(len(queries)):
        assert results[i]["ids"] == serial[i]["ids"]
        assert results[i]["scores"] == serial[i]["scores"]
    stats = _get(server + "/stats")
    assert stats["coalesced_device_calls"] >= 1


def test_no_coalesce_path_validates_requests():
    """Validation lives in RetrieverService.search, so the
    --no_coalesce lock path rejects bad payloads with the intended
    message instead of dying deep inside encode()."""
    from vsearch_tpu_torch.serve import RetrieverService

    class FakeRetriever:
        index = None

        def retrieve(self, queries, k, rerank=False):
            import numpy as _np

            self.last = list(queries)
            n = len(queries)
            return type("R", (), {"ids": _np.zeros((n, k), int),
                                  "scores": _np.zeros((n, k))})()

    r = FakeRetriever()
    svc = RetrieverService(r, coalesce=False)
    with pytest.raises(ValueError, match="non-empty list"):
        svc.search([])
    # a bare string is wrapped, not exploded into characters
    out = svc.search("green tea", k=2)
    assert r.last == ["green tea"]
    assert len(out["ids"]) == 1


def test_embed_endpoint_validates_requests():
    """/embed rejects empty payloads with a clear message and wraps a
    bare string, on both coalesced and lock paths (embed always takes
    the lock path)."""
    from vsearch_tpu_torch.serve import RetrieverService

    class FakeEncoder:
        def embed(self, texts, **kw):
            import numpy as _np

            return _np.zeros((len(texts), 4))

    class FakeRetriever:
        index = None
        encoder_q = FakeEncoder()

    svc = RetrieverService(FakeRetriever(), coalesce=False)
    with pytest.raises(ValueError, match="non-empty list"):
        svc.embed([])
    out = svc.embed("green tea", sparse=False)
    assert len(out["embeddings"]) == 1


def test_search_rejects_zero_k():
    """An explicit k=0 must not silently become default_k."""
    from vsearch_tpu_torch.serve import RetrieverService

    class FakeRetriever:
        index = None

        def retrieve(self, queries, k, rerank=False):
            import numpy as _np

            return type("R", (), {"ids": _np.zeros((len(queries), k),
                                                   int),
                                  "scores": _np.zeros((len(queries),
                                                       k))})()

    svc = RetrieverService(FakeRetriever(), coalesce=False)
    with pytest.raises(ValueError, match="k must be"):
        svc.search(["q"], k=0)


def test_coalescer_groups_by_query_kind():
    """String and embedding-vector queries must not merge into one
    device call (the backend branches on element type) — both kinds
    must still succeed concurrently."""
    import numpy as np

    from vsearch_tpu_torch.serve import SearchCoalescer

    calls = []

    def backend(queries, k, rerank, n_real=None):
        kinds = {type(q).__name__ for q in queries}
        assert len(kinds) == 1, f"mixed kinds in one call: {kinds}"
        calls.append(sorted(kinds))
        n = len(queries)
        return np.zeros((n, k), int), np.zeros((n, k))

    co = SearchCoalescer(backend)
    out = []
    ts = []
    for payload in (["text one"], [[0.1, 0.2]], ["text two"]):
        t = threading.Thread(
            target=lambda p=payload: out.append(
                co.submit(p, k=2, rerank=False)))
        t.start()
        ts.append(t)
    for t in ts:
        t.join(30)
    assert len(out) == 3
    assert all(len(k) == 1 for k in calls)


def test_coalescer_fuzz_matches_serial():
    """Randomized concurrent load: any mix of sizes, k values and
    query kinds must return exactly what serial execution would — the
    scheduler (size-fair + starvation bound + kind grouping) only
    reorders device calls, never results."""
    import random

    import numpy as np

    from vsearch_tpu_torch.serve import SearchCoalescer

    def backend(queries, k, rerank, n_real=None):
        # deterministic per-query result: hash of the payload
        def val(q):
            if isinstance(q, str):
                return float(len(q)) + (1000.0 if rerank else 0.0)
            return float(np.sum(q)) + (1000.0 if rerank else 0.0)

        n = len(queries)
        ids = np.arange(n * k).reshape(n, k)
        scores = np.asarray([[val(q) + j for j in range(k)]
                             for q in queries])
        return ids, scores

    co = SearchCoalescer(backend, max_queries=8)
    rng = random.Random(7)
    payloads = []
    for i in range(40):
        k = rng.choice([1, 3, 5])
        rerank = rng.random() < 0.3
        if rng.random() < 0.5:
            qs = [f"query {i} {j} {'x' * rng.randrange(5)}"
                  for j in range(rng.randrange(1, 13))]
        else:
            qs = [[float(i), float(j)]
                  for j in range(rng.randrange(1, 13))]
        payloads.append((qs, k, rerank))

    results = [None] * len(payloads)

    def run(idx):
        qs, k, rerank = payloads[idx]
        results[idx] = co.submit(qs, k=k, rerank=rerank)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)

    for (qs, k, rerank), got in zip(payloads, results):
        assert got is not None, "request lost"
        _ids, scores = got
        expect = np.asarray([[ (float(len(q)) if isinstance(q, str)
                                else float(np.sum(q)))
                               + (1000.0 if rerank else 0.0) + j
                               for j in range(k)] for q in qs])
        np.testing.assert_allclose(np.asarray(scores), expect)


def _item(queries, k, tenant, rerank=False):
    """Build a coalescer queue item (dispatcher tuple layout)."""
    kind = "str" if isinstance(queries[0], str) else "vec"
    return (list(queries), (k, kind), rerank, threading.Event(), {},
            tenant)


def test_coalescer_tenant_lead_rotation():
    """The lead tenant rotates round-robin: a tenant with many small
    pending requests cannot win every wakeup against another tenant's
    single larger request (pre-tenant policy picked the globally
    smallest group every time until the pass-over bound)."""
    from vsearch_tpu_torch.serve import SearchCoalescer

    co = SearchCoalescer(lambda *a, **kw: (_ for _ in ()).throw(
        AssertionError("dispatcher must stay idle")), max_queries=8)

    a1 = [_item(["a1"], 2, "A"), _item(["a2"], 2, "A"),
          _item(["a3"], 2, "A")]
    b = _item(["b0", "b1", "b2", "b3"], 3, "B")  # bigger AND rarer
    sel1 = co._select(a1 + [b])
    assert all(it[5] == "A" for it in sel1)  # first-seen tenant leads

    # next wakeup: fresh A singletons have arrived; rotation hands the
    # lead to B even though A's group is still the smaller one
    a2 = [_item(["a4"], 2, "A"), _item(["a5"], 2, "A")]
    sel2 = co._select([b] + a2)
    assert sel2 == [b]
    assert co.tenant_leads == {"A": 1, "B": 1}

    # and back to A
    sel3 = co._select(a2)
    assert all(it[5] == "A" for it in sel3)
    assert co.tenant_leads["A"] == 2


def test_coalescer_cross_tenant_coriding():
    """Same-(k, kind, rerank) requests from different tenants merge
    into ONE device call: tenant fairness must not cost coalescing
    throughput when the groups are compatible anyway."""
    from vsearch_tpu_torch.serve import SearchCoalescer

    co = SearchCoalescer(lambda *a, **kw: None, max_queries=8)
    items = [_item(["a"], 2, "A"), _item(["b"], 2, "B"),
             _item(["c"], 2, "C")]
    sel = co._select(list(items))
    assert {it[5] for it in sel} == {"A", "B", "C"}

    # budget still binds: co-riders stop at max_queries
    co2 = SearchCoalescer(lambda *a, **kw: None, max_queries=2)
    sel2 = co2._select(list(items))
    assert len(sel2) == 2 and sel2[0][5] == "A"


def test_coalescer_tenant_flood_fairness():
    """Threaded end-to-end: tenant A floods singletons; tenant B's
    incompatible (different-k) request is served within ~one rotation,
    not after the pass-over bound."""
    import time

    from vsearch_tpu_torch.serve import SearchCoalescer

    stop = threading.Event()

    def search(queries, k, rerank, n_real=None):
        time.sleep(0.03)
        ids = np.asarray([[1] * k for _ in queries])
        return ids, ids.astype(np.float32)

    co = SearchCoalescer(search, max_queries=8)

    def spammer():
        while not stop.is_set():
            co.submit(["small"], k=2, rerank=False, tenant="A")

    threads = [threading.Thread(target=spammer) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    t0 = time.time()
    ids, _ = co.submit(["b0", "b1"], k=3, rerank=False, tenant="B")
    b_wait = time.time() - t0
    stop.set()
    for t in threads:
        t.join()
    assert np.asarray(ids).shape == (2, 3)
    # rotation serves B on the wakeup after its arrival: its wait is
    # bounded by ~2 device calls, far under the pass-over fallback
    assert b_wait < 0.5
    assert co.tenant_leads["B"] >= 1


def test_search_tenant_http(server):
    """The tenant field flows HTTP -> coalescer; /stats exposes the
    per-tenant lead breakdown once real tenants appear; a non-string
    tenant is a 400, not a server error."""
    out = _post(server + "/search",
                {"queries": ["green tea"], "k": 2, "tenant": "acme"})
    assert len(out["ids"][0]) == 2
    _post(server + "/search",
          {"queries": ["mars"], "k": 2, "tenant": "globex"})
    stats = _get(server + "/stats")
    leads = stats["tenant_device_leads"]
    assert leads.get("acme", 0) >= 1 and leads.get("globex", 0) >= 1

    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server + "/search",
              {"queries": ["tea"], "tenant": 7})
    assert ei.value.code == 400


def test_coalescer_tenant_cardinality_bounded():
    """Untrusted tenant strings must not grow dispatcher state without
    bound (ADVICE r4): the rotation caps at MAX_TENANTS with idle
    tenants evicted, lead counters stay bounded (evicted counts fold
    into one aggregate), and when every slot has pending work a new
    tenant folds into the "-" bucket instead of growing the list."""
    from vsearch_tpu_torch.serve import SearchCoalescer

    co = SearchCoalescer(lambda *a, **kw: None, max_queries=8)
    cap = SearchCoalescer.MAX_TENANTS
    for i in range(cap * 3):  # one unique tenant per wakeup
        co._select([_item([f"q{i}"], 2, f"tenant-{i}")])
    assert len(co._tenant_order) <= cap
    assert len(co.tenant_leads) <= cap
    assert "-" in co._tenant_order  # fold bucket is permanent
    assert (sum(co.tenant_leads.values()) + co.evicted_tenant_leads
            == cap * 3)

    # every rotation slot busy in ONE wakeup: overflow tenants fold
    # into "-" and still co-ride the same device call
    co2 = SearchCoalescer(lambda *a, **kw: None, max_queries=512)
    pending = [_item([f"p{i}"], 2, f"t{i}") for i in range(cap + 5)]
    sel = co2._select(list(pending))
    assert len(co2._tenant_order) == cap
    assert len(sel) == len(pending)  # same group: all co-ride


def test_request_script_matches_jax_service():
    """The same request script through the JAX package's RetrieverService
    and the port's, over equal weights and the same bag-of-token index:
    ids equal and scores within 1e-4, for singles, a batch, rerank and a
    concurrent burst that the coalescers merge."""
    import jax

    from vsearch_tpu.retriever import Retriever as JRetriever
    from vsearch_tpu.retriever import RetrieverConfig as JConfig
    from vsearch_tpu.serve import RetrieverService as JService
    from vsearch_tpu_torch.models.convert import vdr_state_dict_from_flax
    from vsearch_tpu_torch.serve import RetrieverService

    tok = make_tokenizer()
    enc = {
        "type": "vdr", "max_len": 32, "topk": 16, "shift_vocab_num": 5,
        **{k: v for k, v in vars(tiny_bert_config(tok.vocab_size)).items()
           if k in ("vocab_size", "hidden_size", "num_hidden_layers",
                    "num_attention_heads", "intermediate_size",
                    "max_position_embeddings")},
    }
    j = JRetriever(JConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                           shared_encoder=True), tokenizer=tok)
    t = Retriever(RetrieverConfig(encoder_q=dict(enc), encoder_p=dict(enc),
                                  shared_encoder=True),
                  tokenizer=WordPieceTokenizer(dict(tok.vocab)),
                  device="cpu")
    params = jax.tree_util.tree_map(np.asarray,
                                    j.encoder_q.variables["params"])
    t.encoder_q.module.load_state_dict(vdr_state_dict_from_flax(params, 2))
    script = [(["green tea"], 2, False), (["red planet mars"], 3, True),
              (["einstein relativity", "dog city", "tea"], 4, False),
              (["river water"], 2, True)]
    burst = [([f"{w} tea"], 3, True) for w in ("green", "red", "big")]
    out = []
    for r, cls in ((j, JService), (t, RetrieverService)):
        r.build_index(CORPUS, batch_size=4, index_type="bag_of_token")
        svc = cls(r, default_k=3)
        got = [svc.search(q, k=k, rerank=rr) for q, k, rr in script]
        res = {}

        def client(i, svc=svc, res=res):
            q, k, rr = burst[i]
            res[i] = svc.search(q, k=k, rerank=rr)

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(len(burst))]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        out.append(got + [res[i] for i in range(len(burst))])
    for a, b in zip(*out):
        assert b["ids"] == a["ids"]
        np.testing.assert_allclose(b["scores"], a["scores"], rtol=0,
                                   atol=1e-4)


def test_step_timer_and_cpu_trace(tmp_path):
    """``utils/profiling``: the step timer's summary, and a profiler trace
    of a block on the CPU written as a Chrome trace."""
    import os

    import torch

    from vsearch_tpu_torch.utils.profiling import StepTimer, trace

    timer = StepTimer(window=4)
    for n in (1, 2, 3, 4, 5):
        with timer.step(items=n):
            pass
    s = timer.summary()
    assert s["steps"] == 5 and set(s) == {"steps", "mean_s", "p50_s",
                                          "p99_s", "items_per_s"}
    assert list(timer.items) == [2, 3, 4, 5]  # the window
    with trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_coalescer_close_answers_queued_then_stops():
    """close() answers every request queued before it, ends the dispatcher
    thread and refuses later submits."""
    import time

    from vsearch_tpu_torch.serve import SearchCoalescer

    gate, taken = threading.Event(), []

    def search(queries, k, rerank, n_real=None):
        taken.append(n_real)
        gate.wait()  # hold the first call so the rest queue behind it
        ids = np.asarray([[len(q)] * k for q in queries])
        return ids, ids.astype(np.float32)

    co = SearchCoalescer(search)
    results = {}

    def client(i):
        results[i] = co.submit(["q" * (i + 1)], k=2, rerank=False)[0]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    deadline = time.time() + 5
    while sum(taken) + co._q.qsize() < 4 and time.time() < deadline:
        time.sleep(0.01)  # every request in flight or queued
    closer = threading.Thread(target=co.close)
    closer.start()
    gate.set()
    closer.join(5)
    for t in threads:
        t.join(5)
    assert not co._thread.is_alive()
    assert {i: int(r[0, 0]) for i, r in results.items()} == {
        0: 1, 1: 2, 2: 3, 3: 4}
    with pytest.raises(RuntimeError, match="closed"):
        co.submit(["late"], k=2, rerank=False)


def test_server_close_ends_dispatcher():
    from vsearch_tpu_torch.serve import serve as make_server

    srv = make_server(None, host="127.0.0.1", port=0)
    thread = srv.service._coalescer._thread
    assert thread.is_alive()
    srv.server_close()
    thread.join(5)
    assert not thread.is_alive()


def test_listen_backlog_takes_concurrent_clients():
    """The server's listen backlog holds 40 connections that it has not
    accepted yet: with socketserver's default of 5, the kernel drops the
    rest, and each client waits out a 1 s SYN retry (seen as ~1 s tail
    latency under 16 concurrent clients on the card)."""
    import socket

    from vsearch_tpu_torch.serve import RetrieverService, make_handler
    from vsearch_tpu_torch.serve import _Server

    srv = _Server(("127.0.0.1", 0), make_handler(
        RetrieverService(None, coalesce=False)))
    socks = []
    try:
        for _ in range(40):  # nothing accepts: all wait in the backlog
            s = socket.create_connection(srv.server_address, timeout=0.5)
            socks.append(s)
    finally:
        for s in socks:
            s.close()
        srv.server_close()
    assert len(socks) == 40
