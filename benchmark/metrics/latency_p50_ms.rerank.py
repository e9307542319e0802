"""The 50th-percentile request latency of a beta-search (rerank) window,
taken as ``latency_p50_ms`` is: from each request's due time to its
answer, over every request due in the window, on the host's clock. These
cells report it per layer, where its runs spread too widely for an
end-to-end bound. A ``--trace 1`` run takes it over the requests due
before the profiler starts, whose stop stalls the sender."""


def read(layers):
    if layers.get("kind") != "serve":
        return None
    return layers["latency_ms"]["p50"]
