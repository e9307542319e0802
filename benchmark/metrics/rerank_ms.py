"""Mean milliseconds a device call spends in the rerank (the candidates'
texts fetched, tokenized, embedded by the passage encoder and rescored),
over the calls that start in the window:
``Retriever.last_timings["rerank"]``, read after each call (a host clock
around a stage that ends in a copy to the host)."""


def read(layers):
    if layers.get("kind") != "serve":
        return None
    got = [c["timings"]["rerank"] for c in layers["calls"]
           if "rerank" in c["timings"]]
    return 1e3 * sum(got) / len(got) if got else None
