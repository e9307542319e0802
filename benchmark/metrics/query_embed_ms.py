"""Mean milliseconds a device call spends in the query embedding (the query
encoder's forward, its top-k and lexical mask, and the copy of the
vectors to the host), over the calls that start in the window:
``Retriever.last_timings["query_embed"]``, read after each call (a host
clock around a stage that ends in a copy to the host)."""


def read(layers):
    if layers.get("kind") != "serve":
        return None
    got = [c["timings"]["query_embed"] for c in layers["calls"]
           if "query_embed" in c["timings"]]
    return 1e3 * sum(got) / len(got) if got else None
