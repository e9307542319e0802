"""Mean milliseconds a device call spends in the first stage (the index's
search: kernel #3 on the resident bits, or #1 and #4 a block in the
block tier, and the top-k), over the calls that start in the window:
``Retriever.last_timings["first_stage"]``, read after each call (a host
clock around a stage that ends in a copy to the host)."""


def read(layers):
    if layers.get("kind") != "serve":
        return None
    got = [c["timings"]["first_stage"] for c in layers["calls"]
           if "first_stage" in c["timings"]]
    return 1e3 * sum(got) / len(got) if got else None
