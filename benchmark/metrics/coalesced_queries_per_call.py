"""Real queries a coalesced device call of ``SearchCoalescer`` serves over
the window: ``RetrieverService.search_timer``'s ``total_items`` over its
``total_steps``, both taken at the window's open and close."""


def read(layers):
    timer = layers.get("timer") if layers.get("kind") == "serve" else None
    if timer is None:
        return None
    (s0, i0), (s1, i1) = timer
    return (i1 - i0) / (s1 - s0) if s1 > s0 else None
