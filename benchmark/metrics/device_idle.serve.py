"""Share of the traced stretch of a served window in which no operation
ran on the card (the profiler's kernels, copies and sets, merged)."""


def read(layers):
    data = layers.get("trace")
    if data is None or layers.get("kind") != "serve":
        return None
    return 100.0 * (1.0 - data.busy_s / data.window_s)
