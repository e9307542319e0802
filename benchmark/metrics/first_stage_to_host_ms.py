"""Mean milliseconds a device call waits in the first stage's closing copy
of ids and scores to the host (``first_stage/to_host``: the host blocked
on the index's kernels and top-k), over the calls that start in the
window."""
from benchmark.spans import mean_ms


def read(layers):
    return mean_ms(layers, "first_stage/to_host")
