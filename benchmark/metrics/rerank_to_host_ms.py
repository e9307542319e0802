"""Mean milliseconds a device call waits in the rerank's closing copy of
the rescored candidates to the host (``rerank/to_host``), over the calls
that start in the window."""
from benchmark.spans import mean_ms


def read(layers):
    return mean_ms(layers, "rerank/to_host")
