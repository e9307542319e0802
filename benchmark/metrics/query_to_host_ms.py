"""Mean milliseconds a device call waits in the query embedding's closing
copy of the vectors to the host (``query_embed/to_host``: the host
blocked on the card), over the calls that start in the window."""
from benchmark.spans import mean_ms


def read(layers):
    return mean_ms(layers, "query_embed/to_host")
