"""Mean milliseconds a device call spends fetching its rerank candidates'
texts (``rerank/fetch``: the distinct ids, ``get_sample``, the length
sort), over the calls that start in the window."""
from benchmark.spans import mean_ms


def read(layers):
    return mean_ms(layers, "rerank/fetch")
