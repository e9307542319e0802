"""Mean milliseconds a device call spends tokenizing its queries (the
query encoder's ``tokenize`` spans under ``query_embed``, summed over its
batches), over the calls that start in the window."""
from benchmark.spans import mean_ms


def read(layers):
    return mean_ms(layers, "query_embed/tokenize")
