"""Mean milliseconds a real query waits in the serving layer's queue: from
``SearchCoalescer.submit`` putting its chunk on the queue to the start of
the device call that serves it (``serve/queue_wait``, the sum of the
call's real queries' waits), summed over the window's calls over their
real queries."""
from benchmark.spans import per_query_ms


def read(layers):
    return per_query_ms(layers, "serve/queue_wait")
