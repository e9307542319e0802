"""Mean milliseconds a device call spends tokenizing its rerank candidates
(the passage encoder's ``tokenize`` spans under ``rerank``, summed over
its batches), over the calls that start in the window."""
from benchmark.spans import mean_ms


def read(layers):
    return mean_ms(layers, "rerank/tokenize")
