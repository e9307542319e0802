"""Kernel #4's share of its roofline in the block tier: the bound of its
function on each block (``flops.k4_int8_bucketed_s``, at each call's real
queries) over the profiler's device time of its launches, over the calls
that lie whole in the traced stretch."""
from benchmark import flops
from benchmark.blocks import share_by_block


def read(layers):
    v = layers.get("num_cols")
    return share_by_block(
        layers, "k4_int8_bucketed",
        lambda rows, bits, call: flops.k4_int8_bucketed_s(
            rows, bits, call["real"], v))
