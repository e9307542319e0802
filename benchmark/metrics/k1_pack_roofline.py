"""Kernel #1's share of its roofline as the block tier repacks each block
for every call: the bound of its function on each block
(``flops.k1_pack_s``: the block's ids, as the 32-bit ids the kernel takes,
and counts read, its bits written) over the profiler's device time of its
launches, over the calls that lie whole in the traced stretch."""
from benchmark import flops
from benchmark.blocks import share_by_block


def read(layers):
    v = layers.get("num_cols")
    return share_by_block(
        layers, "k1_pack",
        lambda rows, bits, call: flops.k1_pack_s(rows, bits, v, 4))
