"""The block tier's row blocks, for the readers of its kernels: each
call packs (kernel #1) and scores (kernel #4) every block once, in row
order."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .trace import complete_calls, kernels_matching


def block_sizes(nnz: np.ndarray, block_rows: int) -> List[Tuple[int, int]]:
    """[(rows, set bits)] of each block of ``block_rows`` rows."""
    starts = np.arange(0, len(nnz), block_rows)
    bits = np.add.reduceat(nnz.astype(np.int64), starts)
    rows = np.minimum(block_rows, len(nnz) - starts)
    return list(zip(rows.tolist(), bits.tolist()))


def share_by_block(layers, family: str, bound_of) -> float:
    """Roofline share in % of a kernel ``family`` launched once a block in
    each call: ``bound_of(rows, set bits, call)`` summed over the blocks of
    the calls that lie whole in the stretch, over their device time."""
    from . import flops

    data = layers.get("trace")
    if data is None or layers.get("tier") != "block":
        return None
    blocks = block_sizes(layers["nnz"], layers["block_rows"])
    bound = spent = 0.0
    for call, kernels in complete_calls(data, layers["calls"]):
        times = kernels_matching(kernels, family)
        if len(times) != len(blocks):
            continue
        bound += sum(bound_of(r, b, call) for r, b in blocks)
        spent += sum(times)
    return flops.share(bound, spent) if spent > 0 else None
