"""Kernel #3's share of its roofline on the resident index: the bound of
its function (``flops.k3_bucketed_s``, at each call's real queries) over
the profiler's device time of its launches, summed over the calls that
lie whole in the traced stretch."""
from benchmark import flops
from benchmark.trace import complete_calls, kernels_matching


def read(layers):
    data = layers.get("trace")
    if data is None or layers.get("tier") != "resident":
        return None
    bound = spent = 0.0
    for call, kernels in complete_calls(data, layers["calls"]):
        times = kernels_matching(kernels, "k3_bucketed")
        if len(times) != 1:
            continue
        bound += flops.k3_bucketed_s(layers["rows"], layers["set_bits"],
                                     call["real"], layers["num_cols"])
        spent += times[0]
    return flops.share(bound, spent) if spent > 0 else None
