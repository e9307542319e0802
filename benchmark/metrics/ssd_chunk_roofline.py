"""The Mamba-2 chunk-scan kernel's (``ssd_chunk``) share of its roofline
in a granite-4.0-h cell: the bound of its function over every text a call
embeds (``flops_granite.ssd_chunk_s``: each real query's and each distinct
candidate's own tokens, in every Mamba-2 layer; the largest of its bytes at
3.35 TB/s, its pair products at the bf16 tensor-core rate and its conv and
skip at the f32 rate) over the profiler's device time of its launches,
summed over the calls that lie whole in the traced stretch."""
from benchmark import flops_granite
from benchmark.flops import share
from benchmark.trace import _is, complete_calls

_SSD = _is("ssd_chunk_kernel")


def read(layers):
    data = layers.get("trace")
    if data is None or layers.get("trunk") != "granite_hybrid":
        return None
    bound = spent = 0.0
    for call, kernels in complete_calls(data, layers["calls"]):
        times = [s for name, s in kernels if _SSD(name)]
        if not times:
            continue
        bound += flops_granite.ssd_chunk_s(
            call["q_tokens"] + call.get("p_tokens", []), layers["model"])
        spent += sum(times)
    return share(bound, spent) if spent > 0 else None
