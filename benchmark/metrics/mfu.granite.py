"""A granite-4.0-h cell's served step's share of the H100's bf16 peak: the
FLOPs the window's device calls need (each real query's and each distinct
candidate's granite-VDR forward at its own token count,
``flops_granite.encoder_forward_flops``, and one add per set bit of the
index and query), over the window's seconds times 989 TFLOP/s."""
from benchmark import flops, flops_granite


def read(layers):
    if (layers.get("kind") != "serve" or layers.get("trunk") != "granite_hybrid"
            or not layers["calls"]):
        return None
    g, v = layers["model"], layers["num_cols"]
    total = 0.0
    for c in layers["calls"]:
        total += sum(flops_granite.encoder_forward_flops(t, g, v)
                     for t in c["q_tokens"] + c.get("p_tokens", []))
        total += flops.first_stage_adds(layers["set_bits"], c["real"])
    return 100.0 * total / (layers["window_s"] * flops.H100_BF16_FLOPS)
