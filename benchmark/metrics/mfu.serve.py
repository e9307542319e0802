"""The served step's share of the H100's bf16 peak: the FLOPs the
window's device calls need (each real query's encoder forward at its own
token count, one add per set bit of the index and query, and with the
rerank each call's distinct candidates' forwards at their own token
counts; ``benchmark.flops``), over the window's seconds times 989
TFLOP/s."""
from benchmark import flops


def read(layers):
    if layers.get("kind") != "serve" or not layers["calls"]:
        return None
    model = layers["model"]
    v = layers["num_cols"]
    total = 0.0
    for c in layers["calls"]:
        total += sum(flops.encoder_forward_flops(t, model["bert"], v)
                     for t in c["q_tokens"] + c.get("p_tokens", []))
        total += flops.first_stage_adds(layers["set_bits"], c["real"])
    return 100.0 * total / (layers["window_s"] * flops.H100_BF16_FLOPS)
