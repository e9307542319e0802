"""The share of the rerank's encoder forwards that is padding: the padding
tokens (the rest of each row's length bucket, and a batch's empty rows)
over all tokens the passage encoder ran in the window's calls, from the
counts of each call's record (``rerank/forward/pad_tokens`` and
``rerank/forward/tokens``, ``encoder_base._run_batches``). A program
without the counts reads None."""


def read(layers):
    if layers.get("kind") != "serve":
        return None
    real = pad = 0
    for c in layers["calls"]:
        counts = c.get("counts") or {}
        real += counts.get("rerank/forward/tokens", 0)
        pad += counts.get("rerank/forward/pad_tokens", 0)
    return 100.0 * pad / (real + pad) if real + pad else None
