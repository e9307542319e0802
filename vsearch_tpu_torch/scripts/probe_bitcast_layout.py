"""The uint32 -> bf16 row layout of P1 (counterpart of
``scripts/probe_bitcast_layout.py``).

    python -m vsearch_tpu_torch.scripts.probe_bitcast_layout [--device cpu]

The TPU probe asked where ``pltpu.bitcast(x [S, L] uint32, bf16)`` puts
the two halves of word (s, l) in its [2S, L] output, and the TPU answered
layout A: the low half at row 2s, the high half at row 2s + 1 (B, blocked,
would put them at rows s and S + s). CUDA has no such primitive: a bf16 is
16 bits of memory wherever a kernel writes it. So on the GPU this is a
check of the port's own layout convention, the one P1
(``ops.probes.bitcast_rows``, ``csrc/probe_bitcast.cu``) writes by hand,
not of the hardware. The words are the TPU probe's: low half bf16(1 +
s/256), high half bf16(2 + s/256).
"""
from __future__ import annotations

import torch

from ..ops import probes
from . import common

S, L = 8, 128


def layout_words(s: int = S, l: int = L) -> torch.Tensor:
    """[s, l] int32 words: low half the bf16 bits of 1 + row/256, high
    half those of 2 + row/256."""
    row = torch.arange(s, dtype=torch.float32)[:, None].expand(s, l)

    def bits(x):
        return x.contiguous().to(torch.bfloat16).view(torch.int16).to(
            torch.int32) & 0xFFFF

    return bits(1.0 + row / 256) | (bits(2.0 + row / 256) << 16)


def main(argv=None) -> dict:
    args, dev, out = common.start(__doc__, argv)
    x = layout_words().to(dev)
    got = probes.bitcast_rows(x)
    want = probes.bitcast_rows_plain(x)
    rows = got[:, 0].float().cpu()
    s = torch.arange(S, dtype=torch.float32)
    interleaved = bool(
        torch.allclose(rows[0::2], 1.0 + s / 256, atol=1e-2)
        and torch.allclose(rows[1::2], 2.0 + s / 256, atol=1e-2))
    blocked = bool(torch.allclose(rows[:S], 1.0 + s / 256, atol=1e-2)
                   and torch.allclose(rows[S:], 2.0 + s / 256, atol=1e-2))
    out.update({
        "shape": [S, L], "out_rows_lane0": [round(float(v), 4)
                                            for v in rows],
        "interleaved_A": interleaved, "blocked_B": blocked,
        "layout": "A" if interleaved else "B" if blocked else "neither",
        "check": common.compare(got, want),
        "ms": common.time_ms(lambda: probes.bitcast_rows(x), dev,
                              args.iters),
        "plain_ms": common.time_ms(lambda: probes.bitcast_rows_plain(x),
                                    dev, args.iters),
        **common.bound(x.numel() * 4 * 2)})
    return common.emit(out, args.out)


if __name__ == "__main__":
    main()
