"""The benchmark's frozen arithmetic: the H100's published peaks and the
operations and bytes each measured piece of work needs.

Everything counts what the inputs need, never padding and never what a
particular kernel reads again: real queries, real rows, each text at its
own token count, each input byte read once and each output byte written
once. Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), at the
card's full 700 W.
"""
from __future__ import annotations

from typing import Dict, Optional

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12  # bf16 dense on the tensor cores

BUCKET_RESIDENT = 8  # kernel #3's fold (the resident path)
BUCKET_BLOCK = 16  # kernel #4's fold (the block tier)


def encoder_forward_flops(tokens: int, bert: Dict, v_out: int) -> float:
    """Matrix FLOPs of one BERT-VDR forward over a text of ``tokens``
    tokens: per token the QKVO projections (8h^2), the FFN (4 h inter),
    attention's scores and context (4 L h, with L the text's own length)
    and the vocabulary head (2 h V'); layernorms, softmax and the pooling
    are left out (``bench.py``'s count, at the text's own length and the
    unpadded V')."""
    h, inter = bert["hidden_size"], bert["intermediate_size"]
    per_tok = (bert["num_hidden_layers"] * (8 * h * h + 4 * h * inter
                                            + 4 * tokens * h)
               + 2 * h * v_out)
    return float(tokens * per_tok)


def bound_s(nbytes: float, ops: float, peak_ops: float = H100_F32_FLOPS
            ) -> float:
    """The least seconds of a piece of work on an H100: its bytes at
    3.35 TB/s or its operations at ``peak_ops``, the larger (the rule of
    the repository's ``score_bounds``)."""
    return max(nbytes / H100_BYTES_PER_S, ops / peak_ops)


def bits_bytes(rows: int, num_cols: int) -> float:
    """Bytes of ``rows`` rows of the bit matrix, ``num_cols`` bits each."""
    return rows * num_cols / 8.0


def k3_bucketed_s(rows: int, set_bits: int, queries: int, num_cols: int,
                  bucket: int = BUCKET_RESIDENT) -> float:
    """Kernel #3 (scores spliced with the row id, max-folded by
    ``bucket``): the words read once, the bf16 query operand read once,
    the int32 keys written once; one f32 add per set bit and query."""
    nbytes = (bits_bytes(rows, num_cols) + num_cols * queries * 2
              + -(-rows // bucket) * queries * 4)
    return bound_s(nbytes, set_bits * queries)


def k4_int8_bucketed_s(rows: int, set_bits: int, queries: int,
                       num_cols: int, bucket: int = BUCKET_BLOCK) -> float:
    """Kernel #4: as #3 with an int8 query operand and bucket 16."""
    nbytes = (bits_bytes(rows, num_cols) + num_cols * queries
              + -(-rows // bucket) * queries * 4)
    return bound_s(nbytes, set_bits * queries)


def k1_pack_s(rows: int, set_bits: int, num_cols: int,
              id_bytes: int = 4) -> float:
    """Kernel #1 (ELL rows to bits): each row's ids (``id_bytes`` each)
    and its count read once, its bits written once."""
    return bound_s(set_bits * id_bytes + rows * 4
                   + bits_bytes(rows, num_cols), 0.0)


def first_stage_adds(set_bits: int, queries: int) -> float:
    """One add per set bit of the index and query."""
    return float(set_bits) * queries


def share(bound_seconds: float, seconds: float) -> Optional[float]:
    """A roofline share in %, or None when nothing was timed."""
    if seconds <= 0:
        return None
    return 100.0 * bound_seconds / seconds
