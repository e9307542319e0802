"""The granite-4.0-h cell cut to a size the CPU runs in seconds (tests
only): a three-layer (Mamba-2, attention, Mamba-2), 64-wide trunk over the
full 100,352-entry vocabulary, a few thousand short passages, 10
candidates a query and a short window, with the port's plain (CPU)
kernels."""
from __future__ import annotations

import copy

from benchmark import harness

CELL = "beir-nq-granite-rerank"
TINY_TRUNK = {"hidden_size": 64, "shared_intermediate_size": 128,
              "layer_types": ["mamba", "attention", "mamba"],
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "mamba_n_heads": 4, "mamba_d_head": 16, "mamba_d_state": 16}


def tiny_granite_cell(rows: int = 2000, rate: float = 3.0) -> harness.Cell:
    cell = harness.find_cell(harness.load_benchmark(), CELL)
    cfg = copy.deepcopy(cell.config)
    cfg.update(TINY_TRUNK)
    cfg["corpus"]["passages"] = rows
    cfg["corpus"]["passage_words"].update(median=12, max=30)
    cell.config = cfg
    traffic = copy.deepcopy(cell.traffic)
    traffic.update(rate_qps=rate, k=10, lead_seconds=0.3, tail_seconds=0.3,
                   clients=16, check_sample=4, warm_rerank_batch=2,
                   trace_seconds=0.3)
    cell.traffic = traffic
    return cell
