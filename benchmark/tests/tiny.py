"""Cells of the benchmark cut to a size the CPU runs in seconds (tests
only): a two-layer, 64-wide BERT, a few thousand passages and a short
window, with the port's plain (CPU) versions of its kernels."""
from __future__ import annotations

import copy
import time

from benchmark import harness

TINY_BERT = {"hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 128}


def tiny_cell(name: str, rows: int = 3000, rate: float = 20.0) -> harness.Cell:
    cell = harness.find_cell(harness.load_benchmark(), name)
    cfg = copy.deepcopy(cell.config)
    cfg["model"]["bert"].update(TINY_BERT)
    cfg["corpus"]["passages"] = rows
    if cfg["index"]["tier"] == "block":
        cfg["index"]["search_mode"] = "block"
        cfg["index"]["attributes"] = {"stream_block_rows": 1024}
    cell.config = cfg
    traffic = copy.deepcopy(cell.traffic)
    traffic.update(rate_qps=rate, lead_seconds=0.3, tail_seconds=0.3,
                   clients=16, check_sample=4,
                   trace_seconds=0.3)
    cell.traffic = traffic
    return cell


def run_tiny(cell: harness.Cell, seed: int = 2 ** 31 + 11,
             seconds: float = 1.0, trace: bool = False):
    spec = harness.RunSpec(cell=cell, seed=seed, seconds=seconds,
                           trace=trace, device="cpu",
                           process_start=time.time(), log=lambda m: None)
    return harness.load_generator(cell.traffic["generator"]).run(spec)
