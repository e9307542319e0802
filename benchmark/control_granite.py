"""The control of a granite-4.0-h cell's comparison, on the card at the
cell's own size: the plain reference computed in fp8 (the precision below
the configuration's bf16) answers in the program's place, held to the
float32 reference by the same numbers as a run's (``control.py``'s rule
for the BERT cells).

    python3 -m benchmark.control_granite --workload <cell> \\
        --seeds 1,2,3 --seconds <s>

One JSON line a seed: the numbers and whether each is over its limit.
The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np

from benchmark import checks_granite, harness
from benchmark import corpus_granite, vocab_granite, weights_granite
from benchmark.run import log


def control_numbers(cell, seed: int, seconds: float, device,
                    precision: str = "fp8"):
    """The control's numbers for ``seed``: the run's corpus, weights,
    queries and sample, answered by the reference at ``precision``."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    model = cfg["model"]
    vocab = vocab_granite.build_vocab()
    tok_table = vocab_granite.word_token_ids(vocab)
    weights = weights_granite.make_encoders(cfg, 2, seed, device,
                                            getattr(torch, model["dtype"]),
                                            model["initializer_range"])
    corpus = corpus_granite.make_corpus(
        cfg["corpus"]["passages"], cfg["corpus"]["passage_words"], seed + 1,
        device, model["shift_vocab_num"], tok_table,
        keep_words=bool(traffic["rerank"]),
        col_dtype=getattr(torch, cfg["index"]["ell_dtype"]))
    queries = corpus_granite.make_queries(traffic, seed, seconds)
    due = queries.due
    in_window = np.nonzero((due >= 0) & (due < seconds))[0]
    sample = checks_granite.draw_sample(in_window, queries, seed,
                                        int(traffic["check_sample"]))
    return checks_granite.control(cfg, traffic, corpus, weights, tok_table,
                                  vocab, [queries.words[i] for i in sample],
                                  device, precision)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--precision", default="fp8")
    args = ap.parse_args(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no card")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(cell, seed, args.seconds,
                                  torch.device("cuda:0"), args.precision)
        over = {n: numbers[n] > lim
                for n, lim in cell.traffic["limits"].items()}
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "precision": args.precision,
                          "numbers": numbers,
                          "over_limit": over,
                          "fails": any(over.values())}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
