"""Find a served cell's knee: one set-up, then a window at each offered
rate, in order, through a fresh service each (no correctness check).

    python3 -m benchmark.sweep --workload <cell> --seed <n> --seconds <s> \\
        --rates 400,600,800

One JSON line a rate on standard output: the rate offered, queries
answered a second, latency p50/p95, the backlog ratio (median latency of
the window's last quarter of requests over its first), the generator's
lateness, and the coalesced calls' mean batch. The knee is the highest
rate whose answered rate keeps up and whose backlog does not grow.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys

from benchmark import harness
from benchmark.run import log, process_start, set_cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    set_cache_dirs(harness.repo_root())
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        log("no card")
        return 2
    gen = harness.load_generator(cell.traffic["generator"])
    from benchmark import corpus as corpus_mod

    spec = harness.RunSpec(cell=cell, seed=args.seed, seconds=args.seconds,
                           trace=False, device="cuda:0",
                           process_start=process_start(), log=log)
    sys_ = gen.prepare(spec)
    log(f"set-up parts: {sys_['parts']}")
    for j, rate in enumerate(float(r) for r in args.rates.split(",")):
        traffic = copy.deepcopy(cell.traffic)
        traffic["rate_qps"] = rate
        queries = corpus_mod.make_queries(traffic, args.seed + j,
                                          args.seconds)
        n_calls = len(sys_["recorder"].calls)
        res = gen.serve_window(sys_, traffic, queries, args.seconds)
        m = gen.window_metrics(res)
        calls = sys_["recorder"].calls[n_calls:]
        print(json.dumps({
            "rate_qps": rate, "qps": m["qps"],
            "latency_p50_ms": m["latency_p50_ms"],
            "latency_p95_ms": m["latency_p95_ms"],
            "backlog_ratio": m["backlog_ratio"],
            "failed": int(m["failed_mask"].sum()),
            "requests": m["requests"], "late_max_s": m["late_max_s"],
            "late_p95_s": m["late_p95_s"],
            "mean_batch": (sum(c["real"] for c in calls) / len(calls)
                           if calls else 0.0),
            "calls": len(calls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
