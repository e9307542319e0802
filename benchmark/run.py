"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Progress and the set-up's parts go to standard error; the last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit, also the last
lines of standard error). ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled stretch of
the window. Without a CUDA card, or with fewer cards than the cell asks
for, it prints no result and exits 2; if JAX, flax or the JAX package
were loaded, it exits 3.
"""
from __future__ import annotations

import time

PROCESS_T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vsearch_tpu")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``), else
    when this module was first run."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
        # /proc's clock counts whole seconds since boot: keep it only when
        # it agrees with this module's own start
        return start if 0 <= PROCESS_T0 - start < 5 else PROCESS_T0
    except (OSError, ValueError, IndexError, StopIteration):
        return PROCESS_T0


def set_cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so a
    second run of a cell finds every kernel built."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_line(torch, chips: int, outcome) -> dict:
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    if outcome.busy_s is not None:
        dev["busy_s"] = outcome.busy_s
        dev["window_s"] = outcome.window_s
    return dev


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    root = harness.repo_root()
    set_cache_dirs(root)
    bench = harness.load_benchmark(root)
    cell = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: no card to run on")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell asks for {cell.chips} cards; "
            f"{torch.cuda.device_count()} are present")
        return 2
    generator = harness.load_generator(cell.traffic["generator"])
    start = process_start()
    log(f"process start to the cell's run: {time.time() - start:.3f} s "
        "(interpreter, torch, BENCHMARK.json)")
    spec = harness.RunSpec(cell=cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda:0",
                           process_start=start, log=log)
    outcome = generator.run(spec)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    if args.trace:
        metrics = harness.per_layer_values(cell, outcome.layers)
    else:
        metrics = {m["name"]: {"value": float(outcome.end_to_end[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    result = {"correct": bool(outcome.correct),
              "attempted": int(outcome.attempted),
              "failed": int(outcome.failed), "metrics": metrics,
              "device": device_line(torch, cell.chips, outcome)}
    if args.trace and outcome.breakdown is not None:
        result["breakdown"] = outcome.breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in outcome.checks}
    for c in outcome.checks:
        log(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
