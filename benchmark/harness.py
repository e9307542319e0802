"""Finding a cell's parts by name, and running its per-layer readers.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic mix; each is a file of its own here:

- ``configs/<config>.json``: the model and corpus, as they are run;
- ``traffic/<traffic>.json``: the mix's parameters, whose ``generator``
  names ``generators/<generator>.py`` (it has ``run(RunSpec) -> Outcome``);
- ``metrics/<metric>.py``: a per-layer reader, ``read(outcome.layers)``,
  which returns a number or None when it finds nothing to read.

A later cell or metric is added as files and ``BENCHMARK.json`` entries
alone.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def repo_root() -> str:
    return os.path.dirname(HERE)


def load_benchmark(root: Optional[str] = None) -> Dict:
    with open(os.path.join(root or repo_root(), "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(kind: str, name: str, base: str = HERE) -> Dict:
    with open(os.path.join(base, kind, f"{name}.json")) as f:
        return json.load(f)


def load_config(name: str, base: str = HERE) -> Dict:
    return _read_json("configs", name, base)


def load_traffic(name: str, base: str = HERE) -> Dict:
    return _read_json("traffic", name, base)


def _module_from(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_generator(name: str, base: str = HERE):
    """``generators/<name>.py``, as a module of this package (it may
    import the benchmark's other modules relatively)."""
    return _module_from(os.path.join(base, "generators", f"{name}.py"),
                        f"benchmark.generators.{name}")


def load_reader(name: str, base: str = HERE) -> Callable:
    """``metrics/<name>.py``'s ``read`` (a name may hold dots)."""
    mod = _module_from(os.path.join(base, "metrics", f"{name}.py"),
                       "bench_metric_" + name.replace(".", "_"))
    return mod.read


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: Dict, name: str, base: str = HERE) -> Cell:
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=load_config(w["config"], base),
                traffic=load_traffic(w["traffic"], base),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


@dataclasses.dataclass
class RunSpec:
    """What a generator is asked to run."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    process_start: float  # time.time() of the process's start
    log: Callable[[str], None]


@dataclasses.dataclass
class Outcome:
    """What a generator hands back."""

    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    layers: Any  # what the per-layer readers read
    memory_peak_bytes: int
    checks: List[Dict]  # [{"name", "value", "limit"}], each value <= limit
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict] = None


def per_layer_values(cell: Cell, layers, base: str = HERE) -> Dict[str, Any]:
    """{metric: {"value", "unit"}} of every reader that found something."""
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"], base)(layers)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
