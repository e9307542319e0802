"""Cells, configurations, traffic mixes, generators and per-layer metrics
are found by name, and BENCHMARK.json keeps to the contract's shape."""
import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_every_cell_resolves_to_its_files(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        harness.load_generator(cell.traffic["generator"])
        for m in cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_benchmark_json_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(harness.repo_root(), c["file"]))
        assert json.load(open(os.path.join(harness.repo_root(),
                                           c["file"])))["source"] == \
            c["source"]
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        # each cell that reads the metric reports what it moves
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_cell_and_a_metric_added_as_files_alone_are_picked_up(tmp_path):
    base = tmp_path / "bench"
    for d in ("configs", "traffic", "generators", "metrics"):
        (base / d).mkdir(parents=True)
    (base / "configs" / "dummy-model.json").write_text(
        json.dumps({"name": "dummy-model", "size": 3}))
    (base / "traffic" / "dummy-mix.json").write_text(
        json.dumps({"generator": "dummy_gen", "calls": 7}))
    (base / "generators" / "dummy_gen.py").write_text(
        "from benchmark.harness import Outcome\n"
        "def run(spec):\n"
        "    n = spec.cell.traffic['calls'] * spec.cell.config['size']\n"
        "    return Outcome(correct=True, attempted=n, failed=0,\n"
        "                   end_to_end={'setup_s': 1.0}, layers={'n': n},\n"
        "                   memory_peak_bytes=0, checks=[])\n")
    (base / "metrics" / "dummy.per_call.py").write_text(
        "def read(layers):\n    return layers.get('n')\n")
    bench = {"workloads": [{"name": "dummy-cell", "config": "dummy-model",
                            "traffic": "dummy-mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "dummy.per_call", "unit": "calls",
                            "workloads": ["dummy-cell"]},
                           {"name": "elsewhere", "unit": "s",
                            "workloads": ["another-cell"]}]}
    cell = harness.find_cell(bench, "dummy-cell", base=str(base))
    assert [m["name"] for m in cell.per_layer] == ["dummy.per_call"]
    gen = harness.load_generator(cell.traffic["generator"], base=str(base))
    out = gen.run(harness.RunSpec(cell=cell, seed=1, seconds=1.0,
                                  trace=False, device="cpu",
                                  process_start=0.0, log=print))
    assert out.attempted == 21
    assert harness.per_layer_values(cell, out.layers, base=str(base)) == {
        "dummy.per_call": {"value": 21.0, "unit": "calls"}}


def test_unknown_cell_is_refused(bench):
    with pytest.raises(KeyError):
        harness.find_cell(bench, "no-such-cell")
