"""A short run of each cell's command on the card (skips without one):
the result line's shape, and ``correct``."""
import json
import subprocess
import sys

import pytest

from benchmark import harness

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_prints_a_correct_result(card, trace):
    bench = harness.load_benchmark()
    name = bench["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace",
         str(trace)], cwd=harness.repo_root(), capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert line["device"]["busy_s"] > 0
