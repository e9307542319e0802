"""No module of JAX or of the JAX package is loaded by a run (a dry run at
a tiny size on the CPU, in a process of its own), and the reference loads
nothing of the port. Names are compared by their top-level part whole:
the port's ``vsearch_tpu_torch`` is not the JAX package's
``vsearch_tpu``."""
import json
import os
import subprocess
import sys

from benchmark.harness import repo_root

FORBIDDEN = {"jax", "jaxlib", "flax", "vsearch_tpu"}


def _top_modules(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=repo_root(), capture_output=True, text=True, timeout=300,
        env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_dry_run_loads_no_jax():
    mods = _top_modules(
        "from benchmark.tests.tiny import tiny_cell, run_tiny\n"
        "out = run_tiny(tiny_cell('msmarco-rerank', rows=1500), seconds=0.5)\n"
        "assert out.attempted > 0\n"
        "from benchmark import run, sweep, control\n")
    assert "vsearch_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_modules("import benchmark.reference.vdr\n"
                        "import benchmark.checks, benchmark.corpus\n"
                        "import benchmark.weights, benchmark.flops\n")
    assert not mods & (FORBIDDEN | {"vsearch_tpu_torch"})
