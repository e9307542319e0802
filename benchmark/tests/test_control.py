"""The comparison's control at a size a test holds: the plain reference
in fp8 (the precision below the configurations' bf16) answering in the
program's place reads above the program's own run on the number each
cell compares first, and the float32 reference in its place reads 0. A
two-layer, 64-wide model separates the precisions less than BERT-base:
the limits come from the card at the cells' own sizes, where the control
reads 8-19x the program (``python3 -m benchmark.control --workload
<cell> --seeds ...``; PERF.md)."""
import pytest

from benchmark import control
from benchmark.tests.tiny import run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["msmarco-first-stage",
                                  "wiki21m-first-stage", "msmarco-rerank"])
def test_the_control_reads_far_above_the_program(name):
    cell = tiny_cell(name)
    out = run_tiny(cell)
    program = {c["name"]: c["value"] for c in out.checks}
    lower = control.control_numbers(cell, 2 ** 31 + 11, 1.0, "cpu")
    exact = control.control_numbers(cell, 2 ** 31 + 11, 1.0, "cpu", "f32")
    assert out.correct
    assert max(exact[n] for n in program) == 0.0
    first = next(iter(cell.traffic["limits"]))
    assert lower[first] > 1.5 * program[first]
