"""On the card: every cell of BENCHMARK.json runs as a fresh process and
comes out correct, traced and not; and its check's control (a lower
precision in the program's place) comes out not correct on three seeds.

    python -m pytest benchmark/tests -m chip
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def run_cell(cell, seed, *, trace=0, control=0, seconds=2):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace),
         "--control", str(control)], cwd=ROOT, capture_output=True,
        text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cuda, cell, trace):
    result = run_cell(cell, 2 ** 31 + 101 + trace, trace=trace)
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("seed", [2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda, cell, seed):
    result = run_cell(cell, seed, control=1)
    assert result["correct"] is False, result["compared"]
