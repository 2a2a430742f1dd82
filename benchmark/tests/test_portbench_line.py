"""The result line: the contract's keys, the compared numbers last, in
the window and in the traced run; and no result without a card or a
program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import HOME, ROOT, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["tiny_mesh.tiny", "tiny_grid.knight"])
def test_result_line_keys(tiny_root, cell, trace):
    rc, out, err = run_tiny(tiny_root, cell, trace=trace)
    assert rc == 0
    result = json.loads(out[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(result) == want
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, v in result["metrics"].items():
        assert set(v) == {"value", "unit"}
    compared = result["compared"]
    assert compared and all(set(v) == {"value", "limit"}
                            for v in compared.values())
    tail = err.strip().splitlines()[-len(compared):]
    assert [line.split()[1] for line in tail] == list(compared)
    # Everything before the result is a JSON line of its own.
    for line in out[:-1]:
        json.loads(line)


def test_end_to_end_metrics_of_the_window(tiny_root):
    rc, out, _ = run_tiny(tiny_root, "tiny_grid.knight", seconds=0.5)
    result = json.loads(out[-1])
    assert set(result["metrics"]) == {"setup_s", "call_ms_p95.host"}
    rc, out, _ = run_tiny(tiny_root, "tiny_mesh.tiny", seconds=0.5)
    m = json.loads(out[-1])["metrics"]
    assert set(m) == {"setup_s", "solves_per_s", "call_ms_p95"}
    assert m["solves_per_s"]["value"] > 0


def _run_script(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mesh1k.mc16k",
         "--seed", "1", "--seconds", "1", *extra], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_result_without_the_card_or_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark,
    and here without a card, the run exits non-zero and prints no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HOME, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (tmp_path, ROOT):
        proc = _run_script(cwd)
        if proc.returncode == 0:
            pytest.fail(f"exit 0 in {cwd}: {proc.stdout[-500:]}")
        assert '"correct"' not in proc.stdout
