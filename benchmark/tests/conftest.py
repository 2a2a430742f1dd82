"""Tests of the port's benchmark: ``python -m pytest benchmark/tests``.

On the CPU they drive whole runs at tiny sizes (a 5×8 mesh at B 4, a 32²
grid) from a copy of the benchmark with test-only configurations.  Tests
marked ``chip`` run the real cells on an NVIDIA GPU and skip without one:
the test decides, never the import.
"""

from __future__ import annotations

import io
import json
import shutil
import sys
from pathlib import Path

import pytest

HOME = Path(__file__).resolve().parents[1]
ROOT = HOME.parent
for p in (str(ROOT), str(HOME)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_SEED = 2 ** 31 + 12345


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU (CUDA); skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def tiny_bench(tmp: Path) -> Path:
    """A copy of the benchmark whose ``BENCHMARK.json`` adds tiny cells
    made of test-only configuration and traffic files, each metric
    listing them beside the real cells: a 5×8 mesh at B 4 (``tiny_mesh``)
    and a 32² grid (``tiny_grid``)."""
    root = tmp / "bench"
    shutil.copytree(HOME, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    home = root / "benchmark"
    mesh = json.loads((home / "configs" / "mesh1k.json").read_text())
    mesh.update(name="tiny_mesh")
    mesh["circuit"].update(rows=5, cols=8)
    grid = json.loads((home / "configs" / "grid1024.json").read_text())
    grid.update(name="tiny_grid", h=32, w=32)
    for c in (mesh, grid):
        (home / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
        spec["configs"].append({"name": c["name"], "source": "test",
                                "file": f"benchmark/configs/{c['name']}.json",
                                "why": "test",
                                "reduced": []})
    (home / "traffic" / "tiny.json").write_text(json.dumps(
        {"batch": 4, "pool": 2, "warm_calls": 1, "trace_calls": 2,
         "check_calls": 3, "check_rows": 4}))
    (home / "traffic" / "tiny_knight.json").write_text(json.dumps(
        {"offset": [1, 2], "pool": 3, "region": 0.5, "warm_calls": 1,
         "trace_calls": 2}))
    # Each tiny cell reports what the real cell it mirrors reports.
    tiny = {"tiny_mesh.tiny": ("tiny_mesh", "tiny", "mesh1k.mc16k"),
            "tiny_grid.knight": ("tiny_grid", "tiny_knight",
                                 "grid1024.knight")}
    for name, (config, traffic, _) in tiny.items():
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w for w, (_, _, mirror) in tiny.items()
                               if mirror in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_bench(tmp_path_factory.mktemp("portbench"))


def run_tiny(root: Path, workload: str, *, trace: bool = False,
             seconds: float = 0.3, seed: int = TINY_SEED, control=False):
    """One CPU run of a tiny cell: (exit code, stdout lines, stderr)."""
    import torch

    from portbench import runner
    from portbench.spec import Bench

    out, err = io.StringIO(), io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = runner.run(Bench(root, root / "benchmark"), workload, seed,
                        seconds, trace, device="cpu", control=control,
                        out=out, err=err)
    finally:
        torch.set_num_threads(threads)
    return rc, out.getvalue().splitlines(), err.getvalue()
