"""BENCHMARK.json against the benchmark's contract, and every part of
every cell found by name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import HOME, ROOT, run_tiny
from portbench.spec import Bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and w["config"] in names
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    names += CELLS
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    bench = Bench(ROOT, HOME)
    c = bench.cell(cell)
    for attr in ("Driver",):
        assert hasattr(c.driver, attr)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(bench.metric(m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in e2e  # reported beside what it moves


def test_a_new_entry_takes_only_files(tiny_root):
    """A configuration, a traffic mix, a driver kind and a metric that
    exist only here are found by name and run, with no file of the
    benchmark changed."""
    home = tiny_root / "benchmark"
    (home / "drivers" / "sweep_twice.py").write_text(
        "from portbench_drivers__sweep import Driver as _D\n"
        "class Driver(_D):\n"
        "    pass\n")
    (home / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n"
        "    return ctx.window.calls if ctx.window else None\n")
    conf = json.loads((home / "configs" / "tiny_mesh.json").read_text())
    conf.update(name="tiny_mesh2", driver="sweep_twice")
    (home / "configs" / "tiny_mesh2.json").write_text(json.dumps(conf))
    (home / "traffic" / "tiny2.json").write_text(json.dumps(
        {"batch": 3, "pool": 1, "warm_calls": 1, "trace_calls": 1,
         "check_calls": 2, "check_rows": 3}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_mesh2", "source": "test",
                            "file": "benchmark/configs/tiny_mesh2.json",
                            "reduced": []})
    spec["workloads"].append({"name": "tiny_mesh2.tiny2",
                              "config": "tiny_mesh2", "traffic": "tiny2",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "calls_in_window", "unit": "count",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny_mesh2.tiny2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    # The tiny copy's own driver must be the one loaded.
    Bench(tiny_root, home).cell("tiny_mesh.tiny")
    try:
        rc, out, _ = run_tiny(tiny_root, "tiny_mesh2.tiny2")
    finally:
        spec["end_to_end"].pop()
        spec["workloads"].pop()
        spec["configs"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = json.loads(out[-1])
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"setup_s", "calls_in_window"}
    assert result["metrics"]["calls_in_window"]["value"] == \
        result["attempted"]
