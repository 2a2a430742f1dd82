"""The block-tier sweep on the CPU: a tiny random-network cell (300 nodes,
1200 draws, the smallest of ``randnet1k``'s class whose ``auto`` tier is
``block``) runs whole through the harness and comes out correct, traced
and not; the control (the raw f32 tier) makes ``correct`` false; the
driver refuses another tier; the reference's rows are the repo's random
network; the blocked-LU bounds hold fixed values at the cell's shape."""

from __future__ import annotations

import hashlib
import json

import pytest

from conftest import TINY_SEED, run_tiny, tiny_bench
from reference.randnet import randnet_rows
from roofline.block_lu import lu_factor_bound, lu_substitution_bound

CELL = "tiny_randnet.tiny"

#: sha256 of ``json.dumps(chip_smoke.randnet_rows())``: 4021 rows.
RANDNET1K_DIGEST = \
    "d5d7d62d5bdf796f5edd7cb5738d53d04a7396e5288d014682c9461170c4e043"


def _config(home, **circuit):
    conf = json.loads((home / "configs" / "randnet1k.json").read_text())
    conf.update(name="tiny_randnet")
    conf["circuit"].update(circuit)
    return conf


@pytest.fixture(scope="module")
def randnet_root(tmp_path_factory):
    """``tiny_bench`` with a tiny random-network cell that reports what
    ``randnet1k.mc4k`` reports."""
    root = tiny_bench(tmp_path_factory.mktemp("portbench_randnet"))
    home = root / "benchmark"
    conf = _config(home, nodes=300, edges=1200)
    (home / "configs" / "tiny_randnet.json").write_text(json.dumps(conf))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_randnet", "source": "test",
                            "file": "benchmark/configs/tiny_randnet.json",
                            "why": "test", "reduced": []})
    spec["workloads"].append({"name": CELL, "config": "tiny_randnet",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "randnet1k.mc4k" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_randnet_cell_is_correct(randnet_root, trace):
    rc, out, err = run_tiny(randnet_root, CELL, trace=trace)
    assert rc == 0, err[-2000:]
    result = json.loads(out[-1])
    assert result["correct"] is True, result["compared"]
    assert result["compared"]["max_rel_err"]["value"] <= 1e-6
    if trace:
        # The CPU has no device times and no library kernels.
        assert {"contract_passes.sweep", "kernels_per_call.sweep",
                "device_idle.sweep"} <= set(result["metrics"])
        assert result["metrics"]["contract_passes.sweep"]["value"] == 1.0
        assert not {"lu_ms.randnet", "assemble_ms.dense", "lu_roofline"} \
            & set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"setup_s", "solves_per_s",
                                          "call_ms_p95"}


def test_randnet_control_is_not_correct(randnet_root):
    """The planted fault: the raw f32 tier in the program's place."""
    rc, out, _ = run_tiny(randnet_root, CELL, control=True)
    assert rc == 0
    result = json.loads(out[-1])
    assert result["compared"]["max_rel_err"]["value"] > 1e-6
    assert result["correct"] is False


def test_driver_refuses_another_tier(randnet_root):
    from portbench.spec import Bench

    cell = Bench(randnet_root, randnet_root / "benchmark").cell(CELL)
    conf = dict(cell.config, tier="dense")
    with pytest.raises(ValueError, match="block tier"):
        cell.driver.Driver(conf, cell.traffic, TINY_SEED, "cpu", False)
    # A configuration that states ``block`` where the program picks
    # another tier (RCM finds a band at 200 nodes) is refused too.
    conf = dict(cell.config, circuit=dict(cell.config["circuit"], nodes=200,
                                          edges=800))
    with pytest.raises(RuntimeError, match="chose the band tier"):
        cell.driver.Driver(conf, cell.traffic, TINY_SEED, "cpu", False)


def test_reference_rows_are_the_repos_random_network():
    rows = randnet_rows(1000, 4000, 50, 1.0, 0)
    assert len(rows) == 4021
    digest = hashlib.sha256(json.dumps(rows).encode()).hexdigest()
    assert digest == RANDNET1K_DIGEST


def test_block_lu_bounds_at_the_cell_shape():
    """(4096, 1024) f32: a factorization's 2/3·1024³ flops a system over
    67 TFLOP/s; a substitution's factor (1024² values) and two columns a
    system over 3.35 TB/s."""
    f = lu_factor_bound(4096, 1024, "float32")
    assert f["bound_by"] == "operations"
    assert f["bound_ms"] == pytest.approx(
        2 / 3 * 1024 ** 3 * 4096 / 67e12 * 1e3, rel=1e-12)
    assert f["bound_ms"] == pytest.approx(43.7617, abs=5e-4)
    s = lu_substitution_bound(4096, 1024, 1, "float32")
    assert s["bound_by"] == "bytes"
    assert s["bound_ms"] == pytest.approx(
        (1024 ** 2 + 2 * 1024) * 4096 * 4 / 3.35e12 * 1e3, rel=1e-12)
    assert s["bound_ms"] == pytest.approx(5.1383, abs=5e-4)
    # A randnet call: one factorization and two substitutions.
    assert f["bound_ms"] + 2 * s["bound_ms"] == pytest.approx(54.0384,
                                                              abs=5e-4)
    assert lu_factor_bound(4096, 1024, "float64")["bound_ms"] == \
        pytest.approx(43.7617, abs=5e-4)
