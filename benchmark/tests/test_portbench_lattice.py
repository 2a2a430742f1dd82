"""The band-tier sweep on the CPU: a tiny lattice cell (7×10×10, the
smallest depth at which the program's ``auto`` choice is the ``band``
tier) runs whole through the harness and comes out correct, traced and
not; a planted fault makes ``correct`` false; the plain PyTorch reference
equals SciPy's sparse LU; the block-Thomas bound equals a hand count."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import run_tiny, tiny_bench
from reference import mna, mna_torch
from reference.lattice import lattice_rows
from roofline.block_thomas import block_thomas_bound

CELL = "tiny_lattice.tiny"


@pytest.fixture(scope="module")
def lattice_root(tmp_path_factory):
    """``tiny_bench`` with a tiny lattice cell that reports what
    ``lattice2k.mc1k`` reports."""
    root = tiny_bench(tmp_path_factory.mktemp("portbench_lattice"))
    home = root / "benchmark"
    conf = json.loads((home / "configs" / "lattice2k.json").read_text())
    conf.update(name="tiny_lattice")
    conf["circuit"].update(d=7, h=10, w=10)
    (home / "configs" / "tiny_lattice.json").write_text(json.dumps(conf))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_lattice", "source": "test",
                            "file": "benchmark/configs/tiny_lattice.json",
                            "why": "test", "reduced": []})
    spec["workloads"].append({"name": CELL, "config": "tiny_lattice",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "lattice2k.mc1k" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_lattice_cell_is_correct(lattice_root, trace):
    rc, out, err = run_tiny(lattice_root, CELL, trace=trace)
    assert rc == 0, err[-2000:]
    result = json.loads(out[-1])
    assert result["correct"] is True, result["compared"]
    assert result["compared"]["max_rel_err"]["value"] <= 1e-6
    if trace:
        # The CPU has no device times and no library kernels.
        assert {"contract_passes.sweep", "kernels_per_call.sweep",
                "device_idle.sweep"} <= set(result["metrics"])
        assert not {"thomas_ms.lattice", "thomas_roofline"} & \
            set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"setup_s", "solves_per_s",
                                          "call_ms_p95"}


def test_lattice_answer_altered(lattice_root, monkeypatch):
    """One sample's answer off by 1e-5 of its largest potential."""
    from nodal_tpu_torch import batch

    original = batch.BatchedSolver.__call__

    def altered(self, p):
        x = original(self, p)
        x[-1, x.shape[1] // 2] += 1e-5 * x[-1].abs().max()
        return x
    monkeypatch.setattr(batch.BatchedSolver, "__call__", altered)
    rc, out, _ = run_tiny(lattice_root, CELL)
    assert rc == 0
    result = json.loads(out[-1])
    assert result["compared"]["max_rel_err"]["value"] > 1e-6
    assert result["correct"] is False


def test_lattice_control_is_not_correct(lattice_root):
    rc, out, _ = run_tiny(lattice_root, CELL, control=True)
    assert rc == 0
    assert json.loads(out[-1])["correct"] is False


def test_torch_reference_equals_scipy():
    rows = lattice_rows(4, 3, 5)
    gen = np.random.default_rng(3)
    base = mna.ResistiveMNA(rows).values(rows)
    params = base * (1 + 0.05 * gen.standard_normal((3, len(base))))
    ref = mna.ResistiveMNA(rows).solve(params)
    ours = mna_torch.NodalTorch(rows).solve(torch.as_tensor(params), block=2)
    # Two f64 LUs of a well-conditioned 59-unknown Laplacian.
    assert ours.numpy() == pytest.approx(ref, rel=0, abs=1e-12)
    assert float(mna_torch.rel_errors(ours, torch.as_tensor(ref)).max()) \
        < 1e-12


def test_block_thomas_bound_by_hand():
    """(1024, 16, 128, 1) f32: a system's flops are 16 block rows of an LU
    of S and S⁻¹·rhs and 15 of the products L·C, L·y, S⁻¹·U and C·x,
    over 67 TFLOP/s; its bytes the band and two columns, over 3.35 TB/s."""
    kb, nb, B = 128, 16, 1024
    flops = (nb * (2 / 3 * kb ** 3 + 2 * kb ** 2)
             + (nb - 1) * (4 * kb ** 3 + 4 * kb ** 2)) * B
    nbytes = nb * kb * (3 * kb + 2) * B * 4
    got = block_thomas_bound(B, nb, kb, 1, "float32")
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(flops / 67e12 * 1e3, rel=1e-12)
    assert got["bound_ms"] == pytest.approx(2.288, abs=5e-4)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.9666, abs=5e-4)
    assert block_thomas_bound(B, nb, kb, 1, "float64")["bound_ms"] == \
        pytest.approx(2.288, abs=5e-4)
