"""The readers of the program's own spans and counters
(``portbench/spans.py``, ``metrics/*.py``) on synthetic call records: the
right value, and None when the records are missing, miscounted or of
another root, or the program has no tracing module; and on the traced
runs of the tiny cells."""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import pytest

from conftest import HOME, ROOT, run_tiny
from portbench.spec import Bench

from nodal_tpu_torch.utils import tracing

MS = 1_000_000  # ns

SWEEP = ("contract_ms.sweep", "assemble_ms.sweep", "contract_passes.sweep")
GRID = ("issue_ms_per_iteration", "sync_wait_ms.host",
        "host_syncs_per_iteration")


def _span(name, parent, start_ms, end_ms, device_ms=None):
    s = tracing.Span(name, parent, int(start_ms * MS), int(end_ms * MS))
    s._device_ms = device_ms
    return s


def sweep_call(i):
    """A sweep call as the contract layer records it: the raw solve and
    one defect pass, each tier solve with its assembly."""
    call = tracing.Call(i, 0)
    call.spans = [
        _span("batch.call", None, 0, 50),
        _span("contract.run", 0, 1, 49, device_ms=40.0 + i),
        _span("tier.solve", 1, 2, 10, device_ms=8.0),
        _span("band.assemble", 2, 2, 4, device_ms=2.0),
        _span("contract.pass", 1, 20, 40),
        _span("tier.solve", 4, 21, 30, device_ms=9.0),
        _span("band.assemble", 5, 21, 23, device_ms=3.0),
    ]
    call.counters = {"contract_passes": 1, "host_syncs": 2,
                     "rescued_samples": 0}
    return call


def grid_call(i, iterations=8):
    """A grid solve: ``iterations`` stepping bodies, each after a
    continuation test, and the last test."""
    call = tracing.Call(i, 0)
    spans = [_span("grid.solve", None, 0, 10 * iterations + 10)]
    for k in range(iterations + 1):
        t = 10 * k
        spans.append(_span("cg.sync", 0, t, t + 0.5 + 0.1 * i))
        if k < iterations:
            spans.append(_span("cg.iteration", 0, t + 1, t + 2))
    call.spans = spans
    call.counters = {"host_syncs": iterations + 1}
    return call


@pytest.fixture
def records(monkeypatch):
    """Put a list of call records in the program's place; the readers
    read its newest entries."""
    kept = []
    monkeypatch.setattr(tracing, "recent", lambda n: kept[-n:] if n else [])
    return kept


def _ctx(n_calls):
    return SimpleNamespace(calls=[{}] * n_calls)


def _read(name, ctx):
    return Bench(ROOT, HOME).metric(name).read(ctx)


def test_sweep_readers(records):
    records += [grid_call(0)] + [sweep_call(i) for i in range(3)]
    ctx = _ctx(3)
    # contract.run less both tier solves: 40 + i - 17, mean over i = 0..2.
    assert _read("contract_ms.sweep", ctx) == pytest.approx(24.0)
    assert _read("assemble_ms.sweep", ctx) == pytest.approx(5.0)
    assert _read("contract_passes.sweep", ctx) == 1.0


def test_grid_readers(records):
    records += [sweep_call(0)] + [grid_call(i) for i in range(2)]
    ctx = _ctx(2)
    assert _read("issue_ms_per_iteration", ctx) == pytest.approx(1.0)
    # 9 tests a call of 0.5 and 0.6 ms.
    assert _read("sync_wait_ms.host", ctx) == pytest.approx(9 * 0.55)
    assert _read("host_syncs_per_iteration", ctx) == pytest.approx(9 / 8)


@pytest.mark.parametrize("name", SWEEP + GRID)
def test_none_when_records_do_not_fit(records, name):
    own = sweep_call if name in SWEEP else grid_call
    other = grid_call if name in SWEEP else sweep_call
    # Not traced, and no records at all.
    assert _read(name, SimpleNamespace(calls=None)) is None
    assert _read(name, _ctx(2)) is None
    # Fewer records than traced calls.
    records.append(own(0))
    assert _read(name, _ctx(2)) is None
    # The newest record is another root's.
    records += [own(1), other(2)]
    assert _read(name, _ctx(2)) is None
    # The program's records, then one call without the spans read.
    records.append(own(3))
    assert _read(name, _ctx(2)) is None
    records.append(own(4))
    assert _read(name, _ctx(2)) is not None
    bare = own(5)
    bare.spans = bare.spans[:1]
    bare.counters = {}
    records.append(bare)
    assert _read(name, _ctx(2)) is None


@pytest.mark.parametrize("name", ("contract_ms.sweep", "assemble_ms.sweep"))
def test_device_readers_none_without_device_times(records, name):
    """A CPU run's spans carry no device time."""
    calls = [sweep_call(i) for i in range(2)]
    for call in calls:
        for s in call.spans:
            s._device_ms = None
    records += calls
    assert _read(name, _ctx(2)) is None


@pytest.mark.parametrize("name", SWEEP + GRID)
def test_none_without_the_tracing_module(monkeypatch, records, name):
    """An older program has no tracing module: nothing to read, and no
    error."""
    import nodal_tpu_torch.utils

    records += [sweep_call(0), grid_call(1)] * 2
    monkeypatch.setitem(sys.modules, "nodal_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(nodal_tpu_torch.utils, "tracing")
    assert _read(name, _ctx(1)) is None


@pytest.mark.parametrize("cell,names", [("tiny_mesh.tiny", SWEEP),
                                        ("tiny_grid.knight", GRID)])
def test_traced_tiny_runs_report_the_program_metrics(tiny_root, cell,
                                                     names):
    """On the CPU the host readers read the program's records; the device
    readers find no device time and leave their metrics out."""
    rc, out, _ = run_tiny(tiny_root, cell, trace=True)
    assert rc == 0
    metrics = json.loads(out[-1])["metrics"]
    if cell == "tiny_mesh.tiny":
        assert metrics["contract_passes.sweep"]["value"] >= 1
        assert "contract_ms.sweep" not in metrics
        assert "assemble_ms.sweep" not in metrics
    else:
        its = metrics["cg_iterations"]["value"]
        assert metrics["host_syncs_per_iteration"]["value"] == \
            pytest.approx((its + 1) / its)
        assert metrics["issue_ms_per_iteration"]["value"] > 0
        assert metrics["sync_wait_ms.host"]["value"] > 0
    for name in names:
        if name in metrics:
            assert metrics[name]["unit"] in ("ms", "count")
