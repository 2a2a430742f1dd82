"""The port's spans and counters (``nodal_tpu_torch/utils/tracing.py``) on
the CPU: off by default, on under ``torch.profiler`` and after
``enable()``; the call record of a contract-layer sweep and of a grid
solve; the records on the exported trace's clock; the kept ring; self
times."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import randnet_rows  # noqa: E402
from nodal_tpu_torch import BatchedSolver, Circuit, Netlist  # noqa: E402
from nodal_tpu_torch.ops.block_thomas import band_solve_multi  # noqa: E402
from nodal_tpu_torch.ops.grid import grid_solve  # noqa: E402
from nodal_tpu_torch.utils import tracing  # noqa: E402
from nodal_tpu_torch.utils.gridgen import (  # noqa: E402
    grid_rows, ladder_rows, weighted_lattice_rows)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (beside other test
    processes the default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def _newer(last_id):
    """The records kept after the record ``last_id``, oldest first."""
    return [c for c in tracing.recent(tracing.KEEP_CALLS) if c.id > last_id]


def _last_id():
    calls = tracing.recent(1)
    return calls[0].id if calls else -1


@pytest.fixture(scope="module")
def mesh():
    rows = list(grid_rows(5, 6, (0, 0), (4, 5))) + [["src", "A", "1", "1",
                                                     "g"]]
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, device="cpu")
    assert solver.method == "sband" and solver.refine == "auto"
    return solver, np.tile(circuit.stamps.params, (4, 1))


def _point_pair(h, w):
    b = torch.zeros(h, w, dtype=torch.float64)
    b[h // 2, w // 2] = 1.0
    b[h // 2 + 1, w // 2 + 2] = -1.0
    return b


def test_off_by_default_leaves_no_record(mesh):
    solver, params = mesh
    last = _last_id()
    solver(params)
    grid_solve(16, 16, _point_pair(16, 16), dtype=torch.float64,
               device="cpu")
    assert _newer(last) == []


@pytest.fixture(scope="module")
def profiled_sweep(mesh, tmp_path_factory):
    """One sweep call in a profiler session of its own, after a session
    that warms the profiler's ranges up: its record and the exported
    trace's events and base time."""
    solver, params = mesh
    with profile(activities=[ProfilerActivity.CPU]):
        solver(params)
    last = _last_id()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver(params)
    calls = _newer(last)
    path = tmp_path_factory.mktemp("trace") / "sweep.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    return calls, trace["traceEvents"], trace["baseTimeNanoseconds"]


def test_sweep_call_record(profiled_sweep):
    calls, _, _ = profiled_sweep
    assert [c.name for c in calls] == ["batch.call"]
    call = calls[0]
    names = [s.name for s in call.spans]
    assert names.count("contract.run") == 1
    assert names.count("tier.solve") == 2
    assert names.count("band.assemble") == 1
    assert names.count("contract.pass") == 1
    assert call.counters == {"band_assemblies": 1, "contract_passes": 1,
                             "host_syncs": 2, "rescued_samples": 0}

    def ancestors(span):
        while span.parent is not None:
            span = call.spans[span.parent]
            yield span.name

    for s in call.find("tier.solve"):
        assert "contract.run" in ancestors(s)
    for s in call.find("band.assemble"):
        assert next(ancestors(s)) == "tier.solve"
    for s in call.spans[1:]:
        parent = call.spans[s.parent]
        assert 0 <= s.parent < call.spans.index(s)
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    # Host-only on the CPU: no span carries a device time.
    assert all(s.device_ms is None for s in call.spans)


def test_spans_on_the_exported_trace_clock(profiled_sweep):
    calls, events, base_ns = profiled_sweep
    call = calls[0]
    starts = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            starts.setdefault(e["name"], []).append(e["ts"])
    for s in call.spans:
        mapped_us = (call.wall_ns(s) - base_ns) / 1e3
        assert s.name in starts
        assert min(abs(t - mapped_us) for t in starts[s.name]) <= 50.0


def test_grid_solve_counts_iterations_and_syncs():
    tracing.enable()
    last = _last_id()
    _, info = grid_solve(64, 64, _point_pair(64, 64), dtype=torch.float64,
                         device="cpu")
    calls = _newer(last)
    assert [c.name for c in calls] == ["grid.solve"]
    call = calls[0]
    its = int(info.iterations)
    assert its > 1
    assert len(call.find("cg.iteration")) == its
    assert len(call.find("cg.sync")) == its + 1
    assert call.counters == {"host_syncs": its + 1}
    root = call.spans[0]
    for s in call.find("cg.iteration") + call.find("cg.sync"):
        assert call.spans[s.parent] is root


@pytest.fixture(scope="module")
def lattice():
    """A 7×10×10 unit lattice: the smallest depth whose ``auto`` tier is
    ``band`` (block Thomas)."""
    d, h, w = 7, 10, 10
    rows = list(weighted_lattice_rows(
        np.ones((d, h, w - 1)), np.ones((d, h - 1, w)),
        np.ones((d - 1, h, w)), (0, 0, 0), (d - 1, h - 1, w - 1)))
    circuit = Circuit(Netlist.from_rows(rows + [["src", "A", "1", "1",
                                                 "g"]]))
    solver = BatchedSolver(circuit, device="cpu")
    assert solver.method == "band" and solver.refine == "auto"
    return solver, np.tile(circuit.stamps.params, (2, 1))


def test_band_call_records_a_thomas_span_a_solve(lattice):
    """One ``thomas.solve`` span a block-Thomas solve: the raw solve and
    each defect pass, each inside its ``tier.solve``.  On the CPU the
    plain solver runs: no kernel is counted."""
    solver, params = lattice
    kernels = band_solve_multi.kernels
    tracing.enable()
    last = _last_id()
    solver(params)
    (call,) = _newer(last)
    spans = call.find("thomas.solve")
    assert len(spans) == 1 + call.counters["contract_passes"]
    assert len(spans) == len(call.find("tier.solve"))
    for s in spans:
        assert call.spans[s.parent].name == "tier.solve"
        assert s.device_ms is None
    assert call.counters.get("thomas_kernels", 0) == 0
    assert band_solve_multi.kernels == kernels


def test_band_call_untraced_records_nothing(lattice):
    solver, params = lattice
    last = _last_id()
    solver(params)
    assert _newer(last) == []


@pytest.fixture(scope="module")
def randnet():
    """A 300-node random resistor network (chip_smoke.py's class): the
    ``block`` tier."""
    circuit = Circuit(Netlist.from_rows(randnet_rows(300, 1200)))
    solver = BatchedSolver(circuit, device="cpu")
    assert solver.method == "block" and solver.refine == "auto"
    return solver, np.tile(circuit.stamps.params, (2, 1))


def test_block_call_records_lu_spans_and_counters(randnet):
    """A ``block``-tier sweep call: one ``dense.assemble`` and one
    ``lu.factor`` inside the first ``tier.solve``, one ``lu.solve`` in each
    ``tier.solve`` (the raw solve and the defect pass); the counters 1
    assembly, 1 factorization and 2 substitutions.  On the CPU the plain
    blocked LU runs: no kernel is counted and no span carries a device
    time."""
    solver, params = randnet
    tracing.enable()
    last = _last_id()
    solver(params)
    (call,) = _newer(last)
    c = call.counters
    assert c["contract_passes"] == 1
    assert (c["dense_assemblies"], c["lu_factorizations"],
            c["lu_substitutions"]) == (1, 1, 2)
    assert "lu_kernels" not in c
    tiers = [call.spans.index(s) for s in call.find("tier.solve")]
    assert len(tiers) == 2
    (assemble,) = call.find("dense.assemble")
    (factor,) = call.find("lu.factor")
    solves = call.find("lu.solve")
    assert assemble.parent == factor.parent == tiers[0]
    assert [s.parent for s in solves] == tiers
    assert assemble.end_ns <= factor.start_ns <= factor.end_ns \
        <= solves[0].start_ns
    for s in [assemble, factor] + solves:
        assert s.device_ms is None


def test_rescued_sample_is_counted():
    """rp0 = -rs0 zeroes the ladder's first pivot in one sample: the
    contract layer's pivoted f64 rescue re-solves it."""
    circuit = Circuit(Netlist.from_rows(ladder_rows(16)))
    slot = circuit.stamps.param_slot
    params = np.tile(circuit.stamps.params, (4, 1))
    params[2, slot["rp0"]] = -params[2, slot["rs0"]]
    solver = BatchedSolver(circuit, device="cpu")
    tracing.enable()
    last = _last_id()
    x = solver(params)
    (call,) = _newer(last)
    assert torch.isfinite(x).all()
    assert call.counters["rescued_samples"] == 1
    assert call.counters["host_syncs"] == call.counters["contract_passes"] + 1


def test_ring_keeps_the_last_calls():
    tracing.enable()
    last = _last_id()
    for _ in range(tracing.KEEP_CALLS + 6):
        with tracing.root("ring"):
            tracing.count("n")
    kept = tracing.recent(100)
    assert len(kept) == tracing.KEEP_CALLS == 64
    ids = [c.id for c in kept]
    assert ids == list(range(last + 7, last + 71))
    assert tracing.recent(3) == kept[-3:]
    assert tracing.recent(0) == []


def test_nested_root_is_a_span():
    tracing.enable()
    last = _last_id()
    with tracing.root("outer"):
        with tracing.root("inner"):
            tracing.count("n", 2)
    (call,) = _newer(last)
    assert [s.name for s in call.spans] == ["outer", "inner"]
    assert call.spans[1].parent == 0 and call.counters == {"n": 2}


def test_self_time_is_duration_less_children_cover():
    call = tracing.Call(0, 0)
    ms = 1_000_000
    call.spans = [tracing.Span("root", None, 0, 10 * ms),
                  tracing.Span("a", 0, 1 * ms, 3 * ms),
                  tracing.Span("b", 0, 4 * ms, 8 * ms),
                  tracing.Span("c", 2, 5 * ms, 6 * ms)]
    assert tracing.self_ms(call, call.spans[0]) == pytest.approx(4.0)
    assert tracing.self_ms(call, call.spans[2]) == pytest.approx(3.0)
    assert tracing.self_ms(call, call.spans[3]) == pytest.approx(1.0)
    # On the device clock the nearest timed descendants are subtracted.
    assert tracing.self_ms(call, call.spans[0], device=True) is None
    call.spans[0]._device_ms = 9.0
    call.spans[1]._device_ms = 2.0
    call.spans[3]._device_ms = 0.5
    assert tracing.self_ms(call, call.spans[0], device=True) == \
        pytest.approx(6.5)
