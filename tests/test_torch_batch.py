"""The port's batched ladder sweep end to end against the JAX package: the
raw tier, the exact-f64 contract layer, the refined tier, the audit, the
pivoted rescue, the unbanded tiers' selection and the refusals of forced
tiers (the mesh, wide-band, branch and unbanded tiers have their own files,
test_torch_sband.py, test_torch_band.py, test_torch_schur.py and
test_torch_block_lu.py)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Circuit as JCircuit  # noqa: E402
from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu import batch as jbatch  # noqa: E402
from nodal_tpu.ops.assemble import assemble_dense as jassemble_dense  # noqa: E402
from nodal_tpu_torch import BatchedSolver, Circuit, Netlist  # noqa: E402
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import pcr  # noqa: E402
from nodal_tpu_torch.utils import tracing  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows, ladder_rows  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RUNGS, B = 64, 16


@pytest.fixture(scope="module")
def ladder():
    """(JAX circuit, port stamps, params [B, n_components] rounded to f32
    so both packages and the f64 oracle see the same values)."""
    jc = JCircuit(JNetlist.from_rows(ladder_rows(RUNGS)))
    rng = np.random.default_rng(0)
    base = jc.stamps.params
    params = (base * (1.0 + 0.05 * rng.standard_normal((B, len(base))))
              ).astype(np.float32).astype(np.float64)
    return jc, stamps_from_reference(jc.stamps), params


def _jax_solver(jc, **kw):
    return jbatch.BatchedSolver(jc, dtype=jnp.float32, **kw)


def _dense_f64(jc, params):
    """numpy f64 dense solve of every sample (the accuracy oracle)."""
    out = []
    for p in params:
        G, b = jassemble_dense(jc.stamps, jnp.asarray(p), dtype=jnp.float64)
        out.append(np.linalg.solve(np.asarray(G), np.asarray(b)))
    return np.stack(out)


def _rel_err(x, ref):
    return np.max(np.abs(x - ref) / np.abs(ref).max(axis=1, keepdims=True))


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_solver_matches_reference(ladder, refine):
    jc, stamps, params = ladder
    js = _jax_solver(jc, refine=refine)
    ts = BatchedSolver(stamps, refine=refine, device="cpu")
    assert js.method == ts.method == "tridiag"
    want = np.asarray(js(params))
    got = ts(params)
    assert got.device.type == "cpu" and got.shape == (B, stamps.n)
    if refine is False:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert got.dtype == torch.float64
        assert _rel_err(got.numpy(), want) <= 1e-9
        ref = _dense_f64(jc, params)
        assert _rel_err(got.numpy(), ref) <= 1e-6
        assert _rel_err(want, ref) <= 1e-6


def test_raw_f64_matches_reference(ladder):
    jc, stamps, params = ladder
    want = np.asarray(jbatch.BatchedSolver(jc, dtype=jnp.float64,
                                           refine=False)(params))
    got = BatchedSolver(stamps, dtype=torch.float64, refine=False,
                        device="cpu")(params)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_residuals_match_reference(ladder):
    jc, stamps, params = ladder
    js = _jax_solver(jc)
    ts = BatchedSolver(stamps, device="cpu")
    xs = ts(params)
    got = ts.residuals(params, xs)
    want = np.asarray(js.residuals(params, xs.numpy()))
    assert got.dtype == torch.float64 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert float(got.max()) <= 1e-6


def test_transposed_contract_solve_matches_reference(ladder):
    jc, stamps, params = ladder
    rhs = np.random.default_rng(1).standard_normal((B, stamps.n))
    want = np.asarray(_jax_solver(jc)._solve_rhs_t(
        jnp.asarray(params, jnp.float32), jnp.asarray(rhs)))
    got = BatchedSolver(stamps, device="cpu")._solve_rhs_t(
        torch.as_tensor(params, dtype=torch.float32), torch.as_tensor(rhs))
    assert _rel_err(got.numpy(), want) <= 1e-9


def test_pivoted_rescue_matches_reference(ladder):
    """rp0 = -rs0 zeroes the first diagonal entry: the no-pivot PCR gives
    non-finite values for that sample, and the contract layer's pivoted
    f64 LU rescue returns it finite in both packages."""
    jc, stamps, params = ladder
    params = params.copy()
    slot = stamps.param_slot
    params[3, slot["rp0"]] = -params[3, slot["rs0"]]
    raw = BatchedSolver(stamps, refine=False, device="cpu")(params)
    assert not torch.isfinite(raw[3]).all()
    assert torch.isfinite(raw[np.arange(B) != 3]).all()
    jraw = np.asarray(_jax_solver(jc, refine=False)(params))
    assert not np.isfinite(jraw[3]).all()

    js = _jax_solver(jc)
    ts = BatchedSolver(stamps, device="cpu")
    want = np.asarray(js(params))
    got = ts(params)
    assert torch.isfinite(got).all()
    assert _rel_err(got.numpy(), want) <= 1e-9
    res = ts.residuals(params, got)
    assert float(res[3]) <= 1e-12
    assert float(res.max()) <= 1e-6
    np.testing.assert_allclose(
        res.numpy(), np.asarray(js.residuals(params, want)), rtol=0,
        atol=1e-12)


def test_contract_layer_escalates_like_reference(ladder):
    """An inner solve 5 % off contracts the error by only 0.05 a pass, so
    the error-gated continuation runs to its pass cap in both packages and
    still meets the contract."""
    jc, stamps, params = ladder
    calls = []
    raw_t = BatchedSolver(stamps, refine=False, device="cpu")._solve_rhs_t
    raw_j = _jax_solver(jc, refine=False)._solve_rhs_t

    def inner_t(pb, rhs=None):
        calls.append(rhs is None)
        return 1.05 * raw_t(pb, rhs)

    def prepare(pb):
        return lambda rhs=None: inner_t(pb, rhs)

    got = tbatch._escalating_solver(stamps, prepare)(
        torch.as_tensor(params, dtype=torch.float32))
    want = np.asarray(jbatch._escalating_solver(
        jc.stamps, lambda pb, rhs=None: 1.05 * raw_j(pb, rhs))(
            jnp.asarray(params, jnp.float32)))
    assert len(calls) == 1 + tbatch._ESCALATE_MAX_PASSES
    assert _rel_err(got.numpy(), want) <= 1e-9
    assert _rel_err(got.numpy(), _dense_f64(jc, params)) <= 1e-6


#: A 9×40 mesh with a current source: the scalar band takes it, the block
#: band when forced.
MESH = list(grid_rows(9, 40, (0, 0), (8, 39))) + [["src", "A", "1", "1", "g"]]


@pytest.fixture(scope="module")
def mesh_sweep():
    """(port stamps, f32 params [4, n_components], an f64 natural-order
    RHS [4, n])."""
    stamps = Circuit(Netlist.from_rows(MESH)).stamps
    rng = np.random.default_rng(21)
    base = stamps.params
    params = base * (1.0 + 0.05 * rng.standard_normal((4, len(base))))
    return (stamps, torch.as_tensor(params, dtype=torch.float32),
            torch.as_tensor(rng.standard_normal((4, stamps.n))))


def _traced(fn, *args):
    """``fn(*args)`` in a call record of its own: (result, record)."""
    tracing.enable()
    try:
        with tracing.root("check"):
            out = fn(*args)
    finally:
        tracing.disable()
    return out, tracing.recent(1)[0]


def test_prepared_inner_assembles_once_a_run(mesh_sweep):
    """A prepared solve 5 % off contracts the error by only 0.05 a pass,
    so the passes run to their cap: a tier solve each, all on the one
    band assembled by the first, and the contract still met."""
    stamps, params, _ = mesh_sweep
    raw = BatchedSolver(stamps, refine=False, device="cpu")._operator

    def prepare(pb):
        resolve = raw.prepare(pb)
        return lambda rhs=None: 1.05 * resolve(rhs)

    got, call = _traced(tbatch._escalating_solver(stamps, prepare), params)
    passes = tbatch._ESCALATE_MAX_PASSES
    assert call.counters["contract_passes"] == passes
    assert call.counters["band_assemblies"] == 1
    assert len(call.find("tier.solve")) == 1 + passes
    assert len(call.find("band.assemble")) == 1
    truth = BatchedSolver(stamps, dtype=torch.float64, refine=False,
                          device="cpu")(params.to(torch.float64))
    assert _rel_err(got.numpy(), truth.numpy()) <= 1e-6


def test_dense_row_audit_matches_reference():
    """A node with many parallel resistors keeps the chain tridiagonal but
    puts more COO entries on its row than the one-slot-row fold takes, so
    the contract layer and the audit fold the rows sorted, left to right."""
    rows = ladder_rows(8) + [[f"rx{k}", "R", str(1.0 + k), "n0", "n1"]
                             for k in range(12)]
    jc = JCircuit(JNetlist.from_rows(rows))
    stamps = stamps_from_reference(jc.stamps)
    assert tbatch._resid_gather_tables(stamps)[0].offsets is not None
    rng = np.random.default_rng(2)
    base = jc.stamps.params
    params = (base * (1.0 + 0.05 * rng.standard_normal((4, len(base))))
              ).astype(np.float32).astype(np.float64)
    js = _jax_solver(jc)
    ts = BatchedSolver(stamps, device="cpu")
    assert ts.method == js.method == "tridiag"
    got = ts(params)
    want = np.asarray(js(params))
    assert _rel_err(got.numpy(), want) <= 1e-9
    np.testing.assert_allclose(ts.residuals(params, got).numpy(),
                               np.asarray(js.residuals(params, want)),
                               rtol=0, atol=1e-12)


def test_sweep_and_params_with_match_reference(ladder):
    jc, _, _ = ladder
    values = np.linspace(0.5, 2.0, 5)
    want = jbatch.sweep(jc, "rp3", values, refine=True)
    circuit = Circuit(Netlist.from_rows(ladder_rows(RUNGS)))
    got = tbatch.sweep(circuit, "rp3", values, refine=True, device="cpu")
    for node in ("n0", "n10", "g"):
        np.testing.assert_allclose(got.potential(node).numpy(),
                                   np.asarray(want.potential(node)),
                                   rtol=1e-9, atol=1e-12)
    solver = circuit.batched_solver(device="cpu")
    assert solver is circuit.batched_solver(device="cpu")
    np.testing.assert_array_equal(
        solver.params_with({"rs1": values}),
        _jax_solver(jc).params_with({"rs1": values}))


#: A mesh too wide for the scalar band (half-bandwidth 60 after RCM): the
#: block-band tier takes it.
WIDE_MESH = list(grid_rows(60, 60, (0, 0), (59, 59))) + [
    ["src", "A", "1", "1", "g"]]


def _random_graph_rows(n, edges, seed, extra=()):
    """A random resistor graph with a ground tie on every node: SPD, with
    no locality for RCM to find (no narrow band, no block band at n = 1200,
    a block band with kb > 128 at n = 300)."""
    rng = np.random.default_rng(seed)
    rows = [["v", "A", "1", "n0", "g"]]
    for k in range(edges):
        a, b = rng.integers(0, n, 2)
        if a != b:
            rows.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
    return rows + [[f"rg{j}", "R", "1", f"n{j}", "g"] for j in range(n)] + [
        list(r) for r in extra]


#: Unbanded: the JAX package sends it to the dense ``block`` tier.
RANDOM_GRAPH = _random_graph_rows(1200, 4800, seed=0)


def _sweep(jc, B=3, seed=3):
    base = jc.stamps.params
    rng = np.random.default_rng(seed)
    return (base * (1.0 + 0.05 * rng.standard_normal((B, len(base))))
            ).astype(np.float32).astype(np.float64)


def _branch_rows(h, w):
    """test_torch_schur.py's branch circuit: a mesh driven by a voltage
    source, plus a VCCS."""
    return list(grid_rows(h, w, (0, 0), (h - 1, w - 1))) + [
        ["e1", "E", "2", "1", "g"],
        ["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"]]


#: One circuit a tier and ``schur`` sub-branch: (rows, method, the batch
#: module's function that the tier's ``prepare`` calls a fixed number of
#: times, or None where the ``band_assemblies`` counter counts them, and
#: the defect passes ``refine=True`` takes).
TIERS = {
    "tridiag": (ladder_rows(RUNGS), "tridiag", "assemble_tridiag", 2),
    "sband": (MESH, "sband", None, 2),
    "band": (MESH, "band", None, 2),
    "block": (MESH, "block", "assemble_dense", 2),
    # test_torch_schur.py's circuits: an 8×8 mesh whose node block is a
    # narrow band (the scalar-band sub-branch), the 60×60 branch mesh (the
    # block-Thomas one) and a random graph (the blocked LU).
    "schur-sband": (list(grid_rows(8, 8, (0, 0), (7, 7))) + [
        ["e1", "E", "2", "1", "g"],
        ["d1", "VCCS", "0.5", "n0_3", "g", "1", "g"],
        ["f1", "CCCS", "1.5", "n3_3", "g", "1", "g", "e1"]],
        "schur", "gather_fold", 2),
    "schur-band": (_branch_rows(60, 60), "schur", "gather_fold", 2),
    "schur-lu": (_random_graph_rows(300, 900, seed=1, extra=[
        ["e1", "E", "2", "n1", "g"],
        ["d1", "VCCS", "0.5", "n3", "g", "n1", "g"]]),
        "schur", "gather_fold", 3),
    "dense": (ladder_rows(8)[1:] + [["v0", "E", "1", "n0", "g"]], "dense",
              "assemble_dense", 3),
}


@functools.cache
def _tier_sweep(tier):
    """(port stamps, f32 params [4, n_components], an f64 natural-order
    RHS [4, n]) for a tier of :data:`TIERS`, drawn as ``mesh_sweep``."""
    stamps = Circuit(Netlist.from_rows(TIERS[tier][0])).stamps
    rng = np.random.default_rng(21)
    base = stamps.params
    params = base * (1.0 + 0.05 * rng.standard_normal((4, len(base))))
    return (stamps, torch.as_tensor(params, dtype=torch.float32),
            torch.as_tensor(rng.standard_normal((4, stamps.n))))


def _tier_call(solver, transpose, params, rhs):
    """The forward call of ``solver`` or its transposed solve."""
    if transpose:
        return solver._solve_rhs_t, (params, rhs)
    return solver, (params,)


def _counted(monkeypatch, name):
    """Calls of the batch module's function ``name`` from now on."""
    calls = []
    real = getattr(tbatch, name)
    monkeypatch.setattr(tbatch, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["forward", "transposed"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_contract_layer_reuses_the_band_bit_for_bit(tier, transpose,
                                                    monkeypatch):
    """Every tier prepares its operator (the band, bands, blocks or
    factor) once a contract run; the same run on a prepared form whose
    ``resolve`` prepares it again for every solve gives the same answer
    bit for bit: the same operator meets the same kernel with the same
    right-hand sides."""
    _, method, assembly, _ = TIERS[tier]
    stamps, params, rhs = _tier_sweep(tier)
    solver = BatchedSolver(stamps, method=method, device="cpu")
    assert solver.method == method
    op = solver._operator
    prepare = op.prepare_t if transpose else op.prepare
    prepares = []

    def reprepared(pb):
        def resolve(rhs=None):
            prepares.append(1)
            return prepare(pb)(rhs)

        return resolve

    twice = tbatch._escalating_solver(stamps, reprepared, transpose=transpose)
    once, args = _tier_call(solver, transpose, params, rhs)
    calls = [] if assembly is None else _counted(monkeypatch, assembly)
    got, call = _traced(once, *args)
    n_once = len(calls)
    want, ref_call = _traced(twice, *args)
    assert torch.equal(got, want)
    passes = call.counters["contract_passes"]
    assert ref_call.counters["contract_passes"] == passes >= 1
    assert call.counters["rescued_samples"] == 0
    assert len(prepares) == 1 + passes
    if assembly is None:
        assert call.counters["band_assemblies"] == 1
        assert ref_call.counters["band_assemblies"] == 1 + passes
    else:
        assert len(calls) - n_once == (1 + passes) * n_once > 0


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["forward", "transposed"])
@pytest.mark.parametrize("tier", list(TIERS))
def test_refine_true_takes_the_tiers_fixed_passes(tier, transpose):
    """``refine=True`` solves in f32 on the operator prepared once and
    takes the tier's fixed number of exact-f64 defect passes, with no
    escalation and no rescue; the answer meets the 1e-6 contract against
    the raw f64 tier."""
    _, method, _, passes = TIERS[tier]
    stamps, params, rhs = _tier_sweep(tier)
    solver = BatchedSolver(stamps, method=method, refine=True, device="cpu")
    once, args = _tier_call(solver, transpose, params, rhs)
    got, call = _traced(once, *args)
    assert got.dtype == torch.float64
    assert call.counters["contract_passes"] == passes
    assert not call.find("contract.run")
    assert "rescued_samples" not in call.counters
    raw = BatchedSolver(stamps, method=method, dtype=torch.float64,
                        refine=False, device="cpu")
    truth, args = _tier_call(raw, transpose, params.to(torch.float64), rhs)
    assert _rel_err(got.numpy(), truth(*args).detach().numpy()) <= 1e-6


@pytest.mark.parametrize("rows,jax_method", [
    pytest.param(RANDOM_GRAPH, "block", id="unbanded"),
    pytest.param(ladder_rows(8)[1:] + [["v0", "E", "1", "n0", "g"]],
                 "dense", id="voltage-source"),
    # An SPD node block of 300 nodes that neither banded schur sub-branch
    # takes: the dense node block on the blocked LU.
    pytest.param(_random_graph_rows(300, 900, seed=1,
                                    extra=[["e1", "E", "2", "n1", "g"]]),
                 "schur", id="branch-wide-node-block"),
])
def test_unbanded_tiers_match_reference(rows, jax_method):
    """The circuits without a band: the same tier as the JAX package, and
    ``refine="auto"`` within 1e-9 of it and 1e-6 of numpy f64."""
    jc = JCircuit(JNetlist.from_rows(rows))
    js = _jax_solver(jc)
    ts = BatchedSolver(stamps_from_reference(jc.stamps), device="cpu")
    assert js.method == ts.method == jax_method
    params = _sweep(jc)
    got = ts(params).numpy()
    assert _rel_err(got, np.asarray(js(params))) <= 1e-9
    assert _rel_err(got, _dense_f64(jc, params)) <= 1e-6


@pytest.mark.parametrize("method", [
    # The port has the sband and band tiers: forcing either on a circuit
    # that does not qualify is the JAX package's ValueError.
    pytest.param("sband", id="sband"),
    pytest.param("band", id="band"),
])
def test_forced_tiers_refuse_like_reference(method):
    rows, match = {"sband": (WIDE_MESH, "narrow symmetric band"),
                   "band": (RANDOM_GRAPH, "does not band")}[method]
    with pytest.raises(ValueError, match=match):
        jbatch.BatchedSolver(JCircuit(JNetlist.from_rows(rows)),
                             method=method)
    with pytest.raises(ValueError, match=match):
        BatchedSolver(Circuit(Netlist.from_rows(rows)), method=method,
                      device="cpu")


@pytest.mark.parametrize("method", ["block", "dense"])
def test_forced_dense_tiers_match_reference(ladder, method):
    """The ladder forced onto the dense tiers, as the JAX package takes
    it."""
    jc, stamps, params = ladder
    ts = BatchedSolver(stamps, method=method, device="cpu")
    assert ts.method == method
    got = ts(params)
    assert got.dtype == torch.float64
    want = np.asarray(_jax_solver(jc, method=method)(params))
    assert _rel_err(got.numpy(), want) <= 1e-9
    assert _rel_err(got.numpy(), _dense_f64(jc, params)) <= 1e-6


@pytest.mark.parametrize("method,rows", [
    ("tridiag", list(grid_rows(4, 4, (0, 0), (3, 3)))),
    ("tridiag", ladder_rows(8)[1:] + [["v0", "E", "1", "n0", "g"]]),
    ("schur", ladder_rows(8)),
    ("bogus", ladder_rows(8)),
])
def test_invalid_methods_raise_like_reference(method, rows):
    with pytest.raises(ValueError):
        jbatch.BatchedSolver(JCircuit(JNetlist.from_rows(rows)),
                             method=method)
    with pytest.raises(ValueError):
        BatchedSolver(Circuit(Netlist.from_rows(rows)), method=method,
                      device="cpu")


def test_cuda_device_without_cuda_raises(ladder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedSolver(ladder[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedSolver(ladder[1], device="cuda")


def test_cpu_solver_never_launches_the_kernel(ladder):
    _, stamps, params = ladder
    before = pcr.pcr_solve.launches
    BatchedSolver(stamps, device="cpu")(params)
    assert pcr.pcr_solve.launches == before == 0


def test_reference_stamps_need_conversion(ladder):
    jc, _, _ = ladder
    with pytest.raises(TypeError, match="stamps_from_reference"):
        BatchedSolver(jc.stamps, device="cpu")
