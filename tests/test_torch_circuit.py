"""The port's single solve (``nodal_tpu_torch/circuit.py``: ``Circuit``,
``Solution``) and the dense helpers it sits on against the JAX package's
(``nodal_tpu/circuit.py``, ``nodal_tpu/ops/dense_solve.py``,
``nodal_tpu/ops/assemble.py``), on the CPU.

Tolerances: in f64 both packages run a pivoted LU (LAPACK on both sides)
or the same pivoted block-Thomas recursion on the same assembled system,
so solutions agree to 1e-10 of max|x| on the goldens and 1e-9 on the
band route.  Routes: the same ``stats["method"]`` in both packages, the
JAX package's ``"cpu_f64_rescue"`` named ``"f64_rescue"`` in the port
(there is no host routing to name).  The OPMODEL amplifier in f32 stays on
the dense route in both packages on the CPU (its f32 residual, 6e-3 to
1e-2, is under the 3e-2 gate) and logs the accuracy warning in both; the
hand-modelled buffer at extreme values (``_BUFFER_EXTREME``) reaches the
rescue in both.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.linalg import LinAlgError  # noqa: E402

import nodal_tpu as J  # noqa: E402
from nodal_tpu.ops import dense_solve as jdense  # noqa: E402
from nodal_tpu.ops.assemble import assemble_rhs as jassemble_rhs  # noqa: E402
from nodal_tpu_torch import (Circuit, Netlist, Solution,  # noqa: E402
                             UnconnectedCircuitError)
from nodal_tpu_torch import circuit as tcircuit  # noqa: E402
from nodal_tpu_torch.ops import dense_solve  # noqa: E402
from nodal_tpu_torch.ops.assemble import assemble_rhs  # noqa: E402
from nodal_tpu_torch.ops.band import band_plan  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows  # noqa: E402

import fixtures as fx  # noqa: E402

GOLDENS = [
    ("DIVIDER", fx.DIVIDER, fx.DIVIDER_EXPECTED),
    ("161", fx.CIRCUIT_161, fx.CIRCUIT_161_EXPECTED),
    ("BUFFER", fx.BUFFER, fx.BUFFER_EXPECTED),
    ("OPMODEL_AMPLIFIER", fx.OPMODEL_AMPLIFIER, fx.OPMODEL_AMPLIFIER_EXPECTED),
    ("OPMODEL_BUFFER", fx.OPMODEL_BUFFER, fx.OPMODEL_BUFFER_EXPECTED),
    ("ALL_TYPES", fx.ALL_TYPES, fx.ALL_TYPES_EXPECTED),
    ("UNCONNECTED_0", fx.UNCONNECTED_0, None),
]

#: BASELINE configs 1–3 and the other example netlists that solve.
EXAMPLES = ["netlist.csv", "1.6.1.csv", "opmodel_amplifier.csv",
            "opmodel_voltage_buffer.csv", "divider.csv", "buffer.csv",
            "all_components.csv", "test_1.csv", "opamp_amplifier.csv",
            "unconnected_0.csv"]

#: examples/buffer.csv at extreme values: its f32 LU misses the residual
#: gate in both packages, which then take the f64 rescue.
_BUFFER_EXTREME = [["Ri", "R", "1e12", "1", "3"], ["Ro", "R", "1e-3", "1", "2"],
                   ["vs", "E", "10", "3", "g"],
                   ["d1", "VCVS", "1e9", "2", "g", "3", "1"]]

_JMETHOD = {"cpu_f64_rescue": "f64_rescue"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(path_or_rows, jdtype=jnp.float64, tdtype=torch.float64):
    """(JAX solution, port solution) of one netlist on the CPU."""
    if isinstance(path_or_rows, str):
        jn, tn = J.Netlist(path_or_rows), Netlist(path_or_rows)
    else:
        jn = J.Netlist.from_rows(path_or_rows)
        tn = Netlist.from_rows(path_or_rows)
    return (J.Circuit(jn, dtype=jdtype).solve(),
            Circuit(tn, dtype=tdtype, device="cpu").solve())


def _assert_same_solution(js, ts, rtol):
    assert ts.ground == js.ground
    assert ts.result.dtype == np.float64
    assert ts.result.shape == js.result.shape
    scale = max(float(np.abs(js.result).max()), 1e-300)
    err = float(np.abs(ts.result - js.result).max()) / scale
    assert err <= rtol, err
    assert ts.stats["method"] == _JMETHOD.get(js.stats["method"],
                                              js.stats["method"])
    assert set(ts.stats) == set(js.stats)


@pytest.mark.parametrize("name,text,expected", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_goldens_match_jax(tmp_netlist, name, text, expected):
    js, ts = _both(tmp_netlist(text))
    _assert_same_solution(js, ts, 1e-10)
    assert ts.stats["dtype"] == "float64" and ts.stats["backend"] == "cpu"
    if expected is not None:
        for node, value in expected["e"].items():
            np.testing.assert_allclose(ts.potential(node), value, rtol=1e-6,
                                       atol=1e-9)
        for comp, value in expected["i"].items():
            np.testing.assert_allclose(ts.current(comp), value, rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("example", EXAMPLES)
def test_examples_match_jax(example):
    js, ts = _both(f"examples/{example}")
    _assert_same_solution(js, ts, 1e-10)


def test_divider_is_exact():
    """The divider's goldens are exact in both packages, bytes included."""
    js, ts = _both("examples/netlist.csv")
    assert str(ts) == str(js)
    assert str(ts).splitlines() == ["Ground node: 1", "e(2) \t= -1.0",
                                    "e(3) \t= -2.0"]


@pytest.mark.parametrize("example", ["1.6.1.csv", "opmodel_amplifier.csv",
                                     "buffer.csv"])
def test_printed_format_matches_jax(example):
    """Labels, order, tabs and the ground line byte for byte; values within
    1e-12 of the largest printed value (two LAPACK builds, or LAPACK and
    cuSOLVER, may differ in the last bits)."""
    js, ts = _both(f"examples/{example}")
    jl, tl = str(js).splitlines(), str(ts).splitlines()
    assert tl[0] == jl[0] and len(tl) == len(jl)
    scale = float(np.abs(js.result).max())
    for a, b in zip(jl[1:], tl[1:]):
        ka, va = a.split(" \t= ")
        kb, vb = b.split(" \t= ")
        assert ka == kb
        assert abs(float(vb) - float(va)) <= 1e-12 * scale, (a, b)
        assert repr(float(vb)) == vb  # printed as repr of a float64


def test_band_route_matches_jax():
    """A 20×20 mesh grounded at a corner: both packages take the band route
    (block Thomas at B = 1, nb ≥ 2) and agree to 1e-9."""
    rows = list(grid_rows(20, 20, (0, 0), (19, 19))) + [
        ["src", "A", "1", "1", "g"]]
    js, ts = _both(rows)
    assert js.stats["method"] == ts.stats["method"] == "band_thomas"
    circuit = Circuit(Netlist.from_rows(rows), device="cpu")
    assert circuit._band_plan() is not None
    assert band_plan(circuit.stamps).nb >= 2
    _assert_same_solution(js, ts, 1e-9)
    assert ts.stats["residual"] < 1e-12


def test_band_route_f32_matches_jax():
    rows = list(grid_rows(20, 20, (0, 0), (19, 19))) + [
        ["src", "A", "1", "1", "g"]]
    js, ts = _both(rows, jnp.float32, torch.float32)
    assert js.stats["method"] == ts.stats["method"] == "band_thomas"
    assert ts.stats["dtype"] == "float32"
    err = np.abs(ts.result - js.result).max() / np.abs(js.result).max()
    assert err <= 1e-4


def test_single_block_row_takes_the_dense_route():
    """One block row (nb = 1) is no band: the dense LU, in both packages."""
    rows = list(grid_rows(5, 6, (0, 0), (4, 5))) + [["src", "A", "1", "1",
                                                     "g"]]
    js, ts = _both(rows)
    assert js.stats["method"] == ts.stats["method"] == "dense_lu"
    _assert_same_solution(js, ts, 1e-10)


def test_opmodel_amplifier_f32_warns_in_both(caplog):
    """In f32 the amplifier's residual lands between the warning level and
    the failure gate in both packages: the dense answer comes back with the
    same logged warning."""
    with caplog.at_level(logging.WARNING):
        js, ts = _both("examples/opmodel_amplifier.csv", jnp.float32,
                       torch.float32)
    assert js.stats["method"] == ts.stats["method"] == "dense_lu"
    assert js.stats["accuracy_warning"] and ts.stats["accuracy_warning"]
    tcircuit_msgs = [r.getMessage() for r in caplog.records
                     if r.name == "nodal_tpu_torch.circuit"]
    jcircuit_msgs = [r.getMessage() for r in caplog.records
                     if r.name == "nodal_tpu.circuit"]
    assert len(tcircuit_msgs) == len(jcircuit_msgs) == 1
    strip = lambda m: m.split(":", 1)[1]  # noqa: E731 - value differs
    assert strip(tcircuit_msgs[0]) == strip(jcircuit_msgs[0])
    assert tcircuit._RESIDUAL_WARN < ts.stats["residual"] <= \
        tcircuit._RESIDUAL_TOL[torch.float32]
    np.testing.assert_allclose(ts.potential("2"), 1.99976, rtol=1e-3)


def test_f32_rescue_in_both():
    js, ts = _both(_BUFFER_EXTREME, jnp.float32, torch.float32)
    assert js.stats["method"] == "cpu_f64_rescue"
    assert ts.stats["method"] == "f64_rescue"
    _assert_same_solution(js, ts, 1e-10)
    assert ts.stats["residual"] <= tcircuit._RESIDUAL_TOL[torch.float64]


def test_unconnected_raises_in_both():
    for circuit in (J.Circuit(J.Netlist("examples/unconnected_1.csv")),
                    Circuit(Netlist("examples/unconnected_1.csv"),
                            device="cpu")):
        with pytest.raises(Exception) as exc:
            circuit.solve()
        assert type(exc.value).__name__ == "UnconnectedCircuitError"


def test_degenerate_netlists_match_jax():
    """``tests/test_golden.py``'s degenerate cases, in both packages."""
    js, ts = _both([["r1", "R", "1", "1", "g"]])
    assert ts.potential("1") == js.potential("1") == 0.0

    for circuit in (J.Circuit(J.Netlist.from_rows([["a1", "A", "1", "1",
                                                    "g"]])),
                    Circuit(Netlist.from_rows([["a1", "A", "1", "1", "g"]]),
                            device="cpu")):
        with pytest.raises(LinAlgError):
            circuit.solve()

    js, ts = _both([["e1", "E", "5", "1", "g"]])
    _assert_same_solution(js, ts, 1e-12)
    np.testing.assert_allclose(ts.potential("1"), 5.0)
    np.testing.assert_allclose(ts.current("e1"), 0.0, atol=1e-12)

    js, ts = _both([["r1", "R", "2", "a", "b"], ["e1", "E", "4", "a", "b"]])
    assert ts.ground == js.ground == "a"
    np.testing.assert_allclose(ts.potential("b"), -4.0)


def test_zero_resistance_rejected_in_both():
    for C, N in ((J.Circuit, J.Netlist), (Circuit, Netlist)):
        with pytest.raises(ValueError, match="null resistance"):
            C(N.from_rows([["r1", "R", "0", "1", "g"],
                           ["e1", "E", "1", "1", "g"]]))


def test_above_the_rescue_cap_matches_jax(monkeypatch):
    """Past ``_DENSE_RESCUE_MAX_N`` the rescue is the bordered elimination
    in both packages: an unconnected circuit still raises
    ``UnconnectedCircuitError``, and the buffer at extreme values, whose
    f32 LU misses the gate, is rescued to the JAX package's answer."""
    import nodal_tpu.circuit as jcircuit

    monkeypatch.setattr(tcircuit, "_DENSE_RESCUE_MAX_N", 0)
    monkeypatch.setattr(jcircuit, "_DENSE_RESCUE_MAX_N", 0)
    with pytest.raises(J.UnconnectedCircuitError):
        J.Circuit(J.Netlist("examples/unconnected_1.csv")).solve()
    with pytest.raises(UnconnectedCircuitError):
        Circuit(Netlist("examples/unconnected_1.csv"), device="cpu").solve()
    js, ts = _both(_BUFFER_EXTREME, jnp.float32, torch.float32)
    _assert_same_solution(js, ts, 1e-10)
    assert ts.stats["method"] == "f64_rescue"
    assert ts.stats["residual"] <= 1e-10
    # A solve that passes its gate never reaches the rescue.
    s = Circuit(Netlist("examples/1.6.1.csv"), device="cpu").solve()
    assert s.stats["method"] == "dense_lu"


def test_build_model_matches_jax():
    for example in ("1.6.1.csv", "opmodel_amplifier.csv", "divider.csv"):
        G, b = Circuit(Netlist(f"examples/{example}")).build_model()
        jG, jb = J.Circuit(J.Netlist(f"examples/{example}")).build_model()
        assert G.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(G, jG)
        np.testing.assert_array_equal(b, jb)


def test_against_numpy_reference():
    circuit = Circuit(Netlist("examples/1.6.1.csv"), device="cpu")
    G, b = circuit.build_model()
    np.testing.assert_allclose(circuit.solve().result, np.linalg.solve(G, b),
                               rtol=1e-9, atol=1e-12)


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    circuit = Circuit(Netlist("examples/1.6.1.csv"))
    assert circuit.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        circuit.solve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        circuit.batched_solver()


def test_sparse_matches_jax():
    """``Circuit(sparse=True)`` on a circuit with branch rows: the ideal-
    source reduction and the bordered elimination, as in the JAX
    package."""
    js = J.Circuit(J.Netlist("examples/1.6.1.csv"), sparse=True).solve()
    ts = Circuit(Netlist("examples/1.6.1.csv"), sparse=True,
                 device="cpu").solve()
    _assert_same_solution(js, ts, 1e-10)
    assert ts.stats["method"] == "ereduce+schur-skyline"
    assert ts.stats["iterations"] == js.stats["iterations"]
    assert str(ts) == str(js)


def test_constructor_checks():
    with pytest.raises(TypeError, match="Input isn't a netlist"):
        Circuit("examples/1.6.1.csv")
    with pytest.raises(ValueError, match="dtype"):
        Circuit(Netlist("examples/1.6.1.csv"), dtype=torch.float16)


def test_quirks_reach_the_stamps():
    from nodal_tpu_torch import Quirks

    rows = [["e1", "E", "1", "1", "g"], ["r1", "R", "2", "2", "g"],
            ["d", "VCCS", "3", "2", "g", "1", "g"]]
    for quirks, e2 in ((None, 6.0), (Quirks(vccs_as_vcvs=True), 3.0)):
        jq = None if quirks is None else J.Quirks(vccs_as_vcvs=True)
        js = J.Circuit(J.Netlist.from_rows(rows), quirks=jq).solve()
        ts = Circuit(Netlist.from_rows(rows), quirks=quirks,
                     device="cpu").solve()
        np.testing.assert_allclose(ts.potential("2"), e2, rtol=1e-12)
        _assert_same_solution(js, ts, 1e-12)


def test_batched_solver_defaults_to_the_circuits_device():
    circuit = Circuit(Netlist("examples/1.6.1.csv"), device="cpu")
    solver = circuit.batched_solver()
    assert solver.device == torch.device("cpu")
    assert solver is circuit.batched_solver(device="cpu")


def test_solution_accessors_and_constructor():
    netlist = Netlist("examples/1.6.1.csv")
    x = Circuit(netlist, device="cpu").solve().result
    s = Solution(x, netlist, [])  # the reference's positional form
    assert s.potential("g") == 0.0
    np.testing.assert_allclose(s.potential("4"), 8.0)
    np.testing.assert_allclose(s.current("d1"), -2.0)
    assert s.stats is None and s.currents == []


def test_assemble_rhs_matches_jax():
    c = J.Circuit(J.Netlist("examples/1.6.1.csv"))
    stamps = Circuit(Netlist("examples/1.6.1.csv")).stamps
    rng = np.random.default_rng(0)
    params = stamps.params * (1 + 0.1 * rng.standard_normal((3, len(
        stamps.params))))
    got = assemble_rhs(stamps, torch.as_tensor(params))
    for k in range(3):
        np.testing.assert_array_equal(
            got[k].numpy(), np.asarray(jassemble_rhs(c.stamps, params[k])))


def test_solve_refined_and_auto_match_jax():
    rng = np.random.default_rng(1)
    n = 12
    G = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    want = np.linalg.solve(G, b)
    got = dense_solve.solve_refined(torch.as_tensor(G), torch.as_tensor(b))
    jgot = np.asarray(jdense.solve_refined(jnp.asarray(G), jnp.asarray(b)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-13, atol=1e-14)
    # Batched over a leading dimension.
    Gb = torch.as_tensor(np.stack([G, 2 * G]))
    bb = torch.as_tensor(np.stack([b, b]))
    xb = dense_solve.solve_refined(Gb, bb)
    np.testing.assert_allclose(xb[1].numpy(), want / 2, rtol=1e-13,
                               atol=1e-14)
    for dt, jdt, tol in ((torch.float64, jnp.float64, 1e-13),
                         (torch.float32, jnp.float32, 1e-5)):
        x = dense_solve.solve_auto(torch.as_tensor(G), torch.as_tensor(b), dt)
        jx = np.asarray(jdense.solve_auto(jnp.asarray(G), jnp.asarray(b),
                                          jdt))
        assert x.dtype == dt
        np.testing.assert_allclose(x.double().numpy(), jx, rtol=tol,
                                   atol=tol)
