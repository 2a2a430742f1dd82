"""The port's bordered elimination (``nodal_tpu_torch/ops/sparse_schur.py``)
and its wiring (``Circuit(sparse=True)``, the rescue above the dense cap,
``sensitivities``, both CLIs' ``-s``) against the JAX package's
(``nodal_tpu/ops/sparse_schur.py``) on the cases of
``tests/test_sparse_schur.py``, on the CPU:

* the partition plan array for array;
* x within 1e-8 of max|x| of the JAX package's x and of a dense f64
  solve, the residual at most tol and the same method label, on the
  default route (the host skyline first) and on the card's route
  (``a11="cg"``, host AMG-CG here; the JAX package's with
  ``NODAL_TPU_NO_SKYLINE=1``); the κ ≈ 1e12 opamp chain within 1e-6, the
  bound of its oracle test;
* transpose solves, the factorization cache they share with the forward
  solve, and ``general_sparse_adjoint_gradient`` (pbar within 1e-7 of the
  JAX package's, relative);
* the unconnected and singular-but-connected circuits raising the same
  errors;
* ``-s`` (and ``--native on``) on every ``examples/*.csv`` through both
  CLIs with ``--device cpu``, byte for byte with the JAX package's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import nodal_tpu as J  # noqa: E402
from nodal_tpu import equiv_cli as jequiv_cli  # noqa: E402
from nodal_tpu import solver_cli as jsolver_cli  # noqa: E402
from nodal_tpu.models.stamps import compile_stamps as jcompile  # noqa: E402
from nodal_tpu.ops import sparse_schur as jschur  # noqa: E402
from nodal_tpu_torch import (Circuit, Netlist,  # noqa: E402
                             UnconnectedCircuitError, equiv_cli, solver_cli)
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch import circuit as tcircuit  # noqa: E402
from nodal_tpu_torch.models.stamps import (stamp_values_np,  # noqa: E402
                                           stamps_from_reference)
from nodal_tpu_torch.ops import sparse_schur  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh_rows(h, w, ground_resistor=True):
    """tests/test_sparse_schur.py's mesh with E, VCCS and CCCS sources;
    without ``ground_resistor`` grounded only through the E's."""
    rows = list(grid_rows(h, w, None, (0, 0) if ground_resistor else None))
    return rows + [["e1", "E", "2", "n0_1", "g"],
                   ["e2", "E", "-1", "n1_0", "g"],
                   ["d1", "VCCS", "0.5", "n2_2", "g", "n0_1", "g"],
                   ["rdrv", "R", "2", "n3_1", "n3_2"],
                   ["f1", "CCCS", "1.5", "n2_1", "g", "n3_1", "n3_2",
                    "rdrv"]]


def _opmodel_rows(stages=4):
    """tests/test_sparse_schur.py's chain of OPMODEL buffers (κ ~1e12)."""
    rows, prev = [["e1", "E", "1", "in", "g"]], "in"
    for k in range(stages):
        rows += [[f"op{k}", "OPMODEL", "0", f"b{k}", "g", prev, f"b{k}"],
                 [f"rl{k}", "R", "1000", f"b{k}", "g"]]
        prev = f"b{k}"
    return rows


def _pair(rows):
    jst = jcompile(J.Netlist.from_rows(rows))
    return jst, stamps_from_reference(jst)


def _dense(stamps):
    g, r = stamp_values_np(stamps, stamps.params)
    G = np.zeros((stamps.n, stamps.n))
    np.add.at(G, (stamps.g_rows, stamps.g_cols), g)
    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, r)
    return G, b


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


def _route(monkeypatch, a11):
    """The JAX package's counterpart of ``a11``: its environment switch."""
    monkeypatch.setenv("NODAL_TPU_NO_SKYLINE", "1" if a11 == "cg" else "0")


@pytest.mark.parametrize("ground_resistor", [True, False])
def test_plan_matches_jax(ground_resistor):
    jst, tst = _pair(_mesh_rows(6, 6, ground_resistor))
    plan, jplan = sparse_schur.general_plan(tst), jschur.general_plan(jst)
    for f in dataclasses.fields(plan):
        a, b = getattr(plan, f.name), getattr(jplan, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(
        sparse_schur.resistively_grounded_nodes(tst),
        jschur.resistively_grounded_nodes(jst))
    kbe = tst.n - tst.n_kcl
    assert plan.m == kbe + (0 if ground_resistor else 1)
    assert sparse_schur.general_plan(tst) is plan


@pytest.mark.parametrize("a11", ["auto", "skyline", "cg"])
@pytest.mark.parametrize("ground_resistor", [True, False])
def test_solve_matches_jax_and_dense(monkeypatch, ground_resistor, a11):
    _route(monkeypatch, a11)
    jst, tst = _pair(_mesh_rows(8, 12, ground_resistor))
    jx, jinfo = jschur.solve_general_sparse(jst, tol=1e-10)
    x, info = sparse_schur.solve_general_sparse(tst, tol=1e-10, a11=a11,
                                                device="cpu")
    G, b = _dense(tst)
    assert bool(info.converged) and float(info.residual) <= 1e-10
    assert info.method == jinfo.method == (
        "schur" if a11 == "cg" else "schur-skyline")
    assert _rel(x, jx) <= 1e-8
    assert _rel(x, np.linalg.solve(G, b)) <= 1e-8


def test_no_resistors_and_rhs_override():
    """Source-held nodes (the border is nearly the whole system; with no
    resistor at all K1 is empty) and the probe-injection ``rhs=`` path."""
    for rows, n1 in (([["e1", "E", "3", "1", "g"]], 0),
                     ([["e1", "E", "3", "1", "g"],
                       ["e2", "E", "1", "2", "1"],
                       ["r1", "R", "1", "2", "g"]], 1)):
        jst, tst = _pair(rows)
        x, info = sparse_schur.solve_general_sparse(tst, device="cpu")
        jx, _ = jschur.solve_general_sparse(jst)
        assert sparse_schur.general_plan(tst).n1 == n1
        assert _rel(x, jx) <= 1e-8 and bool(info.converged)
        assert _rel(x, np.linalg.solve(*_dense(tst))) <= 1e-8
    sol = Circuit(Netlist.from_rows(rows), sparse=True, device="cpu").solve()
    np.testing.assert_allclose([sol.potential("1"), sol.potential("2")],
                               [3.0, 4.0], atol=1e-9)

    jst, tst = _pair(_mesh_rows(6, 8))
    rhs = np.zeros(tst.n)
    rhs[0], rhs[5] = 1.0, -1.0
    x, info = sparse_schur.solve_general_sparse(tst, rhs=rhs, device="cpu")
    jx, _ = jschur.solve_general_sparse(jst, rhs=rhs)
    G, _ = _dense(tst)
    assert bool(info.converged)
    assert _rel(x, jx) <= 1e-8
    assert _rel(x, np.linalg.solve(G, rhs)) <= 1e-8


@pytest.mark.parametrize("a11", ["auto", "cg"])
def test_circuit_sparse_matches_jax(monkeypatch, a11):
    """``Circuit(sparse=True).solve()`` routes through the reduction and
    the bordered elimination in both packages (``a11="cg"`` through
    ``solve_sparse_system``'s own call, as the card runs it)."""
    _route(monkeypatch, a11)
    rows = _mesh_rows(10, 10)
    if a11 == "cg":
        real = sparse_schur.solve_general_auto

        def cg_route(*args, **kw):
            return real(*args, **kw, a11="cg")

        monkeypatch.setattr("nodal_tpu_torch.ops.sparse.solve_general_auto",
                            cg_route)
    sol = Circuit(Netlist.from_rows(rows), sparse=True, device="cpu").solve()
    jsol = J.Circuit(J.Netlist.from_rows(rows), sparse=True).solve()
    G, b = Circuit(Netlist.from_rows(rows)).build_model()
    assert sol.stats["method"] == jsol.stats["method"] == (
        "ereduce+schur-skyline" if a11 == "auto" else "ereduce+schur")
    assert _rel(sol.result, jsol.result) <= 1e-8
    assert _rel(sol.result, np.linalg.solve(G, b)) <= 1e-8


def test_opmodel_chain_matches_jax():
    """The κ ~1e12 opamp chain: within 1e-6, the bound of its oracle test
    (tests/test_sparse_schur.py:166-168)."""
    rows = _opmodel_rows()
    sol = Circuit(Netlist.from_rows(rows), sparse=True, device="cpu").solve()
    jsol = J.Circuit(J.Netlist.from_rows(rows), sparse=True).solve()
    G, b = Circuit(Netlist.from_rows(rows)).build_model()
    assert sol.stats["method"] == jsol.stats["method"]
    for k in range(4):
        assert abs(sol.potential(f"b{k}") - 1.0) < 1e-3
    assert _rel(sol.result, jsol.result) <= 1e-6
    assert _rel(sol.result, np.linalg.solve(G, b)) <= 1e-6


def test_errors_match_jax():
    """A floating island raises UnconnectedCircuitError, an island tied in
    only through a VCCS output (connected, singular) LinAlgError, in both
    packages."""
    island = list(grid_rows(4, 4, (0, 0), (3, 3))) + [
        ["ri", "R", "1", "x1", "x2"], ["e1", "E", "1", "1", "g"]]
    singular = list(grid_rows(4, 4, (0, 0), (3, 3))) + [
        ["ri", "R", "1", "x1", "x2"],
        ["dv", "VCCS", "0.5", "x1", "g", "1", "g"],
        ["e1", "E", "1", "1", "g"]]
    with pytest.raises(J.UnconnectedCircuitError):
        J.Circuit(J.Netlist.from_rows(island), sparse=True).solve()
    with pytest.raises(UnconnectedCircuitError):
        Circuit(Netlist.from_rows(island), sparse=True, device="cpu").solve()
    with pytest.raises(np.linalg.LinAlgError):
        J.Circuit(J.Netlist.from_rows(singular), sparse=True).solve()
    with pytest.raises(np.linalg.LinAlgError):
        Circuit(Netlist.from_rows(singular), sparse=True,
                device="cpu").solve()


def test_rescue_above_the_cap_matches_jax(monkeypatch):
    """Above the dense-rescue cap the rescue is the bordered elimination,
    in both packages."""
    import nodal_tpu.circuit as jcircuit

    rows = _mesh_rows(16, 16)
    monkeypatch.setattr(tcircuit, "_DENSE_RESCUE_MAX_N", 10)
    monkeypatch.setattr(jcircuit, "_DENSE_RESCUE_MAX_N", 10)
    x, residual = Circuit(Netlist.from_rows(rows), sparse=True,
                          device="cpu")._rescue(torch.device("cpu"))
    jx, jresidual = J.Circuit(J.Netlist.from_rows(rows),
                              sparse=True)._rescue()
    G, b = Circuit(Netlist.from_rows(rows)).build_model()
    assert residual < 1e-8 and jresidual < 1e-8
    assert _rel(x, jx) <= 1e-8
    assert _rel(x, np.linalg.solve(G, b)) <= 1e-8


def test_refinement_escalation_reaches_tol():
    """A deliberately loose setup tolerance on the CG route still lands at
    the target, by extra passes or the rebuild at tol, in both."""
    jst, tst = _pair(_mesh_rows(8, 8))
    x, info = sparse_schur.solve_general_sparse(tst, tol=1e-10, setup_tol=1e-2,
                                                a11="cg", device="cpu")
    jx, _ = jschur.solve_general_sparse(jst, tol=1e-10, setup_tol=1e-2)
    assert bool(info.converged) and float(info.residual) <= 1e-10
    assert _rel(x, jx) <= 1e-8


@pytest.mark.parametrize("a11", ["auto", "cg"])
@pytest.mark.parametrize("ground_resistor", [True, False])
def test_transpose_matches_jax_and_dense(monkeypatch, ground_resistor, a11):
    _route(monkeypatch, a11)
    jst, tst = _pair(_mesh_rows(6, 7, ground_resistor))
    c = np.random.default_rng(7).standard_normal(tst.n)
    y, info = sparse_schur.solve_general_sparse_transpose(
        tst, rhs=c, a11=a11, device="cpu")
    jy, jinfo = jschur.solve_general_sparse_transpose(jst, rhs=c)
    G, _ = _dense(tst)
    assert bool(info.converged)
    assert info.method == jinfo.method == (
        "schur-T-skyline" if a11 == "auto" else "schur-T")
    assert _rel(y, jy) <= 1e-8
    assert _rel(y, np.linalg.solve(G.T, c)) <= 1e-8


def test_transpose_reuses_forward_factorization():
    _, tst = _pair(_mesh_rows(6, 7))
    sparse_schur.solve_general_sparse(tst, a11="cg", device="cpu")
    fact = tst._general_fact["fact"]
    rhs = np.zeros(tst.n)
    rhs[3] = 1.0
    _, info = sparse_schur.solve_general_sparse_transpose(
        tst, rhs=rhs, a11="cg", device="cpu")
    assert bool(info.converged)
    assert tst._general_fact["fact"] is fact


@pytest.mark.parametrize("a11", ["auto", "cg"])
def test_adjoint_gradient_matches_jax_and_autograd(monkeypatch, a11):
    """pbar within 1e-7 of the JAX package's and of torch autograd through
    a dense f64 solve."""
    from nodal_tpu_torch.ops.assemble import assemble_dense

    _route(monkeypatch, a11)
    jst, tst = _pair(_mesh_rows(6, 7))
    pbar, _, info_f, info_a = sparse_schur.general_sparse_adjoint_gradient(
        tst, 5, a11=a11, device="cpu")
    jpbar, _, _, _ = jschur.general_sparse_adjoint_gradient(jst, 5)
    assert bool(info_f.converged) and bool(info_a.converged)
    p = torch.tensor(tst.params, dtype=torch.float64, requires_grad=True)
    G, b = assemble_dense(tst, p[None])
    torch.linalg.solve(G, b)[0, 5].backward()
    oracle = p.grad.numpy()
    assert np.abs(pbar - jpbar).max() <= 1e-7 * np.abs(jpbar).max()
    assert np.abs(pbar - oracle).max() <= 1e-7 * np.abs(oracle).max()


@pytest.mark.parametrize("seed", [40_003, 40_017, 40_031, 40_049])
def test_controlled_chain_fuzz_matches_jax(seed):
    """tests/test_sparse_schur.py's torture seeds: E, VCCS, a CCVS driven
    by the E, a CCCS driven by the CCVS and an OPMODEL follower, forward
    and transposed, against the JAX package and the dense oracle."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 80))
    rows = [[f"rc{i}", "R", f"{rng.uniform(0.3, 5):.5f}", f"n{i}",
             f"n{i + 1}"] for i in range(n - 1)]
    rows.append(["rg", "R", "1", "n0", "g"])
    nE = int(rng.integers(0, n))
    nH = int(rng.integers(0, n))
    rows.append(["e0", "E", f"{rng.uniform(1, 4):.4f}", f"n{nE}", "g"])
    rows.append(["d0", "VCCS", "0.3", f"n{rng.integers(0, n)}", "g",
                 f"n{rng.integers(0, n)}", "g"])
    rows.append(["h0", "CCVS", "0.7", f"n{nH}", "g", f"n{nE}", "g", "e0"])
    rows.append(["f0", "CCCS", "0.5", f"n{rng.integers(0, n)}", "g",
                 f"n{nH}", "g", "h0"])
    rows.append(["u0", "OPMODEL", "0", "uo", "g",
                 f"n{int(rng.integers(0, n))}", "uo"])
    rows.append(["rl", "R", "100", "uo", "g"])
    jst, tst = _pair(rows)
    G, b = _dense(tst)
    x, info = sparse_schur.solve_general_auto(tst, tol=1e-10, device="cpu")
    jx, jinfo = jschur.solve_general_auto(jst, tol=1e-10)
    assert bool(info.converged) and info.method == jinfo.method
    assert _rel(x, jx) <= 1e-8
    assert _rel(x, np.linalg.solve(G, b)) <= 1e-7
    c = rng.standard_normal(tst.n)
    y, info_t = sparse_schur.solve_general_auto_transpose(
        tst, rhs=c, tol=1e-10, device="cpu")
    jy, jinfo_t = jschur.solve_general_auto_transpose(jst, rhs=c, tol=1e-10)
    assert bool(info_t.converged) and info_t.method == jinfo_t.method
    assert _rel(y, jy) <= 1e-8
    assert _rel(y, np.linalg.solve(G.T, c)) <= 1e-7


def test_sensitivities_sparse_match_dense_route():
    """``sensitivities`` of a sparse circuit (the bordered adjoint) against
    the same circuit's dense route, node and branch-current outputs."""
    rows = _mesh_rows(6, 7)
    sparse_c = Circuit(Netlist.from_rows(rows), sparse=True, device="cpu")
    dense_c = Circuit(Netlist.from_rows(rows), device="cpu")
    for kw in ({"potential": "n2_3"}, {"current": "e1"}):
        got = tbatch.sensitivities(sparse_c, **kw)
        want = tbatch.sensitivities(dense_c, **kw)
        assert list(got) == list(want)
        scale = max(max(abs(v) for v in want.values()), 1.0)
        for name in want:
            assert abs(got[name] - want[name]) <= 1e-8 * scale, name


def test_border_caps_by_device(monkeypatch):
    """The CG tier's border cap: ``_BORDER_CAP`` on the CPU as in the JAX
    package, ``_BORDER_CAP_NATIVE`` on CUDA, both under the YB bytes cap;
    the host skyline extends the CPU's, never the card's."""
    _, tst = _pair(_mesh_rows(6, 6))
    plan = sparse_schur.general_plan(tst)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for m, cpu_cg, card in ((4096, True, True), (4097, False, True),
                            (16384, False, True), (16385, False, False)):
        wide = dataclasses.replace(plan, m=m)
        assert sparse_schur._plan_viable(tst, wide, cpu, "cg") is cpu_cg
        assert sparse_schur._plan_viable(tst, wide, cuda, "auto") is card
        assert sparse_schur._plan_viable(tst, wide, cpu, "auto") is (
            m <= 16384)
    big = dataclasses.replace(plan, m=8192, n1=(8 << 30) // (8 * 8192) + 1)
    assert not sparse_schur._plan_viable(tst, big, cuda, "auto")
    with pytest.raises(ValueError, match="skyline"):
        sparse_schur._check_route("skyline", cuda)
    with pytest.raises(ValueError, match="a11"):
        sparse_schur._check_route("lu", cpu)


def _run(capsys, main, argv):
    try:
        main(argv)
        code = 0
    except SystemExit as exc:
        code = exc.code
    out = capsys.readouterr()
    return out.out, code


EXAMPLES = ["1.6.1.csv", "all_components.csv", "buffer.csv", "divider.csv",
            "netlist.csv", "opamp_amplifier.csv", "opmodel_amplifier.csv",
            "opmodel_voltage_buffer.csv", "resistive_1.csv",
            "resistive_2.csv", "resistive_3.csv", "test_1.csv",
            "unconnected_0.csv", "unconnected_1.csv"]


@pytest.mark.parametrize("flags", [["-s"], ["-s", "--native", "on"]],
                         ids=["sparse", "native"])
@pytest.mark.parametrize("example", EXAMPLES)
def test_cli_sparse_examples_match_jax(capsys, example, flags):
    """Both CLIs with ``-s`` on every example: the port's output and exit
    code equal the JAX package's, byte for byte (the skyline on both
    sides; unconnected_1 exits 1 in both; equiv_cli refuses a netlist
    with sources in both)."""
    path = f"examples/{example}"
    for port, ref in ((solver_cli.main, jsolver_cli.main),
                      (equiv_cli.main, jequiv_cli.main)):
        out, code = _run(capsys, port, [path, *flags, "--device", "cpu"])
        jout, jcode = _run(capsys, ref, [path, *flags])
        assert (out, code) == (jout, jcode)
