"""The port's command lines (``nodal_tpu_torch/solver_cli.py``,
``nodal_tpu_torch/equiv_cli.py``) with ``--device cpu`` against the JAX
package's (``nodal_tpu/solver_cli.py``, ``nodal_tpu/equiv_cli.py``) on the
cases of ``tests/test_cli.py``: the printed lines (labels, order, tabs and
the ground line byte for byte; values within 1e-12 of the largest printed
value), the exit codes and the messages.  ``-s`` and ``--native on`` on
resistive netlists print what the JAX package prints byte for byte (both
take the skyline LDLᵀ on the CPU); ``solver_cli -s`` on a circuit with
branch rows prints what the JAX package prints byte for byte (both run
the ideal-source reduction and the bordered elimination on the skyline).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nodal_tpu import equiv_cli as jequiv_cli  # noqa: E402
from nodal_tpu import solver_cli as jsolver_cli  # noqa: E402
from nodal_tpu_torch import equiv_cli, solver_cli  # noqa: E402

import fixtures as fx  # noqa: E402

_VCCS_WHERE_IT_MATTERS = "e1,E,1,1,g\nr1,R,2,2,g\nd,VCCS,3,2,g,1,g\n"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, main, argv):
    """(stdout, stderr, exit code) of one CLI call."""
    try:
        main(argv)
        code = 0
    except SystemExit as exc:
        code = exc.code
    out = capsys.readouterr()
    return out.out, out.err, code


def _assert_same_lines(port: str, ref: str):
    pl, rl = port.splitlines(), ref.splitlines()
    assert len(pl) == len(rl), (port, ref)
    vals = [float(ln.split(" \t= ")[1]) for ln in rl if " \t= " in ln]
    scale = max((abs(v) for v in vals), default=1.0)
    for p, r in zip(pl, rl):
        if " \t= " not in r:
            assert p == r
            continue
        kp, vp = p.split(" \t= ")
        kr, vr = r.split(" \t= ")
        assert kp == kr
        assert abs(float(vp) - float(vr)) <= 1e-12 * scale, (p, r)


@pytest.mark.parametrize("text", [fx.DIVIDER, fx.CIRCUIT_161, fx.BUFFER,
                                  fx.OPMODEL_AMPLIFIER, fx.ALL_TYPES,
                                  fx.UNCONNECTED_0],
                         ids=["divider", "161", "buffer", "opmodel", "all",
                              "unconnected_0"])
def test_solver_cli_matches_jax(tmp_netlist, capsys, text):
    path = tmp_netlist(text)
    out, err, code = _run(capsys, solver_cli.main, [path, "--device", "cpu"])
    jout, _, jcode = _run(capsys, jsolver_cli.main, [path])
    assert code == jcode == 0
    _assert_same_lines(out, jout)


def test_solver_cli_divider_bytes(tmp_netlist, capsys):
    out, _, _ = _run(capsys, solver_cli.main,
                     [tmp_netlist(fx.DIVIDER), "--device", "cpu"])
    assert out == "Ground node: 1\ne(2) \t= -1.0\ne(3) \t= -2.0\n"


def test_solver_cli_missing_file_exit_1(capsys):
    for main, extra in ((solver_cli.main, ["--device", "cpu"]),
                        (jsolver_cli.main, [])):
        out, err, code = _run(capsys, main,
                              ["/nonexistent/netlist.csv", *extra])
        assert code == 1 and out == ""


def test_solver_cli_unconnected_exit_1(tmp_netlist, capsys):
    path = tmp_netlist(fx.UNCONNECTED_1)
    for main, extra in ((solver_cli.main, ["--device", "cpu"]),
                        (jsolver_cli.main, [])):
        out, _, code = _run(capsys, main, [path, *extra])
        assert code == 1 and out == ""


def test_solver_cli_compat_vccs(tmp_netlist, capsys):
    """Quirk Q1: correct VCCS semantics give e(2) = 6.0; ``--compat-vccs``
    restores upstream's 3.0; both packages alike."""
    path = tmp_netlist(_VCCS_WHERE_IT_MATTERS)
    for flags, e2 in (([], 6.0), (["--compat-vccs"], 3.0)):
        out, _, _ = _run(capsys, solver_cli.main,
                         [path, "--device", "cpu", *flags])
        jout, _, _ = _run(capsys, jsolver_cli.main, [path, *flags])
        _assert_same_lines(out, jout)
        line = next(ln for ln in out.splitlines() if ln.startswith("e(2)"))
        np.testing.assert_allclose(float(line.split("= ")[1]), e2,
                                   rtol=1e-9)


@pytest.mark.parametrize("text,target", [
    (fx.DIVIDER, "e(2)"), (fx.CIRCUIT_161, "e(2)"), (fx.CIRCUIT_161, "i(e1)"),
    (fx.OPMODEL_AMPLIFIER, "e(2)")], ids=["divider", "161_e2", "161_ie1",
                                          "opmodel"])
def test_solver_cli_sensitivity_matches_jax(tmp_netlist, capsys, text,
                                            target):
    path = tmp_netlist(text)
    out, _, code = _run(capsys, solver_cli.main,
                        [path, "--device", "cpu", "--sensitivity", target])
    jout, _, jcode = _run(capsys, jsolver_cli.main,
                          [path, "--sensitivity", target])
    assert code == jcode == 0
    sol, sens = out.split(f"Sensitivities of {target}:\n")
    jsol, jsens = jout.split(f"Sensitivities of {target}:\n")
    _assert_same_lines(sol, jsol)
    pl, rl = sens.splitlines(), jsens.splitlines()
    assert [ln.split(" \t= ")[0] for ln in pl] == \
        [ln.split(" \t= ")[0] for ln in rl]
    pv = np.array([float(ln.split(" \t= ")[1]) for ln in pl])
    rv = np.array([float(ln.split(" \t= ")[1]) for ln in rl])
    assert np.abs(pv - rv).max() <= 1e-8 * max(np.abs(rv).max(), 1.0)


def test_solver_cli_sensitivity_divider_analytic(tmp_netlist, capsys):
    out, _, _ = _run(capsys, solver_cli.main,
                     [tmp_netlist(fx.DIVIDER), "--device", "cpu",
                      "--sensitivity", "e(2)"])
    sens = {ln.split(" \t= ")[0][4:-1]: float(ln.split(" \t= ")[1])
            for ln in out.splitlines() if ln.startswith("d/d(")}
    np.testing.assert_allclose(sens["1"], -1.0, atol=1e-9)
    np.testing.assert_allclose(sens["r3"], -1.0, atol=1e-9)
    np.testing.assert_allclose(sens["r2"], 0.0, atol=1e-9)


@pytest.mark.parametrize("target", ["2", "e(nope)", "i(r2)"])
def test_solver_cli_sensitivity_bad_target_exit_1(tmp_netlist, capsys,
                                                  target):
    path = tmp_netlist(fx.DIVIDER)
    _, err, code = _run(capsys, solver_cli.main,
                        [path, "--device", "cpu", "--sensitivity", target])
    _, jerr, jcode = _run(capsys, jsolver_cli.main,
                          [path, "--sensitivity", target])
    assert code == jcode == 1
    assert err == jerr


def test_solver_cli_stats_and_dtype(tmp_netlist, capsys):
    path = tmp_netlist(fx.CIRCUIT_161)
    out, err, code = _run(capsys, solver_cli.main,
                          [path, "--device", "cpu", "--stats",
                           "--dtype", "f32"])
    assert code == 0 and out.startswith("Ground node: g")
    assert "method: dense_lu" in err and "residual:" in err


def test_solver_cli_sparse_matches_jax(tmp_netlist, capsys):
    """``-s`` on a circuit with branch rows runs the bordered elimination
    and prints what the JAX package prints, byte for byte."""
    path = tmp_netlist(fx.CIRCUIT_161)
    out, _, code = _run(capsys, solver_cli.main,
                        ["-s", path, "--device", "cpu"])
    jout, _, jcode = _run(capsys, jsolver_cli.main, ["-s", path])
    assert code == jcode == 0
    assert out == jout


def test_solver_cli_default_device_raises_without_cuda(tmp_netlist):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solver_cli.main([tmp_netlist(fx.CIRCUIT_161)])


@pytest.mark.parametrize("text,nodes,expected", [
    (fx.RESISTIVE_1, [], 2.0), (fx.RESISTIVE_2, [], 1.0),
    (fx.RESISTIVE_3, [], 1.0), (fx.RESISTIVE_1, ["--nodes", "2", "g"], 1.0)],
    ids=["r1", "r2", "r3", "r1_nodes"])
def test_resistance_cli_matches_jax(tmp_netlist, capsys, text, nodes,
                                    expected):
    path = tmp_netlist(text)
    out, _, code = _run(capsys, equiv_cli.main,
                        [path, "--device", "cpu", *nodes])
    jout, _, jcode = _run(capsys, jequiv_cli.main, [path, *nodes])
    assert code == jcode == 0
    assert out.startswith("R = ")
    r, jr = float(out.split("= ")[1]), float(jout.split("= ")[1])
    assert abs(r - jr) <= 1e-12 * abs(jr)
    np.testing.assert_allclose(r, expected, rtol=1e-8)


def test_resistance_cli_example_bytes(capsys):
    out, _, _ = _run(capsys, equiv_cli.main,
                     ["examples/resistive_1.csv", "--device", "cpu"])
    assert out == "R = 2.0\n"


@pytest.mark.parametrize("text,needle", [
    (fx.CIRCUIT_161, "Resistors are the only component allowed"),
    ("ra, R, 1, 5, 6\nrb, R, 1, 6, g\n", "not found")],
    ids=["non_resistive", "missing_node"])
def test_resistance_cli_invalid_exit_1(tmp_netlist, capsys, text, needle):
    path = tmp_netlist(text)
    out, _, code = _run(capsys, equiv_cli.main, [path, "--device", "cpu"])
    jout, _, jcode = _run(capsys, jequiv_cli.main, [path])
    assert code == jcode == 1
    assert out == jout
    assert out.startswith("Invalid netlist\n") and needle in out


def test_resistance_cli_missing_file_exit_1(capsys):
    out, _, code = _run(capsys, equiv_cli.main,
                        ["/nonexistent/netlist.csv", "--device", "cpu"])
    assert code == 1 and out == ""


def test_resistance_cli_sparse_is_a_usage_error(tmp_netlist, capsys):
    """``-s`` is no usage error any more: on a resistive netlist it prints
    the JAX package's line byte for byte."""
    path = tmp_netlist(fx.RESISTIVE_1)
    out, err, code = _run(capsys, equiv_cli.main, ["-s", path, "--device",
                                                   "cpu"])
    jout, _, jcode = _run(capsys, jequiv_cli.main, ["-s", path])
    assert code == jcode == 0 and err == ""
    assert out == jout == "R = 2.0\n"


def _grid_csv(tmp_netlist, h=9, w=13):
    from nodal_tpu_torch.utils.gridgen import grid_csv

    return tmp_netlist(grid_csv(h, w, (1, 2), (h - 2, w - 3), 1.7),
                       name="grid.csv")


@pytest.mark.parametrize("flags", [["-s"], ["--native", "on"],
                                   ["-s", "--native", "on"]],
                         ids=["sparse", "native", "both"])
@pytest.mark.parametrize("which", ["r1", "r3", "grid"])
def test_resistance_cli_sparse_and_native_bytes(tmp_netlist, capsys, flags,
                                                which):
    path = (_grid_csv(tmp_netlist) if which == "grid" else tmp_netlist(
        {"r1": fx.RESISTIVE_1, "r3": fx.RESISTIVE_3}[which]))
    out, _, code = _run(capsys, equiv_cli.main,
                        [path, "--device", "cpu", *flags])
    jout, _, jcode = _run(capsys, jequiv_cli.main, [path, *flags])
    assert code == jcode == 0
    assert out == jout and out.startswith("R = ")


@pytest.mark.parametrize("text", [fx.CIRCUIT_161,
                                  "ra, R, 1, 5, 6\nrb, R, 1, 6, g\n"],
                         ids=["non_resistive", "missing_node"])
def test_resistance_cli_native_invalid_exit_1(tmp_netlist, capsys, text):
    path = tmp_netlist(text)
    argv = [path, "--native", "on"]
    out, _, code = _run(capsys, equiv_cli.main, [*argv, "--device", "cpu"])
    jout, _, jcode = _run(capsys, jequiv_cli.main, argv)
    assert code == jcode == 1
    assert out == jout and out.startswith("Invalid netlist\n")


def test_resistance_cli_native_auto_takes_large_files(tmp_netlist, capsys,
                                                      monkeypatch):
    """``--native auto`` parses natively from 256 KiB up: with the
    threshold lowered, the C++ parser runs; with it high, it does not."""
    from nodal_tpu_torch import solver_cli as cli
    from nodal_tpu_torch.utils import native

    assert cli._NATIVE_SIZE_THRESHOLD == \
        jequiv_cli._NATIVE_SIZE_THRESHOLD == 256 * 1024
    calls = []
    real = native.parse_stamps
    monkeypatch.setattr(native, "parse_stamps",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    path = _grid_csv(tmp_netlist)
    for threshold, native_calls in ((1 << 30, 0), (16, 1)):
        monkeypatch.setattr(cli, "_NATIVE_SIZE_THRESHOLD", threshold)
        out, _, code = _run(capsys, equiv_cli.main, [path, "--device",
                                                     "cpu"])
        assert code == 0 and out.startswith("R = ")
        assert len(calls) == native_calls


@pytest.mark.parametrize("flags", [["-s"], ["--native", "on"]],
                         ids=["sparse", "native"])
@pytest.mark.parametrize("which", ["r2", "grid"])
def test_solver_cli_sparse_and_native_bytes(tmp_netlist, capsys, flags,
                                            which):
    from nodal_tpu_torch.utils.gridgen import grid_rows

    if which == "grid":
        rows = list(grid_rows(9, 13, (1, 2), (7, 10))) + [
            ["src", "A", "1", "1", "g"]]
        path = tmp_netlist("\n".join(",".join(r) for r in rows) + "\n")
    else:
        path = tmp_netlist(fx.RESISTIVE_2 + "src, A, 1, 1, g\n")
    out, err, code = _run(capsys, solver_cli.main,
                          [path, "--device", "cpu", "--stats", *flags])
    jout, jerr, jcode = _run(capsys, jsolver_cli.main,
                             [path, "--stats", *flags])
    assert code == jcode == 0
    assert out == jout
    assert "skyline" in err and "iterations: 1" in err


def test_solver_cli_native_hands_branch_rows_to_python(tmp_netlist, capsys):
    """``--native on`` with branch rows: the native path keeps the netlist
    and solves it with the general sparse backend (the bordered
    elimination on the native stamps, which carry no ideal-source
    metadata to reduce), as the JAX package does: the same bytes and the
    same method.  Only a solve that does not converge goes on to the
    Python path."""
    path = tmp_netlist(fx.CIRCUIT_161)
    out, err, code = _run(capsys, solver_cli.main,
                          [path, "--device", "cpu", "--native", "on",
                           "--stats"])
    jout, jerr, jcode = _run(capsys, jsolver_cli.main,
                             [path, "--native", "on", "--stats"])
    assert code == jcode == 0
    assert out == jout
    assert "method: native+schur-skyline" in err
    assert "method: native+schur-skyline" in jerr


def test_solver_cli_default_device_sparse_raises_without_cuda(tmp_netlist):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    path = tmp_netlist(fx.RESISTIVE_2 + "src, A, 1, 1, g\n")
    for flags in (["-s"], ["--native", "on"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            solver_cli.main([path, *flags])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            equiv_cli.main([tmp_netlist(fx.RESISTIVE_1), *flags])
