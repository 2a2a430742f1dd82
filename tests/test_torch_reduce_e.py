"""The port's ideal-voltage-constraint reduction
(``nodal_tpu_torch/ops/reduce_e.py``) and the general solve on top of it
(``ops/sparse_schur.py:solve_general_auto`` and its transpose) against the
JAX package's (``nodal_tpu/ops/reduce_e.py``, ``ops/sparse_schur.py``), on
the cases of ``tests/test_reduce_e.py``, on the CPU:

* the reduction plan, the reduced stamps among it, array for array;
* x within 1e-8 of max|x| of the JAX package's x and of a dense f64 solve,
  converged, and the same method label, on the default route (the host
  skyline) and on the card's route (``a11="cg"``, host AMG-CG here, the
  JAX package's with ``NODAL_TPU_NO_SKYLINE=1``);
* the transpose solve and the adjoint gradient through the reduction
  (pbar within 1e-7 of the JAX package's, relative);
* E-cycles and parallel E's raising ``LinAlgError`` in both.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nodal_tpu.models.stamps import compile_stamps as jcompile  # noqa: E402
from nodal_tpu.netlist import Netlist as JNetlist  # noqa: E402
from nodal_tpu.ops import reduce_e as jreduce  # noqa: E402
from nodal_tpu.ops import sparse_schur as jschur  # noqa: E402
from nodal_tpu_torch.models.stamps import (stamp_values_np,  # noqa: E402
                                           stamps_from_reference)
from nodal_tpu_torch.ops import reduce_e, sparse_schur  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rows):
    jst = jcompile(JNetlist.from_rows(rows))
    return jst, stamps_from_reference(jst)


def _dense(stamps):
    g, r = stamp_values_np(stamps, stamps.params)
    G = np.zeros((stamps.n, stamps.n))
    np.add.at(G, (stamps.g_rows, stamps.g_cols), g)
    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, r)
    return G, b


def _assert_same_fields(port, ref):
    """Every dataclass field of ``port`` equal to ``ref``'s, arrays
    exactly, nested dataclasses (the reduced stamps) field by field."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _assert_same_fields(a, b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _rel(x, ref):
    return np.abs(x - ref).max() / max(np.abs(ref).max(), 1.0)


CASES = {
    "e_to_ground_divider": ([["e1", "E", "5", "1", "g"],
                             ["r1", "R", "1", "1", "2"],
                             ["r2", "R", "2", "2", "g"]], 1),
    "floating_e": ([["e1", "E", "2", "2", "3"], ["r1", "R", "1", "1", "2"],
                    ["r2", "R", "3", "3", "g"], ["i1", "A", "1", "1", "g"]],
                   1),
    "e_chain": ([["e1", "E", "1", "1", "g"], ["e2", "E", "2", "2", "1"],
                 ["e3", "E", "0.5", "3", "2"], ["r1", "R", "1", "3", "4"],
                 ["r2", "R", "2", "4", "g"]], 3),
    "mixed_border": ([["e1", "E", "3", "1", "g"], ["r1", "R", "1", "1", "2"],
                      ["r2", "R", "2", "2", "g"],
                      ["d1", "VCCS", "0.5", "2", "g", "1", "g"],
                      ["rdrv", "R", "2", "2", "3"],
                      ["f1", "CCCS", "1.5", "3", "g", "2", "3", "rdrv"]], 1),
    "e_driving_cccs_kept": ([["e1", "E", "3", "1", "g"],
                             ["r1", "R", "1", "1", "2"],
                             ["r2", "R", "2", "2", "g"],
                             ["f1", "CCCS", "0.5", "2", "g", "1", "g",
                              "e1"]], 0),
    "pure_e": ([["e1", "E", "2", "1", "g"], ["e2", "E", "5", "2", "1"],
                ["r4", "R", "4", "2", "g"], ["r1", "R", "1", "1", "2"]], 2),
    "vcvs_and_e": ([["e1", "E", "2", "1", "g"], ["r1", "R", "1", "1", "2"],
                    ["r2", "R", "1", "2", "g"],
                    ["v1", "VCVS", "3", "3", "g", "2", "g"],
                    ["r3", "R", "2", "3", "g"]], 1),
}
METHODS = {"e_driving_cccs_kept": "schur", "pure_e": "ereduce"}


def _border_mesh_rows(h=16, w=16):
    """The large-border mesh of tests/test_reduce_e.py cut to 16×16: an E
    to ground on every top node and E's between rows 2–13."""
    rows = list(grid_rows(h, w))
    for col in range(w):
        rows.append([f"eg{col}", "E", str(1.0 + 0.01 * col), f"n0_{col}",
                     "g"])
    for r in range(2, 14, 2):
        for col in range(0, w, 2):
            rows.append([f"e{r}_{col}", "E", str(0.01 * r), f"n{r}_{col}",
                         f"n{r + 1}_{col}"])
    return rows


CASES["border_mesh"] = (_border_mesh_rows(), 16 + 6 * 8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reduction_plan_matches_jax(name):
    rows, n_elim = CASES[name]
    jst, tst = _pair(rows)
    jred, red = jreduce.build_e_reduction(jst), reduce_e.build_e_reduction(tst)
    if n_elim == 0:
        assert red is None and jred is None
        return
    assert len(red.elim) == n_elim
    _assert_same_fields(red, jred)
    assert reduce_e.e_reduction_or_none(tst) is reduce_e.e_reduction_or_none(
        tst)


@pytest.mark.parametrize("a11", ["auto", "cg"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax(monkeypatch, name, a11):
    rows, _ = CASES[name]
    jst, tst = _pair(rows)
    monkeypatch.setenv("NODAL_TPU_NO_SKYLINE", "1" if a11 == "cg" else "0")
    tol = 1e-10 if name == "border_mesh" else 1e-12
    jx, jinfo = jschur.solve_general_auto(jst, tol=tol)
    x, info = sparse_schur.solve_general_auto(tst, tol=tol, a11=a11,
                                              device="cpu")
    G, b = _dense(tst)
    assert bool(info.converged) and bool(jinfo.converged)
    assert info.method == jinfo.method
    want = METHODS.get(name, "ereduce+schur")
    skyline = "-skyline" if a11 == "auto" and want != "ereduce" else ""
    assert info.method == want + skyline
    assert float(info.residual) <= 10 * tol
    assert _rel(x, jx) <= 1e-8
    assert _rel(x, np.linalg.solve(G, b)) <= 1e-8


def test_fuzz_matches_jax_and_dense():
    """Random resistor networks with random eliminable E forests and a
    source (tests/test_reduce_e.py's fuzz, 12 draws): the port within
    1e-8 of the JAX package and of a dense f64 solve."""
    rng = np.random.default_rng(7)
    for trial in range(12):
        n_nodes = int(rng.integers(6, 16))
        labels = [f"n{i}" for i in range(n_nodes)] + ["g"]
        rows = []
        for i in range(n_nodes):
            j = labels[int(rng.integers(0, i))] if i else "g"
            rows.append([f"r{i}", "R", f"{rng.uniform(0.5, 5):.4f}",
                         labels[i], j])
        for k in range(int(rng.integers(0, 2 * n_nodes))):
            a, b = rng.choice(n_nodes + 1, size=2, replace=False)
            rows.append([f"rx{k}", "R", f"{rng.uniform(0.5, 5):.4f}",
                         labels[a], labels[b]])
        rows.append(["i1", "A", "1.5", labels[0], "g"])
        parent = list(range(n_nodes + 1))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        added = 0
        for _ in range(3 * n_nodes):
            a, b = rng.choice(n_nodes + 1, size=2, replace=False)
            ra, rb = find(a), find(b)
            if ra == rb:
                continue
            parent[ra] = rb
            rows.append([f"e{added}", "E", f"{rng.uniform(-2, 2):.4f}",
                         labels[a], labels[b]])
            added += 1
            if added >= n_nodes // 2:
                break
        jst, tst = _pair(rows)
        jx, jinfo = jschur.solve_general_auto(jst, tol=1e-12)
        x, info = sparse_schur.solve_general_auto(tst, tol=1e-12,
                                                  device="cpu")
        G, b = _dense(tst)
        assert info.method == jinfo.method, trial
        assert _rel(x, jx) <= 1e-8, trial
        assert _rel(x, np.linalg.solve(G, b)) <= 1e-8, trial


_ADJOINT_ROWS = [["e1", "E", "3", "1", "g"], ["e2", "E", "1", "2", "1"],
                 ["r1", "R", "1", "2", "3"], ["r2", "R", "2", "3", "g"],
                 ["d1", "VCCS", "0.5", "3", "g", "2", "g"],
                 ["i1", "A", "0.7", "3", "g"]]


@pytest.mark.parametrize("a11", ["auto", "cg"])
def test_transpose_matches_jax_and_dense(monkeypatch, a11):
    monkeypatch.setenv("NODAL_TPU_NO_SKYLINE", "1" if a11 == "cg" else "0")
    jst, tst = _pair(_ADJOINT_ROWS)
    c = np.random.default_rng(0).standard_normal(tst.n)
    jy, jinfo = jschur.solve_general_auto_transpose(jst, rhs=c, tol=1e-12)
    y, info = sparse_schur.solve_general_auto_transpose(
        tst, rhs=c, tol=1e-12, a11=a11, device="cpu")
    G, _ = _dense(tst)
    assert info.method == jinfo.method
    assert info.method == "ereduce+schur-T" + ("-skyline" if a11 == "auto"
                                               else "")
    assert bool(info.converged)
    assert _rel(y, jy) <= 1e-8
    assert _rel(y, np.linalg.solve(G.T, c)) <= 1e-8


@pytest.mark.parametrize("a11", ["auto", "cg"])
def test_adjoint_gradient_matches_jax(monkeypatch, a11):
    monkeypatch.setenv("NODAL_TPU_NO_SKYLINE", "1" if a11 == "cg" else "0")
    jst, tst = _pair(_ADJOINT_ROWS)
    jp, jx, _, _ = jschur.general_sparse_adjoint_gradient(jst, 2, tol=1e-12)
    p, x, info_f, info_a = sparse_schur.general_sparse_adjoint_gradient(
        tst, 2, tol=1e-12, a11=a11, device="cpu")
    assert bool(info_f.converged) and bool(info_a.converged)
    assert np.abs(p - jp).max() <= 1e-7 * np.abs(jp).max()
    assert _rel(x, jx) <= 1e-8


def test_e_cycles_raise_in_both():
    cycle = [["e1", "E", "1", "1", "g"], ["e2", "E", "1", "2", "1"],
             ["e3", "E", "2", "2", "g"], ["r1", "R", "1", "2", "g"]]
    parallel = [["e1", "E", "1", "1", "g"], ["e2", "E", "1", "1", "g"],
                ["r1", "R", "1", "1", "g"]]
    for rows in (cycle, parallel):
        jst, tst = _pair(rows)
        with pytest.raises(np.linalg.LinAlgError):
            jreduce.build_e_reduction(jst)
        with pytest.raises(np.linalg.LinAlgError, match="Singular matrix"):
            reduce_e.build_e_reduction(tst)
        with pytest.raises(np.linalg.LinAlgError):
            sparse_schur.solve_general_auto(tst, device="cpu")
        with pytest.raises(np.linalg.LinAlgError):
            sparse_schur.general_auto_viable(tst, device="cpu")
