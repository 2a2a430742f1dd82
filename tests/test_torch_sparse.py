"""The port's resistive sparse backend (``nodal_tpu_torch/ops/sparse.py``,
``ops/cg.py:bicgstab``, ``Circuit(sparse=True)``) against the JAX
package's (``nodal_tpu/ops/sparse.py``) on identical stamps
(``stamps_from_reference``), on the CPU:

* the deduplicated topology array for array;
* ``sparse_values`` and ``coo_matvec`` within 1e-14 of max|JAX| in f64;
* ``solve_sparse_system`` on each route (the skyline, Jacobi-CG and AMG-CG
  forced): x within 1e-9 of max|x| at tol 1e-10, and the CG iterations
  equal or one apart: both loops stop on the same test ||r||² <= tol²·||b||²,
  but their sums round in other orders (``segment_reduce`` here, XLA's
  scatter there), so a residual that crosses the threshold within rounding
  on one side may take one more step;
* Jacobi-BiCGStab on a circuit with branch rows (``general="krylov"``),
  and the bordered elimination for ``general="auto"`` there
  (``tests/test_torch_sparse_schur.py`` holds it whole).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nodal_tpu import Circuit as JCircuit  # noqa: E402
from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu.models.stamps import compile_stamps as jcompile  # noqa: E402
from nodal_tpu.ops import sparse as jsparse  # noqa: E402
from nodal_tpu_torch import Circuit, Netlist  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import sparse  # noqa: E402
from nodal_tpu_torch.ops.cg import bicgstab  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows  # noqa: E402

import jax.numpy as jnp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randnet_rows(n_nodes=300, n_edges=900, seed=0):
    """Unit-range random resistors between random node pairs, a ground tie
    on every 25th node, a 1 A source: no band for RCM to find."""
    rng = np.random.default_rng(seed)
    rows = [["v", "A", "1", "n0", "g"]]
    for k in range(n_edges):
        a, b = rng.integers(0, n_nodes, 2)
        if a != b:
            rows.append([f"r{k}", "R", f"{rng.uniform(0.5, 2.0):.4f}",
                         f"n{a}", f"n{b}"])
    rows += [[f"rg{j}", "R", "1", f"n{j}", "g"]
             for j in range(0, n_nodes, 25)]
    return rows


CIRCUITS = {
    "mesh": list(grid_rows(12, 20, (0, 0), (11, 19)))
    + [["src", "A", "1", "1", "g"]],
    "randnet": _randnet_rows(),
}
# A source-driven mesh with a voltage source and a VCCS: not SPD, and one
# on which Jacobi-BiCGStab converges in both packages (with the E row's
# right-hand side alone it breaks down at once in both).
BRANCH = ([["a1", "A", "1", "n2_2", "g"], ["e1", "E", "2", "n0_0", "g"],
           ["d1", "VCCS", "0.5", "n3_3", "g", "n0_0", "g"]]
          + list(grid_rows(6, 8)))


def _pair(rows):
    jst = jcompile(JNetlist.from_rows(rows))
    return jst, stamps_from_reference(jst)


@pytest.mark.parametrize("name", sorted(CIRCUITS) + ["branch"])
def test_topology_matches_jax(name):
    jst, tst = _pair(CIRCUITS.get(name, BRANCH))
    jt, tt = jsparse.build_sparse_topology(jst), \
        sparse.build_sparse_topology(tst)
    assert tt.n == jt.n
    for f in ("rows", "cols", "entry_to_slot", "diag_slot"):
        got, want = getattr(tt, f), getattr(jt, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(tt.offsets[1:] - tt.offsets[:-1],
                                  np.bincount(tt.rows, minlength=tt.n))


@pytest.mark.parametrize("name", sorted(CIRCUITS) + ["branch"])
def test_values_and_matvec_match_jax(name):
    jst, tst = _pair(CIRCUITS.get(name, BRANCH))
    jt, tt = jsparse._topology(jst), sparse._topology(tst)
    p = np.random.default_rng(1).uniform(0.5, 2.0, len(tst.params))
    vals = sparse.sparse_values(tt, tst, torch.tensor(p))
    jvals = np.asarray(jsparse.sparse_values(jt, jst, jnp.asarray(p)))
    assert vals.dtype == torch.float64
    assert np.abs(vals.numpy() - jvals).max() <= 1e-14 * np.abs(jvals).max()
    x = np.random.default_rng(2).standard_normal((2, tst.n))
    y = sparse.coo_matvec(tt, vals, torch.tensor(x))
    jy = np.stack([np.asarray(jsparse.coo_matvec(jt, jnp.asarray(jvals),
                                                 jnp.asarray(xi)))
                   for xi in x])
    assert y.shape == (2, tst.n)
    assert np.abs(y.numpy() - jy).max() <= 1e-14 * np.abs(jy).max()
    M = sparse.jacobi_preconditioner(tt, vals)
    jM = jsparse.jacobi_preconditioner(jt, jnp.asarray(jvals))
    np.testing.assert_allclose(M(torch.tensor(x[0])).numpy(),
                               np.asarray(jM(jnp.asarray(x[0]))),
                               rtol=1e-15)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
@pytest.mark.parametrize("pre", ["auto", "jacobi", "amg"])
def test_solve_matches_jax(name, pre):
    jst, tst = _pair(CIRCUITS[name])
    x, info = sparse.solve_sparse_system(tst, tst.params, tol=1e-10,
                                         preconditioner=pre, device="cpu")
    jx, jinfo = jsparse.solve_sparse_system(jst, jst.params, tol=1e-10,
                                            preconditioner=pre)
    jx = np.asarray(jx)
    assert x.dtype == torch.float64 and x.shape == (tst.n,)
    assert np.abs(x.numpy() - jx).max() <= 1e-9 * np.abs(jx).max()
    assert info.converged
    if pre == "auto":
        assert info.method == jinfo.method == "skyline"
        assert info.iterations == 1 and info.residual < 1e-12
    else:
        assert info.method == "krylov" and info.preconditioner == pre
        assert abs(info.iterations - int(jinfo.iterations)) <= 1
        assert info.residual <= 1e-10


def test_solve_with_rhs_and_f32():
    jst, tst = _pair(CIRCUITS["mesh"])
    rhs = np.random.default_rng(3).standard_normal(tst.n)
    x, info = sparse.solve_sparse_system(tst, tst.params, rhs=rhs,
                                         preconditioner="jacobi",
                                         tol=1e-10, device="cpu")
    jx, _ = jsparse.solve_sparse_system(jst, jst.params, rhs=rhs,
                                        preconditioner="jacobi", tol=1e-10)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(jx)).max())
    x32, info32 = sparse.solve_sparse_system(
        tst, tst.params, dtype=torch.float32, preconditioner="amg",
        device="cpu")
    ref, _ = sparse.solve_sparse_system(tst, tst.params, device="cpu")
    assert x32.dtype == torch.float32 and info32.converged
    assert info32.residual <= 1e-6
    assert np.abs(x32.double().numpy() - ref.numpy()).max() <= \
        1e-4 * np.abs(ref.numpy()).max()


def test_bicgstab_on_branch_rows_matches_jax():
    jst, tst = _pair(BRANCH)
    assert tst.n > tst.n_kcl
    x, info = sparse.solve_sparse_system(tst, tst.params, tol=1e-10,
                                         general="krylov", device="cpu")
    jx, jinfo = jsparse.solve_sparse_system(jst, jst.params, tol=1e-10,
                                            general="krylov")
    jx = np.asarray(jx)
    assert info.converged and bool(jinfo.converged)
    assert info.method == "krylov" and info.preconditioner == "jacobi"
    assert abs(info.iterations - int(jinfo.iterations)) <= 1
    assert np.abs(x.numpy() - jx).max() <= 1e-9 * np.abs(jx).max()
    dense = JCircuit(JNetlist.from_rows(BRANCH)).solve().result
    assert np.abs(x.numpy() - dense).max() <= 1e-8 * np.abs(dense).max()
    with pytest.raises(ValueError, match="SPD"):
        sparse.solve_sparse_system(tst, tst.params, general="krylov",
                                   preconditioner="amg", device="cpu")


def test_general_auto_on_branch_rows_matches_jax():
    """``general="auto"`` on a circuit with branch rows: the bordered
    elimination in both packages, x within 1e-9 of max|x| in f64 and f32
    (each cast from the f64 solve), the same method and iterations."""
    jst, tst = _pair(BRANCH)
    for dtype, jdtype, tol in ((torch.float64, jnp.float64, 1e-10),
                               (torch.float32, jnp.float32, 1e-6)):
        x, info = sparse.solve_sparse_system(tst, tst.params, dtype=dtype,
                                             device="cpu")
        jx, jinfo = jsparse.solve_sparse_system(jst, jst.params,
                                                dtype=jdtype)
        jx = np.asarray(jx, dtype=np.float64)
        assert x.dtype == dtype
        assert info.method == jinfo.method == "ereduce+schur-skyline"
        assert int(info.iterations) == int(jinfo.iterations)
        assert bool(info.converged) and float(info.residual) <= tol
        assert np.abs(x.double().numpy() - jx).max() <= \
            1e-9 * np.abs(jx).max()
    sol = Circuit(Netlist.from_rows(BRANCH), sparse=True,
                  device="cpu").solve()
    jsol = JCircuit(JNetlist.from_rows(BRANCH), sparse=True).solve()
    assert sol.stats["method"] == jsol.stats["method"]
    assert np.abs(sol.result - jsol.result).max() <= \
        1e-9 * np.abs(jsol.result).max()


def test_bicgstab_batch_freezes_each_sample():
    """Two right-hand sides at once: each sample's x and iterations are
    those of its own solve, as under ``jax.vmap``."""
    _, tst = _pair(BRANCH)
    topo = sparse._topology(tst)
    vals = sparse.sparse_values(topo, tst, torch.tensor(tst.params))
    M = sparse.jacobi_preconditioner(topo, vals)
    rng = np.random.default_rng(4)
    b = torch.tensor(np.stack([rng.standard_normal(tst.n),
                               1e-3 * rng.standard_normal(tst.n)]))
    def mv(x):
        return sparse.coo_matvec(topo, vals, x)
    x, info = bicgstab(mv, b, preconditioner=M, tol=1e-10, maxiter=2000)
    for i in range(2):
        xi, ii = bicgstab(mv, b[i:i + 1], preconditioner=M, tol=1e-10,
                          maxiter=2000)
        assert int(info.iterations[i]) == int(ii.iterations[0])
        np.testing.assert_array_equal(x[i].numpy(), xi[0].numpy())
    assert bool(info.converged.all())


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_circuit_sparse_solve_matches_jax(name):
    rows = CIRCUITS[name]
    sol = Circuit(Netlist.from_rows(rows), sparse=True, device="cpu").solve()
    jsol = JCircuit(JNetlist.from_rows(rows), sparse=True).solve()
    assert sol.stats["method"] == jsol.stats["method"] == "skyline"
    assert sol.stats["iterations"] == 1
    np.testing.assert_allclose(sol.result, jsol.result, rtol=0,
                               atol=1e-12 * np.abs(jsol.result).max())
    assert str(sol) == str(jsol)


def test_circuit_sparse_krylov_route(monkeypatch):
    """With the skyline's profile cap at zero the CPU route is Jacobi-CG
    in both packages (``stats["method"]`` is ``"krylov"``)."""
    from nodal_tpu.ops import skyline as jskyline
    from nodal_tpu_torch.ops import skyline

    monkeypatch.setattr(skyline, "MAX_PROFILE_NNZ", -1)
    monkeypatch.setattr(jskyline, "MAX_PROFILE_NNZ", -1)
    rows = CIRCUITS["mesh"]
    sol = Circuit(Netlist.from_rows(rows), sparse=True, device="cpu").solve()
    jsol = JCircuit(JNetlist.from_rows(rows), sparse=True).solve()
    assert sol.stats["method"] == jsol.stats["method"] == "krylov"
    assert abs(sol.stats["iterations"] - jsol.stats["iterations"]) <= 1
    np.testing.assert_allclose(sol.result, jsol.result, rtol=0,
                               atol=1e-9 * np.abs(jsol.result).max())


@pytest.mark.parametrize("source", ["a", "c"],
                         ids=["island_tied_by_a_source", "floating_island"])
def test_singular_sparse_circuit_like_jax(source):
    """An island of resistors.  Tied to ground only through a current
    source, the graph is connected and the singular system raises
    ``LinAlgError``; floating with no source on it, the system is
    consistent and the solve returns 0 V on the island, in both
    packages."""
    rows = [["r1", "R", "1", "a", "b"], ["r2", "R", "1", "c", "g"],
            ["s", "A", "1", source, "g"]]
    if source == "a":
        with pytest.raises(np.linalg.LinAlgError):
            JCircuit(JNetlist.from_rows(rows), sparse=True).solve()
        with pytest.raises(np.linalg.LinAlgError):
            Circuit(Netlist.from_rows(rows), sparse=True,
                    device="cpu").solve()
        return
    jsol = JCircuit(JNetlist.from_rows(rows), sparse=True).solve()
    sol = Circuit(Netlist.from_rows(rows), sparse=True, device="cpu").solve()
    assert sol.stats["method"] == jsol.stats["method"]
    np.testing.assert_allclose(sol.result, jsol.result, atol=1e-12)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, tst = _pair(CIRCUITS["mesh"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sparse.solve_sparse_system(tst, tst.params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Circuit(Netlist.from_rows(CIRCUITS["mesh"]), sparse=True).solve()
