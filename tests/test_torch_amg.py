"""The port's smoothed-aggregation AMG (``nodal_tpu_torch/ops/amg.py``)
against the JAX package's (``nodal_tpu/ops/amg.py``): the host hierarchy
level for level and array for array (greedy aggregation on a 30×30 grid
and a 2000-node random graph, the vectorized rounds on an 80×80 grid), one
V-cycle application within 1e-13 of max|JAX| in f64, and the 50×50
stamps-against-grid check of ``tests/test_amg.py`` in the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nodal_tpu.ops import amg as jamg  # noqa: E402
from nodal_tpu_torch import Netlist  # noqa: E402
from nodal_tpu_torch.models.stamps import (compile_stamps,  # noqa: E402
                                           stamp_values_np)
from nodal_tpu_torch.ops import amg  # noqa: E402
from nodal_tpu_torch.ops.sparse import _topology  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(h, w):
    stamps = compile_stamps(Netlist.from_rows(
        grid_rows(h, w, (0, 0), (h - 1, w - 1))))
    topo = _topology(stamps)
    g, _ = stamp_values_np(stamps, stamps.params)
    merged = np.zeros(len(topo.rows))
    np.add.at(merged, topo.entry_to_slot, g)
    return stamps.n, topo.rows, topo.cols, merged


def _random_graph(n=2000, seed=1):
    """``tests/test_amg.py``'s expander-like graph (6n random edges)."""
    rng = np.random.default_rng(seed)
    i, j = rng.integers(0, n, (2, 6 * n))
    keep = i != j
    i, j = i[keep], j[keep]
    g = rng.uniform(0.2, 5, len(i))
    rows = np.concatenate([i, j, i, j, [0]]).astype(np.int32)
    cols = np.concatenate([i, j, j, i, [0]]).astype(np.int32)
    vals = np.concatenate([g, g, -g, -g, [1.0]])
    key = rows.astype(np.int64) * n + cols
    uniq, inv = np.unique(key, return_inverse=True)
    merged = np.zeros(len(uniq))
    np.add.at(merged, inv, vals)
    return n, (uniq // n).astype(np.int32), (uniq % n).astype(np.int32), \
        merged


CASES = {"grid30": lambda: _grid(30, 30), "graph2000": _random_graph,
         "grid80_vectorized": lambda: _grid(80, 80)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hierarchy_matches_jax(case):
    n, rows, cols, vals = CASES[case]()
    if case == "grid80_vectorized":
        assert n > amg._VECTORIZED_AGG_N
    levels = amg.build_hierarchy(n, rows, cols, vals)
    jlevels = jamg.build_hierarchy(n, rows, cols, vals)
    assert len(levels) == len(jlevels) >= 2
    for lv, jl in zip(levels, jlevels):
        assert (lv.n, lv.n_coarse) == (jl.n, jl.n_coarse)
        for f in ("rows", "cols", "vals", "diag", "p_rows", "p_cols",
                  "p_vals"):
            got, want = getattr(lv, f), getattr(jl, f)
            if want is None:
                assert got is None, f
                continue
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("case", ["grid30", "graph2000"])
def test_vcycle_matches_jax(case):
    n, rows, cols, vals = CASES[case]()
    levels = amg.build_hierarchy(n, rows, cols, vals)
    r = np.random.default_rng(7).standard_normal((3, n))
    got = amg.make_amg_preconditioner(levels, torch.float64, "cpu")(
        torch.tensor(r))
    jM = jamg.make_amg_preconditioner(levels, jnp.float64)
    want = np.stack([np.asarray(jM(jnp.asarray(ri))) for ri in r])
    assert got.dtype == torch.float64 and got.shape == (3, n)
    assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()


def test_coarse_operator_is_the_sweeps():
    """The coarsest level's dense map equals 2 + ``_COARSE_SWEEPS``
    weighted-Jacobi sweeps from zero, which a level that stopped
    coarsening (here, one too large for the dense map) still runs."""
    n, rows, cols, vals = _grid(12, 12)
    lv = amg.build_hierarchy(n, rows, cols, vals)[-1]
    assert lv.p_rows is None and lv.n <= amg._COARSEST_N
    S = amg.coarse_operator(lv)
    r = np.random.default_rng(3).standard_normal(lv.n)
    A = np.zeros((lv.n, lv.n))
    np.add.at(A, (lv.rows, lv.cols), lv.vals)
    wd = amg._JACOBI_OMEGA / np.diag(A)
    x = np.zeros(lv.n)
    for _ in range(2 + amg._COARSE_SWEEPS):
        x = x + wd * (r - A @ x)
    np.testing.assert_allclose(S @ r, x, rtol=0, atol=1e-12 * np.abs(x).max())
    # Diagonal only: no aggregate merges, so the level stops coarsening
    # above _COARSEST_N and the cycle sweeps instead of one product.
    m = amg._COARSEST_N + 44
    d = np.linspace(1.0, 2.0, m)
    diag_levels = amg.build_hierarchy(m, np.arange(m), np.arange(m), d)
    assert len(diag_levels) == 1 and diag_levels[0].p_rows is None
    arrays = amg.hierarchy_arrays(diag_levels, torch.float64, "cpu")
    assert "coarse" not in arrays[0]
    rr = torch.tensor(np.random.default_rng(4).standard_normal((2, m)))
    got = amg.make_vcycle(arrays)(rr)
    jM = jamg.make_amg_preconditioner(diag_levels, jnp.float64)
    want = np.asarray(jM(jnp.asarray(rr[1].numpy())))
    np.testing.assert_allclose(got[1].numpy(), want, rtol=1e-14)


def test_equiv_large_netlist_stamp_path_matches_grid():
    """The 50×50 grid netlist through the native parser and
    ``equivalent_resistance_stamps`` (the default CPU route, the skyline;
    and forced AMG-CG) against the port's matrix-free grid solve."""
    from nodal_tpu_torch.equiv import equivalent_resistance_stamps
    from nodal_tpu_torch.ops.grid import grid_equivalent_resistance
    from nodal_tpu_torch.ops.sparse import solve_sparse_system
    from nodal_tpu_torch.utils import native
    from nodal_tpu_torch.utils.gridgen import grid_csv

    h = w = 50
    a, b = (10, 10), (40, 40)
    stamps, symbols = native.parse_stamps(grid_csv(h, w, a, b))
    ia, ib = symbols.node_index("1"), symbols.node_index("g")
    r_stamps = equivalent_resistance_stamps(stamps, ia, ib, device="cpu")
    rhs = np.zeros(stamps.n)
    rhs[ia] += 1.0
    if ib >= 0:
        rhs[ib] -= 1.0
    x, info = solve_sparse_system(stamps, stamps.params, rhs=rhs, tol=1e-10,
                                  preconditioner="amg", device="cpu")
    assert info.converged and info.preconditioner == "amg"
    r_amg = float(x[ia]) - (float(x[ib]) if ib >= 0 else 0.0)
    r_geo, _ = grid_equivalent_resistance(h, w, a, b, dtype=torch.float64,
                                          tol=1e-10, device="cpu")
    np.testing.assert_allclose(r_stamps, float(r_geo), rtol=1e-6)
    np.testing.assert_allclose(r_amg, float(r_geo), rtol=1e-6)
