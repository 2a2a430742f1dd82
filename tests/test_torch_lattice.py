"""The 3-D resistor lattice on the ``band`` tier (block Thomas) against the
plain PyTorch reference of the benchmark (``benchmark/reference/
mna_torch.py``: the nodal equations built from the rows, dense f64
``torch.linalg.solve``), on seeded 5 % normal spreads, on the CPU; and
that reference against SciPy's sparse LU."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nodal_tpu_torch import BatchedSolver, Circuit, Netlist  # noqa: E402
from nodal_tpu_torch.ops.band import band_plan  # noqa: E402
from nodal_tpu_torch.utils.gridgen import weighted_lattice_rows  # noqa: E402

REFERENCE = Path(__file__).resolve().parents[1] / "benchmark" / "reference"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"plain_{name}", REFERENCE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


mna_torch = _load("mna_torch")
lattice = _load("lattice")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors (beside other test
    processes the default pool oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sweep(dims, B, seed):
    """The lattice's rows, its circuit and B parameter samples: every
    component times 1 + 0.05·N(0, 1)."""
    rows = lattice.lattice_rows(*dims)
    circuit = Circuit(Netlist.from_rows(rows))
    slots = circuit.stamps.param_slot
    assert [slots[row[0]] for row in rows] == list(range(len(rows)))
    base = mna_torch.NodalTorch.values(rows)
    gen = torch.Generator().manual_seed(seed)
    params = base * (1 + 0.05 * torch.randn((B, len(base)), generator=gen,
                                            dtype=torch.float64))
    return rows, circuit, params


def _worst(x, rows, params):
    ref = mna_torch.NodalTorch(rows).solve(params)
    return float(mna_torch.rel_errors(x.to(torch.float64), ref).max())


@pytest.mark.parametrize("dtype, refine, tol", [
    # refine="auto": f32 block Thomas inside the exact-f64 contract layer,
    # which promises 1e-6 of the largest potential.
    (torch.float32, "auto", 1e-6),
    # Raw f64 block Thomas: no pivoting, but the grounded Laplacian is
    # SPD with κ ~ 1e3 here, so the error is ~κ·ε64 ~ 1e-13; 1e-10 keeps
    # three decades of room and fails any f32 step (~1e-7).
    (torch.float64, False, 1e-10),
], ids=["f32-auto", "f64-raw"])
def test_forced_band_tier_matches_reference(dtype, refine, tol):
    rows, circuit, params = _sweep((12, 6, 6), 4, seed=11)
    plan = band_plan(circuit.stamps)
    assert plan is not None and plan.nb >= 2
    solver = BatchedSolver(circuit, dtype=dtype, refine=refine,
                           method="band", device="cpu")
    assert solver.method == "band"
    x = solver(params.to(dtype))
    assert x.dtype == torch.float64
    assert _worst(x, rows, params.to(dtype).to(torch.float64)) <= tol


def test_published_lattice_takes_the_band_tier():
    """The 20×10×10 lattice of the benchmark's ``lattice2k``: ``auto``
    chooses ``band`` with 16 block rows of 128 (the kernel's shape), and
    the f32 contract layer holds 1e-6."""
    rows, circuit, params = _sweep((20, 10, 10), 2, seed=12)
    assert (circuit.stamps.n, len(rows)) == (1999, 5501)
    solver = BatchedSolver(circuit, dtype=torch.float32, device="cpu")
    assert solver.method == "band" and solver.refine == "auto"
    plan = band_plan(circuit.stamps)
    assert (plan.nb, plan.kb) == (16, 128)
    p32 = params.to(torch.float32)
    x = solver(p32)
    assert x.dtype == torch.float64
    assert _worst(x, rows, p32.to(torch.float64)) <= 1e-6


def test_reference_matches_scipy_sparse_lu():
    sp = pytest.importorskip("scipy.sparse")
    spla = pytest.importorskip("scipy.sparse.linalg")
    rows, _, params = _sweep((5, 4, 3), 1, seed=13)
    ref = mna_torch.NodalTorch(rows)
    G, b = ref.system(params)
    x = ref.solve(params)
    # The same matrix from SciPy's COO sum of the same stamps.
    r, c, s, p = (t.numpy() for t in ref.g)
    G_sp = sp.csc_matrix((s / params[0].numpy()[p], (r, c)),
                         shape=(ref.n, ref.n))
    np.testing.assert_array_equal(G_sp.toarray(), G[0].numpy())
    x_sp = spla.spsolve(G_sp, b[0].numpy())
    # Two f64 factorizations of a 59-unknown SPD system (κ ~ 1e2).
    np.testing.assert_allclose(x[0].numpy(), x_sp, rtol=0, atol=1e-12)


def test_frozen_rows_are_the_repos_lattice():
    """The benchmark's lattice rows equal ``chip_smoke.py``'s
    ``lattice_rows`` (unit conductances through ``weighted_lattice_rows``,
    a 1 A source), the source's value spelled as a float."""
    d, h, w = 4, 3, 5
    repo = list(weighted_lattice_rows(
        np.ones((d, h, w - 1)), np.ones((d, h - 1, w)),
        np.ones((d - 1, h, w)), (0, 0, 0), (d - 1, h - 1, w - 1)))
    assert lattice.lattice_rows(d, h, w) == repo + [
        ["src", "A", "1.0", "1", "g"]]
