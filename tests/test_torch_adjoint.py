"""The port's adjoint (``nodal_tpu_torch/batch.py:make_adjoint_solver``)
against the JAX package's custom VJP (``nodal_tpu/batch.py``): torch's
gradient of ``Σ w·x`` through the port's ``BatchedSolver`` against
``jax.grad`` of the same loss through the JAX ``BatchedSolver._solve``, on
one ``StampTensors`` carried across, for every tier and every ``refine``
value, on the CPU (the plain solvers; no kernel launches).

Tolerances:

* f64 (``refine=False`` raw and ``refine=True``, f64 output and
  gradient): 1e-9 of max|g| between the packages and against the dense
  f64 autodiff oracle.  Both run one adjoint solve of the same system and
  the same chain rule in f64; they differ by the solves' rounding,
  κ·ε₆₄ ≈ 1e-13 here, and the refinement passes' remaining error.
* ``refine="auto"`` in f32: the contract holds λ = G⁻ᵀx̄ and x each within
  1e-6 of its max norm, and the chain rule rounds each term to f32 before
  pulling it back (as the JAX package does).  So each parameter's gradient
  is within ``(2·1e-6 + ε₃₂)·S_k`` of the f64 truth, where
  ``S_k = Σ_e |∂v_e/∂p_k|·‖λ‖∞·‖x‖∞`` over G entries plus
  ``Σ_e |∂v_e/∂p_k|·‖λ‖∞`` over RHS entries: the contract scaled by the
  chain rule's magnitude, which scales with ‖x̄‖ through λ.  The two
  packages differ by at most twice that.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Circuit as JCircuit  # noqa: E402
from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu import batch as jbatch  # noqa: E402
from nodal_tpu.ops.assemble import assemble_dense as jassemble_dense  # noqa: E402
from nodal_tpu.utils.gridgen import grid_rows, ladder_rows  # noqa: E402
from nodal_tpu_torch import BatchedSolver  # noqa: E402
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch.models import stamps as tstamps  # noqa: E402
from nodal_tpu_torch.ops import block_thomas, lu, pcr, sband  # noqa: E402
from chip_smoke import chain_scale  # noqa: E402  (the bound the card checks)

F64_RTOL = 1e-9
CONTRACT_TOL = 1e-6
EPS32 = float(np.finfo(np.float32).eps)


def _mesh(h, w, extra):
    return list(grid_rows(h, w, (0, 0), (h - 1, w - 1))) + extra


def _random_graph_rows(n, edges, seed):
    """test_torch_schur.py's random graph: no band for RCM to find."""
    rng = np.random.default_rng(seed)
    rows = [["v", "A", "1", "n0", "g"]]
    for k in range(edges):
        a, b = rng.integers(0, n, 2)
        if a != b:
            rows.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
    return rows + [[f"rg{j}", "R", "1", f"n{j}", "g"] for j in range(n)]


SRC = [["src", "A", "1", "n1_1", "g"]]
BRANCH = [["e1", "E", "2", "1", "g"], ["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"]]
# 130 voltage sources on a corner-grounded mesh: 131 right-hand sides for
# the node block, past the block-Thomas kernel's 128 a launch.
MANY_SOURCES = [
    [f"e{k}", "E", str(1 + k % 3), f"n{k % 9}_{2 * k + 1}", "g"]
    for k in range(117)] + [
    [f"f{k}", "E", "1", f"n{(k + 4) % 9}_{2 * k + 2}", "g"] for k in range(13)]

# (rows, solver keywords, batch, the port's tier, the schur sub-branch's
# multi-RHS solve: on the dense node block, the solve on the LU factor).
CASES = {
    "tridiag": (ladder_rows(32), {}, 3, "tridiag", None),
    "sband": (_mesh(9, 40, SRC), {}, 3, "sband", None),
    "band": (_mesh(9, 40, SRC), {"method": "band"}, 3, "band", None),
    "block": (_mesh(5, 20, SRC), {"method": "block"}, 3, "block", None),
    "dense": ([["e1", "E", "5", "1", "g"], ["r1", "R", "2", "1", "2"],
               ["r2", "R", "3", "2", "g"],
               ["d", "VCCS", "0.5", "3", "g", "1", "g"],
               ["r3", "R", "7", "3", "g"]], {}, 3, "dense", None),
    "schur-narrow": (_mesh(16, 17, BRANCH), {}, 3, "schur",
                     "sband_solve_multi"),
    "schur-bandable": (_mesh(60, 60, BRANCH), {}, 2, "schur",
                       "band_solve_multi"),
    "schur-band-scan": (_mesh(9, 240, MANY_SOURCES), {}, 2, "schur",
                        "band_solve_multi"),
    "schur-dense": (_random_graph_rows(300, 900, seed=1)
                    + [["e1", "E", "2", "n1", "g"],
                       ["d1", "VCCS", "0.5", "n3", "g", "n1", "g"]],
                    {"method": "schur"}, 3, "schur", "lu_solve_factored"),
}
# refine value -> dtype of the solver (f64 for the raw and refined tiers,
# f32 for the contract layer).
REFINES = {False: "f64", True: "f64", "auto": "f32"}
# One circuit per tier for the dense f64 oracle.
ORACLE_CASES = ["tridiag", "sband", "band", "block", "dense", "schur-narrow"]

_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    """(JAX circuit, port stamps, params [B, P] f64, weights [B, n])."""
    if name not in _CACHE:
        rows, _, B, _, _ = CASES[name]
        jc = JCircuit(JNetlist.from_rows(rows))
        st = tstamps.stamps_from_reference(jc.stamps)
        rng = np.random.default_rng(11)
        base = jc.stamps.params
        params = np.tile(base, (B, 1)) * rng.uniform(0.9, 1.1, (B, len(base)))
        w = rng.standard_normal((B, st.n))
        _CACHE[name] = (jc, st, params, w)
    return _CACHE[name]


def _dtypes(refine):
    f64 = REFINES[refine] == "f64"
    return (torch.float64 if f64 else torch.float32,
            jnp.float64 if f64 else jnp.float32)


def _torch_grad(st, params, w, dtype, **kw):
    """(x, ∂Σw·x/∂p) through the port's solver on the CPU."""
    solver = BatchedSolver(st, dtype=dtype, device="cpu", **kw)
    p = torch.tensor(params, dtype=dtype, requires_grad=True)
    x = solver(p)
    (torch.as_tensor(w, dtype=x.dtype) * x).sum().backward()
    return solver, x.detach(), p.grad


def _jax_grad(jc, params, w, dtype, **kw):
    solver = jbatch.BatchedSolver(jc, dtype=dtype, **kw)
    wj = jnp.asarray(w)
    g = jax.grad(lambda q: jnp.sum(wj * solver._solve(q)))(
        jnp.asarray(params, dtype))
    return solver, np.asarray(g, dtype=np.float64)


def _dense_truth(jc, params, w):
    """x and λ = G⁻ᵀw per sample, numpy f64 dense solves."""
    xs, lams = [], []
    for p, wk in zip(params, w):
        G, b = (np.asarray(a) for a in jassemble_dense(
            jc.stamps, jnp.asarray(p), dtype=jnp.float64))
        xs.append(np.linalg.solve(G, b))
        lams.append(np.linalg.solve(G.T, wk))
    return np.stack(xs), np.stack(lams)


def _launches():
    return [f.launches for f in (pcr.pcr_solve, sband.sband_solve_multi,
                                 block_thomas.band_solve_multi, lu.lu_factor,
                                 lu.lu_solve_factored)]


@pytest.mark.parametrize("refine", list(REFINES), ids=str)
@pytest.mark.parametrize("name", list(CASES))
def test_grad_matches_reference(name, refine, monkeypatch):
    rows, kw, _, method, multi = CASES[name]
    jc, st, params, w = _case(name)
    tdtype, jdtype = _dtypes(refine)
    before = _launches()
    calls = []
    if multi is not None:
        real = getattr(tbatch, multi)
        monkeypatch.setattr(tbatch, multi,
                            lambda *a: calls.append(1) or real(*a))
    ts, x, g = _torch_grad(st, params, w, tdtype, refine=refine, **kw)
    assert ts.method == method
    # The schur sub-branch named by the case runs, forward and backward.
    assert multi is None or len(calls) >= 2
    assert _launches() == before  # CPU tensors: the plain solvers only
    assert g.dtype == tdtype and g.shape == params.shape
    assert bool(torch.isfinite(g).all())
    js, gj = _jax_grad(jc, params, w, jdtype, refine=refine, **kw)
    assert js.method == method
    g = g.double().numpy()
    if REFINES[refine] == "f64":
        assert np.abs(g - gj).max() <= F64_RTOL * np.abs(gj).max()
        return
    x_true, lam_true = _dense_truth(jc, params.astype(np.float32), w)
    scale = chain_scale(st, params.astype(np.float32).astype(np.float64),
                         x_true, lam_true)
    tol = (2 * CONTRACT_TOL + EPS32) * scale
    assert (np.abs(g - gj) <= 2 * tol).all()


@pytest.mark.parametrize("refine", list(REFINES), ids=str)
@pytest.mark.parametrize("name", list(CASES))
def test_forward_is_unchanged(name, refine, monkeypatch):
    """The adjoint wraps the solve without changing one bit of it, with and
    without a parameter that requires grad."""
    _, kw, _, _, _ = CASES[name]
    _, st, params, _ = _case(name)
    tdtype, _ = _dtypes(refine)
    with_adjoint = BatchedSolver(st, dtype=tdtype, refine=refine,
                                 device="cpu", **kw)
    monkeypatch.setattr(tbatch, "make_adjoint_solver",
                        lambda stamps, solve_batch, solve_rhs_t: solve_batch)
    bare = BatchedSolver(st, dtype=tdtype, refine=refine, device="cpu", **kw)
    want = bare(params)
    assert torch.equal(with_adjoint(params), want)
    p = torch.tensor(params, dtype=tdtype, requires_grad=True)
    got = with_adjoint(p)
    assert got.requires_grad and torch.equal(got.detach(), want)


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_grad_matches_dense_autodiff(name):
    """``tests/test_autodiff.py:_oracle_grad``: reverse mode through dense
    f64 assembly and ``jnp.linalg.solve``, against the raw f64 tier."""
    rows, kw, _, _, _ = CASES[name]
    jc, st, params, w = _case(name)

    def oracle(p, wk):
        G, b = jassemble_dense(jc.stamps, p, dtype=jnp.float64)
        return jnp.sum(wk * jnp.linalg.solve(G, b))

    go = np.asarray(jax.vmap(jax.grad(oracle))(jnp.asarray(params),
                                               jnp.asarray(w)))
    _, _, g = _torch_grad(st, params, w, torch.float64, refine=False, **kw)
    assert np.abs(g.numpy() - go).max() <= F64_RTOL * np.abs(go).max()


def test_auto_grad_within_contract_of_dense_autodiff():
    """The f32 contract tier's gradient against the f64 truth, within the
    bound of the module docstring."""
    jc, st, params, w = _case("sband")
    p32 = params.astype(np.float32).astype(np.float64)
    x_true, lam_true = _dense_truth(jc, p32, w)
    go = np.stack([
        np.asarray(jax.grad(lambda p: jnp.sum(wk * jnp.linalg.solve(
            *jassemble_dense(jc.stamps, p, dtype=jnp.float64))))(
                jnp.asarray(pk))) for pk, wk in zip(p32, w)])
    _, x, g = _torch_grad(st, params, w, torch.float32)
    assert x.dtype == torch.float64
    tol = (2 * CONTRACT_TOL + EPS32) * chain_scale(st, p32, x_true, lam_true)
    assert (np.abs(g.double().numpy() - go) <= tol).all()


def test_zero_valued_source_grad_is_nan_free():
    """A legal 0 V source (the ammeter idiom) must not poison gradients:
    ``stamp_values``'s double-where keeps its 1/x branch out of them."""
    rows = [["e1", "E", "0", "1", "g"], ["r1", "R", "2", "1", "2"],
            ["r2", "R", "3", "2", "g"], ["a1", "A", "1", "2", "g"]]
    jc = JCircuit(JNetlist.from_rows(rows))
    st = tstamps.stamps_from_reference(jc.stamps)
    params = jc.stamps.params[None, :]
    w = np.ones((1, st.n))
    for refine in REFINES:
        tdtype, jdtype = _dtypes(refine)
        _, _, g = _torch_grad(st, params, w, tdtype, refine=refine)
        assert bool(torch.isfinite(g).all())
        _, gj = _jax_grad(jc, params, w, jdtype, refine=refine)
        np.testing.assert_allclose(g.double().numpy(), gj, rtol=1e-6,
                                   atol=1e-12)


def test_grad_of_a_partial_loss_and_batch_rows():
    """A loss that reads one node of one sample: the other samples get a
    zero gradient, and a second backward through a fresh call agrees."""
    _, st, params, _ = _case("tridiag")
    solver = BatchedSolver(st, dtype=torch.float64, refine=False,
                           device="cpu")
    p = torch.tensor(params, requires_grad=True)
    solver(p)[1, 5].backward()
    g1 = p.grad.clone()
    assert bool((g1[0] == 0).all()) and bool((g1[2] == 0).all())
    assert bool((g1[1] != 0).any())
    p.grad = None
    solver(p)[1, 5].backward()
    assert torch.equal(p.grad, g1)
