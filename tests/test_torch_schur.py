"""The port's ``schur`` tier against the JAX package on branch circuits:
meshes driven by a voltage source, plus a VCCS (two branch equations), as
the JAX package's bench builds them.

* 16×17 (n_kcl = 271): the narrow node block, the scalar-band sub-branch.
* 60×60 (n_kcl = 3599, half-bandwidth 60): the bandable node block, the
  block-Thomas sub-branch.
* 91×91 (n_kcl = 8280): past the dense SPD probe, so the banded probe.
* A 300-node random resistor graph with a voltage source (no band the
  banded sub-branches take): the dense node block on the blocked LU; and
  the JAX package's 8×8 dense-method circuit (E, VCCS and CCCS, n_kcl =
  63) forced onto the tier, which the port serves with its scalar-band
  sub-branch.

On the CPU the JAX package solves these with its dense ``schur_solve``
sub-branch (node blocks up to 2048 nodes) or its band scan (past them,
in f64 for ``refine=True``); the port takes the sub-branch it takes on
every device.  The tier (``method == "schur"``) is the same; the tests
compare answers, not sub-branches.

Tolerances: assembly exact in f64; the raw f32 tier 1e-5 from the JAX
package on the 16×17 mesh (two f32 algorithms, κ ≈ 1e3) and twice the JAX
package's own error on the wider meshes (κ·ε₃₂ ≈ 1e-4 there: two f32
algorithms cannot agree better); the f64 tiers 1e-9 from it where the
f32 solve contracts the error by ~1e-6 a pass, and 1e-6 (the contract)
from numpy f64 dense solves everywhere; the raw f64 tier 1e-10.
"""

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Circuit as JCircuit  # noqa: E402
from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu import batch as jbatch  # noqa: E402
from nodal_tpu.ops import band as jband  # noqa: E402
from nodal_tpu.ops import scalar_band as jsb  # noqa: E402
from nodal_tpu.ops.assemble import assemble_dense as jassemble_dense  # noqa: E402
from nodal_tpu_torch import BatchedSolver, Circuit, Netlist  # noqa: E402
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import band as tband  # noqa: E402
from nodal_tpu_torch.ops import block_thomas, sband  # noqa: E402
from nodal_tpu_torch.ops import scalar_band as tsb  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows, ladder_rows  # noqa: E402

H, W, B = 16, 17, 6


def _branch_rows(h, w):
    return list(grid_rows(h, w, (0, 0), (h - 1, w - 1))) + [
        ["e1", "E", "2", "1", "g"],
        ["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"]]


def _rel(x, ref):
    return float(np.abs(np.asarray(x) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def _dense_f64(jc, params, rhs=None, transpose=False):
    out = []
    for k, p in enumerate(params):
        G, b = jassemble_dense(jc.stamps, jnp.asarray(p), dtype=jnp.float64)
        G = np.asarray(G).T if transpose else np.asarray(G)
        out.append(np.linalg.solve(G, np.asarray(b) if rhs is None
                                   else rhs[k]))
    return np.stack(out)


@pytest.fixture(scope="module")
def branch():
    rows = _branch_rows(H, W)
    jc = JCircuit(JNetlist.from_rows(rows))
    st = stamps_from_reference(jc.stamps)
    base = jc.stamps.params
    rng = np.random.default_rng(0)
    params = (base * (1.0 + 0.05 * rng.standard_normal((B, len(base))))
              ).astype(np.float32).astype(np.float64)
    return jc, st, params, _dense_f64(jc, params), rows


def test_branch_circuit_shape(branch):
    jc, st, _, _, _ = branch
    assert st.n_kcl == H * W - 1 >= 256 and st.n - st.n_kcl == 2
    assert tsb.sband_plan(st) is None
    plan = tsb.node_sband_plan(st)
    assert plan is not None and sband.sband_fits(plan.W1, 3)


@pytest.mark.parametrize("case", ["branch", "floating_source_node",
                                  "ladder"])
def test_schur_probe_matches_reference(branch, case):
    if case == "branch":
        rows = branch[4]
    elif case == "floating_source_node":
        # Node x is held only by a voltage source: A is singular.
        rows = branch[4] + [["e2", "E", "1", "x", "g"]]
    else:
        rows = ladder_rows(8)[1:] + [["v0", "E", "1", "n0", "g"]]
    jc = JCircuit(JNetlist.from_rows(rows))
    st = stamps_from_reference(jc.stamps)
    want = jbatch._schur_supported(jc.stamps)
    assert tbatch._schur_supported(st) == want
    assert st.__dict__["_schur_ok"] == want
    assert want == (case != "floating_source_node")


def test_schur_assembler_matches_reference_exactly(branch):
    jc, st, params, _, _ = branch
    jplan = jsb.node_sband_plan(jc.stamps)
    tplan = tsb.node_sband_plan(st)
    with jax.enable_x64(True):
        want = jax.vmap(jbatch._schur_band_assembler(
            jc.stamps, jnp.float64, jplan))(jnp.asarray(params))
    got = tbatch._schur_band_assembler(st, torch.float64, tplan)(
        torch.as_tensor(params))
    for name, g, w in zip(("W", "B", "C", "D", "bk", "bb"), got, want):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_solver_matches_reference(branch, refine):
    jc, st, params, ref, _ = branch
    js = jbatch.BatchedSolver(jc, dtype=jnp.float32, refine=refine)
    ts = BatchedSolver(st, refine=refine, device="cpu")
    assert js.method == ts.method == "schur"
    want = np.asarray(js(params))
    got = ts(params)
    assert got.shape == (B, st.n)
    if refine is False:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= 1e-5
    else:
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), want) <= 1e-9
        assert _rel(got.numpy(), ref) <= 1e-6
        res = ts.residuals(params, got)
        assert float(res.max()) <= 1e-6
        np.testing.assert_allclose(
            res.numpy(), np.asarray(js.residuals(params, got.numpy())),
            rtol=0, atol=1e-12)


def test_raw_f64_matches_reference(branch):
    jc, st, params, ref, _ = branch
    js = jbatch.BatchedSolver(jc, dtype=jnp.float64, refine=False)
    ts = BatchedSolver(st, dtype=torch.float64, refine=False, device="cpu")
    assert js.method == ts.method == "schur"
    got = ts(params)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), np.asarray(js(params))) <= 1e-10
    assert _rel(got.numpy(), ref) <= 1e-10


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_transposed_solve_matches_reference(branch, refine):
    """Gᵀλ = rhs, the adjoint's solve: the border blocks swap."""
    jc, st, params, _, _ = branch
    rhs = np.random.default_rng(1).standard_normal((B, st.n))
    want = np.asarray(jbatch.BatchedSolver(
        jc, dtype=jnp.float32, refine=refine)._solve_rhs_t(
            jnp.asarray(params, jnp.float32), jnp.asarray(rhs)))
    got = BatchedSolver(st, refine=refine, device="cpu")._solve_rhs_t(
        torch.as_tensor(params, dtype=torch.float32), torch.as_tensor(rhs))
    assert _rel(got.numpy(), want) <= (1e-5 if refine is False else 1e-9)
    truth = _dense_f64(jc, params, rhs, transpose=True)
    assert _rel(got.numpy(), truth) <= (1e-4 if refine is False else 1e-6)


def test_batch_result_current_matches_reference(branch):
    jc, _, _, _, rows = branch
    values = np.linspace(0.25, 1.0, 4)
    want = jbatch.sweep(jc, "d1", values, refine=True)
    got = tbatch.sweep(Circuit(Netlist.from_rows(rows)), "d1", values,
                       refine=True, device="cpu")
    for name in ("e1", "d1"):
        cur = got.current(name)
        assert cur.shape == (4,) and bool(torch.isfinite(cur).all())
        np.testing.assert_allclose(cur.numpy(), np.asarray(want.current(name)),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.potential("n3_3").numpy(),
                               np.asarray(want.potential("n3_3")),
                               rtol=1e-9, atol=1e-12)


def test_cpu_solver_never_launches_the_kernel(branch):
    _, st, params, _, _ = branch
    before = sband.sband_solve_multi.launches
    BatchedSolver(st, device="cpu")(params)
    assert sband.sband_solve_multi.launches == before == 0


@pytest.fixture(scope="module")
def big_branch():
    """The 91×91 branch circuit (n_kcl = 8280) in both packages."""
    jc = JCircuit(JNetlist.from_rows(_branch_rows(91, 91)))
    return jc, stamps_from_reference(jc.stamps)


def test_large_node_block_banded_probe_matches_reference(big_branch):
    """Past 8192 nodes both packages probe the node block with a banded
    f64 Cholesky on its block-band plan: SPD on the 91×91 branch circuit,
    not on a 25×330 strip (n_kcl = 8250) with a node held only by a
    voltage source."""
    floating = JCircuit(JNetlist.from_rows(
        _branch_rows(25, 330) + [["e2", "E", "1", "x", "g"]]))
    for jc, st, want in (
            (*big_branch, True),
            (floating, stamps_from_reference(floating.stamps), False)):
        assert st.n_kcl > tbatch._SCHUR_DENSE_PROBE_MAX_NK
        plan = tband.node_band_plan(st)
        assert plan is not None and plan.nb >= 2
        assert jbatch._schur_supported(jc.stamps) is want
        assert tbatch._schur_supported(st) is want
        assert st.__dict__["_schur_ok"] is want


def test_large_node_block_solve_matches_reference(big_branch):
    """One B = 2 sweep of the 91×91 branch circuit: the banded probe, then
    the block-Thomas sub-branch (the JAX package's f64 band scan on the
    CPU)."""
    jc, st = big_branch
    base = jc.stamps.params
    params = (base * (1.0 + 0.05 * np.random.default_rng(2).standard_normal(
        (2, len(base))))).astype(np.float32).astype(np.float64)
    js = jbatch.BatchedSolver(jc, dtype=jnp.float32, refine=True)
    ts = BatchedSolver(st, refine=True, device="cpu")
    assert js.method == ts.method == "schur"
    got = ts(params)
    want = np.asarray(js(params))
    assert got.dtype == torch.float64 and got.shape == (2, st.n)
    assert _rel(got.numpy(), want) <= 1e-9
    assert float(ts.residuals(params, got).max()) <= 1e-9


@pytest.fixture(scope="module")
def wide_branch():
    """(JAX circuit, port stamps, params, f64 dense solutions, rows, the
    dense LU factors of each sample for the transposed solves)."""
    rows = _branch_rows(60, 60)
    jc = JCircuit(JNetlist.from_rows(rows))
    st = stamps_from_reference(jc.stamps)
    base = jc.stamps.params
    params = (base * (1.0 + 0.05 * np.random.default_rng(3).standard_normal(
        (2, len(base))))).astype(np.float32).astype(np.float64)
    factors, ref = [], []
    for p in params:
        G, b = jassemble_dense(jc.stamps, jnp.asarray(p), dtype=jnp.float64)
        factors.append(sla.lu_factor(np.asarray(G)))
        ref.append(sla.lu_solve(factors[-1], np.asarray(b)))
    return jc, st, params, np.stack(ref), rows, factors


def test_wide_branch_takes_the_block_band_sub_branch(wide_branch):
    jc, st, _, _, _, _ = wide_branch
    assert tsb.node_sband_plan(st) is None
    plan = tband.node_band_plan(st)
    jplan = jband.node_band_plan(jc.stamps)
    assert (plan.kb, plan.nb, plan.n) == (jplan.kb, jplan.nb, jplan.n)
    assert plan.kb == 128 and plan.nb >= 2 and st.n - st.n_kcl + 1 <= 128


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_wide_branch_solver_matches_reference(wide_branch, refine):
    jc, st, params, ref, _, _ = wide_branch
    js = jbatch.BatchedSolver(jc, dtype=jnp.float32, refine=refine)
    ts = BatchedSolver(st, refine=refine, device="cpu")
    assert js.method == ts.method == "schur"
    want = np.asarray(js(params))
    before = block_thomas.band_solve_multi.launches
    got = ts(params)
    # The CPU tensors take the plain solver: the kernel never launches.
    assert block_thomas.band_solve_multi.launches == before == 0
    assert got.shape == (len(params), st.n)
    if refine is False:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), ref) <= max(2 * _rel(want, ref), 1e-5)
        return
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) <= 1e-6
    if refine is True:
        assert _rel(got.numpy(), want) <= 1e-9
    res = ts.residuals(params, got)
    assert float(res.max()) <= 1e-6
    np.testing.assert_allclose(
        res.numpy(), np.asarray(js.residuals(params, got.numpy())),
        rtol=0, atol=1e-12)


def test_wide_branch_transposed_solve_meets_contract(wide_branch):
    jc, st, params, _, _, factors = wide_branch
    rhs = np.random.default_rng(4).standard_normal((len(params), st.n))
    got = BatchedSolver(st, device="cpu")._solve_rhs_t(
        torch.as_tensor(params, dtype=torch.float32), torch.as_tensor(rhs))
    want = np.asarray(jbatch.BatchedSolver(jc, dtype=jnp.float32)
                      ._solve_rhs_t(jnp.asarray(params, jnp.float32),
                                    jnp.asarray(rhs)))
    truth = np.stack([sla.lu_solve(f, r, trans=1)
                      for f, r in zip(factors, rhs)])
    assert _rel(got.numpy(), truth) <= 1e-6
    assert _rel(want, truth) <= 1e-6


def test_wide_branch_current_matches_reference(wide_branch):
    jc, _, _, _, rows, _ = wide_branch
    values = np.linspace(0.25, 1.0, 2)
    want = jbatch.sweep(jc, "d1", values, refine=True)
    got = tbatch.sweep(Circuit(Netlist.from_rows(rows)), "d1", values,
                       refine=True, device="cpu")
    for name in ("e1", "d1"):
        cur = got.current(name)
        assert bool(torch.isfinite(cur).all())
        np.testing.assert_allclose(cur.numpy(), np.asarray(want.current(name)),
                                   rtol=1e-9, atol=1e-12)


def _random_graph_rows(n, edges, seed):
    """Random unit resistors between node pairs and a ground tie on every
    node (test_torch_batch.py's graph): no band for RCM to find."""
    rng = np.random.default_rng(seed)
    rows = [["v", "A", "1", "n0", "g"]]
    for k in range(edges):
        a, b = rng.integers(0, n, 2)
        if a != b:
            rows.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
    return rows + [[f"rg{j}", "R", "1", f"n{j}", "g"] for j in range(n)]


DENSE_NODE_BLOCK = {
    "random_graph": list(_random_graph_rows(300, 900, seed=1)) + [
        ["e1", "E", "2", "n1", "g"],
        ["d1", "VCCS", "0.5", "n3", "g", "n1", "g"]],
    "mesh_with_branches": list(grid_rows(8, 8, (0, 0), (7, 7))) + [
        ["e1", "E", "2", "1", "g"],
        ["d1", "VCCS", "0.5", "n0_3", "g", "1", "g"],
        ["f1", "CCCS", "1.5", "n3_3", "g", "1", "g", "e1"]],
}


@pytest.fixture(scope="module", params=list(DENSE_NODE_BLOCK))
def dense_branch(request):
    """(JAX circuit, port stamps, params, numpy f64 solutions, rows)."""
    rows = DENSE_NODE_BLOCK[request.param]
    jc = JCircuit(JNetlist.from_rows(rows))
    st = stamps_from_reference(jc.stamps)
    base = jc.stamps.params
    params = (base * (1.0 + 0.05 * np.random.default_rng(5).standard_normal(
        (3, len(base))))).astype(np.float32).astype(np.float64)
    return jc, st, params, _dense_f64(jc, params), rows


def test_dense_node_block_sub_branch_choice(dense_branch, monkeypatch):
    """The random graph's node block has no band a banded sub-branch
    takes, so the port solves A⁻¹[B | bk] on the blocked LU (300 nodes
    padded to 384, two border columns and the RHS); the 8×8 mesh's node
    block is a narrow band and never reaches it."""
    _, st, params, _, rows = dense_branch
    calls = []
    real = tbatch.lu_solve_multi
    monkeypatch.setattr(tbatch, "lu_solve_multi",
                        lambda A, R: calls.append(tuple(R.shape))
                        or real(A, R))
    BatchedSolver(st, refine=False, method="schur", device="cpu")(params)
    if rows is DENSE_NODE_BLOCK["random_graph"]:
        assert calls == [(len(params), 384, 3)]
    else:
        assert calls == []


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_dense_node_block_matches_reference(dense_branch, refine):
    jc, st, params, ref, _ = dense_branch
    js = jbatch.BatchedSolver(jc, dtype=jnp.float32, refine=refine,
                              method="schur")
    ts = BatchedSolver(st, refine=refine, method="schur", device="cpu")
    assert ts.method == js.method == "schur"
    want = np.asarray(js(params))
    got = ts(params)
    assert got.shape == (len(params), st.n)
    if refine is False:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= 1e-5
        return
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-9
    assert _rel(got.numpy(), ref) <= 1e-6
    assert float(ts.residuals(params, got).max()) <= 1e-6


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_dense_node_block_transposed_solve_matches_reference(dense_branch,
                                                             refine):
    jc, st, params, _, _ = dense_branch
    rhs = np.random.default_rng(6).standard_normal((len(params), st.n))
    want = np.asarray(jbatch.BatchedSolver(
        jc, dtype=jnp.float32, refine=refine, method="schur")._solve_rhs_t(
            jnp.asarray(params, jnp.float32), jnp.asarray(rhs)))
    got = BatchedSolver(st, refine=refine, method="schur",
                        device="cpu")._solve_rhs_t(
        torch.as_tensor(params, dtype=torch.float32), torch.as_tensor(rhs))
    assert _rel(got.numpy(), want) <= (1e-5 if refine is False else 1e-9)
    truth = _dense_f64(jc, params, rhs, transpose=True)
    assert _rel(got.numpy(), truth) <= (1e-4 if refine is False else 1e-6)


def test_dense_node_block_current_matches_reference(dense_branch):
    jc, _, _, _, rows = dense_branch
    values = np.linspace(0.25, 1.0, 3)
    want = jbatch.sweep(jc, "d1", values, refine=True, method="schur")
    got = tbatch.sweep(Circuit(Netlist.from_rows(rows)), "d1", values,
                       refine=True, method="schur", device="cpu")
    for name in ("e1", "d1"):
        cur = got.current(name)
        assert bool(torch.isfinite(cur).all())
        np.testing.assert_allclose(cur.numpy(), np.asarray(want.current(name)),
                                   rtol=1e-9, atol=1e-12)
