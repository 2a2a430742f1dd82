"""The port's block-band tier against the JAX package: the plan, batched
assembly, the band matvec, the plain block-Thomas solver (also against the
Pallas kernels in interpret mode), the CPU side of the CUDA kernel's
wrapper, and ``BatchedSolver`` with the ``band`` tier end to end.

Tolerances: plan arrays and f64 assembly exact; the f64 matvec and solver
1e-12 relative (the same recursion, summed in another order); the plain
solver against the Pallas kernels 2e-4 relative, the bound of the JAX
package's own tests of those kernels in f32 (Newton-Schulz block inverses
against pivoted solves); the f64 tiers 1e-9 from the JAX package and
1e-6 (the contract) from numpy f64 dense solves.  The circuits are
grounded at one corner, so κ·ε₃₂ is 1e-5 (9×40 mesh) to 1e-4 (60×60):
each package's raw f32 answer is that far from the f64 truth, and two f32
algorithms cannot agree better.  So the raw f32 tier is held to twice the
JAX package's own error (at least 1e-5), and on the wide circuits
``auto`` to the contract, as the scalar-band tests do on the 5×800 strip.
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
from nodal_tpu.ops import pallas_band as jpb  # noqa: E402
from nodal_tpu.ops.assemble import assemble_dense as jassemble_dense  # noqa: E402
from nodal_tpu_torch import BatchedSolver  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import band as tband  # noqa: E402
from nodal_tpu_torch.ops import block_thomas  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402
from nodal_tpu_torch.utils.gridgen import (grid_rows, ladder_rows,  # noqa: E402
                                           weighted_lattice_rows)

PLAN_FIELDS = ("order", "rank", "sel", "g_flat", "rhs_sel", "rhs_perm_rows",
               "unit_flat")
PALLAS_RTOL = 2e-4


def _mesh_rows(h, w):
    return list(grid_rows(h, w, (0, 0), (h - 1, w - 1))) + [
        ["src", "A", "1", "1", "g"]]


def _branch_rows(h, w):
    return list(grid_rows(h, w, (0, 0), (h - 1, w - 1))) + [
        ["e1", "E", "2", "1", "g"], ["d1", "VCCS", "0.5", "n3_3", "g", "1",
                                     "g"]]


def _lattice_rows(d, h, w):
    """A d×h×w unit-resistor lattice between corner probes, with a 1 A
    source: RCM's level sets cross ~h·w nodes, the wide-band regime."""
    return list(weighted_lattice_rows(
        np.ones((d, h, w - 1)), np.ones((d, h - 1, w)),
        np.ones((d - 1, h, w)), (0, 0, 0), (d - 1, h - 1, w - 1))) + [
        ["src", "A", "1", "1", "g"]]


def _random_graph_rows(n, edges, seed):
    """A random resistor graph with a ground tie on every node: SPD, but
    with no locality for RCM to find."""
    rng = np.random.default_rng(seed)
    rows = [["v", "A", "1", "n0", "g"]]
    for k in range(edges):
        a, b = rng.integers(0, n, 2)
        if a != b:
            rows.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
    return rows + [[f"rg{j}", "R", "1", f"n{j}", "g"] for j in range(n)]


def _stamps(rows):
    jc = JCircuit(JNetlist.from_rows(rows))
    return jc, stamps_from_reference(jc.stamps)


def _params(jc, B, seed=0):
    """5 % perturbations, rounded to f32 so every path sees the same
    values."""
    base = jc.stamps.params
    rng = np.random.default_rng(seed)
    return (base * (1.0 + 0.05 * rng.standard_normal((B, len(base))))
            ).astype(np.float32).astype(np.float64)


def _rel(x, ref):
    return float(np.abs(np.asarray(x) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


PLAN_CASES = {
    "mesh7x23": (_mesh_rows(7, 23), False),
    "mesh60x60": (_mesh_rows(60, 60), False),
    "lattice12x14x14": (_lattice_rows(12, 14, 14), False),
    "ladder64": (ladder_rows(64), False),
    "branch64x64_node_block": (_branch_rows(64, 64), True),
}


def _plans(case):
    """(JAX circuit, port stamps, JAX plan, port plan) for a plan case."""
    rows, node_block = PLAN_CASES[case]
    jc, st = _stamps(rows)
    if node_block:
        return (jc, st, jband.node_band_plan(jc.stamps),
                tband.node_band_plan(st))
    return jc, st, jband.band_plan(jc.stamps), tband.band_plan(st)


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_matches_reference(case):
    _, st, jp, tp = _plans(case)
    assert jp is not None and tp is not None
    assert (tp.n, tp.kb, tp.nb, tp.n_pad, tp.halfbw) == (
        jp.n, jp.kb, jp.nb, jp.n_pad, jp.halfbw)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    if case == "ladder64":
        # The natural order is no wider than RCM's: the plan keeps it.
        np.testing.assert_array_equal(tp.order, np.arange(st.n))
    if case == "lattice12x14x14":
        assert tp.kb == 256
    if case == "branch64x64_node_block":
        assert tp.n == st.n_kcl < st.n


def test_unbandable_plan_is_none_in_both():
    jc, st = _stamps(_random_graph_rows(1200, 4800, seed=0))
    assert jband.band_plan(jc.stamps) is None
    assert tband.band_plan(st) is None
    # max_kb caps the block size as in the JAX package.
    jc, st = _stamps(_lattice_rows(12, 14, 14))
    assert jband.make_band_plan(jc.stamps, max_kb=128) is None
    assert tband.make_band_plan(st, max_kb=128) is None


def test_plans_cached_on_stamps():
    _, st = _stamps(_branch_rows(6, 7))
    p = tband.band_plan(st)
    assert p is not None and tband.band_plan(st) is p
    q = tband.node_band_plan(st)
    assert q is not None and tband.node_band_plan(st) is q and q.n == st.n_kcl


@pytest.mark.parametrize("case", ["mesh7x23", "lattice12x14x14"])
def test_batched_assembly_matches_reference_exactly(case):
    jc, st, jp, tp = _plans(case)
    params = _params(jc, 2, seed=1)
    with jax.enable_x64(True):
        jW, jb = jax.vmap(lambda p: jp.assemble(jc.stamps, p,
                                                dtype=jnp.float64))(
            jnp.asarray(params))
    W, b = tp.assemble(st, torch.as_tensor(params))
    assert W.shape == (2, tp.nb, tp.kb, 3 * tp.kb) and b.shape == (2, tp.n_pad)
    assert W.dtype == b.dtype == torch.float64
    np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    W32, b32 = tp.assemble(st, torch.as_tensor(params), dtype=torch.float32)
    assert W32.dtype == b32.dtype == torch.float32


def test_band_order_round_trip_matches_reference():
    jc, st, jp, tp = _plans("mesh7x23")
    rhs = np.random.default_rng(2).standard_normal((3, st.n))
    got = tp.rhs_to_band(torch.as_tensor(rhs))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp.rhs_to_band(jnp.asarray(rhs))))
    np.testing.assert_array_equal(tp.unpermute(got).numpy(), rhs)
    # Multi-RHS arrays carry the rows on axis -2.
    multi = torch.stack([got, 2 * got], dim=-1)
    np.testing.assert_array_equal(
        tp.unpermute(multi, rows_axis=-2).numpy(),
        np.asarray(jp.unpermute(jnp.asarray(multi.numpy()), rows_axis=-2)))
    with pytest.raises(ValueError):
        tp.unpermute(multi)


def _assembled(case, B=2, seed=3):
    jc, st, jp, tp = _plans(case)
    return tp.assemble(st, torch.as_tensor(_params(jc, B, seed)))


@pytest.mark.parametrize("case", ["mesh7x23", "lattice12x14x14"])
def test_band_matvec_matches_reference(case):
    W, b = _assembled(case)
    with jax.enable_x64(True):
        want = jband.band_matvec(jnp.asarray(W.numpy()),
                                 jnp.asarray(b.numpy()))
    assert _rel(tband.band_matvec(W, b).numpy(), want) <= 1e-12


@pytest.mark.parametrize("case", ["mesh7x23", "lattice12x14x14"])
def test_plain_solver_matches_reference_scan(case):
    W, b = _assembled(case)
    jW, jb = jnp.asarray(W.numpy()), jnp.asarray(b.numpy())
    x = tband.band_thomas_solve(W, b)
    assert x.shape == b.shape and x.dtype == torch.float64
    with jax.enable_x64(True):
        assert _rel(x.numpy(), jband.band_thomas_solve(jW, jb)) <= 1e-12
    # The solution solves the band: a round trip through the matvec.
    assert _rel(tband.band_matvec(W, x).numpy(), b.numpy()) <= 1e-12
    R = torch.stack([b, -3.0 * b, torch.ones_like(b)], dim=-1)
    xm = tband.band_thomas_solve(W, R)
    assert xm.shape == R.shape
    with jax.enable_x64(True):
        assert _rel(xm.numpy(), jband.band_thomas_solve(
            jW, jnp.asarray(R.numpy()))) <= 1e-12
    # One system, no batch dimension.
    assert _rel(tband.band_thomas_solve(W[0], b[0]).numpy(),
                x[0].numpy()) <= 1e-12


def _f32_mesh_system(h, w, B, seed):
    jc, st = _stamps(_mesh_rows(h, w))
    tp = tband.band_plan(st)
    return tp.assemble(st, torch.as_tensor(_params(jc, B, seed)),
                       dtype=torch.float32)


def _random_band(rng, B, nb, kb=128):
    """Diagonally dominant f32 bands, as ``tests/test_band.py`` makes
    them: ``L_0`` and ``U_{nb−1}`` zero."""
    W = rng.standard_normal((B, nb, kb, 3 * kb)).astype(np.float32) * 0.1
    W[:, 0, :, :kb] = 0.0
    W[:, -1, :, 2 * kb:] = 0.0
    idx = np.arange(kb)
    W[:, :, idx, kb + idx] = np.abs(W).sum(-1)[:, :, idx] + 1.0
    return W


def test_plain_solver_matches_pallas_kernel():
    """The VMEM Pallas kernel, interpret mode, on an 8×33 mesh at B = 5."""
    W, b = _f32_mesh_system(8, 33, 5, seed=2)
    want = jpb.pallas_band_solve(jnp.asarray(W.numpy()),
                                 jnp.asarray(b.numpy()))
    got = tband.band_thomas_solve(W, b)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < PALLAS_RTOL


def test_plain_solver_matches_pallas_multi_kernel():
    """The multi-RHS VMEM Pallas kernel, interpret mode, with 7 RHS."""
    W, _ = _f32_mesh_system(8, 20, 1, seed=3)
    R = np.random.default_rng(3).standard_normal(
        (1, W.shape[1] * W.shape[2], 7)).astype(np.float32)
    want = jpb.pallas_band_solve_multi(jnp.asarray(W.numpy()),
                                       jnp.asarray(R))
    got = tband.band_thomas_solve(W, torch.as_tensor(R))
    assert _rel(got.numpy(), want) < PALLAS_RTOL


def test_plain_solver_matches_pallas_stream_kernels():
    """The streaming Pallas kernels, interpret mode: 20 block rows (past
    the VMEM kernel's reach) with one RHS, 4 block rows with 6."""
    rng = np.random.default_rng(8)
    W = _random_band(rng, 3, 20)
    b = rng.standard_normal((3, 20 * 128)).astype(np.float32)
    want = jpb.pallas_band_solve_stream(jnp.asarray(W), jnp.asarray(b))
    got = tband.band_thomas_solve(torch.as_tensor(W), torch.as_tensor(b))
    assert _rel(got.numpy(), want) < PALLAS_RTOL
    W = _random_band(rng, 2, 4)
    R = rng.standard_normal((2, 4 * 128, 6)).astype(np.float32)
    want = jpb.pallas_band_solve_multi_stream(jnp.asarray(W), jnp.asarray(R))
    got = tband.band_thomas_solve(torch.as_tensor(W), torch.as_tensor(R))
    assert _rel(got.numpy(), want) < PALLAS_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("r", [1, 3, 130])
def test_wrapper_on_cpu_is_the_plain_version(dtype, r):
    W, b = _assembled("mesh7x23")
    W = W.to(dtype)
    R = torch.stack([b * (k + 1) for k in range(r)], dim=-1).to(dtype)
    before = block_thomas.band_solve_multi.launches
    got = block_thomas.band_solve_multi(W, R)
    assert torch.equal(got, tband.band_thomas_solve(W, R))
    x = block_thomas.band_solve(W, b.to(dtype))
    assert _rel(x.numpy(), got[..., 0].numpy()) <= 1e-6
    n_valid = tband.band_plan(_stamps(PLAN_CASES["mesh7x23"][0])[1]).n
    trimmed = block_thomas.band_solve(W, b.to(dtype), n_valid=n_valid)
    assert torch.equal(trimmed, x[:, :n_valid])
    assert block_thomas.band_solve_multi.launches == before == 0


@pytest.mark.parametrize("bad", ["rank", "batch", "rows", "dtype", "int",
                                 "kb", "cols", "no_rhs"])
def test_wrapper_rejects_bad_input(bad):
    W, b = _assembled("mesh7x23")
    R = b.unsqueeze(-1)
    if bad == "rank":
        W = W[0]
    elif bad == "batch":
        R = R[:1]
    elif bad == "rows":
        R = R[:, :-1]
    elif bad == "dtype":
        R = R.float()
    elif bad == "int":
        W, R = W.int(), R.int()
    elif bad == "kb":
        W = torch.zeros(3, 4, 64, 192, dtype=W.dtype)
        R = torch.zeros(3, 256, 1, dtype=W.dtype)
    elif bad == "cols":
        W = W[..., :-1]
    else:
        R = R[..., :0]
    with pytest.raises((ValueError, TypeError)):
        block_thomas.band_solve_multi(W, R)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B,nb,kb,r", [
    (1024, 16, 128, 1), (256, 79, 128, 1), (256, 10, 256, 1),
    (1024, 32, 128, 3), (1, 1, 128, 1), (7, 8, 384, 128),
    (4, 2048, 128, 128)])
def test_launch_config(B, nb, kb, r, itemsize):
    cfg = block_thomas.launch_config(B, nb, kb, r, itemsize, sm_count=132)
    per_block = kb * kb + nb * kb * (kb + r)
    assert 1 <= cfg.grid <= min(B, 132 * block_thomas.BLOCKS_PER_SM)
    assert cfg.scratch_elems == cfg.grid * per_block
    assert cfg.grid * cfg.waves >= B > cfg.grid * (cfg.waves - 1)
    # The scratch cap binds, but never below one block.
    assert (cfg.scratch_elems * itemsize <= block_thomas.SCRATCH_BYTES_MAX
            or cfg.grid == 1)
    # S sits in shared memory exactly at kb = 128 in f32 (the main paths).
    assert cfg.smem_bytes == (kb * kb * 4 if (kb, itemsize) == (128, 4)
                              else 0)


def test_kernel_is_built_with_the_library():
    assert "block_thomas.cu" in [p.name for p in kernels._sources()]
    for name in ("block_thomas_f32", "block_thomas_f64"):
        argtypes, _ = kernels._SIGNATURES[name]
        assert len(argtypes) == 11
    src = (kernels.CSRC_DIR / "block_thomas.cu").read_text()
    assert "int block_thomas_f32(" in src and "int block_thomas_f64(" in src
    assert "kThreads = 256" in src and block_thomas.THREADS == 256


def _dense_f64(jc, params):
    out = []
    for p in params:
        G, b = jassemble_dense(jc.stamps, jnp.asarray(p), dtype=jnp.float64)
        out.append(np.linalg.solve(np.asarray(G), np.asarray(b)))
    return np.stack(out)


@pytest.fixture(scope="module")
def mesh9x40():
    jc, st = _stamps(_mesh_rows(9, 40))
    params = _params(jc, 4, seed=4)
    return jc, st, params, _dense_f64(jc, params)


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_forced_band_matches_reference(mesh9x40, refine):
    """``method="band"`` on a mesh narrow enough for ``sband``: both
    packages take the forced tier."""
    jc, st, params, ref = mesh9x40
    js = jbatch.BatchedSolver(jc, dtype=jnp.float32, refine=refine,
                              method="band")
    ts = BatchedSolver(st, refine=refine, method="band", device="cpu")
    assert js.method == ts.method == "band"
    want = np.asarray(js(params))
    got = ts(params)
    assert got.device.type == "cpu" and got.shape == (len(params), st.n)
    if refine is False:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), ref) <= max(2 * _rel(want, ref), 1e-5)
    else:
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), want) <= 1e-9
        assert _rel(got.numpy(), ref) <= 1e-6
        res = ts.residuals(params, got)
        assert res.shape == (len(params),) and float(res.max()) <= 1e-6
        np.testing.assert_allclose(
            res.numpy(), np.asarray(js.residuals(params, got.numpy())),
            rtol=0, atol=1e-12)


def test_forced_band_raw_f64_matches_reference(mesh9x40):
    jc, st, params, ref = mesh9x40
    js = jbatch.BatchedSolver(jc, dtype=jnp.float64, refine=False,
                              method="band")
    ts = BatchedSolver(st, dtype=torch.float64, refine=False, method="band",
                       device="cpu")
    got = ts(params)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), np.asarray(js(params))) <= 1e-10
    assert _rel(got.numpy(), ref) <= 1e-10
    assert float(ts.residuals(params, got).max()) <= 1e-12


def test_forced_band_transposed_solve_matches_reference(mesh9x40):
    jc, st, params, _ = mesh9x40
    rhs = np.random.default_rng(5).standard_normal((len(params), st.n))
    want = jbatch.BatchedSolver(jc, dtype=jnp.float32, method="band"
                                )._solve_rhs_t(
        jnp.asarray(params, jnp.float32), jnp.asarray(rhs))
    got = BatchedSolver(st, method="band", device="cpu")._solve_rhs_t(
        torch.as_tensor(params, dtype=torch.float32), torch.as_tensor(rhs))
    assert _rel(got.numpy(), want) <= 1e-9
    truth = np.stack([
        np.linalg.solve(np.asarray(jassemble_dense(
            jc.stamps, jnp.asarray(p), dtype=jnp.float64)[0]).T, r)
        for p, r in zip(params, rhs)])
    assert _rel(got.numpy(), truth) <= 1e-6


WIDE = {"mesh60x60": _mesh_rows(60, 60),
        "lattice12x14x14": _lattice_rows(12, 14, 14)}


@pytest.fixture(scope="module", params=list(WIDE))
def wide(request):
    """(JAX circuit, port stamps, params, f64 dense solutions, the dense
    LU factors of each sample for the transposed solves)."""
    jc, st = _stamps(WIDE[request.param])
    params = _params(jc, 2, seed=6)
    factors, ref = [], []
    for p in params:
        G, b = jassemble_dense(jc.stamps, jnp.asarray(p), dtype=jnp.float64)
        factors.append(sla.lu_factor(np.asarray(G)))
        ref.append(sla.lu_solve(factors[-1], np.asarray(b)))
    return jc, st, params, np.stack(ref), factors


@pytest.mark.parametrize("refine", [False, "auto"])
def test_auto_selects_band_like_reference(wide, refine):
    jc, st, params, ref, _ = wide
    js = jbatch.BatchedSolver(jc, dtype=jnp.float32, refine=refine)
    ts = BatchedSolver(st, refine=refine, device="cpu")
    assert js.method == ts.method == "band"
    want = np.asarray(js(params))
    got = ts(params)
    if refine is False:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), ref) <= max(2 * _rel(want, ref), 1e-5)
    else:
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), ref) <= 1e-6
        assert _rel(want, ref) <= 1e-6
        res = ts.residuals(params, got)
        assert float(res.max()) <= 1e-6
        np.testing.assert_allclose(
            res.numpy(), np.asarray(js.residuals(params, got.numpy())),
            rtol=0, atol=1e-12)


def test_auto_band_transposed_solve_meets_contract(wide):
    """The transposed solve on the wide circuits: the contract against the
    f64 truth (the JAX package's answer is compared on the 9×40 mesh)."""
    _, st, params, _, factors = wide
    rhs = np.random.default_rng(7).standard_normal((len(params), st.n))
    got = BatchedSolver(st, device="cpu")._solve_rhs_t(
        torch.as_tensor(params, dtype=torch.float32), torch.as_tensor(rhs))
    truth = np.stack([sla.lu_solve(f, r, trans=1)
                      for f, r in zip(factors, rhs)])
    assert _rel(got.numpy(), truth) <= 1e-6


def test_cpu_solver_never_launches_the_kernel(mesh9x40):
    _, st, params, _ = mesh9x40
    before = block_thomas.band_solve_multi.launches
    BatchedSolver(st, method="band", device="cpu")(params)
    assert block_thomas.band_solve_multi.launches == before == 0
