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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _per_system(nb, kb, r):
    """Scratch values a system: S, the right-hand side, the slots and, for
    kb > 128, the LU's P and Z (csrc/block_thomas.cu's layout)."""
    ls = kb + -(-r // 4) * 4
    p = {128: 0, 256: 128 * 128, 384: 128 * 128 + 256 * 128}[kb]
    extra = p + 128 * (kb + r) if kb > 128 else 0
    return kb * kb + kb * r + nb * kb * ls + extra


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B,nb,kb,r", [
    (1024, 16, 128, 1), (256, 79, 128, 1), (256, 10, 256, 1),
    (1024, 32, 128, 3), (1, 1, 128, 1), (7, 8, 384, 128),
    (4, 2048, 128, 128)])
def test_launch_config(B, nb, kb, r, itemsize):
    """The host loop's plan: slot rows padded to 4 values, the scratch of a
    chunk, chunks that cover the batch within ``SCRATCH_BYTES_MAX`` (never
    below one system), and the kernel launches of one loop."""
    plan = block_thomas.launch_plan(B, nb, kb, r, itemsize)
    assert plan.slot_ld % 4 == 0 and kb + r <= plan.slot_ld < kb + r + 4
    per = _per_system(nb, kb, r)
    assert plan.scratch_elems == plan.chunk * per
    assert 1 <= plan.chunk <= B and plan.calls == -(-B // plan.chunk)
    cap = block_thomas.SCRATCH_BYTES_MAX
    assert plan.scratch_elems * itemsize <= cap or plan.chunk == 1
    assert plan.chunk == B or (plan.chunk + 1) * per * itemsize > cap
    per_row = {128: 3 if r <= 4 else 5, 256: 13, 384: 22}[kb]
    assert plan.launches == nb * (per_row + 1)


@pytest.mark.parametrize("B,nb,kb,r,itemsize,chunk", [
    (16384, 79, 128, 128, 8, 204), (4096, 300, 384, 128, 4, 18),
    (65536, 16, 128, 1, 8, 1871)])
def test_launch_plan_chunks_the_batch(B, nb, kb, r, itemsize, chunk):
    """Batches whose scratch passes ``SCRATCH_BYTES_MAX`` are cut into the
    largest chunks that fit."""
    plan = block_thomas.launch_plan(B, nb, kb, r, itemsize)
    assert plan.chunk == chunk < B
    assert plan.calls == -(-B // chunk)
    assert plan.scratch_elems * itemsize <= block_thomas.SCRATCH_BYTES_MAX


def test_kernel_is_built_with_the_library():
    names = [p.name for p in kernels._sources()]
    assert "block_thomas.cu" in names and "dense_tile.cuh" in names
    for name in ("block_thomas_f32", "block_thomas_f64"):
        argtypes, _ = kernels._SIGNATURES[name]
        assert len(argtypes) == 9
    src = (kernels.CSRC_DIR / "block_thomas.cu").read_text()
    assert "int block_thomas_f32(" in src and "int block_thomas_f64(" in src
    # The blocked LU's tile core, under this source's own kernel names.
    assert '#include "dense_tile.cuh"' in src
    assert "DENSE_TILE_KERNELS(block_thomas)" in src
    assert block_thomas.PANEL == 128
    core = (kernels.CSRC_DIR / "dense_tile.cuh").read_text()
    assert f"kBlock = {block_thomas.PANEL}" in core


# --- the CUDA kernels' order of operations, emulated on the CPU --------------
#
# block_thomas.cu walks the block rows with batch-wide launches of the
# blocked LU's kernels (csrc/dense_tile.cuh): every product summed apart
# from zero and added last, each 128×128 Schur block inverted by
# Gauss-Jordan in 32-column panels (kb = 128: C_t = S⁻¹U_t and y_t =
# S⁻¹rhs, for r <= 4 rhs and y_t formed inside the inverse's launch), larger
# Schur blocks factored by the LU's 128-panel steps and the slot [U_t | rhs]
# solved in place.  The emulation follows that loop launch
# for launch.

def _gauss_jordan(D):
    """In-place Gauss-Jordan without pivoting, element by element."""
    a = D.clone()
    for k in range(a.shape[-1]):
        p = 1.0 / a[..., k, k]
        col, row = a[..., :, k].clone(), a[..., k, :].clone()
        a = a - (col * p[..., None])[..., :, None] * row[..., None, :]
        a[..., k, :] = row * p[..., None]
        a[..., :, k] = -col * p[..., None]
        a[..., k, k] = p
    return a


def _panel_gauss_jordan(D, panel=32):
    """The kernels' 128×128 inverse: Gauss-Jordan in 32-column panels."""
    M = D.clone()
    for p0 in range(0, M.shape[-1], panel):
        P = slice(p0, p0 + panel)
        Dp = _gauss_jordan(M[..., P, P])
        rowp = Dp @ M[..., P, :]
        rowp[..., :, P] = Dp
        upd = M[..., :, P] @ rowp
        new = M - upd
        new[..., :, P] = -upd[..., :, P]
        new[..., P, :] = rowp
        M = new
    return M


class _Emulator:
    """block_thomas.cu's host loop in torch, counting its launches."""

    def __init__(self):
        self.launches = 0

    def gemm(self, cin, A=None, Bm=None, alpha=-1.0):
        """cin + alpha·(A·Bm), the product summed apart and added last."""
        self.launches += 1
        if A is None or A.shape[-1] == 0:
            return cin.clone()
        prod = alpha * (A @ Bm)
        return prod if cin is None else cin + prod

    def inv(self, D):
        self.launches += 1
        return _panel_gauss_jordan(D)

    def lu_solve(self, S, X, k=128):
        """The LU's factor of S (panels in pairs, their updates of the rest
        delayed into one product of depth 256), then X = S⁻¹X by its two
        sweeps."""
        n = S.shape[-1]
        F = S.clone()
        d = 0
        while d < n:
            e = d + k
            F[..., d:e, d:e] = self.inv(F[..., d:e, d:e])
            if e == n:
                break
            if e + k == n:
                P = self.gemm(None, F[..., d:e, d:e], F[..., d:e, e:], 1.0)
                F[..., e:, e:] = self.gemm(F[..., e:, e:], F[..., e:, d:e], P)
                d = e
                continue
            f = e + k
            Pa = self.gemm(None, F[..., d:e, d:e], F[..., d:e, e:f], 1.0)
            Pb = self.gemm(None, F[..., d:e, d:e], F[..., d:e, f:], 1.0)
            F[..., e:, e:f] = self.gemm(F[..., e:, e:f], F[..., e:, d:e], Pa)
            F[..., e:f, f:] = self.gemm(F[..., e:f, f:], F[..., e:f, d:e], Pb)
            F[..., e:f, e:f] = self.inv(F[..., e:f, e:f])
            Pc = self.gemm(None, F[..., e:f, e:f], F[..., e:f, f:], 1.0)
            F[..., f:, f:] = self.gemm(F[..., f:, f:], F[..., f:, d:f],
                                       torch.cat([Pb, Pc], dim=-2))
            d = f
        X = X.clone()
        for d in range(0, n - k, k):
            e = d + k
            z = self.gemm(None, F[..., d:e, d:e], X[..., d:e, :], 1.0)
            X[..., e:, :] = self.gemm(X[..., e:, :], F[..., e:, d:e], z)
        for d in range(n - k, -1, -k):
            e = d + k
            z = self.gemm(X[..., d:e, :], F[..., d:e, e:], X[..., e:, :])
            X[..., d:e, :] = self.gemm(None, F[..., d:e, d:e], z, 1.0)
        return X

    def solve(self, W, R):
        B, nb, kb, _ = W.shape
        slots = []
        C = y = None
        for t in range(nb):
            L, D, U = W[:, t, :, :kb], W[:, t, :, kb:2 * kb], W[:, t, :, 2 * kb:]
            Rt = R[:, t * kb:(t + 1) * kb]
            S = self.gemm(D, L if t else None, C)
            rhs = self.gemm(Rt, L if t else None, y)
            if kb == 128:
                Sinv = self.inv(S)
                C = self.gemm(None, Sinv, U, 1.0)
                y = self.gemm(None, Sinv, rhs, 1.0)
                if R.shape[-1] <= 4:  # rhs and y_t in the inverse's launch
                    self.launches -= 2
            else:
                slot = self.lu_solve(S, torch.cat([self.gemm(U), rhs], -1))
                C, y = slot[..., :kb], slot[..., kb:]
            slots.append((C, y))
        xs = [self.gemm(slots[-1][1])]
        for t in range(nb - 2, -1, -1):
            xs.append(self.gemm(slots[t][1], slots[t][0], xs[-1]))
        return torch.cat(xs[::-1], dim=1)


def _random_system(kb, nb, B, r, seed):
    rng = np.random.default_rng(seed)
    W = _random_band(rng, B, nb, kb).astype(np.float64)
    return W, rng.standard_normal((B, nb * kb, r))


#: Bands held against the JAX package: the 60×60 mesh (kb 128) and the
#: 12×14×14 lattice (kb 256) of the tests' plans, both grounded at one
#: corner, and random dominant bands at kb 128 (past the VMEM kernel's
#: reach, 3 right-hand sides) and kb 384.
EMULATION_CASES = {
    "mesh60x60": lambda: tuple(t.numpy()[..., None] if t.dim() == 2
                               else t.numpy()
                               for t in _assembled("mesh60x60")),
    "lattice12x14x14": lambda: tuple(t.numpy()[..., None] if t.dim() == 2
                                     else t.numpy()
                                     for t in _assembled("lattice12x14x14")),
    "random_kb128_nb20_r3": lambda: _random_system(128, 20, 2, 3, 8),
    "random_kb384_nb3": lambda: _random_system(384, 3, 2, 1, 9),
}


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_emulated_kernel_order_matches_reference(case):
    """The kernels' order of operations in f32 stays near the f64 truth:
    within 8× the JAX package's own f32 block Thomas error (pivoted solves
    of each block against an explicit no-pivot S⁻¹ and products summed
    apart), or 1e-6 where both sit at the f32 rounding floor; products summed
    onto the Schur complement once drifted to 20×.  In f64 it agrees with the JAX package to 1e-10 (κ·ε₆₄ with
    growth along the block rows).  The emulated loop makes exactly the
    launches of ``launch_plan``."""
    W, R = EMULATION_CASES[case]()
    B, nb, kb, _ = W.shape
    with jax.enable_x64(True):
        truth = np.asarray(jband.band_thomas_solve(jnp.asarray(W),
                                                   jnp.asarray(R)))
    emu = _Emulator()
    got = emu.solve(torch.as_tensor(W, dtype=torch.float32),
                    torch.as_tensor(R, dtype=torch.float32)).numpy()
    assert emu.launches == block_thomas.launch_plan(
        B, nb, kb, R.shape[-1], 4).launches
    want = np.asarray(jband.band_thomas_solve(jnp.asarray(W, jnp.float32),
                                              jnp.asarray(R, jnp.float32)))
    assert _rel(got, truth) <= max(8 * _rel(want, truth), 1e-6)
    got64 = _Emulator().solve(torch.as_tensor(W), torch.as_tensor(R)).numpy()
    assert _rel(got64, truth) <= 1e-10


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
