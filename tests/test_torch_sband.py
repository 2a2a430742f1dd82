"""The port's scalar-band tier against the JAX package: the plan, batched
assembly, the band matvec, the plain solver (also against the Pallas
kernels in interpret mode), the CUDA kernel's order of operations
emulated in torch, the CPU side of the kernel's wrapper, and
``BatchedSolver(method="sband")`` end to end.

Tolerances: plan arrays and f64 assembly exact; the f64 matvec, solver and
kernel emulation 1e-12 relative (the same recurrence, summed in another
order); the f32 emulation ``chip_smoke.SBAND_RTOL``, the card's bound on
the kernel; the plain solver against the Pallas kernels 1e-5 (VMEM
kernel) and 1e-4 (streaming kernel) relative, the bounds of the JAX
package's own tests of those kernels in f32; the raw f32 tier 1e-5 from
the JAX package, the f64 tiers 1e-9 from it and 1e-6 (the contract) from
numpy f64 dense solves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Circuit as JCircuit  # noqa: E402
from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu import batch as jbatch  # noqa: E402
from nodal_tpu.ops import pallas_scalar_band as jpsb  # noqa: E402
from nodal_tpu.ops import scalar_band as jsb  # noqa: E402
from nodal_tpu.ops.assemble import assemble_dense as jassemble_dense  # noqa: E402
from chip_smoke import SBAND_RTOL  # noqa: E402  (the bound the card checks)
from nodal_tpu_torch import BatchedSolver  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import sband  # noqa: E402
from nodal_tpu_torch.ops import scalar_band as tsb  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402
from nodal_tpu_torch.utils.gridgen import grid_rows, ladder_rows  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PLAN_FIELDS = ("order", "rank", "sel", "u_flat", "unit_flat", "rhs_sel",
               "rhs_perm_rows")


def _mesh_rows(h, w):
    return list(grid_rows(h, w, (0, 0), (h - 1, w - 1))) + [
        ["src", "A", "1", "1", "g"]]


def _branch_rows(h, w):
    """The JAX package bench's branch circuit: a mesh driven by a voltage
    source, plus a VCCS."""
    return list(grid_rows(h, w, (0, 0), (h - 1, w - 1))) + [
        ["e1", "E", "2", "1", "g"], ["d1", "VCCS", "0.5", "n3_3", "g", "1",
                                     "g"]]


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


def _plans(case):
    """(JAX stamps, port stamps, JAX plan, port plan) for a plan case."""
    rows, node_block = {
        "mesh5x6": (_mesh_rows(5, 6), False),
        "mesh7x30": (_mesh_rows(7, 30), False),
        "ladder64": (ladder_rows(64), False),
        "branch_node_block": (_branch_rows(6, 7), True),
    }[case]
    jc, st = _stamps(rows)
    if node_block:
        return (jc, st, jsb.node_sband_plan(jc.stamps),
                tsb.node_sband_plan(st))
    return jc, st, jsb.sband_plan(jc.stamps), tsb.sband_plan(st)


PLAN_CASES = ["mesh5x6", "mesh7x30", "ladder64", "branch_node_block"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_matches_reference(case):
    _, _, jp, tp = _plans(case)
    assert jp is not None and tp is not None
    assert (tp.n, tp.w, tp.W1, tp.n_pad) == (jp.n, jp.w, jp.W1, jp.n_pad)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)


@pytest.mark.parametrize("refusal", ["unsymmetric", "wide"])
def test_plan_refusals_match_reference(refusal):
    if refusal == "unsymmetric":
        # Branch equations break the symmetry of the full system.
        jc, st = _stamps(list(grid_rows(5, 6, (0, 0), (4, 5)))
                         + [["e1", "E", "1", "1", "g"]])
        kw = {}
    else:
        jc, st = _stamps(_mesh_rows(30, 30))
        kw = {"max_w": 8}
    assert jsb.make_scalar_band_plan(jc.stamps, **kw) is None
    assert tsb.make_scalar_band_plan(st, **kw) is None


def test_plans_cached_on_stamps():
    _, st = _stamps(_branch_rows(6, 7))
    assert tsb.sband_plan(st) is None
    assert tsb.sband_plan(st) is None
    p = tsb.node_sband_plan(st)
    assert p is not None and tsb.node_sband_plan(st) is p


@pytest.mark.parametrize("case", PLAN_CASES)
def test_batched_assembly_matches_reference_exactly(case):
    jc, st, jp, tp = _plans(case)
    params = _params(jc, 4, seed=1)
    with jax.enable_x64(True):
        jU, jb = jax.vmap(lambda p: jp.assemble(jc.stamps, p,
                                                dtype=jnp.float64))(
            jnp.asarray(params))
    U, b = tp.assemble(st, torch.as_tensor(params))
    assert U.shape == (4, tp.n_pad, tp.W1) and b.shape == (4, tp.n_pad)
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    U32, b32 = tp.assemble(st, torch.as_tensor(params), dtype=torch.float32)
    assert U32.dtype == b32.dtype == torch.float32


def test_band_order_round_trip_matches_reference():
    jc, st, jp, tp = _plans("mesh7x30")
    rhs = np.random.default_rng(2).standard_normal((3, st.n))
    got = tp.rhs_to_band(torch.as_tensor(rhs))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp.rhs_to_band(jnp.asarray(rhs))))
    np.testing.assert_array_equal(tp.unpermute(got).numpy(), rhs)
    assert tp.rhs_to_band(torch.as_tensor(rhs), torch.float32).dtype == \
        torch.float32


def _assembled(case, B=3, seed=3):
    jc, st, jp, tp = _plans(case)
    U, b = tp.assemble(st, torch.as_tensor(_params(jc, B, seed)))
    return U, b


def _rel(x, ref):
    return float(np.abs(np.asarray(x) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("case", ["mesh5x6", "mesh7x30", "ladder64"])
def test_sband_matvec_matches_reference(case):
    U, b = _assembled(case)
    want = jsb.sband_matvec(jnp.asarray(U.numpy()), jnp.asarray(b.numpy()))
    assert _rel(tsb.sband_matvec(U, b).numpy(), want) <= 1e-12


@pytest.mark.parametrize("case", ["mesh5x6", "mesh7x30", "ladder64"])
def test_plain_solver_matches_reference_scan(case):
    U, b = _assembled(case)
    jU, jb = jnp.asarray(U.numpy()), jnp.asarray(b.numpy())
    x = tsb.scalar_band_solve_scan(U, b)
    assert x.shape == b.shape and x.dtype == torch.float64
    assert _rel(x.numpy(), jsb.scalar_band_solve_scan(jU, jb)) <= 1e-12
    # The solution solves the band: a round trip through the matvec.
    assert _rel(tsb.sband_matvec(U, x).numpy(), b.numpy()) <= 1e-12
    R = torch.stack([b, -3.0 * b, torch.ones_like(b)], dim=-1)
    xm = tsb.scalar_band_solve_scan(U, R)
    assert xm.shape == R.shape
    assert _rel(xm.numpy(), jsb.scalar_band_solve_scan(
        jU, jnp.asarray(R.numpy()))) <= 1e-12
    # One system, no batch dimension.
    assert _rel(tsb.scalar_band_solve_scan(U[0], b[0]).numpy(),
                x[0].numpy()) <= 1e-12


def _f32_system(case, B, seed):
    jc, st, jp, tp = _plans(case)
    U, b = tp.assemble(st, torch.as_tensor(_params(jc, B, seed)),
                       dtype=torch.float32)
    return U, b


def test_plain_solver_matches_pallas_kernels():
    """The Pallas VMEM kernel, interpret mode, single and 3-RHS forms."""
    U, b = _f32_system("mesh5x6", 3, seed=7)
    jU, jb = jnp.asarray(U.numpy()), jnp.asarray(b.numpy())
    got = tsb.scalar_band_solve_scan(U, b).numpy()
    assert _rel(got, jpsb.pallas_scalar_band_solve(jU, jb)) < 1e-5
    R = torch.stack([b, -2.0 * b, 0.5 * b + 1.0], dim=-1)
    gotm = tsb.scalar_band_solve_scan(U, R).numpy()
    assert _rel(gotm, jpsb.pallas_scalar_band_solve_multi(
        jU, jnp.asarray(R.numpy()))) < 1e-5


def test_plain_solver_matches_pallas_stream_kernel(monkeypatch):
    """The streaming Pallas kernel, interpret mode, with the chunk forced
    small so the 7×30 mesh spans several chunks."""
    monkeypatch.setattr(jpsb, "_stream_chunk", lambda W1a: 64)
    U, b = _f32_system("mesh7x30", 2, seed=3)
    R = torch.stack([b, -2.0 * b], dim=-1)
    want = jpsb.pallas_scalar_band_solve_stream_multi(
        jnp.asarray(U.numpy()), jnp.asarray(R.numpy()))
    assert _rel(tsb.scalar_band_solve_scan(U, R).numpy(), want) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rhs", [1, 3])
def test_wrapper_on_cpu_is_the_plain_version(dtype, n_rhs):
    U, b = _assembled("mesh7x30")
    U = U.to(dtype)
    R = torch.stack([b * (k + 1) for k in range(n_rhs)], dim=-1).to(dtype)
    before = sband.sband_solve_multi.launches
    got = sband.sband_solve_multi(U, R)
    assert torch.equal(got, tsb.scalar_band_solve_scan(U, R))
    assert _rel(sband.sband_solve(U, b.to(dtype)).numpy(),
                got[..., 0].numpy()) <= 1e-6
    assert sband.sband_solve_multi.launches == before == 0


@pytest.mark.parametrize("bad", ["rank", "batch", "dtype", "int", "wide",
                                 "rhs"])
def test_wrapper_rejects_bad_input(bad):
    U, b = _assembled("mesh5x6")
    R = b.unsqueeze(-1)
    if bad == "rank":
        U = U[0]
    elif bad == "batch":
        R = R[:2]
    elif bad == "dtype":
        R = R.float()
    elif bad == "int":
        U, R = U.int(), R.int()
    elif bad == "wide":
        U = torch.zeros(3, U.shape[1], tsb.MAX_W + 2, dtype=U.dtype)
    else:
        R = R.expand(-1, -1, sband.MAX_W1A - U.shape[2] + 1)
    with pytest.raises((ValueError, TypeError)):
        sband.sband_solve_multi(U, R)


def _kernel_order_solve(U, R):
    """The register variant of ``csrc/sband.cu`` in its order of
    operations, in torch: the forward stores each factored row as
    (1/d, m_r = A[i][i+r]·(1/d), q = b'·(1/d)), so that neither sweep
    divides a row; the column-form backward keeps the pending value of
    rows i..i-w (lane r holds row i - r), takes x_i from row i's, subtracts
    m_{i-r,r}·x_i from each row i - r, shifts the rows down one lane and
    starts row i-1-w at its q."""
    B, n, W1 = U.shape
    n_rhs = R.shape[2]
    w = W1 - 1
    W1a = W1 + n_rhs
    # Rows past n read as 0 (the kernel's zero-filled window rows).
    A = torch.cat([torch.cat([U, R], -1), U.new_zeros(B, w, W1a)], 1)
    F = U.new_empty(B, n, W1a)
    for i in range(n):
        p = A[:, i, :].clone()
        inv = 1.0 / p[:, :1]
        F[:, i, 0] = inv[:, 0]
        F[:, i, 1:] = p[:, 1:] * inv
        for r in range(1, w + 1):
            m = p[:, r:r + 1] * inv
            A[:, i + r, :W1 - r] -= m * p[:, r:W1]
            A[:, i + r, W1:] -= m * p[:, W1:]
    X = U.new_empty(B, n, n_rhs)
    pend = U.new_zeros(B, w + 1, n_rhs)
    for r in range(min(w + 1, n)):
        pend[:, r] = F[:, n - 1 - r, W1:]
    lanes = torch.arange(1, w + 1)
    for i in range(n - 1, -1, -1):
        x = pend[:, 0].clone()
        X[:, i] = x
        rows = i - lanes
        diag = F[:, rows.clamp(min=0), lanes] * (rows >= 0)
        pend[:, 1:] -= diag[..., None] * x[:, None, :]
        pend = torch.cat([pend[:, 1:], F[:, i - 1 - w, None, W1:] if
                          i - 1 - w >= 0 else U.new_zeros(B, 1, n_rhs)], 1)
    return X


def _random_sband_np(B, n, w, n_rhs, seed):
    """numpy twin of ``chip_smoke.random_sband``: diagonally dominant
    symmetric bands (couplings past the last row zero) and right-hand
    sides, f64."""
    rng = np.random.default_rng(seed)
    W1 = w + 1
    U = -(0.1 + 0.9 * rng.random((B, n, W1)))
    U *= (np.arange(n)[:, None] + np.arange(W1)) < n
    diag = np.abs(U[:, :, 1:]).sum(-1)
    for k in range(1, min(W1, n)):
        diag[:, k:] += np.abs(U[:, :-k, k])
    U[:, :, 0] = diag + 0.1 + 0.9 * rng.random((B, n))
    return U, rng.standard_normal((B, n, n_rhs))


@pytest.mark.parametrize("B,n,w,n_rhs", [
    (3, 60, 26, 1), (2, 50, 26, 3), (2, 40, 3, 28), (4, 7, 8, 3),
    (2, 1, 1, 1), (2, 45, 30, 1), (3, 33, 1, 5), (2, 20, 0, 2)])
def test_kernel_order_matches_plain_solver(B, n, w, n_rhs):
    """The kernel's order of operations (stored 1/d, column-form back
    substitution) against the plain solver: 1e-12 in f64 (the same
    recurrence summed in another order), chip_smoke's SBAND_RTOL in f32,
    the bound the card holds the kernel to."""
    U, R = _random_sband_np(B, n, w, n_rhs, seed=n + w + n_rhs)
    for dtype, tol in ((torch.float64, 1e-12),
                       (torch.float32, SBAND_RTOL[torch.float32])):
        Ut = torch.as_tensor(U, dtype=dtype)
        Rt = torch.as_tensor(R, dtype=dtype)
        got = _kernel_order_solve(Ut, Rt)
        want = tsb.scalar_band_solve_scan(Ut, Rt)
        assert got.dtype == dtype and got.shape == Rt.shape
        for s in range(B):
            assert _rel(got[s].numpy(), want[s].numpy()) <= tol


@pytest.mark.parametrize("case,n_rhs", [("mesh7x30", 1),
                                        ("branch_node_block", 3)])
def test_kernel_order_matches_reference_scan(case, n_rhs):
    """The kernel's order of operations against the JAX package's scan on
    an assembled mesh band and the branch circuit's node block with three
    right-hand sides, f64."""
    U, b = _assembled(case)
    rng = np.random.default_rng(11)
    R = torch.cat([b[..., None], torch.as_tensor(
        rng.standard_normal(b.shape + (n_rhs - 1,)))], -1)
    want = np.asarray(jsb.scalar_band_solve_scan(jnp.asarray(U.numpy()),
                                                 jnp.asarray(R.numpy())))
    got = _kernel_order_solve(U, R)
    assert _rel(got.numpy(), want) <= 1e-12


def test_stages_match_the_kernel_source():
    src = (kernels.CSRC_DIR / "sband.cu").read_text()
    assert f"constexpr int kStages = {sband.STAGES};\n" in src
    assert sband.STAGES & (sband.STAGES - 1) == 0


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("B,n,W1,n_rhs", [
    (16384, 999, 27, 1), (16384, 1000, 27, 3), (256, 4999, 27, 1),
    (7, 16384, 57, 71), (1, 1, 1, 1), (256, 8, 2, 126), (3, 40, 32, 1)])
def test_launch_config(B, n, W1, n_rhs, itemsize):
    cfg = sband.launch_config(B, n, W1, n_rhs, itemsize)
    if W1 + n_rhs <= sband.REGISTER_W1A:
        # The window in registers; shared memory holds the backward ring.
        assert cfg.variant == "registers"
        per_warp = (96 + (W1 + sband.STAGES) * 32) * itemsize
        assert per_warp % 16 == 0
    else:
        assert cfg.variant == "shared"
        per_warp = (W1 + 1) * (W1 + n_rhs) * itemsize
    assert 1 <= cfg.warps_per_block <= sband.MAX_WARPS
    if cfg.variant == "registers" and itemsize == 8:
        assert cfg.warps_per_block <= sband.MAX_WARPS // 2
    assert cfg.smem_bytes == cfg.warps_per_block * per_warp
    assert cfg.smem_bytes <= sband.SMEM_BYTES_MAX
    assert 1 <= cfg.n_warps <= B
    assert cfg.warps_per_block <= cfg.n_warps
    assert cfg.scratch_elems == cfg.n_warps * n * (W1 + n_rhs)
    assert cfg.scratch_elems * itemsize <= max(sband.SCRATCH_BYTES_MAX,
                                               n * (W1 + n_rhs) * itemsize)


def test_main_path_shapes_take_the_register_variant():
    """The 25-row meshes (W1 = 27, one RHS) and the branch circuit's node
    block (three RHS) keep the elimination window in registers."""
    for n_rhs in (1, 3):
        assert sband.launch_config(16384, 1000, 27, n_rhs, 4).variant == \
            "registers"


def test_kernel_fits_every_plan_shape():
    assert sband.sband_fits(tsb.MAX_W + 1, sband.MAX_W1A - tsb.MAX_W - 1)
    assert not sband.sband_fits(tsb.MAX_W + 1, sband.MAX_W1A - tsb.MAX_W)
    assert not sband.sband_fits(tsb.MAX_W + 2, 1)
    # The JAX package's bound on the streaming kernel is the same.
    for W1 in (1, 27, 57):
        for n_rhs in (1, 3, 71, 72, 127):
            assert sband.sband_fits(W1, n_rhs) == (
                jpsb.sband_fits_stream(8, W1, n_rhs) and W1 - 1 <= tsb.MAX_W)


def test_kernel_is_built_with_the_library():
    assert "sband.cu" in [p.name for p in kernels._sources()]
    for name in ("sband_solve_f32", "sband_solve_f64"):
        argtypes, _ = kernels._SIGNATURES[name]
        assert len(argtypes) == 12


def _dense_f64(jc, params):
    out = []
    for p in params:
        G, b = jassemble_dense(jc.stamps, jnp.asarray(p), dtype=jnp.float64)
        out.append(np.linalg.solve(np.asarray(G), np.asarray(b)))
    return np.stack(out)


MESHES = {"mesh9x11": (_mesh_rows(9, 11), 6),
          "midsize5x800": (_mesh_rows(5, 800), 2)}


@pytest.fixture(scope="module", params=list(MESHES))
def mesh(request):
    rows, B = MESHES[request.param]
    jc, st = _stamps(rows)
    params = _params(jc, B, seed=4)
    return jc, st, params, _dense_f64(jc, params), request.param


@pytest.mark.parametrize("refine", [False, "auto", True])
def test_solver_matches_reference(mesh, refine):
    jc, st, params, ref, name = mesh
    js = jbatch.BatchedSolver(jc, dtype=jnp.float32, refine=refine)
    ts = BatchedSolver(st, refine=refine, device="cpu")
    assert js.method == ts.method == "sband"
    want = np.asarray(js(params))
    got = ts(params)
    assert got.device.type == "cpu" and got.shape == params.shape[:1] + (
        st.n,)
    if refine is False:
        # Both packages run the same f32 recurrence, and their rounding
        # differences grow with the conditioning.  On the 9×11 mesh
        # (κ ≈ 1e3) they agree within 1e-5.  On the 5×800 strip each f32
        # answer is ~1e-3 from the f64 truth (κ·ε₃₂), so there the port is
        # held to at most twice the JAX package's own f32 error.
        assert got.dtype == torch.float32
        if name == "mesh9x11":
            assert _rel(got.numpy(), want) <= 1e-5
        assert _rel(got.numpy(), ref) <= max(2 * _rel(want, ref), 1e-5)
    else:
        # The contract, 1e-6 from the f64 truth, on every mesh.  Within
        # 1e-9 of the JAX package where the f32 solve contracts the error
        # by ~1e-6 a pass (the 9×11 mesh).  On the strip one pass
        # contracts by only ~1e-3, so refine="auto" may stop after another
        # pass count than the JAX package's (its error estimate reads its
        # own f32 rounding), and refine=True, two fixed passes, is held to
        # twice the JAX package's own error.
        assert got.dtype == torch.float64
        if name == "mesh9x11":
            assert _rel(got.numpy(), want) <= 1e-9
        elif refine is True:
            assert _rel(got.numpy(), ref) <= max(2 * _rel(want, ref), 1e-9)
        assert _rel(got.numpy(), ref) <= 1e-6
        res = ts.residuals(params, got)
        assert res.shape == (len(params),) and float(res.max()) <= 1e-6
        np.testing.assert_allclose(
            res.numpy(), np.asarray(js.residuals(params, got.numpy())),
            rtol=0, atol=1e-12)


def test_raw_f64_matches_reference(mesh):
    jc, st, params, ref, _ = mesh
    js = jbatch.BatchedSolver(jc, dtype=jnp.float64, refine=False)
    ts = BatchedSolver(st, dtype=torch.float64, refine=False, device="cpu")
    assert js.method == ts.method == "sband"
    got = ts(params)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), np.asarray(js(params))) <= 1e-9
    assert _rel(got.numpy(), ref) <= 1e-6
    assert float(ts.residuals(params, got).max()) <= 1e-10


def test_transposed_solve_matches_reference(mesh):
    """The contract layer's transposed solve (the adjoint's), on a random
    RHS: 1e-6 from the f64 truth, and 1e-9 from the JAX package on the
    well-conditioned mesh (see test_solver_matches_reference)."""
    jc, st, params, _, name = mesh
    rhs = np.random.default_rng(5).standard_normal((len(params), st.n))
    want = jbatch.BatchedSolver(jc, dtype=jnp.float32)._solve_rhs_t(
        jnp.asarray(params, jnp.float32), jnp.asarray(rhs))
    got = BatchedSolver(st, device="cpu")._solve_rhs_t(
        torch.as_tensor(params, dtype=torch.float32), torch.as_tensor(rhs))
    truth = np.stack([
        np.linalg.solve(np.asarray(jassemble_dense(
            jc.stamps, jnp.asarray(p), dtype=jnp.float64)[0]).T, r)
        for p, r in zip(params, rhs)])
    assert _rel(got.numpy(), truth) <= 1e-6
    if name == "mesh9x11":
        assert _rel(got.numpy(), want) <= 1e-9


def test_cpu_solver_never_launches_the_kernel(mesh):
    _, st, params, _, _ = mesh
    before = sband.sband_solve_multi.launches
    BatchedSolver(st, device="cpu")(params)
    assert sband.sband_solve_multi.launches == before == 0
