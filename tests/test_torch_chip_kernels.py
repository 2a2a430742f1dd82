"""Properties of the port's CUDA kernels that only the card can show
(marked ``chip``; each test skips without a CUDA device).

This file imports neither JAX nor the JAX package.  The card has no JAX,
so run it there without the suite's ``conftest.py``:

    python -m pytest --noconftest -m chip tests/test_torch_chip_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the shapes and bounds the card checks)
from nodal_tpu_torch import BatchedSolver, Circuit, Netlist  # noqa: E402
from nodal_tpu_torch import batch as tbatch  # noqa: E402
from nodal_tpu_torch.ops import block_lu, block_thomas, lu  # noqa: E402
from nodal_tpu_torch.ops.band import band_plan, band_thomas_solve  # noqa: E402
from nodal_tpu_torch.ops.block_thomas import (  # noqa: E402
    band_factor, band_solve_multi, band_substitute, launch_plan)
from nodal_tpu_torch.ops.sband import sband_solve_multi  # noqa: E402
from nodal_tpu_torch.ops.scalar_band import sband_plan  # noqa: E402
from nodal_tpu_torch.utils import tracing  # noqa: E402
from nodal_tpu_torch.utils.gridgen import (  # noqa: E402
    grid_rows, ladder_rows, weighted_lattice_rows)

pytestmark = pytest.mark.chip


def _lattice_rows():
    """The 20×10×10 unit-resistor lattice of ``lattice2k``."""
    d, h, w = 20, 10, 10
    return list(weighted_lattice_rows(
        np.ones((d, h, w - 1)), np.ones((d, h - 1, w)),
        np.ones((d - 1, h, w)), (0, 0, 0), (d - 1, h - 1, w - 1)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("tier", ["sband", "band"])
def test_band_kernels_leave_their_inputs(cuda, tier, dtype):
    """The contract layer assembles the band once a run and solves every
    defect pass on it, so neither band kernel may write its band or its
    right-hand sides; a second solve on them gives the same answer."""
    rows = list(grid_rows(25, 40, (0, 0), (24, 39)))
    stamps = Circuit(Netlist.from_rows(
        rows + [["src", "A", "1", "1", "g"]])).stamps
    plan, solve = {"sband": (sband_plan(stamps), sband_solve_multi),
                   "band": (band_plan(stamps), band_solve_multi)}[tier]
    gen = torch.Generator(device=cuda).manual_seed(21)
    base = torch.as_tensor(stamps.params, dtype=dtype, device=cuda)
    params = base * (1.0 + 0.05 * torch.randn(
        (64, len(base)), generator=gen, dtype=dtype, device=cuda))
    W, _ = plan.assemble(stamps, params)
    rhs = torch.randn((64, 3, stamps.n), generator=gen, dtype=dtype,
                      device=cuda)
    R = plan.rhs_to_band(rhs).transpose(1, 2).contiguous()
    W0, R0 = W.clone(), R.clone()
    launches = solve.launches
    x = solve(W, R)
    again = solve(W, R)
    torch.cuda.synchronize(cuda)
    assert solve.launches > launches
    assert torch.equal(W, W0)
    assert torch.equal(R, R0)
    assert torch.equal(again, x)


def _random_regular_rows(n, seed):
    """Unit resistors along two random permutations and a ground tie on
    every node: no band, and at most 10 COO entries a row, so the f64
    residual takes the gather-fold (the scatter-add that wider rows take
    sums by atomics, whose order the card does not repeat)."""
    rng = np.random.default_rng(seed)
    rows = [["v", "A", "1", "n0", "g"]]
    for k, p in enumerate((rng.permutation(n), rng.permutation(n))):
        rows += [[f"r{k}_{a}", "R", "1", f"n{a}", f"n{b}"]
                 for a, b in enumerate(p) if a != b]
    return rows + [[f"rg{j}", "R", "1", f"n{j}", "g"] for j in range(n)]


_MESH = list(grid_rows(9, 40, (0, 0), (8, 39))) + [["src", "A", "1", "1",
                                                   "g"]]
_BRANCH = [["e1", "E", "2", "1", "g"],
           ["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"]]

#: One circuit a tier and schur sub-branch (rows, method).
_TIERS = {
    "tridiag": (ladder_rows(64), "tridiag"),
    "sband": (_MESH, "sband"),
    "band": (_MESH, "band"),
    "block": (_MESH, "block"),
    "schur-sband": (list(grid_rows(16, 17, (0, 0), (15, 16))) + _BRANCH,
                    "schur"),
    "schur-band": (list(grid_rows(60, 60, (0, 0), (59, 59))) + _BRANCH,
                   "schur"),
    "schur-lu": (_random_regular_rows(400, seed=1) + [
        ["e1", "E", "2", "n1", "g"],
        ["d1", "VCCS", "0.5", "n3", "g", "n1", "g"]], "schur"),
    "dense": (ladder_rows(8)[1:] + [["v0", "E", "1", "n0", "g"]], "dense"),
}


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["forward", "transposed"])
@pytest.mark.parametrize("tier", list(_TIERS))
def test_every_tier_prepares_once_bit_for_bit(cuda, tier, transpose):
    """The contract layer prepares each tier's operator (bands, blocks,
    factor) once a run and solves every defect pass on it, so no kernel
    may write what it is given: the run equals, bit for bit, the same run
    on a prepared form that prepares again for every solve."""
    rows, method = _TIERS[tier]
    stamps = Circuit(Netlist.from_rows(rows)).stamps
    solver = BatchedSolver(stamps, method=method, device=cuda)
    assert solver.method == method
    op = solver._operator
    prepare = op.prepare_t if transpose else op.prepare
    twice = tbatch._escalating_solver(
        stamps, lambda pb: lambda rhs=None: prepare(pb)(rhs),
        transpose=transpose)
    gen = torch.Generator(device=cuda).manual_seed(25)
    base = torch.as_tensor(stamps.params, dtype=torch.float32, device=cuda)
    params = base * (1.0 + 0.05 * torch.randn(
        (64, len(base)), generator=gen, dtype=torch.float32, device=cuda))
    rhs = torch.randn((64, stamps.n), generator=gen, dtype=torch.float64,
                      device=cuda)
    if transpose:
        (got, call), (want, ref) = (
            _traced(solver._solve_rhs_t, params, rhs),
            _traced(twice, params, rhs))
    else:
        (got, call), (want, ref) = _traced(solver, params), _traced(
            twice, params)
    torch.cuda.synchronize(cuda)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    if tier == "band":
        # The band tier eliminates once and substitutes for each pass.
        passes = call.counters["contract_passes"]
        assert call.counters["thomas_factorizations"] == 1
        assert call.counters["thomas_substitutions"] == passes >= 1
        assert ref.counters["thomas_factorizations"] == 1 + passes


def _traced(fn, *args):
    """``fn(*args)`` in a call record of its own: (result, record)."""
    tracing.enable()
    try:
        with tracing.root("check"):
            out = fn(*args)
    finally:
        tracing.disable()
    return out, tracing.recent(1)[0]


def test_thomas_kernels_counted_a_host_loop(cuda):
    """A ``band``-tier sweep call of the 20×10×10 lattice: one host loop
    eliminates (``band_solve_multi.launches``, ``thomas_factorizations``)
    and each defect pass substitutes (``thomas_substitutions``); the
    tracing counter ``thomas_kernels`` and ``band_solve_multi.kernels``
    both add ``launch_plan``'s kernels for the host loop and one a
    substitution, and each block-Thomas solve is a device-timed
    ``thomas.solve`` span."""
    circuit = Circuit(Netlist.from_rows(_lattice_rows()
                                        + [["src", "A", "1", "1", "g"]]))
    solver = BatchedSolver(circuit, device=cuda)
    assert solver.method == "band"
    params = np.tile(circuit.stamps.params, (64, 1))
    solver(params)  # builds the library outside the counted call
    loops, kernels = band_solve_multi.launches, band_solve_multi.kernels
    tracing.enable()
    try:
        solver(params)
        (call,) = tracing.recent(1)
    finally:
        tracing.disable()
    loops = band_solve_multi.launches - loops
    per_loop = launch_plan(*band_solve_multi.last_shape, 4).launches
    passes = call.counters["contract_passes"]
    assert band_solve_multi.last_shape == (64, 16, 128, 1)
    assert loops == call.counters["thomas_factorizations"] == 1
    assert call.counters["thomas_substitutions"] == passes >= 1
    assert call.counters["thomas_kernels"] == loops * per_loop + passes == \
        band_solve_multi.kernels - kernels
    spans = call.find("thomas.solve")
    assert len(spans) == loops + passes
    assert all(s.device_ms > 0 for s in spans)


def test_lattice_call_trace_holds_the_counted_kernels(cuda):
    """One profiled ``band``-tier call of the 20×10×10 lattice: the
    block-Thomas kernels in the trace, substitution included, are as many
    as ``band_solve_multi.kernels`` counted (the benchmark's condition
    for a whole trace), from one eliminating host loop.  The profiler
    drops events at times, so up to three calls are traced."""
    from torch.profiler import ProfilerActivity, profile

    circuit = Circuit(Netlist.from_rows(_lattice_rows()
                                        + [["src", "A", "1", "1", "g"]]))
    solver = BatchedSolver(circuit, device=cuda)
    params = np.tile(circuit.stamps.params, (64, 1))
    solver(params)
    torch.cuda.synchronize(cuda)
    for _ in range(3):
        loops, kernels = band_solve_multi.launches, band_solve_multi.kernels
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solver(params)
            torch.cuda.synchronize(cuda)
        traced = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "block_thomas" in e.name]
        counted = band_solve_multi.kernels - kernels
        assert band_solve_multi.launches - loops == 1
        if len(traced) == counted:
            break
    assert len(traced) == counted
    assert any("block_thomas_subst" in e.name for e in traced)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [
    (cs.GENERAL_BATCH, 16, 128, 1), (7, 2, 128, 4), (3, 16, 128, 3),
    (5, 1, 128, 1)], ids=lambda s: "x".join(map(str, s)))
def test_kept_elimination_and_substitution_bit_for_bit(cuda, shape, dtype,
                                                       monkeypatch):
    """``band_factor``'s X equals ``band_solve_multi``'s bit for bit (the
    same launches; only S_t⁻¹'s address differs), and
    ``block_thomas_subst`` on new right-hand sides equals a fresh
    ``band_solve_multi`` on them bit for bit, within the f32 solve's own
    error of the f64 answer, the held factors left as they were."""
    # The lattice's shape keeps 4.4 GB in f64, past the default cap.
    monkeypatch.setattr(block_thomas, "SCRATCH_BYTES_MAX", 16 << 30)
    B, nb, kb, r = shape
    gen = torch.Generator(device=cuda).manual_seed(26)
    W, R = cs.random_block_band(B, nb, kb, r, dtype, gen)
    R2 = torch.randn(R.shape, generator=gen, device=cuda, dtype=dtype)
    X, f = band_factor(W, R)
    assert f is not None
    held = f.F.clone()
    got = band_substitute(f, R2)
    fresh = band_solve_multi(W, R2)
    torch.cuda.synchronize(cuda)
    assert torch.equal(X, band_solve_multi(W, R))
    assert torch.equal(got, fresh)
    assert torch.equal(f.F, held)
    truth = band_thomas_solve(W.double(), R2.double())
    err = cs.rel_diff(got.double().reshape(B, -1), truth.reshape(B, -1))
    assert err <= cs.BAND_RTOL[dtype]


# --- the f32 128×128 inverse (csrc/dense_tile.cuh, invert_block_f32) on every
# route that reaches it, each against the plain version on the same CUDA
# tensors.  The kernel eliminates without pivoting, the plain versions pivot
# inside each block or invert it by torch.linalg; on these diagonally
# dominant bands and grounded Laplacians both are backward-stable, so they
# differ by rounding: chip_smoke's bounds, which hold the kernels to the
# unit roundoff times modest growth (BAND_RTOL, LU_RTOL: 1e-4 in f32, about
# two orders above the differences seen) or, on the Laplacians, to
# LU_KAPPA_FACTOR·κ₁·ε.

@pytest.mark.parametrize("shape", [
    (cs.GENERAL_BATCH, 16, 128, 1),   # lattice2k.mc1k: the r <= 4 launch
    (7, 16, 128, 5),                  # r > 4: the plain inverse launch
    (3, 16, 128, 64),                 # equiv_many's 64 probe pairs
    (1, 16, 128, 1), (1, 79, 128, 1),  # B = 1: one block a launch
    (7, 4, 256, 3), (7, 3, 384, 1),    # kb > 128: inside lu_factor
], ids=lambda s: "x".join(map(str, s)))
def test_block_thomas_f32_inverse_routes(cuda, shape):
    """Block Thomas in f32 at every shape class whose Schur blocks the f32
    inverse takes, against ``band_thomas_solve`` on the card."""
    B, nb, kb, r = shape
    gen = torch.Generator(device=cuda).manual_seed(24)
    W, R = cs.random_block_band(B, nb, kb, r, torch.float32, gen)
    got = band_solve_multi(W, R)
    want = band_thomas_solve(W, R)
    torch.cuda.synchronize(cuda)
    assert bool(torch.isfinite(got).all())
    assert cs.rel_diff(got.reshape(B, -1), want.reshape(B, -1)) <= \
        cs.BAND_RTOL[torch.float32]


def test_block_lu_f32_inverse_at_randnet(cuda):
    """The blocked LU in f32 at the ``randnet`` shape (1024 grounded random
    networks of 1000 nodes padded to 1024), whose eight diagonal blocks a
    system the f32 inverse takes, against the plain blocked LU."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    A, R = cs.random_laplacian(cs.GENERAL_BATCH, 1024, 1, torch.float32, gen)
    tol = cs.lu_check_tol(A, "laplacian")["tol"]
    want = block_lu.blocked_solve_factored(block_lu.blocked_factor(A), R)
    got = lu.lu_solve_multi(A, R)
    torch.cuda.synchronize(cuda)
    assert bool(torch.isfinite(got).all())
    assert cs.rel_diff(got.reshape(A.shape[0], -1),
                       want.reshape(A.shape[0], -1)) <= tol


def test_f32_inverse_of_lattice_schur_blocks(cuda):
    """The inverse alone (``lu_factor`` of one 128×128 panel is one inverse
    launch) on the grounded-Laplacian Schur blocks S_t = D_t − L_t·S_{t−1}⁻¹
    ·U_{t−1} of the 20×10×10 lattice's own band, 5 % conductance spread,
    against ``torch.linalg.inv`` in f64: within LU_KAPPA_FACTOR·κ₁·ε of
    max|S⁻¹| (κ₁ of each block), and bit for bit the same on a repeat."""
    circuit = Circuit(Netlist.from_rows(_lattice_rows()
                                        + [["src", "A", "1", "1", "g"]]))
    stamps = circuit.stamps
    plan = band_plan(stamps)
    assert plan is not None and plan.kb == 128
    gen = torch.Generator(device=cuda).manual_seed(24)
    base = torch.as_tensor(stamps.params, dtype=torch.float64, device=cuda)
    params = base * (1.0 + 0.05 * torch.randn(
        (64, len(base)), generator=gen, dtype=torch.float64, device=cuda))
    W, _ = plan.assemble(stamps, params)
    kb = plan.kb
    S, blocks = W[:, 0, :, kb:2 * kb], []
    for t in range(plan.nb):
        if t:
            C = torch.linalg.solve(S, W[:, t - 1, :, 2 * kb:])
            S = W[:, t, :, kb:2 * kb] - W[:, t, :, :kb] @ C
        blocks.append(S)
    S64 = torch.cat(blocks)
    want = torch.linalg.inv(S64)
    got = lu.lu_factor(S64.float().contiguous())
    again = lu.lu_factor(S64.float().contiguous())
    torch.cuda.synchronize(cuda)
    assert torch.equal(got, again)
    kappa = torch.linalg.cond(S64, p=1)
    eps = torch.finfo(torch.float32).eps / 2
    err = ((got.double() - want).abs().amax((1, 2))
           / want.abs().amax((1, 2)))
    assert bool((err <= cs.LU_KAPPA_FACTOR * kappa * eps).all())


def test_lu_kernels_counted_a_randnet_call(cuda):
    """A ``block``-tier sweep call of chip_smoke.py's random network (999
    unknowns, n_pad 1024) at B 64: one ``dense.assemble``, one
    factorization and two substitutions, each a device-timed span, and
    ``lu_kernels`` = ``factor_launches(1024)`` + 2 ``solve_launches(1024)``
    = 88, as many ``block_lu`` kernels as the profiler traces (the
    benchmark's condition for a whole trace; up to three calls traced,
    since the profiler drops events at times)."""
    from torch.profiler import ProfilerActivity, profile

    circuit = Circuit(Netlist.from_rows(cs.randnet_rows()))
    solver = BatchedSolver(circuit, device=cuda)
    assert solver.method == "block"
    params = np.tile(circuit.stamps.params, (64, 1))
    solver(params)  # builds the library outside the counted call
    tracing.enable()
    try:
        solver(params)
        (call,) = tracing.recent(1)
    finally:
        tracing.disable()
    c = call.counters
    assert (c["dense_assemblies"], c["lu_factorizations"],
            c["lu_substitutions"]) == (1, 1, 2)
    want = lu.factor_launches(1024) + 2 * lu.solve_launches(1024)
    assert c["lu_kernels"] == want == 88
    spans = (call.find("dense.assemble") + call.find("lu.factor")
             + call.find("lu.solve"))
    assert len(spans) == 4 and all(s.device_ms > 0 for s in spans)
    torch.cuda.synchronize(cuda)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solver(params)
            torch.cuda.synchronize(cuda)
        traced = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "block_lu" in e.name]
        if len(traced) == want:
            break
    assert len(traced) == want


def test_randnet_answers_bit_for_bit(cuda):
    """The random network's ``"auto"`` answers at B 256 are the same bits on
    a second call and with the batch split in two: its residual's wide rows
    fold in a fixed order, with no atomics, as the f64 COO apply alone
    shows too."""
    circuit = Circuit(Netlist.from_rows(cs.randnet_rows()))
    stamps = circuit.stamps
    solver = BatchedSolver(circuit, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(28)
    base = torch.as_tensor(stamps.params, dtype=torch.float32, device=cuda)
    p = base * (1 + 0.05 * torch.randn((256, len(base)), generator=gen,
                                       device=cuda))
    x = solver(p)
    assert torch.equal(solver(p), x)
    assert torch.equal(torch.cat([solver(p[:128]), solver(p[128:])]), x)
    g_vals, _ = tbatch.stamp_values(stamps, p.to(torch.float64))
    y = tbatch._coo_apply(stamps, g_vals, x)
    assert tbatch._resid_gather_tables(stamps)[0].offsets is not None
    assert torch.equal(tbatch._coo_apply(stamps, g_vals, x), y)
    assert torch.equal(torch.cat([
        tbatch._coo_apply(stamps, g_vals[:100], x[:100]),
        tbatch._coo_apply(stamps, g_vals[100:], x[100:])]), y)
