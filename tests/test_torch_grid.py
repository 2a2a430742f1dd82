"""The port's matrix-free grid solve against the JAX package: the batched
CG (``nodal_tpu_torch/ops/cg.py``) and ``nodal_tpu_torch/ops/grid.py`` on
the CPU (the plain cycle) against ``nodal_tpu/ops/cg.py`` and
``nodal_tpu/ops/grid.py`` (the xla cycle), and against the netlist path.

Tolerances: in f64 the two packages run the same operations, rounded alike
up to the order of the reductions, so R agrees to 1e-9 relative at tol
1e-10 with the same iteration count, and x to 1e-9; the netlist path is an
independent dense solve, held to 1e-7 as the JAX package's own test does;
in f32 R agrees to 1e-5 and the iteration count to ±1 (the f32 CG's
rounding can move the last iteration).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu.equiv import equivalent_resistance  # noqa: E402
from nodal_tpu.ops import cg as jcg  # noqa: E402
from nodal_tpu.ops import grid as jgrid  # noqa: E402
from nodal_tpu.utils.gridgen import grid_rows  # noqa: E402
from nodal_tpu_torch.ops import cg as tcg  # noqa: E402
from nodal_tpu_torch.ops import grid, stencil  # noqa: E402

SMALL = [(2, 2, (0, 0), (1, 1)), (3, 3, (0, 0), (1, 2)),
         (4, 4, (1, 1), (2, 3)), (5, 7, (0, 0), (4, 6))]
PAIRS16 = np.array([[[0, 0], [15, 15]], [[3, 3], [4, 5]],
                    [[8, 8], [9, 10]]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_laplacian_matvec_matches_dense():
    h, w = 5, 6
    x = np.random.default_rng(0).standard_normal((h, w))
    L = grid._dense_laplacian(h, w, 1.0)
    np.testing.assert_array_equal(L, jgrid._dense_laplacian(h, w, 1.0))
    expected = (L @ x.reshape(-1)).reshape(h, w)
    got = grid.laplacian_matvec(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12)
    batch = grid.laplacian_matvec(torch.as_tensor(np.stack([x, 2 * x])))
    np.testing.assert_allclose(batch[1].numpy(), 2 * expected, rtol=1e-12)


@pytest.mark.parametrize("h,w", [(1024, 1024), (1000, 1000), (48, 80), (5, 7)])
def test_levels_match_reference(h, w):
    """The port's hierarchy is the JAX package's, with the same edge weight
    on every level (the bilinear transfers' factor 1)."""
    want = jgrid._build_levels(h, w)
    assert stencil.level_shapes(h, w, grid._COARSEST_SIZE) == [
        (lv.h, lv.w) for lv in want]
    assert all(lv.weight == 1.0 for lv in want)


@pytest.mark.parametrize("h,w,a,b", SMALL + [(64, 64, (32, 32), (33, 34))])
def test_equivalent_resistance_matches_reference(h, w, a, b):
    r_ref, info_ref = jgrid.grid_equivalent_resistance(
        h, w, a, b, dtype=jnp.float64, tol=1e-10)
    r, info = grid.grid_equivalent_resistance(
        h, w, a, b, dtype=torch.float64, tol=1e-10, device="cpu")
    assert r.dim() == 0 and r.dtype == torch.float64
    np.testing.assert_allclose(float(r), float(r_ref), rtol=1e-9)
    assert int(info.iterations) == int(info_ref.iterations)
    assert bool(info.converged) == bool(info_ref.converged)
    assert bool(info.converged)


@pytest.mark.parametrize("h,w,a,b", SMALL)
def test_equivalent_resistance_matches_netlist_path(h, w, a, b):
    netlist = JNetlist.from_rows(grid_rows(h, w, probe_a=a, probe_b=b))
    r_netlist = equivalent_resistance(netlist, "1", "g")
    r, _ = grid.grid_equivalent_resistance(h, w, a, b, dtype=torch.float64,
                                           tol=1e-10, device="cpu")
    np.testing.assert_allclose(float(r), r_netlist, rtol=1e-7)


def test_grid_solve_matches_reference_injection_field():
    h = w = 8
    rhs = np.zeros((h, w))
    rhs[1, 1], rhs[6, 6] = 1.0, -1.0
    x_ref, _ = jgrid.grid_solve(h, w, rhs, dtype=jnp.float64, tol=1e-10)
    x, info = grid.grid_solve(h, w, rhs, dtype=torch.float64, tol=1e-10,
                              device="cpu")
    assert x.shape == (h, w) and bool(info.converged)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0,
                               atol=1e-9)
    assert abs(float(x.mean())) <= 1e-12
    assert float(x[1, 1]) > float(x[6, 6])


def test_many_pairs_match_reference_and_single_solves():
    rs_ref, res_ref = jgrid.grid_equivalent_resistance_many(
        16, 16, PAIRS16, dtype=jnp.float64, tol=1e-10)
    rs, res = grid.grid_equivalent_resistance_many(
        16, 16, PAIRS16, dtype=torch.float64, tol=1e-10, device="cpu")
    assert rs.shape == (3,) and res.shape == (3,)
    assert bool((res < 1e-9).all())
    np.testing.assert_allclose(rs.numpy(), np.asarray(rs_ref), rtol=1e-8)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), rtol=1e-6,
                               atol=1e-13)
    for k, (a, b) in enumerate(PAIRS16):
        r1, _ = grid.grid_equivalent_resistance(
            16, 16, tuple(a), tuple(b), dtype=torch.float64, tol=1e-10,
            device="cpu")
        np.testing.assert_allclose(float(rs[k]), float(r1), rtol=1e-8)


def test_batched_cg_freezes_converged_samples():
    """A sample that converges first keeps its own solve's state and count,
    as under ``jax.vmap`` of the while loop."""
    h = w = 32
    probe, *_ = grid._probe_fields(h, w, np.array([[[0, 0], [31, 31]]]),
                                   torch.float64, "cpu")
    i = torch.arange(h, dtype=torch.float64)[:, None]
    j = torch.arange(w, dtype=torch.float64)[None, :]
    smooth = torch.cos(np.pi * (i + 0.5) / h) * torch.cos(np.pi * (j + 0.5)
                                                          / w)
    fields = torch.stack([probe[0], smooth])
    x, info = grid.grid_solve(h, w, fields, dtype=torch.float64, tol=1e-10,
                              device="cpu")
    its = [int(k) for k in info.iterations]
    assert its[0] != its[1]
    for k in range(2):
        x1, info1 = grid.grid_solve(h, w, fields[k], dtype=torch.float64,
                                    tol=1e-10, device="cpu")
        assert int(info1.iterations) == its[k]
        np.testing.assert_allclose(x[k].numpy(), x1.numpy(), rtol=0,
                                   atol=1e-14)
        assert float(info.residual[k]) == pytest.approx(
            float(info1.residual), rel=1e-9)


def test_cg_matches_vmapped_reference_cg():
    """Batched CG on dense SPD systems of unequal difficulty: each sample's
    x, iterations and residual are those of ``jax.vmap`` of the JAX cg."""
    rng = np.random.default_rng(4)
    n, B = 24, 3
    A = []
    for k in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A.append(Q @ np.diag(np.geomspace(1, 2.0 ** (2 * k + 1), n)) @ Q.T)
    A = np.stack(A)
    b = rng.standard_normal((B, n))
    x_ref, info_ref = jax.vmap(lambda Ak, bk: jcg.cg(
        lambda v: Ak @ v, bk, tol=1e-10, maxiter=200))(jnp.asarray(A),
                                                      jnp.asarray(b))
    At = torch.as_tensor(A)
    x, info = tcg.cg(lambda v: (At @ v[..., None])[..., 0],
                     torch.as_tensor(b), tol=1e-10, maxiter=200)
    np.testing.assert_array_equal(info.iterations.numpy(),
                                  np.asarray(info_ref.iterations))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-9,
                               atol=1e-12)
    # The last step's residual is rounding noise near 1e-11 in both.
    assert bool((info.residual <= 1e-10).all())
    assert info.converged.tolist() == np.asarray(info_ref.converged).tolist()
    assert len(set(info.iterations.tolist())) == B


def test_unpreconditioned_cg_matches_reference():
    r_ref, info_ref = jgrid.grid_equivalent_resistance(
        16, 16, (3, 3), (12, 10), dtype=jnp.float64, tol=1e-10, mg=False)
    r, info = grid.grid_equivalent_resistance(
        16, 16, (3, 3), (12, 10), dtype=torch.float64, tol=1e-10, mg=False,
        device="cpu")
    np.testing.assert_allclose(float(r), float(r_ref), rtol=1e-9)
    assert int(info.iterations) == int(info_ref.iterations)


def test_f32_solve_matches_reference():
    r_ref, info_ref = jgrid.grid_equivalent_resistance(
        64, 64, (32, 32), (33, 34), dtype=jnp.float32, tol=3e-6,
        mg_backend="xla")
    r, info = grid.grid_equivalent_resistance(
        64, 64, (32, 32), (33, 34), tol=3e-6, device="cpu")
    assert r.dtype == torch.float32 and bool(info.converged)
    assert abs(float(r) - float(r_ref)) <= 1e-5
    assert abs(int(info.iterations) - int(info_ref.iterations)) <= 1


def test_preconditioner_backends_on_the_cpu():
    r = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 16, 24)))
    auto = grid.make_mg_preconditioner()(r)
    plain = grid.make_mg_preconditioner(backend="plain")(r)
    assert torch.equal(auto, plain)
    with pytest.raises(ValueError, match="mg_backend"):
        grid.make_mg_preconditioner(backend="xla")


def test_cpu_solve_never_launches_a_kernel():
    wrappers = (stencil.jacobi_sweeps, stencil.presmooth_restrict,
                stencil.prolong_postsmooth, stencil.vcycle)
    before = [f.launches for f in wrappers]
    grid.grid_equivalent_resistance(16, 16, (8, 8), (9, 10), device="cpu")
    assert [f.launches for f in wrappers] == before


def test_device_policy():
    if torch.cuda.is_available():
        pytest.skip("the default device is usable on this machine")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grid.grid_equivalent_resistance(8, 8, (0, 0), (7, 7))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grid.grid_equivalent_resistance_many(8, 8, PAIRS16[:1] % 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grid.grid_solve(8, 8, np.zeros((8, 8)))


def test_refusals():
    """Bad arguments raise; ``fused_cg=True`` does not: on the CPU it
    follows the JAX gate, which ignores the flag away from its Pallas
    backend, and gives the unfused solve bit for bit."""
    with pytest.raises(ValueError, match="mg_backend"):
        grid.grid_solve(8, 8, np.zeros((8, 8)), device="cpu",
                        mg_backend="pallas")
    rhs = np.zeros((8, 8))
    rhs[1, 2], rhs[6, 5] = 1.0, -1.0
    fused = grid.grid_solve(8, 8, rhs, device="cpu", fused_cg=True)
    plain = grid.grid_solve(8, 8, rhs, device="cpu")
    assert torch.equal(fused[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(fused[1], plain[1]))
    with pytest.raises(ValueError, match="shape"):
        grid.grid_solve(8, 8, np.zeros((8, 9)), device="cpu")
    with pytest.raises(ValueError, match="outside"):
        grid.grid_equivalent_resistance(8, 8, (0, 0), (8, 7), device="cpu")
    with pytest.raises(ValueError, match=r"\[P, 2, 2\]"):
        grid.grid_equivalent_resistance_many(8, 8, [[0, 0], [1, 1]],
                                             device="cpu")
