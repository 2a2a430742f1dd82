"""The port's weighted 3-D lattices (``nodal_tpu_torch/ops/grid_weighted3.py``
over the [B, d, h, w] machinery of ``ops/grid_weighted.py`` and the plain
versions of ``ops/weighted_stencil.py``) against the JAX package's
``nodal_tpu/ops/grid_weighted3.py`` on the same numpy inputs, in f64 unless
a case says otherwise: ``degree`` and ``coarsen_weights`` bit for bit, the
matvec within 1e-12 of max|y|, Galerkin exactness (PᵀLP is the coarse
lattice), one V-cycle within 1e-12 of max|M r| of JAX's at an even and an
odd size, solves at tol 1e-10 (x within 1e-8 of max|x|, R within 1e-8 of
JAX's and of the netlist path, the same iterations and ``converged``), a
batch of 4 f32 lattices against single solves and ``jax.vmap`` (rtol 1e-4),
gradients against ``jax.grad`` (1e-8 relative) and central differences, and
a lattice with zero-conductance edges.
"""

import numpy as np
import pytest
from scipy.sparse.csgraph import connected_components

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nodal_tpu.ops import grid_weighted3 as jgw3  # noqa: E402
from nodal_tpu_torch import Netlist  # noqa: E402
from nodal_tpu_torch.equiv import equivalent_resistance  # noqa: E402
from nodal_tpu_torch.ops import grid_weighted as gw  # noqa: E402
from nodal_tpu_torch.ops import grid_weighted3 as gw3  # noqa: E402
from nodal_tpu_torch.ops import weighted_stencil as ws  # noqa: E402
from nodal_tpu_torch.utils.gridgen import weighted_lattice_rows  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(d, h, w, seed=0, lo=0.2, hi=5.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (d, h, w - 1)),
            rng.uniform(lo, hi, (d, h - 1, w)),
            rng.uniform(lo, hi, (d - 1, h, w)))


def _batched(*arrays):
    return tuple(torch.tensor(a)[None] for a in arrays)


def _dense(gx, gy, gz):
    d, h, w = gy.shape[0], gx.shape[1], gy.shape[2]
    n = d * h * w
    L = np.zeros((n, n))
    idx = np.arange(n).reshape(d, h, w)
    for a, b, g in ((idx[..., :-1], idx[..., 1:], gx),
                    (idx[:, :-1], idx[:, 1:], gy), (idx[:-1], idx[1:], gz)):
        a, b, g = a.ravel(), b.ravel(), g.ravel()
        np.add.at(L, (a, a), g)
        np.add.at(L, (b, b), g)
        np.add.at(L, (a, b), -g)
        np.add.at(L, (b, a), -g)
    return L


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dims", [(4, 4, 6), (3, 5, 4), (2, 2, 2),
                                  (1, 4, 4)])
def test_degree_and_coarsening_equal_jax(dims):
    d, h, w = dims
    gs = _weights(d, h, w, seed=sum(dims))
    g = _batched(*gs)
    jg = tuple(jnp.asarray(a) for a in gs)
    assert np.array_equal(ws.degree(g)[0].numpy(),
                          np.asarray(jgw3._degree3(*jg, d, h, w)))
    if all(n % 2 == 0 for n in dims):
        for port, ref in zip(ws.coarsen_weights(g),
                             jgw3._coarsen_weights3(*jg)):
            assert np.array_equal(port[0].numpy(), np.asarray(ref))


def test_matvec_matches_jax_and_dense():
    d, h, w = 3, 4, 5
    gs = _weights(d, h, w)
    x = np.random.default_rng(1).standard_normal((d, h, w))
    y = ws.laplacian_plain(torch.tensor(x)[None],
                           _batched(*gs))[0].numpy()
    yj = np.asarray(jgw3.weighted_laplacian_matvec_3d(
        jnp.asarray(x), *(jnp.asarray(a) for a in gs)))
    yd = (_dense(*gs) @ x.ravel()).reshape(d, h, w)
    scale = np.abs(yd).max()
    assert np.abs(y - yj).max() <= 1e-12 * scale
    assert np.abs(y - yd).max() <= 1e-12 * scale


def test_galerkin_coarsening_is_exact():
    """The port's coarse lattice equals PᵀLP for 2×2×2 replication, and its
    restriction and prolongation are that P's transpose and P."""
    d, h, w = 4, 4, 6
    gs = _weights(d, h, w, seed=2)
    L = _dense(*gs)
    dc, hc, wc = d // 2, h // 2, w // 2
    P = np.zeros((d * h * w, dc * hc * wc))
    for k in range(d):
        for i in range(h):
            for j in range(w):
                P[(k * h + i) * w + j,
                  ((k // 2) * hc + i // 2) * wc + j // 2] = 1.0
    coarse = [t[0].numpy() for t in ws.coarsen_weights(_batched(*gs))]
    np.testing.assert_allclose(_dense(*coarse), P.T @ L @ P, atol=1e-12)
    r = np.random.default_rng(3).standard_normal((d, h, w))
    rc = ws.restrict_plain(torch.tensor(r)[None])[0].numpy()
    np.testing.assert_allclose(rc.ravel(), P.T @ r.ravel(), atol=1e-12)
    z = np.random.default_rng(4).standard_normal((dc, hc, wc))
    zf = ws.prolong_plain(torch.tensor(z)[None], d)[0].numpy()
    np.testing.assert_allclose(zf.ravel(), P @ z.ravel(), atol=0)


def test_fused_sweep_and_restriction_plain_semantics():
    rng = np.random.default_rng(5)
    d, h, w = 4, 6, 8
    g = _batched(*_weights(d, h, w, seed=5))
    x, r = (torch.tensor(rng.standard_normal((1, d, h, w))) for _ in "xr")
    zc = torch.tensor(rng.standard_normal((1, 2, 3, 4)))
    res = r - ws.laplacian_plain(x, g)
    assert torch.equal(ws.weighted_residual(x, g, r, restrict=True),
                       ws.restrict_plain(res))
    xp = x + ws.prolong_plain(zc, d)
    dinv = torch.tensor(0.8, dtype=torch.float64) / ws.degree(g)
    assert torch.equal(ws.weighted_jacobi(x, r, g, zc=zc),
                       xp + dinv * (r - ws.laplacian_plain(xp, g)))
    levels = gw.build_levels(_batched(*_weights(20, 16, 32)), False)
    assert [tuple(lv[2].shape) for lv in levels] == [(1, 19, 16, 32),
                                                     (1, 9, 8, 16)]


@pytest.mark.parametrize("dims", [(16, 16, 16), (10, 10, 12), (4, 6, 5)])
def test_preconditioner_matches_jax(dims):
    d, h, w = dims
    gs = _weights(d, h, w, seed=d * h)
    r = np.random.default_rng(6).standard_normal((d, h, w))
    r -= r.mean()
    M = gw3.make_weighted_preconditioner_3d(d, h, w, *gs, device="cpu")
    Mj = jgw3.make_weighted_preconditioner_3d(
        d, h, w, *(jnp.asarray(a) for a in gs))
    assert _rel(M(r).numpy(), np.asarray(Mj(jnp.asarray(r)))) <= 1e-12


def test_solve_matches_jax_and_dense():
    d, h, w = 4, 6, 5  # odd w: no coarsening
    gs = _weights(d, h, w, seed=3)
    b = np.random.default_rng(4).standard_normal((d, h, w))
    b -= b.mean()
    x, info = gw3.weighted_lattice_solve(*gs, b, tol=1e-10, device="cpu")
    xj, ij = jgw3.weighted_lattice_solve(*(jnp.asarray(a) for a in gs),
                                         jnp.asarray(b), tol=1e-10)
    n = d * h * w
    xe = np.linalg.solve(_dense(*gs) + np.ones((n, n)) / n, b.ravel())
    assert _rel(x.numpy().ravel(), xe) <= 1e-8
    assert _rel(x.numpy(), xj) <= 1e-8
    assert int(info.iterations) == int(ij.iterations)
    assert bool(info.converged) == bool(ij.converged) is True


def test_bench_lattice_converges_as_jax():
    """The 12×16×16 lattice of tests/test_grid_weighted3.py:127."""
    d, h, w = 12, 16, 16
    gs = _weights(d, h, w, seed=5, lo=0.5, hi=2.0)
    rhs = np.zeros((d, h, w))
    rhs[0, 0, 0], rhs[d - 1, h - 1, w - 1] = 1.0, -1.0
    x, info = gw3.weighted_lattice_solve(*gs, rhs, tol=1e-10, device="cpu")
    xj, ij = jgw3.weighted_lattice_solve(*(jnp.asarray(a) for a in gs),
                                         jnp.asarray(rhs), tol=1e-10)
    assert _rel(x.numpy(), xj) <= 1e-8
    assert int(info.iterations) == int(ij.iterations) < 60
    assert bool(info.converged)


@pytest.mark.parametrize("dims,a,b", [
    ((4, 4, 4), (0, 0, 0), (3, 3, 3)),
    ((2, 6, 8), (0, 1, 1), (1, 4, 6)),
])
def test_resistance_matches_jax_and_the_netlist_path(dims, a, b):
    d, h, w = dims
    gs = _weights(d, h, w, seed=d * h * w)
    R, res = gw3.weighted_equivalent_resistance_3d(d, h, w, *gs, a, b,
                                                   tol=1e-10, device="cpu")
    Rj, _ = jgw3.weighted_equivalent_resistance_3d(
        d, h, w, *(jnp.asarray(x) for x in gs), a, b, tol=1e-10)
    netlist = Netlist.from_rows(weighted_lattice_rows(*gs, a, b))
    Rn = equivalent_resistance(netlist, "1", "g", device="cpu")
    assert abs(float(R) - float(Rj)) <= 1e-8 * abs(float(Rj))
    assert abs(float(R) - Rn) <= 1e-8 * abs(Rn)
    assert float(res) <= 1e-10


def test_zero_edge_lattice_solves_as_jax():
    """A connected lattice with about a fifth of its edges at zero."""
    d, h, w = 4, 8, 8
    gs = _weights(d, h, w, seed=12, lo=0.5, hi=2.0)
    mask = np.random.default_rng(2)
    for g in gs:
        g[mask.random(g.shape) < 0.2] = 0.0
    n_parts, _ = connected_components(_dense(*gs) != 0)
    assert n_parts == 1 and sum((g == 0).sum() for g in gs) > 100
    rhs = np.zeros((d, h, w))
    rhs[0, 1, 1], rhs[3, 6, 5] = 1.0, -1.0
    x, info = gw3.weighted_lattice_solve(*gs, rhs, tol=1e-10, device="cpu")
    xj, ij = jgw3.weighted_lattice_solve(*(jnp.asarray(a) for a in gs),
                                         jnp.asarray(rhs), tol=1e-10)
    assert bool(info.converged) and np.isfinite(x.numpy()).all()
    assert _rel(x.numpy(), xj) <= 1e-8
    assert int(info.iterations) == int(ij.iterations)


def test_batch_matches_single_solves_and_vmap():
    d, h, w = 4, 6, 6
    B = 4
    rng = np.random.default_rng(7)
    gxs = rng.uniform(0.5, 2.0, (B, d, h, w - 1)).astype(np.float32)
    gys = rng.uniform(0.5, 2.0, (B, d, h - 1, w)).astype(np.float32)
    gzs = rng.uniform(0.5, 2.0, (B, d - 1, h, w)).astype(np.float32)
    a, b = (0, 1, 1), (3, 4, 4)
    R, _ = gw3.weighted_equivalent_resistance_3d(d, h, w, gxs, gys, gzs, a,
                                                 b, tol=1e-6, device="cpu")
    assert R.shape == (B,) and R.dtype == torch.float32
    Rj = np.asarray(jax.vmap(
        lambda gx, gy, gz: jgw3.weighted_equivalent_resistance_3d(
            d, h, w, gx, gy, gz, a, b, tol=1e-6)[0])(
        jnp.asarray(gxs), jnp.asarray(gys), jnp.asarray(gzs)))
    np.testing.assert_allclose(R.numpy(), Rj, rtol=1e-4)
    for i in range(B):
        Ri, _ = gw3.weighted_equivalent_resistance_3d(
            d, h, w, gxs[i], gys[i], gzs[i], a, b, tol=1e-6, device="cpu")
        np.testing.assert_allclose(float(R[i]), float(Ri), rtol=1e-4)


def test_gradients_match_jax_grad_and_differences():
    d, h, w = 3, 4, 5
    rng = np.random.default_rng(0)
    gs = (rng.uniform(0.5, 2.0, (d, h, w - 1)),
          rng.uniform(0.5, 2.0, (d, h - 1, w)),
          rng.uniform(0.5, 2.0, (d - 1, h, w)))
    b = np.zeros((d, h, w))
    b[0, 0, 0], b[d - 1, h - 1, w - 1] = 1.0, -1.0
    wt = rng.standard_normal((d, h, w))

    def f(*args):
        return jnp.sum(jnp.asarray(wt)
                       * jgw3.weighted_lattice_solve(*args, tol=1e-12)[0])

    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (*gs, b)))
    ts = [torch.tensor(v, requires_grad=True) for v in (*gs, b)]
    x, _ = gw3.weighted_lattice_solve(*ts, tol=1e-12, device="cpu")
    (torch.tensor(wt) * x).sum().backward()
    for t, o in zip(ts, want):
        assert _rel(t.grad.numpy(), o) < 1e-8

    term = ((0, 0, 0), (d - 1, h - 1, w - 1))
    gzt = torch.tensor(gs[2], requires_grad=True)
    R, _ = gw3.weighted_equivalent_resistance_3d(
        d, h, w, gs[0], gs[1], gzt, *term, tol=1e-12, device="cpu")
    R.backward()
    eps = 1e-6
    Rs = []
    for s in (eps, -eps):
        gze = gs[2].copy()
        gze[1, 2, 3] += s
        Rs.append(float(gw3.weighted_equivalent_resistance_3d(
            d, h, w, gs[0], gs[1], gze, *term, tol=1e-12,
            device="cpu")[0]))
    assert abs(float(gzt.grad[1, 2, 3]) - (Rs[0] - Rs[1]) / (2 * eps)) < 1e-7


def test_entry_points_check_shapes_and_probes():
    gs = _weights(2, 3, 4)
    with pytest.raises(ValueError, match="outside"):
        gw3.weighted_equivalent_resistance_3d(2, 3, 4, *gs, (0, 0, 0),
                                              (2, 0, 0), device="cpu")
    with pytest.raises(ValueError):
        gw3.weighted_lattice_solve(gs[0], gs[1], gs[2][:, :2],
                                   np.zeros((2, 3, 4)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gw3.weighted_lattice_solve(*gs, np.zeros((2, 3, 4)))
