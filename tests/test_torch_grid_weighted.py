"""The port's weighted grids (``nodal_tpu_torch/ops/grid_weighted.py`` and
the plain versions and wrappers of ``ops/weighted_stencil.py``) against the
JAX package's ``nodal_tpu/ops/grid_weighted.py`` on the same numpy inputs,
in f64 unless a case says otherwise:

* ``degree`` and ``coarsen_weights`` equal ``_degree`` and
  ``_coarsen_weights`` bit for bit (the same terms in the same order);
* the matvec within 1e-12 of max|y| of JAX's and of a dense Laplacian;
* one application of the V-cycle within 1e-12 of max|M r| of JAX's
  ``make_weighted_preconditioner`` at an even and an odd size (the means
  and block sums are summed in another order, so not bit for bit);
* solves at tol 1e-10: x within 1e-8 of max|x|, R within 1e-8 of JAX's and
  of the port's netlist path, the same CG iterations and ``converged``;
* a batch of 4 f32 fabrics against its single solves and ``jax.vmap``
  (rtol 1e-4), gradients against ``jax.grad`` (1e-8 relative) and central
  differences, a field with zero-conductance edges.
"""

import re

import numpy as np
import pytest
from scipy.sparse.csgraph import connected_components

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nodal_tpu.ops import grid_weighted as jgw  # noqa: E402
from nodal_tpu_torch import Netlist  # noqa: E402
from nodal_tpu_torch.equiv import equivalent_resistance  # noqa: E402
from nodal_tpu_torch.ops import grid_weighted as gw  # noqa: E402
from nodal_tpu_torch.ops import weighted_stencil as ws  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402
from nodal_tpu_torch.utils.gridgen import weighted_grid_rows  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(h, w, seed=0, lo=0.2, hi=5.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (h, w - 1)), rng.uniform(lo, hi, (h - 1, w))


def _planar(gx, gy):
    """numpy [h, w-1], [h-1, w] as the port's batched d = 1 conductances."""
    h, w = gx.shape[0], gy.shape[1]
    return (torch.tensor(gx)[None, None], torch.tensor(gy)[None, None],
            torch.zeros(1, 0, h, w, dtype=torch.float64))


def _dense(gx, gy):
    h, w = gx.shape[0], gy.shape[1]
    n = h * w
    L = np.zeros((n, n))
    idx = np.arange(n).reshape(h, w)
    for a, b, g in ((idx[:, :-1], idx[:, 1:], gx), (idx[:-1], idx[1:], gy)):
        a, b, g = a.ravel(), b.ravel(), g.ravel()
        np.add.at(L, (a, a), g)
        np.add.at(L, (b, b), g)
        np.add.at(L, (a, b), -g)
        np.add.at(L, (b, a), -g)
    return L


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ------------------------------------------------------ plain building blocks

@pytest.mark.parametrize("h,w", [(4, 4), (6, 10), (16, 16), (5, 7)])
def test_degree_and_coarsening_equal_jax(h, w):
    gx, gy = _weights(h, w, seed=h + w)
    g = _planar(gx, gy)
    deg = ws.degree(g)[0, 0].numpy()
    assert np.array_equal(deg, np.asarray(
        jgw._degree(jnp.asarray(gx), jnp.asarray(gy), h, w)))
    if h % 2 == 0 and w % 2 == 0:
        gxc, gyc, gzc = ws.coarsen_weights(g)
        jx, jy = jgw._coarsen_weights(jnp.asarray(gx), jnp.asarray(gy))
        assert np.array_equal(gxc[0, 0].numpy(), np.asarray(jx))
        assert np.array_equal(gyc[0, 0].numpy(), np.asarray(jy))
        assert gzc.shape == (1, 0, h // 2, w // 2)


@pytest.mark.parametrize("h,w", [(5, 6), (1, 7), (9, 1)])
def test_matvec_matches_jax_and_dense(h, w):
    gx, gy = _weights(h, w)
    x = np.random.default_rng(1).standard_normal((h, w))
    y = ws.laplacian_plain(torch.tensor(x)[None, None],
                           _planar(gx, gy))[0, 0].numpy()
    yj = np.asarray(jgw.weighted_laplacian_matvec(
        jnp.asarray(x), jnp.asarray(gx), jnp.asarray(gy)))
    yd = (_dense(gx, gy) @ x.ravel()).reshape(h, w)
    scale = np.abs(yd).max()
    assert np.abs(y - yj).max() <= 1e-12 * scale
    assert np.abs(y - yd).max() <= 1e-12 * scale


def test_restriction_is_the_prolongation_transposed():
    rng = np.random.default_rng(2)
    r = torch.tensor(rng.standard_normal((2, 1, 6, 8)))
    z = torch.tensor(rng.standard_normal((2, 1, 3, 4)))
    lhs = (ws.restrict_plain(r) * z).sum()
    rhs = (r * ws.prolong_plain(z, 1)).sum()
    assert abs(float(lhs - rhs)) <= 1e-12 * float(r.abs().sum())


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(3)
    gx, gy = _weights(6, 8, seed=3)
    g = _planar(gx, gy)
    x, r = (torch.tensor(rng.standard_normal((1, 1, 6, 8))) for _ in "xr")
    zc = torch.tensor(rng.standard_normal((1, 1, 3, 4)))
    res = r - ws.laplacian_plain(x, g)
    assert torch.equal(ws.weighted_residual(x, g, r), res)
    assert torch.equal(ws.weighted_residual(x, g, r, restrict=True),
                       ws.restrict_plain(res))
    shift = torch.tensor([0.25], dtype=torch.float64)
    assert torch.equal(ws.weighted_residual(x, g, shift=shift),
                       ws.laplacian_plain(x, g) + 0.25)
    xp = x + ws.prolong_plain(zc, 1)
    dinv = torch.tensor(0.8, dtype=torch.float64) / ws.degree(g)
    want = xp + dinv * (r - ws.laplacian_plain(xp, g))
    assert torch.equal(ws.weighted_jacobi(x, r, g, zc=zc), want)
    assert torch.equal(ws.weighted_jacobi(None, r, g), dinv * r)
    two = ws.weighted_jacobi(x, r, g, sweeps=2)
    assert torch.equal(two, ws.weighted_jacobi(ws.weighted_jacobi(x, r, g),
                                               r, g))
    out = ws.weighted_jacobi_block(r, g, sweeps=3)
    x3 = ws.weighted_jacobi(None, r - r.mean(), g, sweeps=3)
    assert torch.equal(out, x3 - x3.mean())
    assert torch.equal(ws.coarse_solve(r, g, sweeps=3), out)


def test_wrappers_check_their_arguments():
    gx, gy = _weights(4, 6)
    g = _planar(gx, gy)
    r = torch.zeros(1, 1, 4, 6, dtype=torch.float64)
    with pytest.raises(ValueError):
        ws.weighted_residual(r, g, r, shift=torch.zeros(1, dtype=r.dtype))
    with pytest.raises(ValueError):
        ws.weighted_residual(r, g, restrict=True)
    with pytest.raises(ValueError):
        ws.weighted_residual(r, g)
    with pytest.raises(ValueError):
        ws.weighted_residual(r[:, :, :3], g, r[:, :, :3])
    with pytest.raises(TypeError):
        ws.weighted_jacobi(None, r.float(), g)
    with pytest.raises(ValueError):
        ws.weighted_jacobi(None, r, g, zc=torch.zeros(1, 1, 2, 2,
                                                      dtype=torch.float64))
    with pytest.raises(ValueError):
        ws.weighted_jacobi(None, r, g, sweeps=0)


def test_zero_conductance_edges_keep_the_guard():
    """Zero edges, one node isolated: ω / max(deg, tiny) there is ~3.6e307
    in f64 and 0·huge stays 0 on its edges, as in the JAX formula."""
    h, w = 5, 6
    gx, gy = _weights(h, w, seed=4)
    gx[2, 1:3] = 0.0
    gy[1:3, 2] = 0.0
    gx[0, :] = 0.0
    r = np.random.default_rng(5).uniform(-1, 1, (h, w))
    out = ws.weighted_jacobi(None, torch.tensor(r)[None, None],
                             _planar(gx, gy), sweeps=2)[0, 0].numpy()
    deg = np.asarray(jgw._degree(jnp.asarray(gx), jnp.asarray(gy), h, w))
    assert deg[2, 2] == 0.0
    dinv = 0.8 / np.maximum(deg, np.finfo(np.float64).tiny)
    x = dinv * r
    lap = np.asarray(jgw.weighted_laplacian_matvec(
        jnp.asarray(x), jnp.asarray(gx), jnp.asarray(gy)))
    want = x + dinv * (r - lap)
    assert np.isfinite(out).all()
    assert np.array_equal(out, want)


def test_coarse_route_is_chosen_by_shape():
    assert ws.block_fits(1, 8, 8, 4) and ws.block_fits(1, 64, 64, 8)
    assert ws.block_fits(8, 8, 8, 8) and ws.block_fits(6, 8, 8, 8)
    assert not ws.block_fits(1, 125, 125, 4)   # 1000² grid's coarsest
    assert not ws.block_fits(1, 125, 125, 8)
    assert ws.block_threads(64) == 64 and ws.block_threads(384) == 512
    assert ws.block_threads(3) == 32 and ws.block_threads(15625) == 512
    levels = gw.build_levels(_planar(*_weights(40, 24)), True)
    assert [tuple(lv[1].shape) for lv in levels] == [
        (1, 1, 39, 24), (1, 1, 19, 12), (1, 1, 9, 6)]


def test_kernel_source_exports_what_the_wrappers_bind():
    assert "weighted_stencil.cu" in [p.name for p in kernels._sources()]
    src = (kernels.CSRC_DIR / "weighted_stencil.cu").read_text()
    for name, n_args in (("residual", 13), ("jacobi", 13),
                         ("jacobi_block", 13)):
        assert f"int wstencil_{name}_##SUFFIX(" in src
        for suffix in ("f32", "f64"):
            argtypes, _ = kernels._SIGNATURES[f"wstencil_{name}_{suffix}"]
            assert len(argtypes) == n_args
    assert "NODAL_WSTENCIL_EXPORTS(float, f32)" in src
    assert "NODAL_WSTENCIL_EXPORTS(double, f64)" in src
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kBlockThreads"]) == ws.BLOCK_THREADS
    assert int(consts["kMaxSmem"]) == ws.SMEM_BYTES_MAX


def test_entry_points_default_to_the_card():
    gx, gy = _weights(4, 4)
    b = np.zeros((4, 4))
    for call in (lambda: gw.weighted_grid_solve(gx, gy, b),
                 lambda: gw.weighted_equivalent_resistance(
                     4, 4, gx, gy, (0, 0), (3, 3))):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError, match="outside"):
        gw.weighted_equivalent_resistance(4, 4, gx, gy, (0, 0), (4, 0),
                                          device="cpu")


# ------------------------------------------------------------ preconditioner

@pytest.mark.parametrize("h,w", [(32, 32), (20, 12), (9, 7)])
def test_preconditioner_matches_jax(h, w):
    gx, gy = _weights(h, w, seed=h * w)
    r = np.random.default_rng(6).standard_normal((h, w))
    r -= r.mean()
    M = gw.make_weighted_preconditioner(h, w, gx, gy, device="cpu")
    Mj = jgw.make_weighted_preconditioner(h, w, jnp.asarray(gx),
                                          jnp.asarray(gy))
    want = np.asarray(Mj(jnp.asarray(r)))
    assert _rel(M(r).numpy(), want) <= 1e-12


# -------------------------------------------------------------------- solves

def test_solve_matches_jax_on_a_rough_64_fabric():
    """tests/test_grid_weighted.py's 25x-contrast 64² case."""
    h = w = 64
    gx, gy = _weights(h, w, seed=3)
    rhs = np.zeros((h, w))
    rhs[10, 10], rhs[50, 40] = 1.0, -1.0
    x, info = gw.weighted_grid_solve(gx, gy, rhs, tol=1e-10, device="cpu")
    xj, ij = jgw.weighted_grid_solve(jnp.asarray(gx), jnp.asarray(gy),
                                     jnp.asarray(rhs), tol=1e-10)
    assert _rel(x.numpy(), xj) <= 1e-8
    assert int(info.iterations) == int(ij.iterations) < 120
    assert bool(info.converged) == bool(ij.converged) is True
    assert x.shape == (h, w) and info.residual.dim() == 0


@pytest.mark.parametrize("h,w,a,b", [(4, 4, (0, 0), (3, 3)),
                                     (6, 8, (1, 1), (4, 6)),
                                     (16, 16, (2, 3), (13, 9))])
def test_resistance_matches_jax_and_the_netlist_path(h, w, a, b):
    gx, gy = _weights(h, w, seed=h * w)
    R, res = gw.weighted_equivalent_resistance(h, w, gx, gy, a, b,
                                               tol=1e-10, device="cpu")
    Rj, _ = jgw.weighted_equivalent_resistance(
        h, w, jnp.asarray(gx), jnp.asarray(gy), a, b, tol=1e-10)
    netlist = Netlist.from_rows(weighted_grid_rows(gx, gy, a, b))
    Rn = equivalent_resistance(netlist, "1", "g", device="cpu")
    assert abs(float(R) - float(Rj)) <= 1e-8 * abs(float(Rj))
    assert abs(float(R) - Rn) <= 1e-8 * abs(Rn)
    assert float(res) <= 1e-10


def test_unpreconditioned_solve_matches_jax():
    gx, gy = _weights(8, 8, seed=8)
    rhs = np.zeros((8, 8))
    rhs[0, 0], rhs[7, 7] = 1.0, -1.0
    x, info = gw.weighted_grid_solve(gx, gy, rhs, tol=1e-10, mg=False,
                                     device="cpu")
    xj, ij = jgw.weighted_grid_solve(jnp.asarray(gx), jnp.asarray(gy),
                                     jnp.asarray(rhs), tol=1e-10, mg=False)
    assert _rel(x.numpy(), xj) <= 1e-8
    assert int(info.iterations) == int(ij.iterations)


def test_zero_edge_field_solves_as_jax():
    """A connected field with a fifth of its edges at zero conductance."""
    h, w = 16, 16
    gx, gy = _weights(h, w, seed=9, lo=0.5, hi=2.0)
    mask = np.random.default_rng(13)
    gx[mask.random(gx.shape) < 0.2] = 0.0
    gy[mask.random(gy.shape) < 0.2] = 0.0
    n_parts, _ = connected_components(_dense(gx, gy) != 0)
    assert n_parts == 1 and (gx == 0).sum() + (gy == 0).sum() > 80
    rhs = np.zeros((h, w))
    rhs[1, 1], rhs[14, 12] = 1.0, -1.0
    x, info = gw.weighted_grid_solve(gx, gy, rhs, tol=1e-10, device="cpu")
    xj, ij = jgw.weighted_grid_solve(jnp.asarray(gx), jnp.asarray(gy),
                                     jnp.asarray(rhs), tol=1e-10)
    assert bool(info.converged) and np.isfinite(x.numpy()).all()
    assert _rel(x.numpy(), xj) <= 1e-8
    assert int(info.iterations) == int(ij.iterations)


def test_batch_matches_single_solves_and_vmap():
    """Monte Carlo over 4 f32 fabrics, as tests/test_grid_weighted.py."""
    h = w = 16
    B = 4
    rng = np.random.default_rng(7)
    gxs = rng.uniform(0.5, 2.0, (B, h, w - 1)).astype(np.float32)
    gys = rng.uniform(0.5, 2.0, (B, h - 1, w)).astype(np.float32)
    a, b = (2, 2), (13, 13)
    R, res = gw.weighted_equivalent_resistance(h, w, gxs, gys, a, b,
                                               tol=1e-6, device="cpu")
    assert R.shape == (B,) and R.dtype == torch.float32
    Rj = np.asarray(jax.vmap(
        lambda gx, gy: jgw.weighted_equivalent_resistance(
            h, w, gx, gy, a, b, tol=1e-6)[0])(jnp.asarray(gxs),
                                              jnp.asarray(gys)))
    np.testing.assert_allclose(R.numpy(), Rj, rtol=1e-4)
    for i in range(B):
        Ri, _ = gw.weighted_equivalent_resistance(h, w, gxs[i], gys[i], a, b,
                                                  tol=1e-6, device="cpu")
        np.testing.assert_allclose(float(R[i]), float(Ri), rtol=1e-4)


# ----------------------------------------------------------------- gradients

def test_gradients_match_jax_grad_and_differences():
    h, w = 6, 8
    rng = np.random.default_rng(0)
    gx = rng.uniform(0.5, 2.0, (h, w - 1))
    gy = rng.uniform(0.5, 2.0, (h - 1, w))
    b = np.zeros((h, w))
    b[0, 0], b[h - 1, w - 1] = 1.0, -1.0
    wt = rng.standard_normal((h, w))

    def f(gx_, gy_, b_):
        return jnp.sum(jnp.asarray(wt) * jgw.weighted_grid_solve(
            gx_, gy_, b_, tol=1e-12)[0])

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(gx), jnp.asarray(gy),
                                          jnp.asarray(b))
    ts = [torch.tensor(v, requires_grad=True) for v in (gx, gy, b)]
    x, _ = gw.weighted_grid_solve(*ts, tol=1e-12, device="cpu")
    (torch.tensor(wt) * x).sum().backward()
    for t, o in zip(ts, want):
        assert _rel(t.grad.numpy(), o) < 1e-8

    term = ((0, 0), (h - 1, w - 1))
    gxt = torch.tensor(gx, requires_grad=True)
    R, _ = gw.weighted_equivalent_resistance(h, w, gxt, gy, *term,
                                             tol=1e-12, device="cpu")
    R.backward()
    eps = 1e-6
    Rs = []
    for s in (eps, -eps):
        gxe = gx.copy()
        gxe[2, 3] += s
        Rs.append(float(gw.weighted_equivalent_resistance(
            h, w, gxe, gy, *term, tol=1e-12, device="cpu")[0]))
    assert abs(float(gxt.grad[2, 3]) - (Rs[0] - Rs[1]) / (2 * eps)) < 1e-7


def test_batched_gradients_are_per_sample():
    """The backward's mean(x̄) and mean(λ) are taken per sample: a batch of
    two fabrics gives each its single solve's gradient."""
    h, w = 6, 6
    rng = np.random.default_rng(11)
    gxs = rng.uniform(0.5, 2.0, (2, h, w - 1))
    gys = rng.uniform(0.5, 2.0, (2, h - 1, w))
    b = rng.standard_normal((2, h, w))
    wt = rng.standard_normal((2, h, w))
    gxt = torch.tensor(gxs, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    x, _ = gw.weighted_grid_solve(gxt, gys, bt, tol=1e-12, device="cpu")
    (torch.tensor(wt) * x).sum().backward()
    for i in range(2):
        gi = torch.tensor(gxs[i], requires_grad=True)
        bi = torch.tensor(b[i], requires_grad=True)
        xi, _ = gw.weighted_grid_solve(gi, gys[i], bi, tol=1e-12,
                                       device="cpu")
        (torch.tensor(wt[i]) * xi).sum().backward()
        assert _rel(gxt.grad[i].numpy(), gi.grad.numpy()) < 1e-10
        assert _rel(bt.grad[i].numpy(), bi.grad.numpy()) < 1e-10
