"""The port's fused CG (``nodal_tpu_torch/ops/fused_cg.py``) against the
JAX package's ``nodal_tpu/ops/pallas_cg.py``: the plain versions of both
kernels against the Pallas kernels in interpret mode (as
``tests/test_pallas_cg.py`` runs them) and against the dense Laplacian in
f64, the fused loop against the JAX fused loop (f32) and the JAX plain
grid solve (f64, which the JAX gate never fuses), and the CPU side of the
CUDA kernels' wrappers.

Tolerances: Lp rtol 1e-5 and the summed partials rtol 1e-4 against the
Pallas kernels, the JAX package's own limits for f32 rounding order; f64
against the dense Laplacian 1e-12 (the same sums, rounded alike but for
their order); the f32 loop's x within 1e-5 of max|x| with iterations ±1
(two f32 loops whose reductions round differently); the f64 loop 1e-9 of
max|x| at tol 1e-10 against the plain CG, which computes pᵀAp as one dot
where the fused loop sums p·Lp and mean p·Σp.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nodal_tpu.ops import grid as jgrid  # noqa: E402
from nodal_tpu.ops import pallas_cg as jpc  # noqa: E402
from nodal_tpu_torch.ops import fused_cg, grid, stencil  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402

H, W = 512, 128  # tests/test_pallas_cg.py's shape: two Pallas tiles


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _t(a):
    return torch.as_tensor(a)[None]


def _launches():
    return (fused_cg.stencil_partials.launches,
            fused_cg.update_partials.launches)


def test_stencil_partials_matches_pallas():
    (p,) = _fields(0, (H, W))
    lp_ref, part_ref = jpc.stencil_partials(jnp.asarray(p), weight=2.0)
    lp, part = fused_cg.stencil_partials(_t(p), weight=2.0)
    assert part.shape == (1, fused_cg.plan_of(_t(p)).parts, 2)
    np.testing.assert_allclose(lp[0].numpy(), np.asarray(lp_ref), rtol=1e-5,
                               atol=1e-5)
    sums = part[0].sum(dim=0).numpy()
    np.testing.assert_allclose(sums[0], float(jnp.sum(part_ref[:, 0])),
                               rtol=1e-4)
    np.testing.assert_allclose(sums[1], float(jnp.sum(part_ref[:, 1])),
                               rtol=1e-4, atol=1e-3)


def test_update_partials_matches_pallas():
    x, r, p, lp = _fields(1, *[(H, W)] * 4)
    want = jpc.update_partials(*(jnp.asarray(a) for a in (x, r, p, lp)),
                               jnp.float32(0.37), jnp.float32(0.011))
    got = fused_cg.update_partials(
        *(_t(a) for a in (x, r, p, lp)), torch.tensor([0.37]),
        torch.tensor([0.011]))
    assert got[2].shape == (1, fused_cg.n_tiles(H, W))
    for k in range(2):
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got[2].sum()),
                               float(jnp.sum(want[2][:, 0])), rtol=1e-4)


def _parts(plan, h, w):
    """stencil_partials' parts of an h×w field: (rows, columns) slices in
    the order of the partials (segment, then strip)."""
    return [(slice(i, min(i + plan.segment, h)),
             slice(j, min(j + plan.strip_cols, w)))
            for i in range(0, h, plan.segment)
            for j in range(0, w, plan.strip_cols)]


@pytest.mark.parametrize("h,w", [(5, 7), (33, 65), (64, 128)])
def test_plain_versions_match_dense_laplacian_per_tile(h, w):
    """f64, ragged tiles included: Lp = L p, each part's S partials (on
    the CPU the tiles) are that part's own sums and each tile's U partial
    its own."""
    p, x, r = (torch.as_tensor(a) for a in _fields(h * w, *[(2, h, w)] * 3,
                                                 dtype=np.float64))
    L = grid._dense_laplacian(h, w, 1.5)
    lp, part = fused_cg.stencil_partials(p, weight=1.5)
    alpha = torch.tensor([0.3, -1.2], dtype=torch.float64)
    mean_p = torch.tensor([0.01, 0.2], dtype=torch.float64)
    x_new, r_new, part_u = fused_cg.update_partials(x, r, p, lp, alpha,
                                                    mean_p)
    plan = fused_cg.plan_of(p)
    assert part.shape == (2, plan.parts, 2)
    assert part_u.shape == (2, fused_cg.n_tiles(h, w))
    for b in range(2):
        want = (L @ p[b].reshape(-1).numpy()).reshape(h, w)
        np.testing.assert_allclose(lp[b].numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
        rn = r[b] - alpha[b] * (lp[b] + mean_p[b])
        assert torch.equal(r_new[b], rn)
        assert torch.equal(x_new[b], x[b] + alpha[b] * p[b])
        for t, (i, j) in enumerate(_parts(plan, h, w)):
            got = [float(part[b, t, 0]), float(part[b, t, 1])]
            expect = [float((p[b, i, j] * lp[b, i, j]).sum()),
                      float(p[b, i, j].sum())]
            np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)
        tiles = [(i, j) for i in range(0, h, fused_cg.TILE_H)
                 for j in range(0, w, fused_cg.TILE_W)]
        for t, (i, j) in enumerate(tiles):
            sl = (slice(i, i + fused_cg.TILE_H),
                  slice(j, j + fused_cg.TILE_W))
            np.testing.assert_allclose(float(part_u[b, t]),
                                       float((rn[sl] ** 2).sum()),
                                       rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            float(part[b, :, 0].sum()),
            float(p[b].reshape(-1) @ torch.as_tensor(L) @ p[b].reshape(-1)),
            rtol=1e-12)


@pytest.mark.parametrize("h,w,itemsize,sms", [
    (1024, 1024, 4, 132), (1024, 1024, 8, 132), (4096, 4096, 4, 132),
    (4096, 4096, 8, 132), (1022, 1022, 4, 132), (2, 2, 4, 132),
    (3, 5, 8, 132), (100000, 3, 4, 132), (512, 512, 4, 114)])
def test_partials_plan(h, w, itemsize, sms):
    """Strips of 128 threads × 16 bytes, segments for about 4 blocks an SM
    on one sample (not fewer than needed, never more than h), covering the
    field once and within the CUDA grid's limits."""
    plan = fused_cg.partials_plan(h, w, itemsize, sms)
    assert plan.strip_cols == fused_cg.STRIP_THREADS * 16 // itemsize
    assert plan.strips == -(-w // plan.strip_cols)
    assert plan.segments == -(-h // plan.segment) <= stencil.MAX_GRID_Y
    assert plan.segment * (plan.segments - 1) < h <= plan.segment * (
        plan.segments)
    blocks = stencil.STRIP_BLOCKS_PER_SM * sms
    assert plan.parts <= blocks or plan.segment == 1
    if plan.segment > 1:
        assert plan.strips * (plan.segments + plan.strips) > blocks // 2
    assert plan.parts == plan.strips * plan.segments


@pytest.mark.parametrize("h,w,dtype", [(7, 300, np.float64),
                                       (9, 1030, np.float32),
                                       (130, 20, np.float64)])
def test_partials_strip_parts(h, w, dtype):
    """The sums on the card's strip partition (several strips and
    segments, for cards of 1, 16 and 132 SMs), in the partials' order,
    against the dense Laplacian's terms part by part."""
    (p,) = _fields(h + w, (1, h, w), dtype=np.float64)
    lp = (grid._dense_laplacian(h, w, 1.0) @ p.reshape(-1)).reshape(h, w)
    terms = torch.as_tensor(p * lp)
    for sms in (1, 16, 132):
        plan = fused_cg.partials_plan(h, w, np.dtype(dtype).itemsize, sms)
        sums = fused_cg._block_sums(terms, plan.segment, plan.strip_cols)
        assert sums.shape == (1, plan.parts)
        for t, (i, j) in enumerate(_parts(plan, h, w)):
            np.testing.assert_allclose(float(sums[0, t]),
                                       float((p[0, i, j] * lp[i, j]).sum()),
                                       rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(sums.sum()), float(
            (p[0] * lp).sum()), rtol=1e-12, atol=1e-12)


def test_partials_plan_does_not_depend_on_the_batch():
    """The plan takes no B, so a sample's partials are the same alone or in
    a batch; on the CPU the partition is update_partials' tiles."""
    f = torch.as_tensor(np.stack(_fields(3, *[(40, 600)] * 3)))
    plan = fused_cg.partials_plan(40, 600, 4, 132)
    assert plan.strips == 2 and plan.segment == 1
    lp, part = fused_cg.stencil_partials(f, weight=0.7)
    assert fused_cg.plan_of(f) == fused_cg.PartialsPlan(
        fused_cg.TILE_W, fused_cg.TILE_H, 10, 2)
    for k in range(3):
        lp1, part1 = fused_cg.stencil_partials(f[k:k + 1], weight=0.7)
        assert torch.equal(lp[k], lp1[0]) and torch.equal(part[k], part1[0])


def _mean_zero_field(h, w, dtype):
    (b,) = _fields(h + w, (h, w), dtype=dtype)
    return b - b.mean()


def test_fused_loop_matches_pallas_loop_f32():
    b = _mean_zero_field(H, W, np.float32)
    M = jgrid.make_mg_preconditioner(H, W, jnp.float32, backend="xla")
    x_ref, info_ref = jpc.fused_grid_cg(jnp.asarray(b), M, tol=1e-5,
                                        maxiter=30)
    before = _launches()
    x, info = fused_cg.fused_grid_cg(_t(b), grid.make_mg_preconditioner(),
                                     tol=1e-5, maxiter=30)
    assert _launches() == before  # CPU tensors: the plain versions
    x_ref = np.asarray(x_ref)
    assert bool(info.converged[0]) and bool(info_ref.converged)
    assert abs(int(info.iterations[0]) - int(info_ref.iterations)) <= 1
    np.testing.assert_allclose(x[0].numpy(), x_ref, rtol=0,
                               atol=1e-5 * np.abs(x_ref).max())


def test_fused_loop_f64_matches_reference_grid_solve():
    """The JAX gate never fuses f64, so its answer is the plain CG's."""
    h, w = 64, 48
    b = _mean_zero_field(h, w, np.float64)
    x_ref, info_ref = jgrid.grid_solve(h, w, b, dtype=jnp.float64, tol=1e-10,
                                       fused_cg=True)
    x, info = fused_cg.fused_grid_cg(_t(b), grid.make_mg_preconditioner(),
                                     tol=1e-10, maxiter=200)
    x_ref = np.asarray(x_ref)
    assert bool(info.converged[0])
    assert int(info.iterations[0]) == int(info_ref.iterations)
    np.testing.assert_allclose(x[0].numpy(), x_ref, rtol=0,
                               atol=1e-9 * np.abs(x_ref).max())
    np.testing.assert_allclose(float(info.residual[0]),
                               float(info_ref.residual), rtol=1e-3)


def test_batch_with_mixed_convergence_equals_single_solves():
    """A sample that stops first is frozen (α = 0, its p, r·z, r·r and
    count kept): each sample is its own single fused solve, bit for bit."""
    h = w = 32
    probe, *_ = grid._probe_fields(h, w, np.array([[[0, 0], [31, 31]]]),
                                   torch.float64, "cpu")
    i = torch.arange(h, dtype=torch.float64)[:, None]
    j = torch.arange(w, dtype=torch.float64)[None, :]
    smooth = torch.cos(np.pi * (i + 0.5) / h) * torch.cos(np.pi * (j + 0.5)
                                                          / w)
    fields = torch.stack([probe[0] - probe[0].mean(), smooth - smooth.mean(),
                          torch.zeros(h, w, dtype=torch.float64)])
    M = grid.make_mg_preconditioner()
    x, info = fused_cg.fused_grid_cg(fields, M, tol=1e-10)
    its = [int(k) for k in info.iterations]
    assert its[0] != its[1] and its[2] == 0
    for k in range(3):
        x1, info1 = fused_cg.fused_grid_cg(fields[k:k + 1], M, tol=1e-10)
        assert torch.equal(x[k], x1[0])
        assert int(info1.iterations[0]) == its[k]
        assert torch.equal(info.residual[k], info1.residual[0])
        assert bool(info.converged[k]) == bool(info1.converged[0])


def test_grid_solve_on_the_cpu_follows_the_reference_gate():
    """Away from CUDA the flag is ignored: the plain CG runs, and no kernel
    launches."""
    rhs = np.zeros((2, 16, 24))
    rhs[0, 1, 1], rhs[0, 9, 20] = 1.0, -1.0
    rhs[1, 3, 4], rhs[1, 15, 0] = 2.0, -2.0
    before = _launches()
    for kw in ({}, {"mg_backend": "plain"}, {"mg": False}):
        fused = grid.grid_solve(16, 24, rhs, dtype=torch.float64, tol=1e-10,
                                fused_cg=True, device="cpu", **kw)
        plain = grid.grid_solve(16, 24, rhs, dtype=torch.float64, tol=1e-10,
                                device="cpu", **kw)
        assert torch.equal(fused[0], plain[0])
        assert all(torch.equal(a, b) for a, b in zip(fused[1], plain[1]))
    assert _launches() == before


def test_wrappers_refuse_bad_inputs():
    f = torch.zeros(2, 8, 8)
    a = torch.zeros(2)
    with pytest.raises(ValueError):
        fused_cg.stencil_partials(torch.zeros(8, 8))  # no batch dimension
    with pytest.raises(TypeError):
        fused_cg.stencil_partials(f.half())
    with pytest.raises(ValueError):
        fused_cg.stencil_partials(f.to("meta"))
    with pytest.raises(TypeError):
        fused_cg.update_partials(f, f.double(), f, f, a, a)
    with pytest.raises(ValueError):
        fused_cg.update_partials(f, f, f, torch.zeros(2, 8, 9), a, a)
    with pytest.raises(ValueError, match="alpha"):
        fused_cg.update_partials(f, f, f, f, torch.zeros(3), a)
    with pytest.raises(ValueError, match="mean_p"):
        fused_cg.update_partials(f, f, f, f, a, torch.zeros(2, 1))


def test_kernels_are_built_with_the_library():
    names = [p.name for p in kernels._sources()]
    assert "cg.cu" in names and "grid_common.cuh" in names
    src = (kernels.CSRC_DIR / "cg.cu").read_text()
    for name, n_args in (("stencil_partials", 10), ("update_partials", 13)):
        for suffix in ("f32", "f64"):
            full = f"cg_{name}_{suffix}"
            argtypes, _ = kernels._SIGNATURES[full]
            assert len(argtypes) == n_args, full
            assert f"int {full}(" in src
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kTileH"]) == fused_cg.TILE_H
    assert int(consts["kTileW"]) == fused_cg.TILE_W
    assert int(consts["kStripThreads"]) == fused_cg.STRIP_THREADS
    for cu in ("cg.cu", "stencil.cu"):
        assert '#include "grid_common.cuh"' in (
            kernels.CSRC_DIR / cu).read_text()
    assert stencil.MAX_BATCH == 65_535  # the grid's z dimension: the batch
