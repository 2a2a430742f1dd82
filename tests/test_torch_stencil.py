"""The port's multigrid stencil functions against the JAX package: the plain
torch versions of ``nodal_tpu_torch/ops/stencil.py`` against the Pallas
kernels of ``nodal_tpu/ops/pallas_stencil.py`` in interpret mode (f32) and
against the JAX xla cycle (f64), and the CPU side of the CUDA kernels'
wrappers.

Tolerances: the Jacobi sweeps rtol 2e-5 / atol 2e-6, the JAX package's own
limits for f32 rounding order; the transfers atol 1e-5·max|input| and the
V-cycle 1e-5·max|output|, because the Pallas kernels transfer with matrix
products that round differently from the direct sums; f64 against the xla
cycle 1e-12 of max|output| (the same operations, rounded alike up to the
order of the mean reductions).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nodal_tpu.ops import grid as jgrid  # noqa: E402
from nodal_tpu.ops import pallas_stencil as jps  # noqa: E402
from nodal_tpu_torch.ops import stencil  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402


def _fields(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _t(a):
    return torch.as_tensor(a)[None]


@pytest.mark.parametrize("h,w,sweeps,weight", [
    (16, 16, 1, 1.0), (32, 64, 3, 2.0), (1024, 256, 4, 1.0)])
# (1024, 256) runs the Pallas kernel's tiled form.
def test_jacobi_sweeps_matches_fused_jacobi(h, w, sweeps, weight):
    x, r = _fields(h + w, (h, w), (h, w))
    want = np.asarray(jps.fused_jacobi(jnp.asarray(x), jnp.asarray(r),
                                       weight=weight, omega=0.8,
                                       sweeps=sweeps))
    got = stencil.jacobi_sweeps(_t(x), _t(r), weight=weight, omega=0.8,
                                sweeps=sweeps)[0].numpy()
    # The Pallas tile seams (256-row tiles) and global edges, then all.
    for start in (0, 252, 508, h - 8):
        rows = slice(start, start + 8)
        np.testing.assert_allclose(got[rows], want[rows], rtol=2e-5,
                                   atol=2e-6, err_msg=str(rows))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("h,w", [(64, 64), (32, 128), (768, 1024)])
def test_presmooth_restrict_matches_pallas(h, w):
    (r,) = _fields(h * w, (h, w))
    want = np.asarray(jps.fused_presmooth_restrict(jnp.asarray(r),
                                                   weight=1.0, omega=0.8))
    got = stencil.presmooth_restrict(_t(r))[0].numpy()
    assert got.shape == (h // 2, w // 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("h,w", [(64, 64), (32, 128), (768, 1024)])
def test_prolong_postsmooth_matches_pallas(h, w):
    r, zc = _fields(h + 3 * w, (h, w), (h // 2, w // 2))
    want = np.asarray(jps.fused_prolong_postsmooth(
        jnp.asarray(r), jnp.asarray(zc), weight=1.0, omega=0.8))
    got = stencil.prolong_postsmooth(_t(r), _t(zc))[0].numpy()
    scale = max(np.abs(r).max(), np.abs(zc).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("h,w,nu", [(32, 32, 1), (64, 64, 1), (64, 128, 1),
                                    (64, 64, 2)])
def test_vcycle_matches_fused_vcycle(h, w, nu):
    (r,) = _fields(7 * h + w + nu, (h, w))
    want = np.asarray(jps.fused_vcycle(jnp.asarray(r), nu=nu))
    got = stencil.vcycle(_t(r), nu=nu)[0].numpy()
    assert abs(float(got.astype(np.float64).mean())) <= 1e-6
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("h,w", [(64, 64), (48, 80), (5, 7)])
def test_vcycle_f64_matches_xla_cycle(h, w):
    (r,) = _fields(h * w + 1, (h, w), dtype=np.float64)
    M = jgrid.make_mg_preconditioner(h, w, jnp.float64, backend="xla")
    want = np.asarray(M(jnp.asarray(r)))
    got = stencil.vcycle(_t(r))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_batched_functions_act_per_sample():
    """A batch gives each sample's own result."""
    h, w = 32, 48
    x, r, zc = (torch.as_tensor(a) for a in _fields(
        3, (3, h, w), (3, h, w), (3, h // 2, w // 2), dtype=np.float64))
    calls = [lambda s: stencil.jacobi_sweeps(x[s], r[s], sweeps=3),
             lambda s: stencil.presmooth_restrict(r[s], x=x[s]),
             lambda s: stencil.prolong_postsmooth(r[s], zc[s]),
             lambda s: stencil.vcycle(r[s], nu=2)]
    for call in calls:
        whole = call(slice(None))
        for k in range(3):
            np.testing.assert_allclose(whole[k:k + 1].numpy(),
                                       call(slice(k, k + 1)).numpy(),
                                       rtol=1e-14, atol=1e-14)


def test_transfers_match_the_xla_transfers_and_are_adjoint():
    rng = np.random.default_rng(11)
    r = rng.standard_normal((24, 40))
    zc = rng.standard_normal((12, 20))
    np.testing.assert_allclose(
        stencil._restrict_bilinear(_t(r))[0].numpy(),
        np.asarray(jgrid._restrict_bilinear(jnp.asarray(r))), rtol=1e-15,
        atol=1e-15)
    np.testing.assert_allclose(
        stencil._prolong_bilinear(_t(zc))[0].numpy(),
        np.asarray(jgrid._prolong_bilinear(jnp.asarray(zc))), rtol=1e-15,
        atol=1e-15)
    # R = Pᵀ: <R r, zc> = <r, P zc>.
    lhs = float((stencil._restrict_bilinear(_t(r)) * _t(zc)).sum())
    rhs = float((_t(r) * stencil._prolong_bilinear(_t(zc))).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_presmooth_restrict_with_given_x():
    """``x`` replaces the one-sweep pre-smoothed field c·r: the form the
    CUDA cycle's upper levels take at nu > 1."""
    (r,) = _fields(5, (1, 64, 64), dtype=np.float64)
    r = torch.as_tensor(r)
    c = 0.8 / 4.0
    x2 = stencil.jacobi_sweeps(torch.zeros_like(r), r, sweeps=2)
    np.testing.assert_allclose(
        stencil.presmooth_restrict(r, x=(c * r)).numpy(),
        stencil.presmooth_restrict(r).numpy(), rtol=0, atol=1e-15)
    rc = stencil.presmooth_restrict(r, x=x2)
    want = stencil._restrict_bilinear(r - stencil._lap(x2, 1.0))
    np.testing.assert_allclose(rc.numpy(), want.numpy(), rtol=0, atol=1e-15)


def test_level_shapes_and_entry_levels():
    assert stencil.level_shapes(1024, 1024)[-1] == (8, 8)
    assert stencil.level_shapes(1000, 1000)[-1] == (125, 125)
    assert stencil.level_shapes(1022, 1022) == [(1022, 1022), (511, 511)]
    assert stencil.level_shapes(5, 7) == [(5, 7)]
    shapes = stencil.level_shapes(1024, 1024)
    # The single-block cycle enters at 128² in f32 and 64² in f64.
    assert shapes[stencil.vcycle_entry(shapes, 4)] == (128, 128)
    assert shapes[stencil.vcycle_entry(shapes, 8)] == (64, 64)
    # A coarsest level too large for one block takes the Jacobi route.
    assert stencil.vcycle_entry(stencil.level_shapes(1000, 1000), 4) == 3
    assert stencil.vcycle_entry(stencil.level_shapes(1000, 1000), 8) is None
    assert stencil.vcycle_entry(stencil.level_shapes(1022, 1022), 4) is None
    for h, w, itemsize in ((1024, 1024, 4), (1024, 1024, 8), (2, 2, 8)):
        shapes = stencil.level_shapes(h, w)
        e = stencil.vcycle_entry(shapes, itemsize)
        assert stencil.vcycle_block_bytes(shapes[e:], itemsize) \
            <= stencil.SMEM_BYTES_MAX
        if e:
            assert stencil.vcycle_block_bytes(shapes[e - 1:], itemsize) \
                > stencil.SMEM_BYTES_MAX
    assert stencil.jacobi_single_block(125, 125, 4)
    assert not stencil.jacobi_single_block(125, 125, 8)


def test_cpu_wrappers_take_the_plain_versions_and_never_launch():
    x, r, zc = (torch.as_tensor(a) for a in _fields(
        9, (2, 16, 16), (2, 16, 16), (2, 8, 8)))
    before = [f.launches for f in (stencil.jacobi_sweeps,
                                   stencil.presmooth_restrict,
                                   stencil.prolong_postsmooth,
                                   stencil.vcycle)]
    pairs = [(stencil.jacobi_sweeps(x, r, sweeps=2),
              stencil.jacobi_sweeps_plain(x, r, sweeps=2)),
             (stencil.presmooth_restrict(r), stencil.presmooth_restrict_plain(r)),
             (stencil.prolong_postsmooth(r, zc),
              stencil.prolong_postsmooth_plain(r, zc)),
             (stencil.vcycle(r), stencil.vcycle_plain(r))]
    for got, want in pairs:
        assert torch.equal(got, want)
    after = [f.launches for f in (stencil.jacobi_sweeps,
                                  stencil.presmooth_restrict,
                                  stencil.prolong_postsmooth, stencil.vcycle)]
    assert after == before


def test_wrappers_refuse_bad_inputs():
    r = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError):
        stencil.vcycle(torch.zeros(8, 8))  # no batch dimension
    with pytest.raises(TypeError):
        stencil.vcycle(torch.zeros(1, 8, 8, dtype=torch.float16))
    with pytest.raises(TypeError):
        stencil.jacobi_sweeps(r, r.double())
    with pytest.raises(ValueError):
        stencil.jacobi_sweeps(r, r.to("meta"))
    with pytest.raises(ValueError):
        stencil.jacobi_sweeps(r, torch.zeros(1, 8, 9))
    with pytest.raises(ValueError):
        stencil.jacobi_sweeps(r, r, sweeps=-1)
    with pytest.raises(ValueError):
        stencil.presmooth_restrict(torch.zeros(1, 7, 8))
    with pytest.raises(ValueError):
        stencil.prolong_postsmooth(r, torch.zeros(1, 4, 5))
    with pytest.raises(ValueError):
        stencil.prolong_postsmooth(r, torch.zeros(1, 4, 4), x=torch.zeros(
            1, 8, 6))
    with pytest.raises(ValueError):
        stencil.vcycle(r, nu=0)
    with pytest.raises(ValueError):
        stencil.vcycle(r.to("meta"))


def test_kernels_are_built_with_the_library():
    assert "stencil.cu" in [p.name for p in kernels._sources()]
    src = (kernels.CSRC_DIR / "stencil.cu").read_text()
    for name, n_args in (("jacobi", 11), ("presmooth_restrict", 11),
                         ("prolong_postsmooth", 12), ("vcycle", 11),
                         ("subtract_mean", 6)):
        for suffix in ("f32", "f64"):
            full = f"stencil_{name}_{suffix}"
            argtypes, _ = kernels._SIGNATURES[full]
            assert len(argtypes) == n_args, full
            assert f"int {full}(" in src
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kMaxHalo"]) == stencil.MAX_HALO
    assert int(consts["kBlockThreads"]) == stencil.BLOCK_THREADS
    assert int(consts["kMaxSmem"]) == stencil.SMEM_BYTES_MAX
    assert int(consts["kMeanChunk"]) == stencil.MEAN_CHUNK


# ------------------------------------------------ thread-block cluster plans

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many tiny torch ops: one intra-op thread keeps them fast beside the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (n, itemsize, max_cluster) -> (entry level, C, first level whole in rank
# 0 or None).  By hand: 1024² f32 at C = 16 enters at 256²: strips of 16,
# 8, 4 rows of 256², 128², 64² (a 4,096-value scratch, x of each, r below
# the entry: 13,440 values with rank 0's 32², 16², 8²) and 2,064 static
# bytes, 55,824 bytes; 512² would fit (186,896 bytes) but its strips hold
# 16,384 values, past CLUSTER_ENTRY_VALUES.  1022² f32 enters at its
# 511² coarsest alone, which takes no cap.
@pytest.mark.parametrize("n,itemsize,max_cluster,want", [
    (1024, 4, 16, ((256, 256), 16, (32, 32))),
    (1024, 4, 8, ((256, 256), 8, (16, 16))),
    (1024, 8, 16, ((256, 256), 16, (32, 32))),
    (1024, 8, 8, ((256, 256), 8, (16, 16))),
    (1000, 4, 16, ((250, 250), 16, None)),
    (1000, 4, 8, ((250, 250), 8, None)),
    (1000, 8, 16, ((250, 250), 16, None)),
    (1000, 8, 8, ((250, 250), 8, None)),
    (1022, 4, 16, ((511, 511), 16, None)),
    (1022, 4, 8, None),
    (1022, 8, 16, None),
    (1022, 8, 8, None),
    (4096, 4, 16, ((256, 256), 16, (32, 32))),
    (4096, 4, 8, ((256, 256), 8, (16, 16))),
    (4096, 8, 16, ((256, 256), 16, (32, 32))),
    (4096, 8, 8, ((256, 256), 8, (16, 16))),
])
def test_vcycle_cluster_plan(n, itemsize, max_cluster, want):
    shapes = stencil.level_shapes(n, n)
    plan = stencil.vcycle_cluster_plan(shapes, itemsize, max_cluster)
    if want is None:
        assert plan is None
        return
    entry, cluster, rank0 = want
    assert shapes[plan.entry] == entry and plan.cluster == cluster
    assert (shapes[plan.rank0] if plan.rank0 < len(shapes) else None) \
        == rank0
    tail = shapes[plan.entry:]
    assert stencil.vcycle_cluster_bytes(tail, cluster, itemsize) \
        <= stencil.SMEM_BYTES_MAX
    if len(tail) > 1:
        assert (stencil.cluster_strip_rows(tail, cluster)[0] * tail[0][1]
                <= stencil.CLUSTER_ENTRY_VALUES)
    if plan.entry:  # the level above is refused: the plan from it skips it
        above = stencil.vcycle_cluster_plan(shapes[plan.entry - 1:],
                                            itemsize, max_cluster)
        assert above.entry == 1 and above.cluster == cluster
    if (n, itemsize, max_cluster) == (1024, 4, 16):
        assert stencil.vcycle_cluster_bytes(tail, 16, 4) == 55_824
        assert stencil.vcycle_cluster_bytes(shapes[1:], 16, 4) == 186_896
        assert stencil.cluster_strip_rows(shapes[1:], 16)[0] * 512 == 16_384


def test_vcycle_routes_of_the_grid_paths():
    """Where the cluster cycle takes over on the grid paths (max_cluster
    16): above the single-block entry, or where the Jacobi route ran."""
    def route(n, itemsize):
        r = stencil.vcycle_route(n, n, 8, itemsize, 16)
        return (r.shapes[r.stop], r.plan and r.plan.cluster, r.block)
    assert route(1024, 4) == ((256, 256), 16, False)
    assert route(1024, 8) == ((256, 256), 16, False)
    assert route(1000, 8) == ((250, 250), 16, False)  # was the Jacobi route
    assert route(1022, 4) == ((511, 511), 16, False)  # the one-level route
    assert route(1022, 8) == ((511, 511), None, False)  # Jacobi route stays
    assert route(64, 4) == ((64, 64), None, True)  # one block holds it all


@pytest.mark.parametrize("batch,want", [
    (1, 16), (8, 16), (9, 8), (16, 8), (33, 4), (66, 2), (67, 1),
    (1000, 1)])
def test_batch_cluster_cap(batch, want):
    """The H100's 132 SMs: a batch's clusters fit the card at once."""
    assert stencil.batch_cluster_cap(batch, 16, 132) == want
    if want == 1:  # no cluster: the single-block cycle or the Jacobi route
        assert stencil.vcycle_cluster_plan(
            stencil.level_shapes(1024, 1024), 4, want) is None
    # 16 probe pairs at 1024² f32: clusters of 8 from 256².
    r = stencil.vcycle_route(1024, 1024, 8, 4,
                             stencil.batch_cluster_cap(16, 16, 132))
    assert r.shapes[r.stop] == (256, 256) and r.plan.cluster == 8


@pytest.mark.parametrize("h,w,itemsize,want", [
    (511, 511, 4, 16), (125, 125, 8, 16), (250, 250, 8, 16),
    (511, 511, 8, None), (3, 512, 4, 2), (1, 64, 8, None)])
def test_jacobi_cluster_size(h, w, itemsize, want):
    assert stencil.jacobi_cluster_size(h, w, itemsize) == want


# ------------------------------- an emulation of the cluster kernels' order

def _strips(x, bounds):
    return [x[:, a:b] for a, b in zip(bounds, bounds[1:])]


def _halo(strips, k):
    """Rows just above and below strip k: its neighbours' edge rows, or its
    own edge row at the field's edge."""
    up = strips[k - 1][:, -1:] if k > 0 else strips[k][:, :1]
    dn = strips[k + 1][:, :1] if k < len(strips) - 1 else strips[k][:, -1:]
    return up, dn


def _strip_lap(strips, k, weight):
    up, dn = _halo(strips, k)
    e = torch.nn.functional.pad(torch.cat([up, strips[k], dn], dim=1),
                                (1, 1), mode="replicate")
    v = e[:, 1:-1, 1:-1]
    nbr = e[:, :-2, 1:-1] + e[:, 2:, 1:-1] + e[:, 1:-1, :-2] + e[:, 1:-1, 2:]
    return weight * (4.0 * v - nbr)


def _strip_sweeps(strips, rs, k, weight, c):
    for _ in range(k):
        strips = [s + c * (r - _strip_lap(strips, i, weight))
                  for i, (s, r) in enumerate(zip(strips, rs))]
    return strips


def _from_zero(rs, k, weight, c):
    if k == 0:
        return [torch.zeros_like(r) for r in rs]
    return _strip_sweeps([c * r for r in rs], rs, k - 1, weight, c)


def _rank_order_mean(strips, n):
    total = 0.0
    for s in strips:  # each rank's own sum, added in rank order
        total = total + s.sum(dim=(1, 2), keepdim=True)
    return total / n


def _restrict_strips(res):
    """Each coarse strip from its fine strip and one halo row each side."""
    out = []
    for k in range(len(res)):
        up, dn = _halo(res, k)
        e = torch.nn.functional.pad(torch.cat([up, res[k], dn], dim=1),
                                    (1, 1), mode="replicate")
        cols = (0.75 * (e[:, :, 1:-2:2] + e[:, :, 2:-1:2])
                + 0.25 * (e[:, :, 0:-3:2] + e[:, :, 3::2]))
        out.append(0.75 * (cols[:, 1:-2:2] + cols[:, 2:-1:2])
                   + 0.25 * (cols[:, 0:-3:2] + cols[:, 3::2]))
    return out


def _prolong_strips(zs, fine_bounds, hc):
    """P z on each fine strip from its coarse strip with one halo row each
    side (zs: coarse strips, or one whole coarse field held by rank 0)."""
    out = []
    for k, (lo, hi) in enumerate(zip(fine_bounds, fine_bounds[1:])):
        if len(zs) == 1:  # rank 0's whole field
            zc = zs[0]
            e = zc[:, [max(lo // 2 - 1, 0)] + list(range(lo // 2, hi // 2))
                   + [min(hi // 2, hc - 1)]]
        else:
            up, dn = _halo(zs, k)
            e = torch.cat([up, zs[k], dn], dim=1)
        e = torch.nn.functional.pad(e, (1, 1), mode="replicate")
        # Fine row 2I (2I + 1) takes coarse rows I and I - 1 (I + 1).
        mid = e[:, 1:-1]
        rows = torch.stack([0.75 * mid + 0.25 * e[:, :-2],
                            0.75 * mid + 0.25 * e[:, 2:]], dim=2)
        rows = rows.reshape(e.shape[0], -1, e.shape[2])
        c = rows[:, :, 1:-1]
        a = torch.stack([0.75 * c + 0.25 * rows[:, :, :-2],
                         0.75 * c + 0.25 * rows[:, :, 2:]], dim=3)
        out.append(a.reshape(a.shape[0], a.shape[1], -1))
    return out


def _block_cycle(r, nu, coarse_sweeps, weight, omega):
    """Rank 0's cycle on its whole levels (no final projection)."""
    h, w = r.shape[1:]
    if min(h, w) <= 8 or h % 2 or w % 2:
        x = stencil.jacobi_sweeps_plain(torch.zeros_like(r),
                                        r - stencil._mean(r), weight=weight,
                                        omega=omega, sweeps=coarse_sweeps)
        return x - stencil._mean(x)
    x = stencil.jacobi_sweeps_plain(torch.zeros_like(r), r, weight=weight,
                                    omega=omega, sweeps=nu)
    x = x + stencil._prolong_bilinear(_block_cycle(
        stencil._restrict_bilinear(r - stencil._lap(x, weight)), nu,
        coarse_sweeps, weight, omega))
    return stencil.jacobi_sweeps_plain(x, r, weight=weight, omega=omega,
                                       sweeps=nu)


def emulate_vcycle_cluster(r, plan_tail, cluster, nu=1, coarse_sweeps=96,
                           weight=1.0, omega=0.8):
    """``vcycle_cluster`` (or, for a one-level tail, ``jacobi_cluster``'s
    coarsest solve) on r at the tail's entry, in the kernel's order:
    strips, halos, rank 0's whole levels, rank-order mean sums."""
    c = omega / (4.0 * weight)
    L = len(plan_tail) - 1
    d = stencil.cluster_levels(plan_tail, cluster)
    hl = plan_tail[d - 1][0]
    bounds = [[b << (d - 1 - l) for b in stencil.strip_bounds(hl, cluster)]
              for l in range(d)]
    n = [h * w for h, w in plan_tail]
    if L == 0:  # the coarsest level alone: jacobi_cluster's projection
        rs = _strips(r, bounds[0])
        rz = [s - _rank_order_mean(rs, n[0]) for s in rs]
        xs = _from_zero(rz, coarse_sweeps, weight, c)
        return torch.cat([x - _rank_order_mean(xs, n[0]) for x in xs], 1)
    r_levels, x_levels = [_strips(r, bounds[0])], []
    last = min(d - 1, L - 1)
    for l in range(last + 1):
        x = _from_zero(r_levels[l], nu, weight, c)
        x_levels.append(x)
        res = [rr - _strip_lap(x, k, weight)
               for k, rr in enumerate(r_levels[l])]
        coarse = _restrict_strips(res)
        r_levels.append(coarse if l + 1 < d else [torch.cat(coarse, 1)])
    if L > d - 1:
        z = [_block_cycle(r_levels[d][0], nu, coarse_sweeps, weight, omega)]
    else:
        rz = [s - _rank_order_mean(r_levels[L], n[L]) for s in r_levels[L]]
        z = _from_zero(rz, coarse_sweeps, weight, c)
        z = [s - _rank_order_mean(z, n[L]) for s in z]
    for l in range(last, -1, -1):
        p = _prolong_strips(z, bounds[l], plan_tail[l + 1][0])
        z = _strip_sweeps([a + b for a, b in zip(x_levels[l], p)],
                          r_levels[l], nu, weight, c)
    return torch.cat([s - _rank_order_mean(z, n[0]) for s in z], 1)


def emulate_jacobi_cluster(x, r, sweeps, cluster, weight=1.0, omega=0.8):
    bounds = stencil.strip_bounds(x.shape[1], cluster)
    xs = _strip_sweeps(_strips(x, bounds), _strips(r, bounds), sweeps,
                       weight, omega / (4.0 * weight))
    return torch.cat(xs, 1)


# (h, w, max_cluster): plans with C = 2 (the coarsest cut, no rank-0
# level), C = 4 (8² in rank 0), C = 16 (32², 16², 8² in rank 0), an odd
# coarsest cut over two CTAs, and the one-level route.
_CLUSTER_CASES = [(128, 128, 2), (128, 128, 4), (128, 128, 16),
                  (96, 40, 2), (63, 63, 8)]


def _cluster_case(h, w, max_cluster):
    shapes = stencil.level_shapes(h, w)
    if len(shapes) == 1:
        cluster = max_cluster
        assert stencil.cluster_levels(shapes, cluster) == 1
        return shapes, cluster
    plan = stencil.vcycle_cluster_plan(shapes, 8, max_cluster)
    assert plan.entry == 0 and plan.cluster == max_cluster
    return shapes, plan.cluster


@pytest.mark.parametrize("h,w,max_cluster", _CLUSTER_CASES)
def test_vcycle_cluster_emulation_matches_vcycle_plain(h, w, max_cluster):
    shapes, cluster = _cluster_case(h, w, max_cluster)
    for nu in (1, 2):
        (r,) = _fields(h + w + nu, (2, h, w), dtype=np.float64)
        r = torch.as_tensor(r)
        want = stencil.vcycle_plain(r, nu=nu)
        got = emulate_vcycle_cluster(r, shapes, cluster, nu=nu)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("h,w,max_cluster", _CLUSTER_CASES)
def test_vcycle_cluster_emulation_matches_fused_vcycle(h, w, max_cluster):
    shapes, cluster = _cluster_case(h, w, max_cluster)
    (r,) = _fields(3 * h + w, (h, w))
    want = np.asarray(jps.fused_vcycle(jnp.asarray(r)))
    got = emulate_vcycle_cluster(_t(r), shapes, cluster)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [125, 250])
def test_jacobi_cluster_emulation(n):
    cluster = stencil.jacobi_cluster_size(n, n, 8)
    x, r = _fields(n, (n, n), (n, n))
    for sweeps in (1, 9, 96):
        want = np.asarray(jps.fused_jacobi(jnp.asarray(x), jnp.asarray(r),
                                           weight=1.0, omega=0.8,
                                           sweeps=sweeps))
        got = emulate_jacobi_cluster(_t(x), _t(r), sweeps, cluster)
        np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-5,
                                   atol=2e-6)
        x64, r64 = (torch.as_tensor(a.astype(np.float64))[None]
                    for a in (x, r))
        np.testing.assert_allclose(
            emulate_jacobi_cluster(x64, r64, sweeps, cluster).numpy(),
            stencil.jacobi_sweeps_plain(x64, r64, sweeps=sweeps).numpy(),
            rtol=0, atol=1e-12 * float(x64.abs().max() + r64.abs().max()))


def test_cluster_constants_match_the_kernel_source():
    src = (kernels.CSRC_DIR / "stencil.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kMaxCluster"]) == stencil.MAX_CLUSTER
    assert int(consts["kRank0Rows"]) == stencil.RANK0_ROWS
    assert int(consts["kSlots"]) == stencil.CLUSTER_SLOTS
    # The transfer kernels: a thread a coarse column of the strip.
    assert int(consts["kStripCols"]) == stencil.STRIP_COLS
    for name, n_args in (("vcycle_cluster", 13), ("jacobi_cluster", 12),
                         ("max_cluster", 2), ("presmooth_restrict", 11),
                         ("prolong_postsmooth", 12)):
        for suffix in ("f32", "f64"):
            full = f"stencil_{name}_{suffix}"
            argtypes, _ = kernels._SIGNATURES[full]
            assert len(argtypes) == n_args, full
            assert f"int {full}(" in src


def test_max_cluster_is_each_cards_own(monkeypatch):
    """``max_cluster`` queries each card once a dtype and keeps its answer
    apart from the other cards'."""
    queries = []

    def launcher(name, dtype):
        assert name == "max_cluster"

        def query(index, out):
            queries.append((index, dtype))
            out._obj.value = 16 if index == 0 else 8
            return 0
        return query

    monkeypatch.setattr(stencil, "_launcher", launcher)
    stencil._max_cluster.cache_clear()
    try:
        assert stencil.max_cluster(0, torch.float32) == 16
        assert stencil.max_cluster(torch.device("cuda", 1),
                                   torch.float32) == 8
        assert stencil.max_cluster(1, torch.float32) == 8
        assert stencil.max_cluster(torch.device("cuda", 0),
                                   torch.float32) == 16
        assert stencil.max_cluster(1, torch.float64) == 8
        assert queries == [(0, torch.float32), (1, torch.float32),
                           (1, torch.float64)]
    finally:
        stencil._max_cluster.cache_clear()
