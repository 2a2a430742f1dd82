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
    for name, n_args in (("jacobi", 11), ("presmooth_restrict", 9),
                         ("prolong_postsmooth", 10), ("vcycle", 11),
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
