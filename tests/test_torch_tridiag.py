"""Parity of the port's tridiagonal assembly and PCR with the JAX package,
the plain version of the CUDA kernel's algorithm (``thomas_pcr_solve``)
against the JAX PCR and a scipy f64 banded solve, and the CPU side of the
CUDA kernel's wrapper (dispatch, checks, launch policy, layout, build
errors).

Tolerances: 1e-5 (f32) and 1e-12 (f64) of max|x| against the JAX PCR, the
same systems rounded in another order (FMA-free torch against XLA); the
same bounds against scipy's f64 LAPACK solve, which for these diagonally
dominant systems sits within a few ulps of the exact answer.
"""

import re

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from nodal_tpu import Netlist as JNetlist  # noqa: E402
from nodal_tpu.models.stamps import compile_stamps as jcompile  # noqa: E402
from nodal_tpu.ops import assemble as jassemble  # noqa: E402
from nodal_tpu.ops import tridiag as jtridiag  # noqa: E402
from nodal_tpu.ops.pallas_tridiag import pcr_solve_padded  # noqa: E402
from nodal_tpu_torch.models.stamps import stamps_from_reference  # noqa: E402
from nodal_tpu_torch.ops import assemble, pcr, tridiag  # noqa: E402
from nodal_tpu_torch.utils import kernels  # noqa: E402
from nodal_tpu_torch.utils.gridgen import ladder_rows  # noqa: E402

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
THOMAS_PCR_N = [1, 2, 3, 31, 32, 33, 63, 64, 65, 1000, 4097]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: beside other test
    processes the default pool oversubscribes the cores, and each tiny
    parallel region then waits on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bands(B, n, dtype, seed=0):
    """Diagonally dominant random systems, as resistive chains give."""
    rng = np.random.default_rng(seed)
    dl = -rng.uniform(0.1, 1.0, (B, n))
    du = -rng.uniform(0.1, 1.0, (B, n))
    d = np.abs(dl) + np.abs(du) + rng.uniform(0.1, 1.0, (B, n))
    b = rng.standard_normal((B, n))
    return tuple(a.astype(dtype) for a in (dl, d, du, b))


@pytest.mark.parametrize("rungs", [1, 7, 64])
def test_assemble_tridiag_matches_reference(rungs):
    ref = jcompile(JNetlist.from_rows(ladder_rows(rungs)))
    port = stamps_from_reference(ref)
    rng = np.random.default_rng(rungs)
    params = ref.params * (1.0 + 0.05 * rng.standard_normal(
        (5, len(ref.params))))
    want = [np.asarray(jassemble.assemble_tridiag(ref, jnp.asarray(p),
                                                  dtype=jnp.float64))
            for p in params]
    got = assemble.assemble_tridiag(port, torch.as_tensor(params),
                                    dtype=torch.float64)
    assert assemble.bandwidth(port) == jassemble.bandwidth(ref)
    for k, g in enumerate(got):
        assert g.shape == (5, ref.n)
        np.testing.assert_allclose(
            g.numpy(), np.stack([w[k] for w in want]), rtol=1e-14, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B", [1, 5, 16])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_tridiag_solve_matches_reference(n, B, dtype):
    bands = _bands(B, n, dtype, seed=n * 31 + B)
    got = tridiag.tridiag_solve(*map(torch.as_tensor, bands)).numpy()
    want = np.asarray(jtridiag.tridiag_solve(*map(jnp.asarray, bands)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * np.abs(want).max())
    if dtype == np.float32:
        # The Pallas kernel (interpret mode here) takes float32 only.
        kern = np.asarray(pcr_solve_padded(*map(jnp.asarray, bands)))
        np.testing.assert_allclose(got, kern, rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * np.abs(kern).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tridiag_matvec_matches_reference(dtype):
    dl, d, du, x = _bands(4, 33, dtype, seed=5)
    got = tridiag.tridiag_matvec(*map(torch.as_tensor, (dl, d, du, x)))
    want = jtridiag.tridiag_matvec(*map(jnp.asarray, (dl, d, du, x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 64, 100])
def test_pcr_wrapper_on_cpu_is_the_plain_version(n, dtype):
    before = pcr.pcr_solve.launches
    bands = [torch.as_tensor(a).to(dtype)
             for a in _bands(3, n, np.float64, seed=n)]
    got = pcr.pcr_solve(*bands)
    assert torch.equal(got, tridiag.tridiag_solve(*bands))
    assert pcr.pcr_solve.launches == before == 0


@pytest.mark.parametrize("bad", ["shape", "rank", "dtype", "int"])
def test_pcr_wrapper_rejects_bad_input(bad):
    dl, d, du, b = (torch.as_tensor(a) for a in _bands(2, 8, np.float32))
    if bad == "shape":
        b = b[:, :7]
    elif bad == "rank":
        dl, d, du, b = (t[0] for t in (dl, d, du, b))
    elif bad == "dtype":
        b = b.double()
    else:
        dl, d, du, b = (t.int() for t in (dl, d, du, b))
    with pytest.raises((ValueError, TypeError)):
        pcr.pcr_solve(dl, d, du, b)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 3, 1000, 1024, 2048, 4096, 4097, 20000])
def test_pcr_launch_config(n, itemsize):
    B, sms = 16384, 132
    cfg = pcr.launch_config(B, n, itemsize, sms)
    v = 16 // itemsize
    assert cfg.k >= 2 and cfg.k % v == 0 and pcr.LANES * cfg.k >= n
    assert pcr.LANES * (cfg.k - v) < max(n, pcr.LANES)  # no whole spare unit
    assert 1 <= cfg.warps <= pcr.MAX_WARPS
    per_system = pcr.system_bytes(n, itemsize)
    if per_system <= pcr.SMEM_BYTES_MAX:
        # Shared-memory variant: one buffer a warp, as many warps an SM as
        # buffers fit it (in blocks of at most MAX_WARPS).
        assert cfg.smem_bytes == cfg.warps * per_system <= pcr.SMEM_BYTES_MAX
        assert cfg.scratch_elems == 0
        per_sm = min(pcr.MAX_WARPS_PER_SM, pcr.SMEM_SM_BYTES // (
            per_system + pcr.SMEM_BLOCK_RESERVED))
        blocks = cfg.grid // sms
        assert cfg.grid == sms * blocks and blocks * cfg.warps <= per_sm
        assert blocks * (cfg.smem_bytes + pcr.SMEM_BLOCK_RESERVED) <= (
            pcr.SMEM_SM_BYTES)
        assert (blocks + 1) * cfg.warps > per_sm or cfg.warps == (
            pcr.MAX_WARPS)
    else:
        # Past it the kernel runs on one global buffer a warp.
        assert cfg.smem_bytes == 0
        assert cfg.warps == pcr.SCRATCH_WARPS
        assert 1 <= cfg.grid <= -(-B // cfg.warps)
        assert cfg.scratch_elems * itemsize == (cfg.grid * cfg.warps
                                                * per_system)
        assert cfg.scratch_elems * itemsize <= max(pcr.SCRATCH_BYTES_MAX,
                                                   cfg.warps * per_system)
    # The main path's chain (n = 1000) stays in shared memory in both types.
    if n == 1000:
        assert cfg.scratch_elems == 0
    # A small batch asks for no more warps than systems.
    assert pcr.launch_config(3, n, itemsize, sms).warps <= 3


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1, 33, 1000, 4097])
def test_pcr_layout_reads_take_four_wavefronts(n, itemsize):
    """A warp reads one 16-byte unit of every chunk at once: each quarter
    warp's 8 units lie in 8 distinct groups of 4 banks."""
    k = pcr.chunk_rows(n, itemsize)
    units, stride = k * itemsize // 16, pcr.chunk_stride(k, itemsize)
    assert stride % 2 == 1 and units <= stride <= units + 1
    for q in range(units):
        slots = [lane * stride + q for lane in range(pcr.LANES)]
        for quarter in range(4):
            groups = {u % 8 for u in slots[8 * quarter:8 * quarter + 8]}
            assert len(groups) == 8
    assert pcr.system_bytes(n, itemsize) == 4 * pcr.LANES * stride * 16


def _scipy_solve(dl, d, du, b):
    """Each system solved by LAPACK's banded solver in f64."""
    out = np.empty(d.shape)
    for i in range(d.shape[0]):
        ab = np.zeros((3, d.shape[1]))
        ab[0, 1:], ab[1], ab[2, :-1] = du[i, :-1], d[i], dl[i, 1:]
        out[i] = sla.solve_banded((1, 1), ab, b[i].astype(np.float64))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", THOMAS_PCR_N)
def test_thomas_pcr_matches_reference(n, dtype):
    """The kernel's algorithm (chunks, the 64-row reduced system, back
    substitution) against the JAX PCR and scipy: f32 against the Pallas
    kernel in interpret mode, f64 against the JAX package's PCR (the
    Pallas kernel takes f32 only here)."""
    bands = _bands(3, n, dtype, seed=7 * n + 1)
    got = pcr.thomas_pcr_solve(*map(torch.as_tensor, bands)).numpy()
    assert got.dtype == dtype and got.shape == (3, n)
    if dtype == np.float32:
        want = np.asarray(pcr_solve_padded(*map(jnp.asarray, bands)))
    else:
        want = np.asarray(jtridiag.tridiag_solve(*map(jnp.asarray, bands)))
    exact = _scipy_solve(*bands)
    for ref in (want, exact):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=RTOL[dtype] * np.abs(ref).max())


def test_pcr_kernel_source_matches_the_plan():
    src = (kernels.CSRC_DIR / "pcr.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kMaxWarps"]) == pcr.MAX_WARPS
    assert int(consts["kLanes"]) == pcr.LANES
    assert int(consts["kMaxSmem"]) == pcr.SMEM_BYTES_MAX
    assert '#include "grid_common.cuh"' in src
    for suffix in ("f32", "f64"):
        full = f"pcr_solve_{suffix}"
        argtypes, _ = kernels._SIGNATURES[full]
        assert len(argtypes) == 13 and f"int {full}(" in src


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "library_path", lambda: tmp_path / "x.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()


def test_kernel_library_name_follows_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path == kernels.library_path()
    assert "pcr.cu" in [p.name for p in kernels._sources()]
