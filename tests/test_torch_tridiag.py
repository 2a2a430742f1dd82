"""Parity of the port's tridiagonal assembly and PCR with the JAX package,
and the CPU side of the CUDA kernel's wrapper (dispatch, checks, launch
policy, build errors)."""

import numpy as np
import pytest

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
    B = 16384
    cfg = pcr.launch_config(B, n, itemsize)
    assert cfg.m >= n and cfg.m & (cfg.m - 1) == 0
    assert cfg.threads % 32 == 0 and cfg.threads <= pcr.MAX_THREADS
    per_system = 8 * cfg.m * itemsize
    if per_system <= pcr.SMEM_BYTES_MAX:
        # Shared-memory variant: one block per system.
        assert (cfg.grid, cfg.smem_bytes, cfg.scratch_elems) == (
            B, per_system, 0)
    else:
        # Past the shared-memory cap the kernel runs on global scratch.
        assert cfg.smem_bytes == 0
        assert 1 <= cfg.grid <= B
        assert cfg.scratch_elems == cfg.grid * 8 * cfg.m
        assert cfg.scratch_elems * itemsize <= max(pcr.SCRATCH_BYTES_MAX,
                                                   per_system)
    # The main path's chain (n = 1000) stays in shared memory in both types.
    if n == 1000:
        assert cfg.scratch_elems == 0


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
