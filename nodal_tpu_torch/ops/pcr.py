"""Batched tridiagonal solve: the hand-written CUDA PCR kernel and its
wrapper.

Counterpart of the Pallas kernel ``nodal_tpu/ops/pallas_tridiag.py``
(``pcr_solve``, ``pcr_solve_padded``).  The kernel is ``csrc/pcr.cu``; its
plain version is :func:`nodal_tpu_torch.ops.tridiag.tridiag_solve`.

:func:`pcr_solve` takes the plain version only for tensors on the CPU.  For
CUDA tensors it launches the kernel or raises: there is no fallback.  Every
chain length runs in the kernel: short chains keep their arrays in shared
memory, longer ones in a global scratch buffer allocated here
(:func:`launch_config`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nodal_tpu_torch.ops.tridiag import _next_pow2, tridiag_solve

#: Shared memory one block may use on Hopper (227 KB).
SMEM_BYTES_MAX = 232_448

#: Upper bound on the global scratch of the long-chain variant; the grid is
#: cut so that grid·8·m values fit.
SCRATCH_BYTES_MAX = 1 << 30

#: Threads per block; must match ``__launch_bounds__`` in ``csrc/pcr.cu``
#: (a larger block asks for more registers than an SM has).
MAX_THREADS = 512


@dataclass(frozen=True)
class LaunchConfig:
    m: int              # chain length padded to a power of two
    threads: int        # threads per block
    grid: int           # blocks; each walks the batch with stride ``grid``
    smem_bytes: int     # dynamic shared memory (0 for the scratch variant)
    scratch_elems: int  # global scratch values (0 for the shared variant)


def launch_config(B: int, n: int, itemsize: int) -> LaunchConfig:
    """How :func:`pcr_solve` launches the kernel for B chains of length n.

    The kernel double-buffers four arrays of m values per system.  While
    those 8·m values fit a block's shared memory, each of B blocks solves
    one system in shared memory; past that, the same code runs on a global
    scratch area of 8·m values per block, with the grid bounded by
    ``SCRATCH_BYTES_MAX``.
    """
    m = _next_pow2(n)
    per_system = 8 * m * itemsize
    if per_system <= SMEM_BYTES_MAX:
        threads = min(max(m, 32), MAX_THREADS)
        return LaunchConfig(m, threads, B, per_system, 0)
    grid = max(1, min(B, SCRATCH_BYTES_MAX // per_system))
    return LaunchConfig(m, MAX_THREADS, grid, 0, grid * 8 * m)


def _check(dl, d, du, b) -> None:
    if d.dim() != 2:
        raise ValueError(f"pcr_solve expects [B, n] bands, got {tuple(d.shape)}")
    for name, t in (("dl", dl), ("du", du), ("b", b)):
        if t.shape != d.shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, d has {tuple(d.shape)}")
        if t.dtype != d.dtype:
            raise TypeError(f"{name} is {t.dtype}, d is {d.dtype}")
        if t.device != d.device:
            raise ValueError(f"{name} is on {t.device}, d is on {d.device}")
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pcr_solve supports float32 and float64, not {d.dtype}")


def pcr_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Solve B tridiagonal systems ``[B, n]`` (conventions of
    :func:`~nodal_tpu_torch.ops.tridiag.tridiag_solve`).

    CPU tensors: the plain torch PCR.  CUDA tensors: the CUDA kernel, which
    adds one to ``pcr_solve.launches`` per launch.
    """
    _check(dl, d, du, b)
    if d.device.type == "cpu":
        return tridiag_solve(dl, d, du, b)
    if d.device.type != "cuda":
        raise ValueError(f"pcr_solve runs on CPU or CUDA tensors, not {d.device}")
    for name, t in (("dl", dl), ("d", d), ("du", du), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, n = d.shape
    x = torch.empty_like(d)
    if B == 0 or n == 0:
        return x

    from nodal_tpu_torch.utils.kernels import load_library

    lib = load_library()
    cfg = launch_config(B, n, d.element_size())
    scratch = (torch.empty(cfg.scratch_elems, dtype=d.dtype, device=d.device)
               if cfg.scratch_elems else None)
    fn = lib.pcr_solve_f32 if d.dtype == torch.float32 else lib.pcr_solve_f64
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
                 x.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 B, n, cfg.m, cfg.threads, cfg.grid, cfg.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(
            f"PCR kernel launch failed with CUDA error {err} "
            f"(B={B}, n={n}, {d.dtype}, {cfg})")
    pcr_solve.launches += 1
    return x


pcr_solve.launches = 0
