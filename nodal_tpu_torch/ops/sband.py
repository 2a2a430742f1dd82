"""Batched scalar banded LDLᵀ solve: the hand-written CUDA kernel and its
wrapper.

Counterpart of the Pallas kernels of ``nodal_tpu/ops/pallas_scalar_band.py``
(``pallas_scalar_band_solve(_multi)`` and the streaming
``pallas_scalar_band_solve_stream(_multi)``), which one kernel,
``csrc/sband.cu``, replaces.  Its plain version is
:func:`nodal_tpu_torch.ops.scalar_band.scalar_band_solve_scan`.

:func:`sband_solve_multi` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises: there is no
fallback.  The kernel serves every shape a plan admits: w ≤ ``MAX_W``,
any n (plans stop at 16384 rows) and W1 + n_rhs ≤ ``MAX_W1A``, in float32
and float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nodal_tpu_torch.ops.pcr import SMEM_BYTES_MAX
from nodal_tpu_torch.ops.scalar_band import MAX_W, scalar_band_solve_scan

#: Widest augmented row (band slots plus right-hand sides) the kernel
#: takes: four slots per lane of a warp.
MAX_W1A = 128

#: Upper bound on the factored-band scratch; the number of warps is cut so
#: that warps·n·W1a values fit.
SCRATCH_BYTES_MAX = 1 << 30

#: Warps per block; must match ``kMaxWarps`` in ``csrc/sband.cu``.
MAX_WARPS = 8

#: Rows the register variant stages ahead of use in shared memory, in both
#: sweeps; must match ``kStages`` in ``csrc/sband.cu``.
STAGES = 8


def sband_fits(W1: int, n_rhs: int = 1) -> bool:
    """Whether the kernel takes a band of W1 slots with n_rhs right-hand
    sides (the JAX package's ``sband_fits_stream``)."""
    return W1 - 1 <= MAX_W and W1 + n_rhs <= MAX_W1A


#: Widest augmented row the register variant of the kernel takes (one slot
#: per lane); wider rows take the shared-memory variant.
REGISTER_W1A = 32


@dataclass(frozen=True)
class LaunchConfig:
    variant: str        # "registers" or "shared" (csrc/sband.cu)
    warps_per_block: int
    n_warps: int        # warps in the grid; each owns one scratch area
    smem_bytes: int     # dynamic shared memory per block
    scratch_elems: int  # factored-band scratch values


def launch_config(B: int, n: int, W1: int, n_rhs: int,
                  itemsize: int) -> LaunchConfig:
    """How :func:`sband_solve_multi` launches the kernel.

    Each warp solves one system at a time and writes its factored rows,
    n·W1a values (W1a = W1 + n_rhs), to its own scratch area.  Rows of up
    to ``REGISTER_W1A`` slots keep the elimination window in registers and
    need shared memory for the pivot's multipliers and band slots (96
    values) and a ring of W1 + ``STAGES`` rows of 32 values, through which
    both sweeps stage their rows ``STAGES`` rows ahead; wider rows keep a
    ring of W1 rows plus one buffer row, (W1 + 1)·W1a values.  Blocks take
    as many warps (up to ``MAX_WARPS``, 4 for the f64 register variant) as
    their shared memory allows; the grid has at most one warp per system
    and at most ``SCRATCH_BYTES_MAX`` of scratch.
    """
    W1a = W1 + n_rhs
    max_warps = MAX_WARPS
    if W1a <= REGISTER_W1A:
        # csrc/sband.cu:reg_smem_per_warp
        variant = "registers"
        per_warp = (32 + 64 + (W1 + STAGES) * 32) * itemsize
        if itemsize == 8:
            # The f64 register kernels are built for blocks of at most 4
            # warps, three to an SM, at up to 170 registers a thread (the
            # launch bounds of csrc/sband.cu:sband_reg_kernel).
            max_warps = MAX_WARPS // 2
    else:
        variant, per_warp = "shared", (W1 + 1) * W1a * itemsize
    wpb = max(1, min(max_warps, SMEM_BYTES_MAX // per_warp))
    per_system = n * W1a * itemsize
    n_warps = max(1, min(B, SCRATCH_BYTES_MAX // per_system))
    wpb = min(wpb, n_warps)
    return LaunchConfig(variant, wpb, n_warps, wpb * per_warp,
                        n_warps * n * W1a)


def _check(U: torch.Tensor, R: torch.Tensor) -> None:
    if U.dim() != 3 or R.dim() != 3:
        raise ValueError(
            f"sband_solve_multi expects U [B, n, W1] and R [B, n, n_rhs], "
            f"got {tuple(U.shape)} and {tuple(R.shape)}")
    if U.shape[:2] != R.shape[:2]:
        raise ValueError(
            f"U {tuple(U.shape)} and R {tuple(R.shape)} differ in [B, n]")
    if U.dtype != R.dtype:
        raise TypeError(f"U is {U.dtype}, R is {R.dtype}")
    if U.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"sband_solve_multi supports float32 and float64, not {U.dtype}")
    if U.device != R.device:
        raise ValueError(f"U is on {U.device}, R is on {R.device}")
    if not sband_fits(U.shape[2], R.shape[2]):
        raise ValueError(
            f"band of W1={U.shape[2]} slots with {R.shape[2]} right-hand "
            f"sides exceeds the kernel (w <= {MAX_W}, W1 + n_rhs <= "
            f"{MAX_W1A})")


def sband_solve_multi(U: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Solve B banded systems ``U`` [B, n, W1] (upper band, diagonal in
    slot 0) for the right-hand sides ``R`` [B, n, n_rhs] -> x [B, n,
    n_rhs], in the dtype of the inputs.

    CPU tensors: the plain torch solver.  CUDA tensors: the CUDA kernel,
    which adds one to ``sband_solve_multi.launches`` per launch and records
    ``(B, n, W1, n_rhs)`` in ``sband_solve_multi.last_shape``.
    """
    _check(U, R)
    if U.device.type == "cpu":
        return scalar_band_solve_scan(U, R)
    if U.device.type != "cuda":
        raise ValueError(
            f"sband_solve_multi runs on CPU or CUDA tensors, not {U.device}")
    for name, t in (("U", U), ("R", R)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, n, W1 = U.shape
    n_rhs = R.shape[2]
    x = torch.empty_like(R)
    if B == 0 or n == 0 or n_rhs == 0:
        return x

    from nodal_tpu_torch.utils.kernels import load_library

    lib = load_library()
    cfg = launch_config(B, n, W1, n_rhs, U.element_size())
    scratch = torch.empty(cfg.scratch_elems, dtype=U.dtype, device=U.device)
    fn = lib.sband_solve_f32 if U.dtype == torch.float32 else \
        lib.sband_solve_f64
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = fn(U.data_ptr(), R.data_ptr(), x.data_ptr(), scratch.data_ptr(),
                 B, n, W1, n_rhs, cfg.n_warps, cfg.warps_per_block,
                 cfg.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(
            f"scalar-band kernel launch failed with CUDA error {err} "
            f"(B={B}, n={n}, W1={W1}, n_rhs={n_rhs}, {U.dtype}, {cfg})")
    sband_solve_multi.launches += 1
    sband_solve_multi.last_shape = (B, n, W1, n_rhs)
    return x


sband_solve_multi.launches = 0
sband_solve_multi.last_shape = None


def sband_solve(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Single right-hand side: ``U`` [B, n, W1], ``b`` [B, n] -> x [B, n]."""
    return sband_solve_multi(U, b.unsqueeze(-1).contiguous())[..., 0]
