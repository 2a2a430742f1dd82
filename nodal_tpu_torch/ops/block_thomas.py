"""Batched block-Thomas solve: the hand-written CUDA kernel and its wrapper.

Counterpart of the Pallas kernels of ``nodal_tpu/ops/pallas_band.py``
(``pallas_band_solve(_multi)`` and the streaming
``pallas_band_solve(_multi)_stream``), which one kernel,
``csrc/block_thomas.cu``, replaces.  Its plain version is
:func:`nodal_tpu_torch.ops.band.band_thomas_solve`.

:func:`band_solve_multi` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises: there is no
fallback.  The kernel serves every shape a plan admits: kb in
``_KB_CHOICES``, any number of block rows, any batch, in float32 and
float64; more than ``MAX_R`` right-hand sides take one launch per slice of
``MAX_R`` columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nodal_tpu_torch.ops.band import _KB_CHOICES, band_thomas_solve

#: Right-hand sides one launch takes.
MAX_R = 128

#: Threads a block; must match ``kThreads`` in ``csrc/block_thomas.cu``.
THREADS = 256

#: Resident blocks launched per SM.  Two beat one by 1.3-1.5× at every
#: shape ``chip_grid_sweep.py`` times (kb 128 and 256, nb 10 to 79, B 256
#: and 1024, f32 and f64); at 128 registers a thread no more fit.
BLOCKS_PER_SM = 2

#: Upper bound on the scratch of one launch; the grid is cut so that its
#: blocks' scratch areas fit (at least one block).
SCRATCH_BYTES_MAX = 4 << 30

#: Shared memory a block may give the Schur block S: BLOCKS_PER_SM blocks
#: of it, plus each block's static tiles (``Shared`` in the source, at most
#: 41,472 bytes in f64), must fit the SM's 228 KiB.
S_SHARED_BYTES_MAX = 64 << 10


@dataclass(frozen=True)
class LaunchConfig:
    grid: int           # blocks; each owns a scratch area
    waves: int          # systems a block solves in turn, at most
    scratch_elems: int  # scratch values of the whole grid
    smem_bytes: int     # dynamic shared memory holding S, or 0


def launch_config(B: int, nb: int, kb: int, r: int, itemsize: int,
                  sm_count: int) -> LaunchConfig:
    """How :func:`band_solve_multi` launches the kernel.

    Each block solves one system at a time with a scratch area of kb·kb
    (the Schur block) plus nb·kb·(kb + r) values (one [C_t | y_t] slot a
    block row) and walks the batch in ``waves`` turns.  The grid has
    ``BLOCKS_PER_SM`` blocks an SM, at most one a system, and at most
    ``SCRATCH_BYTES_MAX`` of scratch.  Where S fits
    ``S_SHARED_BYTES_MAX`` (kb = 128 in f32) it lives in shared memory
    instead, off the L2 round trips of every elimination panel.
    """
    per_block = kb * kb + nb * kb * (kb + r)
    grid = max(1, min(B, sm_count * BLOCKS_PER_SM,
                      SCRATCH_BYTES_MAX // (per_block * itemsize)))
    s_bytes = kb * kb * itemsize
    return LaunchConfig(grid, -(-B // grid), grid * per_block,
                        s_bytes if s_bytes <= S_SHARED_BYTES_MAX else 0)


def _check(W: torch.Tensor, R: torch.Tensor) -> None:
    if W.dim() != 4 or R.dim() != 3:
        raise ValueError(
            f"band_solve_multi expects W [B, nb, kb, 3kb] and R [B, nb·kb, "
            f"r], got {tuple(W.shape)} and {tuple(R.shape)}")
    B, nb, kb, kb3 = W.shape
    if kb not in _KB_CHOICES or kb3 != 3 * kb:
        raise ValueError(
            f"band blocks must be [kb, 3kb] with kb in {_KB_CHOICES}, got "
            f"{tuple(W.shape)}")
    if R.shape[:2] != (B, nb * kb):
        raise ValueError(
            f"R {tuple(R.shape)} does not match W {tuple(W.shape)}: "
            f"expected [{B}, {nb * kb}, r]")
    if R.shape[2] < 1:
        raise ValueError("R has no right-hand sides")
    if W.dtype != R.dtype:
        raise TypeError(f"W is {W.dtype}, R is {R.dtype}")
    if W.dtype not in (torch.float32, torch.float64):
        raise TypeError(
            f"band_solve_multi supports float32 and float64, not {W.dtype}")
    if W.device != R.device:
        raise ValueError(f"W is on {W.device}, R is on {R.device}")


def band_solve_multi(W: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Solve B block-band systems ``W`` [B, nb, kb, 3kb] for the right-hand
    sides ``R`` [B, nb·kb, r] -> X [B, nb·kb, r], in the dtype of the
    inputs.

    CPU tensors: the plain torch solver.  CUDA tensors: the CUDA kernel,
    which adds one to ``band_solve_multi.launches`` per launch and records
    ``(B, nb, kb, r)`` of the call in ``band_solve_multi.last_shape``.
    """
    _check(W, R)
    if W.device.type == "cpu":
        return band_thomas_solve(W, R)
    if W.device.type != "cuda":
        raise ValueError(
            f"band_solve_multi runs on CPU or CUDA tensors, not {W.device}")
    for name, t in (("W", W), ("R", R)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, nb, kb, _ = W.shape
    r = R.shape[2]
    if r > MAX_R:
        X = torch.cat([_launch(W, R[..., c:c + MAX_R].contiguous())
                       for c in range(0, r, MAX_R)], dim=-1)
    else:
        X = _launch(W, R)
    band_solve_multi.last_shape = (B, nb, kb, r)
    return X


band_solve_multi.launches = 0
band_solve_multi.last_shape = None


def _launch(W: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """One kernel launch for at most ``MAX_R`` right-hand sides."""
    B, nb, kb, _ = W.shape
    r = R.shape[2]
    X = torch.empty_like(R)
    if B == 0:
        return X

    from nodal_tpu_torch.utils.kernels import load_library

    lib = load_library()
    sm_count = torch.cuda.get_device_properties(W.device).multi_processor_count
    cfg = launch_config(B, nb, kb, r, W.element_size(), sm_count)
    scratch = torch.empty(cfg.scratch_elems, dtype=W.dtype, device=W.device)
    fn = lib.block_thomas_f32 if W.dtype == torch.float32 else \
        lib.block_thomas_f64
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(W.data_ptr(), R.data_ptr(), X.data_ptr(), scratch.data_ptr(),
                 B, nb, kb, r, cfg.grid, cfg.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(
            f"block-Thomas kernel launch failed with CUDA error {err} "
            f"(B={B}, nb={nb}, kb={kb}, r={r}, {W.dtype}, {cfg})")
    band_solve_multi.launches += 1
    return X


def band_solve(W: torch.Tensor, b: torch.Tensor,
               n_valid: int | None = None) -> torch.Tensor:
    """Single right-hand side: ``W`` [B, nb, kb, 3kb], ``b`` [B, nb·kb] ->
    x [B, nb·kb], or its first ``n_valid`` unknowns."""
    x = band_solve_multi(W, b.unsqueeze(-1).contiguous())[..., 0]
    return x if n_valid is None else x[..., :n_valid]
