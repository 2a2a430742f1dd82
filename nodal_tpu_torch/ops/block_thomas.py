"""Batched block-Thomas solve: the hand-written CUDA kernels and their
wrapper.

Counterpart of the Pallas kernels of ``nodal_tpu/ops/pallas_band.py``
(``pallas_band_solve(_multi)`` and the streaming
``pallas_band_solve(_multi)_stream``), which one source,
``csrc/block_thomas.cu``, replaces: a host loop over the block rows whose
every launch covers the batch.  Its plain version is
:func:`nodal_tpu_torch.ops.band.band_thomas_solve`.

:func:`band_solve_multi` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernels or raises: there is no
fallback.  The kernels serve every shape a plan admits: kb in
``_KB_CHOICES``, any number of block rows, any batch, in float32 and
float64; more than ``MAX_R`` right-hand sides take one host loop per slice
of ``MAX_R`` columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nodal_tpu_torch.ops.band import _KB_CHOICES, band_thomas_solve
from nodal_tpu_torch.ops.lu import factor_launches, factor_scratch
from nodal_tpu_torch.utils import tracing

#: Right-hand sides one host loop takes.
MAX_R = 128

#: Panel width of the Schur blocks' LU; must match ``kBlock`` in
#: ``csrc/dense_tile.cuh``.
PANEL = 128

#: Right-hand sides (kb = 128) that the inverse's launch takes along;
#: must match ``kNarrowCols`` in ``csrc/dense_tile.cuh``.
APPLY_R = 4

#: Upper bound on the scratch of one host loop: the batch is cut into
#: chunks whose scratch fits (at least one system a chunk).
SCRATCH_BYTES_MAX = 4 << 30


@dataclass(frozen=True)
class LaunchPlan:
    chunk: int          # systems one host loop takes
    calls: int          # host loops that cover the batch
    slot_ld: int        # row length of a [C_t | y_t] slot
    scratch_elems: int  # scratch values of one host loop
    launches: int       # kernel launches of one host loop


def launch_plan(B: int, nb: int, kb: int, r: int,
                itemsize: int) -> LaunchPlan:
    """How :func:`band_solve_multi` drives the kernels (the host loop of
    ``csrc/block_thomas.cu``, which lays the scratch out the same way).

    Every launch covers a chunk of the batch.  A chunk's scratch is, a
    system: the Schur block S (kb·kb) and the right-hand side (kb·r), one
    [C_t | y_t] slot a block row (nb·kb·slot_ld, rows padded to 4 values so
    that the backward sweep reads them with 16-byte loads), and for
    kb > 128 the LU's panel products P (128·(kb − 128)) and Z
    (128·(kb + r)).  Chunks hold at most ``SCRATCH_BYTES_MAX``.

    Launches a block row: at kb = 128 three for r <= ``APPLY_R`` (S; S⁻¹
    with rhs and y_t formed in the same launch; C_t), else five (S, rhs,
    S⁻¹, C_t, y_t); at q = kb/128 panels three (S, the slot's rhs and U_t),
    the LU of S (:func:`~nodal_tpu_torch.ops.lu.factor_launches`) and its
    solve (4q − 2 products); plus one a block row in the backward sweep.
    """
    ls = kb + -(-r // 4) * 4
    q = kb // PANEL
    per_system = kb * kb + kb * r + nb * kb * ls
    if q > 1:
        per_system += factor_scratch(kb) + PANEL * (kb + r)
    chunk = max(1, min(B, SCRATCH_BYTES_MAX // (per_system * itemsize)))
    if q == 1:
        per_row = 3 if r <= APPLY_R else 5
    else:
        per_row = 3 + factor_launches(kb) + 4 * q - 2
    return LaunchPlan(chunk, -(-B // chunk), ls, chunk * per_system,
                      nb * (per_row + 1))


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

    CPU tensors: the plain torch solver.  CUDA tensors: the CUDA kernels,
    whose wrapper adds one to ``band_solve_multi.launches`` per host loop
    (:func:`launch_plan`'s ``calls`` a slice of ``MAX_R`` columns) and the
    loop's kernel launches (:func:`launch_plan`'s ``launches``) to
    ``band_solve_multi.kernels`` and to the tracing counter
    ``thomas_kernels``, and records ``(B, nb, kb, r)`` of the call in
    ``band_solve_multi.last_shape``.  Each call is a ``thomas.solve`` span,
    device-timed on CUDA.
    """
    _check(W, R)
    with tracing.span("thomas.solve", W):
        if W.device.type == "cpu":
            return band_thomas_solve(W, R)
        if W.device.type != "cuda":
            raise ValueError(
                f"band_solve_multi runs on CPU or CUDA tensors, not "
                f"{W.device}")
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
band_solve_multi.kernels = 0
band_solve_multi.last_shape = None


def _launch(W: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """One host loop a chunk of the batch, for at most ``MAX_R``
    right-hand sides."""
    B, nb, kb, _ = W.shape
    r = R.shape[2]
    X = torch.empty_like(R)
    if B == 0:
        return X

    from nodal_tpu_torch.utils.kernels import load_library

    lib = load_library()
    plan = launch_plan(B, nb, kb, r, W.element_size())
    scratch = torch.empty(plan.scratch_elems, dtype=W.dtype, device=W.device)
    fn = lib.block_thomas_f32 if W.dtype == torch.float32 else \
        lib.block_thomas_f64
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        for lo in range(0, B, plan.chunk):
            hi = min(B, lo + plan.chunk)
            err = fn(W[lo:hi].data_ptr(), R[lo:hi].data_ptr(),
                     X[lo:hi].data_ptr(), scratch.data_ptr(), hi - lo, nb,
                     kb, r, stream)
            if err != 0:
                raise RuntimeError(
                    f"block-Thomas kernels failed with CUDA error {err} "
                    f"(B={B}, nb={nb}, kb={kb}, r={r}, {W.dtype}, {plan})")
            band_solve_multi.launches += 1
            band_solve_multi.kernels += plan.launches
            tracing.count("thomas_kernels", plan.launches)
    return X


def band_solve(W: torch.Tensor, b: torch.Tensor,
               n_valid: int | None = None) -> torch.Tensor:
    """Single right-hand side: ``W`` [B, nb, kb, 3kb], ``b`` [B, nb·kb] ->
    x [B, nb·kb], or its first ``n_valid`` unknowns."""
    x = band_solve_multi(W, b.unsqueeze(-1).contiguous())[..., 0]
    return x if n_valid is None else x[..., :n_valid]
