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

:func:`band_factor` solves as :func:`band_solve_multi` does and keeps the
elimination (every S_t⁻¹ and C_t, kb = 128) where it fits in
``SCRATCH_BYTES_MAX``; :func:`band_substitute` then solves the same band
for other right-hand sides by one substitution-only launch
(``block_thomas_subst``), in the bits of a fresh solve.  Their plain
versions are :func:`~nodal_tpu_torch.ops.band.band_thomas_factor` and
:func:`~nodal_tpu_torch.ops.band.band_thomas_substitute`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nodal_tpu_torch.ops.band import (_KB_CHOICES, ThomasFactors,
                                      band_thomas_factor, band_thomas_solve,
                                      band_thomas_substitute)
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
#: chunks whose scratch fits (at least one system a chunk).  It bounds the
#: elimination that :func:`band_factor` keeps (:func:`held_elems`) too.
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
    Each host loop is a whole solve of its chunk: it eliminates.  The
    loop of :func:`band_factor` makes the same launches on the layout of
    :func:`held_elems`; a :func:`band_substitute` is one launch more, and
    no host loop.

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


def held_elems(B: int, nb: int, kb: int, r: int) -> int:
    """Values of the elimination that :func:`band_factor` keeps for B
    systems (``csrc/block_thomas.cu``'s held layout): S_t⁻¹ for every
    block row [B, nb, kb, kb], the right-hand side's scratch [B, kb, r]
    and the [C_t | y_t] slots [B, nb, kb, slot_ld]."""
    ls = kb + -(-r // 4) * 4
    return B * (nb * kb * kb + kb * r + nb * kb * ls)


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

    CPU tensors: the plain torch solver.  CUDA tensors: the CUDA kernels.

    The counts, which :func:`band_factor` and :func:`band_substitute`
    keep too: ``band_solve_multi.launches`` counts host loops that
    eliminate, each a whole solve's work (here :func:`launch_plan`'s
    ``calls`` a slice of ``MAX_R`` columns); ``band_solve_multi.kernels``
    and the tracing counter ``thomas_kernels`` count every block-Thomas
    kernel launched, eliminating (:func:`launch_plan`'s ``launches`` a
    loop) or substituting (one a substitution);
    ``band_solve_multi.last_shape`` is ``(B, nb, kb, r)`` of the last
    eliminating call.  The tracing counters ``thomas_factorizations`` and
    ``thomas_substitutions`` count eliminating loops (on the CPU, plain
    solves) and substitutions.  Each call is a ``thomas.solve`` span,
    device-timed on CUDA.
    """
    _check(W, R)
    with tracing.span("thomas.solve", W):
        if W.device.type == "cpu":
            tracing.count("thomas_factorizations")
            return band_thomas_solve(W, R)
        _check_cuda(W, R)
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


def _check_cuda(W: torch.Tensor, R: torch.Tensor) -> None:
    if W.device.type != "cuda":
        raise ValueError(
            f"the block-Thomas kernels run on CPU or CUDA tensors, not "
            f"{W.device}")
    for name, t in (("W", W), ("R", R)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _count_loop(launches: int) -> None:
    """One eliminating host loop of ``launches`` kernels."""
    band_solve_multi.launches += 1
    band_solve_multi.kernels += launches
    tracing.count("thomas_kernels", launches)
    tracing.count("thomas_factorizations")


def _launch(W: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """One host loop a chunk of the batch, for at most ``MAX_R``
    right-hand sides."""
    B, nb, kb, _ = W.shape
    r = R.shape[2]
    X = torch.empty_like(R)
    if B == 0:
        return X

    plan = launch_plan(B, nb, kb, r, W.element_size())
    scratch = torch.empty(plan.scratch_elems, dtype=W.dtype, device=W.device)
    for lo in range(0, B, plan.chunk):
        hi = min(B, lo + plan.chunk)
        _run(W, "block_thomas", W[lo:hi].data_ptr(), R[lo:hi].data_ptr(),
             X[lo:hi].data_ptr(), scratch.data_ptr(), hi - lo, nb, kb, r)
        _count_loop(plan.launches)
    return X


def _run(W: torch.Tensor, name: str, *args) -> None:
    """The library's launcher ``name`` in W's dtype, on W's device and
    current stream; raises on the CUDA error it returns."""
    from nodal_tpu_torch.utils.kernels import load_library

    suffix = "f32" if W.dtype == torch.float32 else "f64"
    fn = getattr(load_library(), f"{name}_{suffix}")
    with torch.cuda.device(W.device):
        err = fn(*args, torch.cuda.current_stream(W.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}_{suffix} failed with CUDA error {err} "
                           f"(W {tuple(W.shape)}, arguments {args})")


def band_solve(W: torch.Tensor, b: torch.Tensor,
               n_valid: int | None = None) -> torch.Tensor:
    """Single right-hand side: ``W`` [B, nb, kb, 3kb], ``b`` [B, nb·kb] ->
    x [B, nb·kb], or its first ``n_valid`` unknowns."""
    x = band_solve_multi(W, b.unsqueeze(-1).contiguous())[..., 0]
    return x if n_valid is None else x[..., :n_valid]


@dataclass(frozen=True)
class BandFactors:
    """The elimination of the band ``W`` that :func:`band_factor` kept for
    ``r`` right-hand sides: on the card ``F``, the layout of
    :func:`held_elems`; on the CPU the plain
    :class:`~nodal_tpu_torch.ops.band.ThomasFactors`."""

    W: torch.Tensor
    F: torch.Tensor | ThomasFactors
    r: int


def band_factor(W: torch.Tensor, R: torch.Tensor
                ) -> tuple[torch.Tensor, BandFactors | None]:
    """Solve as :func:`band_solve_multi` does, bit for bit, and keep the
    elimination for :func:`band_substitute`: ``(X, BandFactors)``.

    Kept where kb = 128, r <= ``APPLY_R`` and :func:`held_elems` fits in
    ``SCRATCH_BYTES_MAX`` (then the batch's scratch fits too, and
    :func:`band_solve_multi` would take one host loop); otherwise
    ``(band_solve_multi(W, R), None)``.  The same rule on the CPU, whose
    plain factors are about as large.  On CUDA one host loop, the
    launches of :func:`launch_plan` in its order, counted as
    :func:`band_solve_multi` counts one.
    """
    _check(W, R)
    B, nb, kb, _ = W.shape
    r = R.shape[2]
    held = held_elems(B, nb, kb, r) * W.element_size()
    if B == 0 or kb != PANEL or r > APPLY_R or held > SCRATCH_BYTES_MAX:
        return band_solve_multi(W, R), None
    with tracing.span("thomas.solve", W):
        if W.device.type == "cpu":
            tracing.count("thomas_factorizations")
            X, f = band_thomas_factor(W, R)
            return X, BandFactors(W, f, r)
        _check_cuda(W, R)
        F = torch.empty(held_elems(B, nb, kb, r), dtype=W.dtype,
                        device=W.device)
        X = torch.empty_like(R)
        _run(W, "block_thomas_factor", W.data_ptr(), R.data_ptr(),
             X.data_ptr(), F.data_ptr(), B, nb, kb, r)
        _count_loop(launch_plan(B, nb, kb, r, W.element_size()).launches)
        band_solve_multi.last_shape = (B, nb, kb, r)
        return X, BandFactors(W, F, r)


def band_substitute(f: BandFactors, R: torch.Tensor) -> torch.Tensor:
    """X = W⁻¹R for R [B, nb·kb, r <= ``APPLY_R``] on the elimination
    :func:`band_factor` kept of W: the bits of a fresh solve, from one
    ``block_thomas_subst`` launch on CUDA (no host loop), counted in
    ``band_substitute.launches``, ``band_solve_multi.kernels``,
    ``thomas_kernels`` and ``thomas_substitutions``; a ``thomas.solve``
    span."""
    W = f.W
    _check(W, R)
    B, nb, kb, _ = W.shape
    r = R.shape[2]
    if r > APPLY_R:
        raise ValueError(f"band_substitute takes at most {APPLY_R} "
                         f"right-hand sides, got {r}")
    with tracing.span("thomas.solve", W):
        tracing.count("thomas_substitutions")
        if W.device.type == "cpu":
            return band_thomas_substitute(f.F, R)
        _check_cuda(W, R)
        Sinv = f.F.data_ptr()
        slots = Sinv + (B * nb * kb * kb + B * kb * f.r) * W.element_size()
        X = torch.empty_like(R)
        _run(W, "block_thomas_subst", W.data_ptr(), Sinv, slots,
             R.data_ptr(), X.data_ptr(), B, nb, kb, r, kb + -(-f.r // 4) * 4)
        band_substitute.launches += 1
        band_solve_multi.kernels += 1
        tracing.count("thomas_kernels")
        return X


band_substitute.launches = 0
