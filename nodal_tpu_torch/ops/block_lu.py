"""Batched no-pivot blocked LU: the plain version of the CUDA kernel.

Counterpart of ``nodal_tpu/ops/block_lu.py``.  For the diagonally
dominant and SPD systems of resistive networks (and the schur tier's
resistive node block) pivoting is unnecessary, so the factorization runs
in 128-column panels:

    for each 128-block column t:
        Dinv_t = inv(D_tt)                  (small batched inverse)
        L_t    = A_{>t,t} @ Dinv_t          (tall product)
        A_{>t,>t} -= L_t @ A_{t,>t}         (rank-128 update)

and both triangular sweeps are products with the panels.  Each diagonal
block is inverted with ``torch.linalg.inv``, as the JAX package does off
the TPU (its Newton-Schulz inverses and matmul precisions are TPU
machinery and are not carried over; float32 products here rely on
PyTorch's default of no TF32).

This module is the CPU path and the plain version that ``chip_smoke.py``
holds the CUDA kernel of :mod:`nodal_tpu_torch.ops.lu` against; on CUDA
tensors the solvers call that kernel instead.
"""

from __future__ import annotations

import torch

_BLOCK = 128


def _pad_to_block(A: torch.Tensor, b: torch.Tensor, block: int = _BLOCK):
    """``(A, b, n)`` with A's last two axes and b's last axis padded to a
    multiple of ``block``: zeros, a unit diagonal on the pad."""
    n = A.shape[-1]
    pad = (-n) % block
    if pad == 0:
        return A, b, n
    A = torch.nn.functional.pad(A, (0, pad, 0, pad))
    idx = torch.arange(n, n + pad, device=A.device)
    A[..., idx, idx] = 1.0
    b = torch.nn.functional.pad(b, (0, pad))
    return A, b, n


def blocked_factor(A: torch.Tensor, block: int = _BLOCK):
    """Panel block LU of ``A`` [..., n, n] (n a multiple of ``block``),
    no pivoting.

    Returns the list of panels ``(Dinv_t, L_t, U_t)``: ``L_t`` the
    [..., n−(t+1)k, k] sub-diagonal column panel, ``U_t`` the
    [..., k, n−(t+1)k] Schur-updated row panel.  Carrying a shrinking Schur
    complement keeps each step's update to the trailing block.
    """
    n = A.shape[-1]
    if n % block:
        raise ValueError(f"n = {n} is not a multiple of {block}")
    panels = []
    S = A
    for _ in range(n // block):
        Dinv = torch.linalg.inv(S[..., :block, :block])
        # A copy: a view would keep the whole of this step's S alive.
        U = S[..., :block, block:].clone()
        L = S[..., block:, :block] @ Dinv
        S = S[..., block:, block:] - L @ U
        panels.append((Dinv, L, U))
    return panels


def blocked_solve_factored(panels, b: torch.Tensor, block: int = _BLOCK):
    """Solve with the panels of :func:`blocked_factor`.  ``b`` is [..., n]
    (vector) or [..., n, r] (several right-hand sides)."""
    vector_rhs = b.dim() == panels[0][0].dim() - 1
    rest = b.unsqueeze(-1) if vector_rhs else b
    ys = []
    for _, L, _ in panels:  # forward: peel one block of y a panel
        y_t = rest[..., :block, :]
        rest = rest[..., block:, :] - L @ y_t
        ys.append(y_t)
    x_below = None  # backward: x_t = Dinv_t (y_t − U_t x_below)
    for (Dinv, _, U), y_t in zip(reversed(panels), reversed(ys)):
        rhs = y_t if x_below is None else y_t - U @ x_below
        x_t = Dinv @ rhs
        x_below = x_t if x_below is None else torch.cat([x_t, x_below],
                                                        dim=-2)
    return x_below[..., 0] if vector_rhs else x_below


def blocked_solve(A: torch.Tensor, b: torch.Tensor,
                  block: int = _BLOCK) -> torch.Tensor:
    """No-pivot blocked dense solve of ``A`` [..., n, n], ``b`` [..., n]
    for diagonally dominant or SPD systems; any n (padded internally)."""
    Ap, bp, n = _pad_to_block(A, b, block)
    return blocked_solve_factored(blocked_factor(Ap, block), bp,
                                  block)[..., :n]


def schur_eliminate(Y: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    rb: torch.Tensor, kbe: int):
    """The branch half of the block elimination, given
    ``Y = A⁻¹ [B | bk]`` [..., nk, kbe + 1]:

        S = D − C Y_B,   S xb = rb − C y_b (pivoted),   xk = y_b − Y_B xb

    Returns ``(xk, xb)``.  Plain ``torch.matmul`` and
    ``torch.linalg.solve`` (the JAX package leaves them to XLA).
    """
    YB = Y[..., :kbe]
    yb = Y[..., kbe]
    S = D - C @ YB
    rhs_b = rb - (C @ yb.unsqueeze(-1))[..., 0]
    xb = torch.linalg.solve(S, rhs_b.unsqueeze(-1))[..., 0]
    return yb - (YB @ xb.unsqueeze(-1))[..., 0], xb


def schur_solve(G: torch.Tensor, b: torch.Tensor, nk: int,
                block: int = _BLOCK) -> torch.Tensor:
    """Branch-equation MNA systems ``G`` [..., n, n] by block elimination.

    MNA orders unknowns as [node potentials | branch currents], so ``G``
    is the 2×2 saddle-point form [[A, B], [C, D]] whose node block A holds
    only resistor stamps: diagonally dominant, the no-pivot LU's domain.
    One multi-RHS blocked solve gives ``Y = A⁻¹ [B | bk]`` and
    :func:`schur_eliminate` the rest.  Callers ensure A is nonsingular
    (``batch._schur_supported``).
    """
    n = G.shape[-1]
    kbe = n - nk
    if kbe <= 0:
        raise ValueError("schur_solve requires branch equations")
    A = G[..., :nk, :nk]
    R = torch.cat([G[..., :nk, nk:], b[..., :nk].unsqueeze(-1)], dim=-1)
    pad = (-nk) % block
    if pad:
        A, _, _ = _pad_to_block(A, b[..., :nk], block)
        R = torch.nn.functional.pad(R, (0, 0, 0, pad))
    Y = blocked_solve_factored(blocked_factor(A, block), R, block)[..., :nk, :]
    xk, xb = schur_eliminate(Y, G[..., nk:, :nk], G[..., nk:, nk:],
                             b[..., nk:], kbe)
    return torch.cat([xk, xb], dim=-1)
