"""Batched tridiagonal solves by parallel cyclic reduction (PCR), in plain
torch.

Counterpart of ``nodal_tpu/ops/tridiag.py``, operation for operation.  This
is the plain version of the CUDA kernel in :mod:`nodal_tpu_torch.ops.pcr`:
the kernel's wrapper runs it for CPU tensors, and the tests and the smoke
script hold the kernel against it.

PCR runs log2(n) levels, each a fully vectorized recurrence over ``[B, n]``
applied to every row, so the systems decouple with no sequential
back-substitution.  O(n log n) work; stable for the diagonally dominant
systems resistive networks produce.
"""

from __future__ import annotations

import torch


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _shift(x: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """x shifted by s along the last axis (s>0 reads index i-s), padded
    with ``fill``."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (abs(s),), fill, dtype=x.dtype,
                     device=x.device)
    if s > 0:
        return torch.cat([pad, x[..., :-s]], dim=-1)
    return torch.cat([x[..., -s:], pad], dim=-1)


def tridiag_matvec(dl, d, du, x):
    """y_i = dl_i x_{i-1} + d_i x_i + du_i x_{i+1} (batched)."""
    return d * x + dl * _shift(x, 1, 0.0) + du * _shift(x, -1, 0.0)


def tridiag_solve(dl, d, du, b):
    """Solve batched tridiagonal systems ``dl_i x_{i-1} + d_i x_i +
    du_i x_{i+1} = b_i`` by parallel cyclic reduction.

    Args are ``[..., n]``: sub-diagonal ``dl`` (``dl[..., 0]`` ignored),
    diagonal ``d``, super-diagonal ``du`` (``du[..., n-1]`` ignored) and
    right-hand side ``b``.  Returns ``[..., n]`` solutions.
    """
    n = d.shape[-1]
    m = _next_pow2(n)
    pad = m - n

    def padded(x, fill):
        if pad == 0:
            return x
        p = torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype,
                       device=x.device)
        return torch.cat([x, p], dim=-1)

    # Pad with decoupled identity rows (x_extra = 0); clear the dangling
    # couplings at both physical ends.
    a = padded(dl, 0.0).clone()
    a[..., 0] = 0.0
    c = padded(du, 0.0).clone()
    c[..., n - 1] = 0.0
    dd = padded(d, 1.0)
    rhs = padded(b, 0.0)

    stride = 1
    while stride < m:
        # Eliminate the +-stride couplings of every row simultaneously.
        # Out-of-range neighbors read as decoupled identity rows.
        alpha = a / _shift(dd, stride, 1.0)
        gamma = c / _shift(dd, -stride, 1.0)
        a_new = -alpha * _shift(a, stride, 0.0)
        c_new = -gamma * _shift(c, -stride, 0.0)
        dd = (
            dd
            - alpha * _shift(c, stride, 0.0)
            - gamma * _shift(a, -stride, 0.0)
        )
        rhs = (
            rhs
            - alpha * _shift(rhs, stride, 0.0)
            - gamma * _shift(rhs, -stride, 0.0)
        )
        a, c = a_new, c_new
        stride *= 2

    return (rhs / dd)[..., :n]
