"""Batched preconditioned conjugate gradient.

Counterpart of ``nodal_tpu/ops/cg.py:cg``, written for a leading batch
dimension: ``b`` is ``[B, ...]`` and every dot product runs per sample over
the trailing dimensions.  The loop keeps the semantics of ``jax.vmap`` of the
JAX ``while_loop``: it runs while any sample is unconverged and under
``maxiter``, and a sample that has stopped is frozen (its state is not
stepped), so each sample's x, iterations and residual are those of its own
single solve.

Not yet ported: the collectives of the JAX ``cg`` (``axis_names``,
``cond_axis_names``) and ``bicgstab``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SolveInfo(NamedTuple):
    residual: torch.Tensor    # [B] final relative residual
    iterations: torch.Tensor  # [B] int32 iterations executed
    converged: torch.Tensor   # [B] bool


def _identity(x):
    return x


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-sample inner product over the trailing dimensions, [B]."""
    return (u * v).flatten(1).sum(dim=1)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.where(den == 0, torch.ones_like(den), den)


def _per_sample(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B] scalar broadcast against a [B, ...] field."""
    return s.reshape(s.shape + (1,) * (like.dim() - 1))


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       preconditioner: Callable | None = None, tol: float = 1e-9,
       maxiter: int | None = None):
    """Preconditioned CG for SPD operators, batched over ``b`` [B, ...].

    ``matvec`` and ``preconditioner`` map a [B, ...] batch to a [B, ...]
    batch, each sample independently.  Convergence: ||r|| <= tol * ||b||
    per sample, capped at ``maxiter``.  Returns ``(x, SolveInfo)`` with
    SolveInfo fields of shape [B].
    """
    M = preconditioner or _identity
    if x0 is None:
        x0 = torch.zeros_like(b)
    if maxiter is None:
        maxiter = 10 * b[0].numel()
    tiny = torch.finfo(b.dtype).tiny

    b_norm2 = _dot(b, b)
    atol2 = (tol * tol) * torch.clamp(b_norm2, min=tiny)

    x = x0
    r = b - matvec(x0)
    p = M(r)
    rz = _dot(r, p)
    rr = _dot(r, r)
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    while True:
        active = (rr > atol2) & (k < maxiter)
        # The loop's one host sync an iteration: the continuation test.
        n_active = int(active.sum())
        if n_active == 0:
            break
        Ap = matvec(p)
        alpha = _per_sample(_safe_div(rz, _dot(p, Ap)), p)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = M(r_new)
        rz_new = _dot(r_new, z_new)
        p_new = z_new + _per_sample(_safe_div(rz_new, rz), p) * p
        if n_active == b.shape[0]:
            x, r, p, rz = x_new, r_new, p_new, rz_new
            k = k + 1
        else:
            # A stopped sample keeps its state, as under jax.vmap.
            keep = _per_sample(active, x)
            x = torch.where(keep, x_new, x)
            r = torch.where(keep, r_new, r)
            p = torch.where(keep, p_new, p)
            rz = torch.where(active, rz_new, rz)
            k = k + active.to(torch.int32)
        rr = _dot(r, r)
    res = torch.sqrt(rr / torch.clamp(b_norm2, min=tiny))
    return x, SolveInfo(residual=res, iterations=k, converged=res <= tol)
