"""Batched preconditioned Krylov solvers: CG and BiCGStab.

Counterpart of ``nodal_tpu/ops/cg.py``'s ``cg`` and ``bicgstab``, written
for a leading batch dimension: ``b`` is ``[B, ...]`` and every dot product
runs per sample over the trailing dimensions.  The loops keep the semantics
of ``jax.vmap`` of the JAX ``while_loop``: they run while any sample is
unconverged and under ``maxiter``, and a sample that has stopped is frozen
(its state is not stepped), so each sample's x, iterations and residual
are those of its own single solve.  Each loop syncs the host once an
iteration, for its continuation test.

``cg(group=...)`` is the JAX ``cg``'s ``axis_names``: each sample's field
is a block of a field split over the ranks of a ``torch.distributed``
process group, and every dot product is all-reduced over that group, so
the continuation test agrees on every rank of it.  ``cond_axis_names`` has
no counterpart: each group runs its own loop, and no collective crosses
groups inside it.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from nodal_tpu_torch.utils import tracing


class SolveInfo(NamedTuple):
    residual: torch.Tensor    # [B] final relative residual
    iterations: torch.Tensor  # [B] int32 iterations executed
    converged: torch.Tensor   # [B] bool


def _identity(x):
    return x


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-sample inner product over the trailing dimensions, [B]."""
    return (u * v).flatten(1).sum(dim=1)


def _group_dot(u: torch.Tensor, v: torch.Tensor, group) -> torch.Tensor:
    """:func:`_dot` of the blocks, summed over the ranks of ``group``."""
    d = _dot(u, v)
    dist.all_reduce(d, group=group)
    return d


def _continuation(active: torch.Tensor) -> int:
    """The samples still stepping, read on the host: a loop's continuation
    test and its one host sync an iteration."""
    tracing.count("host_syncs")
    with tracing.span("cg.sync"):
        return int(active.sum())


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.where(den == 0, torch.ones_like(den), den)


def _per_sample(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [B] scalar broadcast against a [B, ...] field."""
    return s.reshape(s.shape + (1,) * (like.dim() - 1))


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       preconditioner: Callable | None = None, tol: float = 1e-9,
       maxiter: int | None = None, group=None):
    """Preconditioned CG for SPD operators, batched over ``b`` [B, ...].

    ``matvec`` and ``preconditioner`` map a [B, ...] batch to a [B, ...]
    batch, each sample independently.  Convergence: ||r|| <= tol * ||b||
    per sample, capped at ``maxiter``.  Returns ``(x, SolveInfo)`` with
    SolveInfo fields of shape [B].

    ``group``: a process group over whose ranks ``b`` and the iterates are
    split (each rank holds its block of every sample, and ``matvec`` and
    ``preconditioner`` exchange what they need); every dot product is then
    all-reduced over it (SUM).  Every rank of the group must call with the
    same batch and ``maxiter``.
    """
    dot = _dot if group is None else functools.partial(_group_dot,
                                                        group=group)
    M = preconditioner or _identity
    if x0 is None:
        x0 = torch.zeros_like(b)
    if maxiter is None:
        maxiter = 10 * b[0].numel()
    tiny = torch.finfo(b.dtype).tiny

    b_norm2 = dot(b, b)
    atol2 = (tol * tol) * torch.clamp(b_norm2, min=tiny)

    x = x0
    r = b - matvec(x0)
    p = M(r)
    rz = dot(r, p)
    rr = dot(r, r)
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    while True:
        active = (rr > atol2) & (k < maxiter)
        # The loop's one host sync an iteration: the continuation test.
        n_active = _continuation(active)
        if n_active == 0:
            break
        with tracing.span("cg.iteration"):
            Ap = matvec(p)
            alpha = _per_sample(_safe_div(rz, dot(p, Ap)), p)
            x_new = x + alpha * p
            r_new = r - alpha * Ap
            z_new = M(r_new)
            rz_new = dot(r_new, z_new)
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
            rr = dot(r, r)
    res = torch.sqrt(rr / torch.clamp(b_norm2, min=tiny))
    return x, SolveInfo(residual=res, iterations=k, converged=res <= tol)


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: torch.Tensor | None = None, *,
             preconditioner: Callable | None = None, tol: float = 1e-9,
             maxiter: int | None = None):
    """Preconditioned BiCGStab for general (nonsymmetric) operators,
    batched over ``b`` [B, ...] as :func:`cg`.

    A sample stops when ||r|| <= tol * ||b||, at ``maxiter``, or after the
    step in which |ρ| fell below the dtype's ``tiny`` (breakdown); the
    denominators are guarded as in the JAX package (:func:`_safe`).
    """
    M = preconditioner or _identity
    if x0 is None:
        x0 = torch.zeros_like(b)
    if maxiter is None:
        maxiter = 10 * b[0].numel()
    eps = torch.finfo(b.dtype).tiny
    B = b.shape[0]

    b_norm2 = _dot(b, b)
    atol2 = (tol * tol) * torch.clamp(b_norm2, min=eps)

    x = x0
    r = b - matvec(x0)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones(B, dtype=b.dtype, device=b.device)
    k = torch.zeros(B, dtype=torch.int32, device=b.device)
    broken = torch.zeros(B, dtype=torch.bool, device=b.device)
    rr = _dot(r, r)
    while True:
        active = (rr > atol2) & (k < maxiter) & ~broken
        # The loop's one host sync an iteration: the continuation test.
        n_active = _continuation(active)
        if n_active == 0:
            break
        with tracing.span("cg.iteration"):
            rho_new = _dot(rhat, r)
            beta = (rho_new / _safe(rho, eps)) * (alpha / _safe(omega, eps))
            p_new = r + _per_sample(beta, r) * (p - _per_sample(omega, r) * v)
            phat = M(p_new)
            v_new = matvec(phat)
            alpha_new = rho_new / _safe(_dot(rhat, v_new), eps)
            s = r - _per_sample(alpha_new, r) * v_new
            shat = M(s)
            t = matvec(shat)
            omega_new = _dot(t, s) / _safe(_dot(t, t), eps)
            x_new = (x + _per_sample(alpha_new, x) * phat
                     + _per_sample(omega_new, x) * shat)
            r_new = s - _per_sample(omega_new, r) * t
            new = (x_new, r_new, p_new, v_new, rho_new, alpha_new, omega_new)
            if n_active == B:
                x, r, p, v, rho, alpha, omega = new
                k = k + 1
            else:
                # A stopped sample keeps its state, as under jax.vmap.
                keep = _per_sample(active, x)
                x, r, p, v = (torch.where(keep, a, o) for a, o in
                              zip(new[:4], (x, r, p, v)))
                rho, alpha, omega = (torch.where(active, a, o) for a, o in
                                     zip(new[4:], (rho, alpha, omega)))
                k = k + active.to(torch.int32)
            broken = broken | (active & (rho_new.abs() < eps))
            rr = _dot(r, r)
    res = torch.sqrt(rr / torch.clamp(b_norm2, min=eps))
    return x, SolveInfo(residual=res, iterations=k, converged=res <= tol)


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x`` with its magnitude raised to at least ``eps``, sign kept (a
    zero counts as positive)."""
    floor = torch.where(x < 0, x.new_full((), -eps), x.new_full((), eps))
    return torch.where(x.abs() < eps, floor, x)
