"""Weighted resistor grids: matrix-free solves with per-edge conductances.

Counterpart of ``nodal_tpu/ops/grid_weighted.py``: the Neumann system
``L_g x = b`` of an h×w grid whose edges carry their own conductances,
``gx[h, w-1]`` on the horizontal edges and ``gy[h-1, w]`` on the vertical
ones, solved by CG on ``A x = L_g x + sum(x)/(h·w)`` with a Galerkin-exact
multigrid V(ν, ν) cycle as its preconditioner: replication prolongation,
block-sum restriction and coarse conductances that sum the fine edges
crossing each coarse face (``coarsen_weights``).  The batch is the JAX
package's ``vmap`` over ``(gx, gy, b)`` written out: every field may carry
a leading batch dimension, and each sample solves with its own
conductances (Monte Carlo over a resistor fabric in one batched solve).

This module also holds the machinery that the 3-D lattices of
:mod:`nodal_tpu_torch.ops.grid_weighted3` share: fields are [B, d, h, w]
(a grid is d = 1), the levels (:func:`build_levels`), the V-cycle
(:func:`lattice_preconditioner`), the batched solve
(:func:`lattice_solve`) and its implicit-function VJP
(:class:`_WeightedSolve`).  On CUDA tensors the stencil work runs in the
kernels of ``csrc/weighted_stencil.cu`` (:mod:`~nodal_tpu_torch.ops.
weighted_stencil`); the coarsening of the conductances, the means and the
CG's vector algebra are torch.  Means are taken per sample.

Entry points run on the card (``device="cuda"``) and raise when CUDA is
absent; the CPU, with the plain versions, only when asked for.
"""

from __future__ import annotations

import torch

from nodal_tpu_torch.ops import weighted_stencil as ws
from nodal_tpu_torch.ops.cg import SolveInfo, cg
from nodal_tpu_torch.utils.device import resolve_device

_OMEGA = 0.8
_COARSEST = 8
_COARSE_SWEEPS = 96


# ------------------------------------------------------ shared [B, d, h, w]

def _stops(d: int, h: int, w: int, planar: bool) -> bool:
    """Whether coarsening stops at a level: at the first odd dimension or
    where the smallest is at most ``_COARSEST`` (d counts in a lattice)."""
    dims = (h, w) if planar else (d, h, w)
    return min(dims) <= _COARSEST or any(n % 2 for n in dims)


def build_levels(g, planar: bool) -> list[tuple]:
    """The multigrid hierarchy: the conductances ``g`` (fields [B, d, h,
    w]) of every level, finest first.  A grid (``planar``, d = 1) halves h
    and w, a lattice d too."""
    levels = [g]
    while not _stops(g[1].shape[1], g[0].shape[2], g[1].shape[3], planar):
        levels.append(ws.coarsen_weights(levels[-1]))
        g = levels[-1]
    return levels


def _mean(v: torch.Tensor) -> torch.Tensor:
    return v.mean(dim=(1, 2, 3), keepdim=True)


def lattice_preconditioner(levels: list[tuple], nu: int = 1):
    """The Galerkin-exact V(ν, ν) cycle on [B, d, h, w] fields: pre-smooth
    from zero, restrict the residual, recurse, add the replicated coarse
    correction and post-smooth; the coarsest level runs ``_COARSE_SWEEPS``
    mean-projected sweeps (:func:`~nodal_tpu_torch.ops.weighted_stencil.
    coarse_solve`).  M(r) is mean-free per sample."""

    def vcycle(r, i):
        g = levels[i]
        if i == len(levels) - 1:
            return ws.coarse_solve(r, g, omega=_OMEGA, sweeps=_COARSE_SWEEPS)
        x = ws.weighted_jacobi(None, r, g, omega=_OMEGA, sweeps=nu)
        rc = ws.weighted_residual(x, g, r, restrict=True)
        zc = vcycle(rc, i + 1)
        return ws.weighted_jacobi(x, r, g, omega=_OMEGA, sweeps=nu, zc=zc)

    def M(r):
        out = vcycle(r, 0)
        return out - _mean(out)

    return M


def lattice_operator(g):
    """``A x = L_g x + sum(x)/n`` on [B, d, h, w] fields, per sample: one
    :func:`~nodal_tpu_torch.ops.weighted_stencil.weighted_residual` launch
    with the mean term as its shift."""

    def matvec(x):
        n = x[0].numel()
        return ws.weighted_residual(x, g, shift=x.flatten(1).sum(1) * (1.0 / n))

    return matvec


def lattice_solve_raw(g, b, planar: bool, tol: float, maxiter, mg: bool):
    """``(x, SolveInfo)`` of ``A x = b − mean(b)`` for [B, d, h, w] fields,
    outside autograd."""
    d, h, w = b.shape[1:]
    M = lattice_preconditioner(build_levels(g, planar)) if mg else None
    if maxiter is None:
        maxiter = 300 if mg else 20 * max((h, w) if planar else (d, h, w))
    with torch.no_grad():
        return cg(lattice_operator(g), b - _mean(b), preconditioner=M,
                  tol=tol, maxiter=maxiter)


def _edge_grads(x, lam):
    """``ḡ_e = −(x_i − x_j)(λ_i − λ_j)`` on every edge, per axis."""
    return (-(x[..., 1:] - x[..., :-1]) * (lam[..., 1:] - lam[..., :-1]),
            -(x[..., 1:, :] - x[..., :-1, :])
            * (lam[..., 1:, :] - lam[..., :-1, :]),
            -(x[:, 1:] - x[:, :-1]) * (lam[:, 1:] - lam[:, :-1]))


class _WeightedSolve(torch.autograd.Function):
    """The implicit-function VJP of the weighted solve (the JAX package's
    ``custom_vjp``, grid_weighted.py:155-174, grid_weighted3.py:175-198):
    the forward runs under ``no_grad``; the backward is one more solve of
    the same symmetric operator, ``λ = A⁻¹x̄ + mean(x̄)`` (A·1 = 1), then
    ``ḡ_e = −(x_i − x_j)(λ_i − λ_j)`` and ``b̄ = λ − mean(λ)``, each mean per
    sample.  The SolveInfo outputs carry no gradient."""

    @staticmethod
    def forward(ctx, gx, gy, gz, b, planar, tol, maxiter, mg):
        g = (gx, gy, gz)
        x, info = lattice_solve_raw(g, b, planar, tol, maxiter, mg)
        ctx.save_for_backward(gx, gy, gz, x)
        ctx.opts = (planar, tol, maxiter, mg)
        ctx.mark_non_differentiable(*info)
        return (x, *info)

    @staticmethod
    def backward(ctx, xbar, *_):
        gx, gy, gz, x = ctx.saved_tensors
        xbar = xbar.contiguous()
        lam = (lattice_solve_raw((gx, gy, gz), xbar, *ctx.opts)[0]
               + _mean(xbar))
        gxbar, gybar, gzbar = _edge_grads(x, lam)
        return (gxbar, gybar, gzbar, lam - _mean(lam), None, None, None,
                None)


def lattice_solve(g, b, planar: bool, *, tol: float, maxiter, mg: bool):
    """The differentiable batched solve: ``(x, SolveInfo)`` for [B, d, h,
    w] fields, gradients to ``g`` and ``b`` through :class:`_WeightedSolve`."""
    x, res, its, conv = _WeightedSolve.apply(*g, b, planar, tol, maxiter, mg)
    return x, SolveInfo(residual=res, iterations=its, converged=conv)


def as_fields(arrays, ndim: int, dtype, device):
    """Tensors of ``arrays`` (numpy or torch) in ``dtype`` on ``device``,
    each given with or without a leading batch: ``(fields, batched)`` with
    every field batched, a single field broadcast to the batch, and
    ``batched`` whether any was."""
    ts = [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]
    batched = any(t.dim() == ndim + 1 for t in ts)
    for t in ts:
        if t.dim() not in (ndim, ndim + 1):
            raise ValueError(f"expected {ndim}-D fields or a batch of them, "
                             f"got {tuple(t.shape)}")
    ts = [t if t.dim() == ndim + 1 else t[None] for t in ts]
    B = max(t.shape[0] for t in ts)
    for t in ts:
        if t.shape[0] not in (1, B):
            raise ValueError(f"batch sizes differ: {[t.shape[0] for t in ts]}")
    return [t.expand(B, *t.shape[1:]).contiguous() for t in ts], batched


def probe_fields(shape, a, b, B: int, dtype, device) -> torch.Tensor:
    """Injection fields [B, *shape]: +1 at node ``a``, −1 at node ``b``
    (0 where they coincide).  A probe outside the field raises
    ``ValueError``."""
    for p in (a, b):
        if len(p) != len(shape) or any(not 0 <= int(q) < n
                                       for q, n in zip(p, shape)):
            raise ValueError(f"probe {tuple(int(q) for q in p)} outside the "
                             f"{'x'.join(map(str, shape))} field")
    rhs = torch.zeros(B, *shape, dtype=dtype, device=device)
    rhs[(slice(None), *map(int, a))] += 1.0
    rhs[(slice(None), *map(int, b))] -= 1.0
    return rhs


def unbatch(x, info: SolveInfo, batched: bool):
    if batched:
        return x, info
    return x[0], SolveInfo(*(t[0] for t in info))


# --------------------------------------------------------------- 2-D grids

def _planar(gx, gy, b=None):
    """[B, h, w-1], [B, h-1, w] (and [B, h, w]) as d = 1 lattices."""
    B, h = gx.shape[:2]
    w = gy.shape[2]
    g = (gx[:, None], gy[:, None], gx.new_zeros(B, 0, h, w))
    return g if b is None else (g, b[:, None])


def make_weighted_preconditioner(h: int, w: int, gx, gy, nu: int = 1, *,
                                 device="cuda"):
    """Galerkin-exact V(ν, ν) cycle for the weighted Neumann grid with
    conductances ``gx`` [h, w-1] / ``gy`` [h-1, w] (or a batch of them):
    ``M(r)`` on [h, w] (or [B, h, w]) fields, mean-free per sample."""
    dev = resolve_device(device, "make_weighted_preconditioner")
    dtype = torch.as_tensor(gx).dtype
    (gx, gy), batched = as_fields((gx, gy), 2, dtype, dev)
    if gx.shape[1:] != (h, w - 1) or gy.shape[1:] != (h - 1, w):
        raise ValueError(f"conductances {tuple(gx.shape)}, "
                         f"{tuple(gy.shape)} do not fit an {h}x{w} grid")
    M = lattice_preconditioner(build_levels(_planar(gx, gy), True), nu)

    def apply(r):
        r = torch.as_tensor(r, dtype=dtype, device=dev)
        single = r.dim() == 2
        out = M((r[None] if single else r)[:, None].contiguous())[:, 0]
        return out[0] if single else out

    return apply


def weighted_grid_solve(gx, gy, b, *, tol: float = 1e-7,
                        maxiter: int | None = None, mg: bool = True,
                        device="cuda"):
    """Solve the weighted-grid Neumann system ``L x = b`` (b made zero-sum)
    by the rank-one-regularized MG-CG: ``(x, SolveInfo)`` in the shape of
    ``b``, the SolveInfo fields [B] for a batch and scalars for one field.

    ``gx`` [h, w-1], ``gy`` [h-1, w] and ``b`` [h, w], each numpy or torch
    and each with or without a leading batch (a single field serves every
    sample); the dtype follows ``gx``.  Differentiable in ``gx``, ``gy`` and
    ``b`` through the implicit-function VJP (one more solve a backward).
    ``maxiter`` defaults to 300 with ``mg`` and ``20·max(h, w)`` without.
    """
    dev = resolve_device(device, "weighted_grid_solve")
    dtype = torch.as_tensor(gx).dtype
    (gx, gy, b), batched = as_fields((gx, gy, b), 2, dtype, dev)
    h, w = b.shape[1:]
    if gx.shape[1:] != (h, w - 1) or gy.shape[1:] != (h - 1, w):
        raise ValueError(f"conductances {tuple(gx.shape)}, "
                         f"{tuple(gy.shape)} do not fit b {tuple(b.shape)}")
    g, b4 = _planar(gx, gy, b)
    x, info = lattice_solve(g, b4, True, tol=tol, maxiter=maxiter, mg=mg)
    return unbatch(x[:, 0], info, batched)


def weighted_equivalent_resistance(h: int, w: int, gx, gy, a, b,
                                   tol: float = 1e-7, *, device="cuda"):
    """Two-point equivalent resistance on a weighted grid: ``a``/``b`` are
    (row, col) pairs.  Returns ``(R, residual)``, each [B] for a batch of
    conductance fields and 0-dim for one."""
    dev = resolve_device(device, "weighted_equivalent_resistance")
    dtype = torch.as_tensor(gx).dtype
    (gx, gy), batched = as_fields((gx, gy), 2, dtype, dev)
    rhs = probe_fields((h, w), a, b, gx.shape[0], dtype, dev)
    x, info = weighted_grid_solve(gx, gy, rhs, tol=tol, device=dev)
    R = x[:, int(a[0]), int(a[1])] - x[:, int(b[0]), int(b[1])]
    return (R, info.residual) if batched else (R[0], info.residual[0])

