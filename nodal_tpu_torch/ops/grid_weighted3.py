"""Weighted 3-D resistor lattices: matrix-free solves with per-edge
conductances.

Counterpart of ``nodal_tpu/ops/grid_weighted3.py``: conductance fields
``gx[d, h, w-1]`` (edges along the last axis), ``gy[d, h-1, w]`` (middle
axis) and ``gz[d-1, h, w]`` (leading axis) on a d×h×w lattice, solved as
the 2-D grids are (:mod:`nodal_tpu_torch.ops.grid_weighted`, whose
[B, d, h, w] machinery this module shares): CG on ``L_g x + sum(x)/n``
with the Galerkin-exact V(ν, ν) cycle over 2×2×2 replication blocks,
batched over a leading dimension of every field, differentiable in every
conductance and ``b`` through the implicit-function VJP.  On CUDA tensors
the stencil work runs in the kernels of ``csrc/weighted_stencil.cu``.
Entry points run on the card (``device="cuda"``) unless asked for the CPU.
"""

from __future__ import annotations

import torch

from nodal_tpu_torch.ops.grid_weighted import (as_fields, build_levels,
                                               lattice_preconditioner,
                                               lattice_solve, probe_fields,
                                               unbatch)
from nodal_tpu_torch.utils.device import resolve_device


def _fields(gx, gy, gz, extra, device, who):
    """The conductances (and ``extra`` fields) as batched tensors in
    ``gx``'s dtype on the resolved device, checked against one shape."""
    dev = resolve_device(device, who)
    dtype = torch.as_tensor(gx).dtype
    (gx, gy, gz, *extra), batched = as_fields((gx, gy, gz, *extra), 3, dtype,
                                              dev)
    d, h = gx.shape[1:3]
    w = gy.shape[3]
    if (gx.shape[1:] != (d, h, w - 1) or gy.shape[1:] != (d, h - 1, w)
            or gz.shape[1:] != (d - 1, h, w)):
        raise ValueError(f"conductances {tuple(gx.shape)}, {tuple(gy.shape)}, "
                         f"{tuple(gz.shape)} do not fit one lattice")
    return (gx, gy, gz), extra, batched, dtype, dev


def make_weighted_preconditioner_3d(d: int, h: int, w: int, gx, gy, gz,
                                    nu: int = 1, *, device="cuda"):
    """Galerkin-exact V(ν, ν) cycle for the weighted Neumann lattice:
    ``M(r)`` on [d, h, w] (or [B, d, h, w]) fields, mean-free per sample."""
    g, _, _, dtype, dev = _fields(gx, gy, gz, (), device,
                                  "make_weighted_preconditioner_3d")
    if g[1].shape[1:] != (d, h - 1, w):
        raise ValueError(f"conductances do not fit a {d}x{h}x{w} lattice")
    M = lattice_preconditioner(build_levels(g, False), nu)

    def apply(r):
        r = torch.as_tensor(r, dtype=dtype, device=dev)
        single = r.dim() == 3
        out = M((r[None] if single else r).contiguous())
        return out[0] if single else out

    return apply


def weighted_lattice_solve(gx, gy, gz, b, *, tol: float = 1e-7,
                           maxiter: int | None = None, mg: bool = True,
                           device="cuda"):
    """Solve the weighted-lattice Neumann system ``L x = b`` (b made
    zero-sum) by the rank-one-regularized MG-CG: ``(x, SolveInfo)`` in the
    shape of ``b``.  Every field with or without a leading batch; the dtype
    follows ``gx``; ``maxiter`` defaults to 300 with ``mg`` and
    ``20·max(d, h, w)`` without.  Differentiable in every conductance and
    ``b``."""
    g, (b,), batched, _, _ = _fields(gx, gy, gz, (b,), device,
                                     "weighted_lattice_solve")
    if b.shape[1:] != (g[0].shape[1], g[0].shape[2], g[1].shape[3]):
        raise ValueError(f"b {tuple(b.shape)} does not fit the conductances")
    x, info = lattice_solve(g, b, False, tol=tol, maxiter=maxiter, mg=mg)
    return unbatch(x, info, batched)


def weighted_equivalent_resistance_3d(d: int, h: int, w: int, gx, gy, gz,
                                      a, b, tol: float = 1e-7, *,
                                      device="cuda"):
    """Two-point equivalent resistance on a weighted 3-D lattice: ``a``/``b``
    are (layer, row, col) triples.  Returns ``(R, residual)``, each [B] for
    a batch of conductance fields and 0-dim for one."""
    g, _, batched, dtype, dev = _fields(gx, gy, gz, (), device,
                                        "weighted_equivalent_resistance_3d")
    rhs = probe_fields((d, h, w), a, b, g[0].shape[0], dtype, dev)
    x, info = weighted_lattice_solve(*g, rhs, tol=tol, device=dev)
    R = x[(slice(None), *map(int, a))] - x[(slice(None), *map(int, b))]
    return (R, info.residual) if batched else (R[0], info.residual[0])
