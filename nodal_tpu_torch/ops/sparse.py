"""Sparse MNA path: a deduplicated COO operator and its direct or Krylov
solve.

Counterpart of ``nodal_tpu/ops/sparse.py``, the resistive (SPD) half.  The
stamp COO entries are deduplicated and row-sorted once on the host
(:func:`build_sparse_topology`, the JAX package's arrays); on the device
the parameter values fold into the deduplicated slots and the matvec is a
gather, a product and a sum over each row's entries.  Both sums run in a
fixed order (``torch.segment_reduce`` over sorted entries), not by atomic
scatter-adds, so a solve on the card is bit-reproducible.

Routes of :func:`solve_sparse_system` for a purely resistive system (the
grounded Laplacian, SPD) with ``preconditioner="auto"``:

* on the CPU, the JAX package's order: the native skyline LDLᵀ
  (:mod:`nodal_tpu_torch.ops.skyline`) first, then Jacobi-CG below
  ``_AMG_THRESHOLD_N`` unknowns and AMG-CG above;
* on CUDA, Jacobi-CG or AMG-CG on the card by the same threshold, never the
  host skyline: the port runs where it is asked.

``preconditioner="jacobi"`` or ``"amg"`` forces the Krylov route on either
device.  A system with branch equations (E, controlled sources) is not
SPD: ``general="auto"`` solves it by ideal-source reduction and bordered
elimination (:func:`nodal_tpu_torch.ops.sparse_schur.solve_general_auto`,
on the card on CUDA), ``general="krylov"`` with Jacobi-BiCGStab.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from nodal_tpu_torch.models.stamps import (StampTensors, device_table,
                                           stamp_values, stamp_values_np)
from nodal_tpu_torch.ops import skyline
from nodal_tpu_torch.ops.amg import build_hierarchy, make_amg_preconditioner
from nodal_tpu_torch.ops.assemble import assemble_rhs
from nodal_tpu_torch.ops.cg import bicgstab, cg
from nodal_tpu_torch.ops.sparse_schur import solve_general_auto
from nodal_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SparseTopology:
    """Deduplicated, row-major-sorted COO structure for one netlist."""

    n: int
    rows: np.ndarray  # int32[nnz] sorted
    cols: np.ndarray  # int32[nnz]
    entry_to_slot: np.ndarray  # int32[raw_nnz]: raw stamp entry -> slot
    diag_slot: np.ndarray  # int32[n]: slot of (i, i), or -1 if absent

    @functools.cached_property
    def offsets(self) -> np.ndarray:
        """CSR row offsets [n + 1] of the sorted slots."""
        return np.searchsorted(self.rows, np.arange(self.n + 1)).astype(
            np.int64)

    @functools.cached_property
    def fold_order(self) -> np.ndarray:
        """Raw stamp entries sorted by slot, stable: each slot sums its
        entries in netlist order."""
        return np.argsort(self.entry_to_slot, kind="stable")

    @functools.cached_property
    def fold_offsets(self) -> np.ndarray:
        """Offsets [nnz + 1] of each slot's entries in :attr:`fold_order`."""
        return np.searchsorted(self.entry_to_slot[self.fold_order],
                               np.arange(len(self.rows) + 1)).astype(
                                   np.int64)


def build_sparse_topology(stamps: StampTensors) -> SparseTopology:
    """Host-side: sort raw COO entries by (row, col) and merge duplicates."""
    key = stamps.g_rows.astype(np.int64) * stamps.n + stamps.g_cols
    uniq, inverse = np.unique(key, return_inverse=True)
    rows = (uniq // stamps.n).astype(np.int32)
    cols = (uniq % stamps.n).astype(np.int32)
    diag_slot = np.full(stamps.n, -1, dtype=np.int32)
    on_diag = rows == cols
    diag_slot[rows[on_diag]] = np.nonzero(on_diag)[0].astype(np.int32)
    return SparseTopology(
        n=stamps.n,
        rows=rows,
        cols=cols,
        entry_to_slot=inverse.astype(np.int32),
        diag_slot=diag_slot,
    )


def _topology(stamps: StampTensors) -> SparseTopology:
    cached = stamps.__dict__.get("_sparse_topology")
    if cached is None:
        cached = stamps.__dict__["_sparse_topology"] = \
            build_sparse_topology(stamps)
    return cached


def sparse_values(topo: SparseTopology, stamps: StampTensors,
                  params: torch.Tensor) -> torch.Tensor:
    """Fold the raw stamp values of ``[n_components]`` params into the
    deduplicated slots, [nnz], on the params' device."""
    g_vals, _ = stamp_values(stamps, params)
    dev = params.device
    order = device_table(topo, "fold_order", topo.fold_order, dev,
                         torch.long)
    offs = device_table(topo, "fold_offsets", topo.fold_offsets, dev,
                        torch.long)
    return torch.segment_reduce(g_vals[order], "sum", offsets=offs)


def coo_matvec(topo: SparseTopology, vals: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``y = G x`` for ``x`` [..., n]: gather, product, and a sum over each
    (sorted) row's slots in order."""
    dev = x.device
    cols = device_table(topo, "cols", topo.cols, dev, torch.long)
    offs = device_table(topo, "offsets", topo.offsets, dev, torch.long)
    lead = x.shape[:-1]
    xf = x.reshape(-1, topo.n)
    prods = vals * xf[:, cols]
    y = torch.segment_reduce(prods, "sum",
                             offsets=offs.expand(xf.shape[0], -1), axis=1)
    return y.reshape(lead + (topo.n,))


def jacobi_preconditioner(topo: SparseTopology, vals: torch.Tensor):
    """Inverse-diagonal preconditioner; identity on empty/zero diagonals
    (voltage-source branch rows)."""
    slot = device_table(topo, "diag_slot", topo.diag_slot, vals.device,
                        torch.long)
    diag = torch.where(slot >= 0, vals[slot.clamp(min=0)], 0.0)
    inv = torch.where(diag.abs() > 0,
                      1.0 / torch.where(diag == 0, 1.0, diag), 1.0)

    def M(r):
        return r * inv

    return M


# Auto preconditioner policy: below this unknown count, Jacobi-CG's cheap
# iterations beat AMG's per-cycle cost (measured at 40k nodes on the TPU:
# AMG cuts iterations 14x — 79 vs 1140 — but lost on wall clock on a cold
# start); above it, iteration counts grow with graph diameter and AMG wins
# outright.  A TPU-era number; chip_smoke.py's randnet40k runs both routes
# on the card.
_AMG_THRESHOLD_N = 100_000


class SparseSolveInfo(NamedTuple):
    residual: float    # ||b − G x||₂ / ||b||₂ (skyline: max-norm, scaled)
    iterations: int    # Krylov iterations; 1 for the direct route
    converged: bool
    method: str        # "skyline" or "krylov"
    preconditioner: str | None  # "jacobi" or "amg" on the Krylov route


def spd_factor(stamps: StampTensors, topo: SparseTopology,
               params: np.ndarray):
    """``(factor, g_vals)`` of the skyline LDLᵀ of the system of the
    ``params`` (host f64), or None when the profile is over the caps or a
    pivot is not positive.  The plan and the factor are cached on the
    stamps (the factor per value fingerprint), so repeat solves and probe
    sweeps pay one backsolve each.  A library that does not build
    raises."""
    if "_spd_skyline_plan" not in stamps.__dict__:
        stamps.__dict__["_spd_skyline_plan"] = skyline.plan_skyline(
            stamps.n, topo.rows, topo.cols)
    plan = stamps.__dict__["_spd_skyline_plan"]
    if plan is None:
        return None
    g_vals, _ = stamp_values_np(stamps, params)
    key = g_vals.tobytes()
    cache = stamps.__dict__.get("_spd_skyline_fact")
    if cache is not None and cache[0] == key:
        fact = cache[1]
    else:
        fact = skyline.factor(plan, stamps.g_rows, stamps.g_cols, g_vals)
        stamps.__dict__["_spd_skyline_fact"] = (key, fact)
    return None if fact is None else (fact, g_vals)


def _solve_spd_skyline(stamps: StampTensors, topo: SparseTopology,
                       params: np.ndarray, rhs):
    """Host-direct solve of a purely resistive system through the skyline
    LDLᵀ, or None to fall through to Krylov.  ``(x [n] f64 numpy,
    SparseSolveInfo)``; the residual is ``max|b − G x| / max(max|b|,
    1)``."""
    if stamps.n == 0:
        return None
    got = spd_factor(stamps, topo, params)
    if got is None:
        return None
    fact, g_vals = got
    if rhs is None:
        b = assemble_rhs(stamps, torch.as_tensor(params)[None])[0].numpy()
    else:
        b = torch.as_tensor(rhs, dtype=torch.float64).cpu().numpy()
    x = skyline.solve(fact, b)
    y = np.zeros(stamps.n)
    with np.errstate(invalid="ignore"):
        np.add.at(y, stamps.g_rows.astype(np.int64),
                  g_vals * x[stamps.g_cols.astype(np.int64)])
    b_scale = max(float(np.max(np.abs(b))), 1.0)
    rel = float(np.max(np.abs(b - y))) / b_scale
    return x, SparseSolveInfo(rel, 1, bool(np.isfinite(rel)), "skyline",
                              None)


def solve_sparse_system(stamps: StampTensors, params, dtype=torch.float64,
                        tol: float | None = None, rhs=None,
                        preconditioner: str = "auto", general: str = "auto",
                        device="cuda"):
    """Solve the full MNA system sparsely on ``device``.  Returns ``(x [n]
    tensor of dtype on device, SparseSolveInfo)``, or ``GeneralSolveInfo``
    from the bordered elimination of a system with branch equations.

    ``params`` are the component values (numpy or tensor, [n_components]);
    ``rhs`` overrides the netlist's own source vector (the equivalent-
    resistance probe injection).  ``tol`` defaults to 1e-10 in f64 and 1e-6
    in f32; the Krylov routes stop at ||r|| <= tol·||b|| or 20·n
    iterations; the bordered elimination solves in f64 to the relative
    residual ``max(tol, 1e-12)`` and casts x to ``dtype``.
    """
    if preconditioner not in ("auto", "jacobi", "amg"):
        raise ValueError(f"unknown preconditioner {preconditioner!r}")
    if general not in ("auto", "krylov"):
        raise ValueError(f"unknown general solver {general!r}")
    dev = resolve_device(device, "solve_sparse_system")
    spd = stamps.n == stamps.n_kcl  # no branch equations -> SPD Laplacian
    if not spd and general != "krylov":
        gtol = tol
        if gtol is None:
            gtol = 1e-10 if dtype == torch.float64 else 1e-6
        x, info = solve_general_auto(
            stamps,
            torch.as_tensor(params, dtype=torch.float64).cpu().numpy(),
            rhs=None if rhs is None else torch.as_tensor(
                rhs, dtype=torch.float64).cpu().numpy(),
            tol=max(float(gtol), 1e-12), device=dev)
        return torch.as_tensor(x, dtype=dtype, device=dev), info
    topo = _topology(stamps)
    if spd and preconditioner == "auto" and dev.type == "cpu":
        direct = _solve_spd_skyline(
            stamps, topo,
            torch.as_tensor(params, dtype=torch.float64).cpu().numpy(), rhs)
        if direct is not None:
            x, info = direct
            return torch.as_tensor(x, dtype=dtype), info

    p = torch.as_tensor(params, dtype=dtype, device=dev)
    if tol is None:
        tol = 1e-10 if dtype == torch.float64 else 1e-6
    if preconditioner == "auto":
        preconditioner = ("amg" if spd and stamps.n >= _AMG_THRESHOLD_N
                          else "jacobi")
    vals = sparse_values(topo, stamps, p)
    if rhs is None:
        b = assemble_rhs(stamps, p[None])
    else:
        b = torch.as_tensor(rhs, dtype=dtype, device=dev).reshape(1, -1)

    if preconditioner == "amg":
        if not spd:
            raise ValueError("AMG preconditioning requires an SPD system")
        g_np, _ = stamp_values_np(
            stamps, torch.as_tensor(params, dtype=torch.float64)
            .cpu().numpy())
        # Sums each slot's entries in entry order, as np.add.at does.
        merged = np.bincount(topo.entry_to_slot, weights=g_np,
                             minlength=len(topo.rows))
        levels = build_hierarchy(stamps.n, topo.rows, topo.cols, merged)
        M = make_amg_preconditioner(levels, dtype, dev)
        solver = cg
    else:
        M = jacobi_preconditioner(topo, vals)
        solver = cg if spd else bicgstab
    x, info = solver(lambda x: coo_matvec(topo, vals, x), b,
                     preconditioner=M, tol=tol, maxiter=20 * stamps.n)
    return x[0], SparseSolveInfo(float(info.residual[0]),
                                 int(info.iterations[0]),
                                 bool(info.converged[0]), "krylov",
                                 preconditioner)
