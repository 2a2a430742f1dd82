"""Sharded solvers: a batch split over every rank of a mesh, and a grid
batch over ``dp`` with each grid's rows over ``sp``.

Counterpart of ``nodal_tpu/parallel/sharded.py``.  The batch solver is
pure data parallelism: rank r of the flattened (dp, sp) mesh solves rows
``[r·B/N, (r+1)·B/N)`` of the batch (the block ``P(("dp", "sp"))`` gives
device r in the JAX package) with the port's tier for the circuit's
structure, which on the card is its CUDA kernel, and no rank talks to
another.  The grid solver is ``grid_solve`` on the rank's samples when
``sp`` is 1, and the halo-exchange multigrid CG of
:mod:`nodal_tpu_torch.parallel.halo` when it is more: the cycle the JAX
package's GSPMD partitions, with its transfers exchanged by hand.

Every rank passes the same global batch and gets back its own block;
``mesh.batch_rows`` and ``mesh.grid_block`` say where the block lies (the
counterpart of a JAX array's ``addressable_shards``).
"""

from __future__ import annotations

import torch

from nodal_tpu_torch.batch import (_METHODS, BatchedSolver, _schur_supported,
                                   _stamps_of)
from nodal_tpu_torch.ops.assemble import bandwidth
from nodal_tpu_torch.ops.band import band_plan
from nodal_tpu_torch.ops.grid import grid_solve
from nodal_tpu_torch.ops.scalar_band import sband_plan
from nodal_tpu_torch.parallel.halo import make_halo_grid_solver
from nodal_tpu_torch.parallel.mesh import batch_rows, grid_block
from nodal_tpu_torch.utils.device import resolve_device

_PALLAS = ("auto", "on", "off")


def local_tier(stamps, method: str = "auto", refine: bool = False) -> str:
    """The tier a rank's block runs: the JAX package's shard-local choice
    (``_pallas_local_batch_solver``, ``_pallas_local_schur_solver``) for
    the structure, without its TPU memory-fit checks; where that finds no
    tier, its XLA-level branches in their order (``tridiag``, ``band``,
    then ``block`` for the rest of the resistive circuits); ``dense`` for
    ``refine`` and for everything else."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{_METHODS}")
    stamps = _stamps_of(stamps)
    if refine:
        return "dense"
    resistive = stamps.n == stamps.n_kcl
    if not resistive:
        if method in ("auto", "schur") and stamps.n_kcl >= 256 \
                and _schur_supported(stamps):
            return "schur"
        return "dense"
    bw = bandwidth(stamps)
    plan = band_plan(stamps)
    if method in ("auto", "tridiag") and bw <= 1:
        return "tridiag"
    if method in ("auto", "sband") and bw > 1 \
            and sband_plan(stamps) is not None:
        return "sband"
    if method in ("auto", "band") and plan is not None and plan.nb >= 2 \
            and (plan.kb == 128 or plan.n > 1024):
        return "band"
    if method in ("auto", "block"):
        return "block"
    if bw <= 1:
        return "tridiag"
    if plan is not None and plan.nb >= 2:
        return "band"
    return "block"


def make_sharded_batch_solver(stamps, mesh, *, dtype=torch.float32,
                              refine: bool = False, pallas: str = "auto",
                              method: str = "auto"):
    """A batch solver whose batch is split over every rank of ``mesh``
    (dp × sp as one data-parallel pool).

    Returns ``solve(params_batch [B, n_components]) -> [B/N, n]``: every
    rank passes the same global batch, B divisible by the mesh's size N,
    and gets back the solutions of its rows (``mesh.batch_rows``).  The
    rank runs ``BatchedSolver(stamps, dtype=dtype, refine=False,
    method=local_tier(...))`` on its rows: the tier's CUDA kernel on the
    card, its plain version on the CPU.  ``refine=True`` runs the dense
    core with three exact-COO f64 defect passes over f32 solves, on
    parameters kept in f64 (f64 out).  The block is differentiable:
    ``backward()`` runs the tier's own adjoint solve on the rank and
    crosses no rank.

    ``pallas``: the port has one implementation of each tier, the kernel
    on CUDA tensors and its plain version on CPU ones, so ``"auto"`` and
    ``"on"`` mean the same and ``"off"`` (the JAX package's XLA-level
    solvers) raises.
    """
    if pallas not in _PALLAS:
        raise ValueError(f"pallas must be one of {_PALLAS}, not {pallas!r}")
    if pallas == "off":
        raise ValueError("pallas='off' has no counterpart in the port: "
                         "each tier has one implementation, its kernel on "
                         "the card and its plain version on the CPU")
    stamps = _stamps_of(stamps)
    dev = resolve_device(mesh.device_type, "make_sharded_batch_solver")
    tier = local_tier(stamps, method, refine)
    local = BatchedSolver(stamps, dtype=dtype, refine=bool(refine),
                          method=tier, device=dev)
    pdtype = torch.float64 if refine else dtype

    def solve(params_batch):
        pb = torch.as_tensor(params_batch, dtype=pdtype, device=dev)
        if pb.ndim != 2:
            raise ValueError("params_batch must be [B, n_components], got "
                             f"{tuple(pb.shape)}")
        return local._solve(pb[batch_rows(pb.shape[0], mesh)])

    solve.tier = tier
    return solve


def make_sharded_grid_solver(h: int, w: int, mesh, *, dtype=torch.float32,
                             tol: float = 1e-6, maxiter: int | None = None,
                             mg: bool = True, mg_backend: str = "auto",
                             device="cuda"):
    """A batched grid solver with the batch over ``dp`` and each grid's
    rows over ``sp``.

    Returns ``solve(b_batch [B, H, W]) -> (x [B/dp, H/sp, W],
    residuals [B/dp])``: every rank passes the same global batch and gets
    back its block (``mesh.grid_block``).  With ``sp`` = 1 a rank runs
    ``ops.grid.grid_solve`` on its samples (on the card, with
    ``mg_backend="auto"``, the stencil kernels); with ``sp`` > 1 the
    halo-exchange multigrid CG, whose agglomerated levels run
    ``stencil.vcycle`` (``"auto"``) or ``stencil.vcycle_plain``
    (``"plain"``).  The default ``maxiter`` is ``grid_solve``'s.
    """
    dev = resolve_device(device, "make_sharded_grid_solver")
    if mesh.size(1) > 1:
        halo = make_halo_grid_solver(
            h, w, mesh, dtype=dtype, tol=tol,
            maxiter=maxiter if maxiter is not None else (
                200 if mg else 20 * max(h, w)),
            mg=mg, mg_backend=mg_backend, device=dev)

        def solve(b_batch):
            x, res, _ = halo(b_batch)
            return x, res

        return solve

    def solve(b_batch):
        b = torch.as_tensor(b_batch, dtype=dtype, device=dev)
        if b.dim() != 3:
            raise ValueError(f"b_batch has shape {tuple(b.shape)}, expected "
                             f"[B, {h}, {w}]")
        samples, _ = grid_block(b.shape[0], h, mesh)
        x, info = grid_solve(h, w, b[samples], dtype=dtype, tol=tol,
                             maxiter=maxiter, mg=mg, mg_backend=mg_backend,
                             device=dev)
        return x, info.residual

    return solve
