"""Batched parameter sweeps: many parameter vectors through one topology.

Counterpart of ``nodal_tpu/batch.py``.  A netlist topology compiles once;
a sweep is a ``[B, n_components]`` params tensor whose leading dimension
is the batch (the JAX package's ``vmap``).  Typical use:

    circuit = Circuit(netlist)
    solver = BatchedSolver(circuit, device="cuda")
    xs = solver(params_batch)                          # [B, n] solutions

Every tier of the JAX package's ``BatchedSolver`` is ported: ``tridiag``
(chain and ladder topologies: band assembly, then the CUDA PCR kernel of
:mod:`nodal_tpu_torch.ops.pcr`), ``sband`` (narrow-band resistive circuits
such as 2-D meshes: scalar band assembly, then the CUDA scalar-band LDLᵀ
kernel of :mod:`nodal_tpu_torch.ops.sband`), ``band`` (wider resistive
bands such as large meshes and 3-D lattices: block-band assembly, then the
CUDA block-Thomas kernel of :mod:`nodal_tpu_torch.ops.block_thomas`),
``block`` (unbanded resistive circuits: dense assembly, then the CUDA
blocked-LU kernel of :mod:`nodal_tpu_torch.ops.lu`), ``schur``
(branch-equation circuits with an SPD node block: one of those kernels
with the border columns as extra right-hand sides) and ``dense`` (what is
left: the library's pivoted LU), the exact-f64 defect-correction
contract layer that ``refine="auto"`` wraps around each, and the adjoint
(:func:`make_adjoint_solver`) that makes every tier differentiable.  On
top of them: :func:`sweep`, :func:`monte_carlo` (component-tolerance
sweeps with an f64 residual audit) and :func:`sensitivities` (one solve
plus one adjoint solve for the derivative of an output by every
component).

Device policy: a solver runs on the device it is given (default
``"cuda"``, which raises when CUDA is absent).  Every tensor of a solve,
the f64 audit included, stays on that device.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from collections.abc import Callable

import numpy as np
import torch

from nodal_tpu_torch.circuit import Circuit
from nodal_tpu_torch.models.stamps import (StampTensors, device_table,
                                           stamp_values, stamp_values_np)
from nodal_tpu_torch.ops import dense_solve
from nodal_tpu_torch.ops.assemble import (assemble_dense, assemble_tridiag,
                                          bandwidth, gather_fold)
from nodal_tpu_torch.ops.band import band_plan, node_band_plan
from nodal_tpu_torch.ops.block_lu import _BLOCK, schur_eliminate
from nodal_tpu_torch.ops.block_thomas import (MAX_R, band_factor,
                                              band_solve, band_solve_multi,
                                              band_substitute)
from nodal_tpu_torch.ops.lu import lu_factor, lu_solve_factored
from nodal_tpu_torch.ops.pcr import pcr_solve
from nodal_tpu_torch.ops.sband import (sband_fits, sband_solve,
                                       sband_solve_multi)
from nodal_tpu_torch.ops.scalar_band import (MAX_W, node_sband_plan,
                                             sband_plan)
from nodal_tpu_torch.ops.sparse_schur import (
    general_auto_viable, general_sparse_adjoint_gradient)
from nodal_tpu_torch.utils import tracing
from nodal_tpu_torch.utils.device import resolve_device

#: Rows with at most this many COO entries fold in one slot row each (the
#: gather-fold pass reads ``width`` slots per output row); a wider row
#: folds as a segment of the entries sorted by row.
_RESID_FOLD_MAX_WIDTH = 16

#: The default accuracy contract: node voltages within 1e-6 *of the f64
#: reference*, an error bound, not a residual bound.
_CONTRACT_TOL = 1e-6

#: Escalation pass cap: each exact-COO defect correction contracts the
#: error by about the f32 tier's own relative error; the cap only bites for
#: near-divergent systems, which then take the pivoted rescue.
_ESCALATE_MAX_PASSES = 4

#: Safety factor on the predicted post-pass error ‖dx‖·ρ̂.  ρ̂ is the raw
#: solve's relative error, but a correction solves for the residual, whose
#: f32 solve can be less accurate: on the 100×100 mesh grounded at one
#: corner (κ·ε₃₂ ≈ 1e-3) the block-Thomas kernel's raw error of 7.5e-4
#: predicted 5.6e-7 after one pass, and a sample ended 1.08e-6 from the f64
#: answer (chip_smoke.py on an NVIDIA H100).  A pass more is taken whenever
#: the prediction is within this factor of the contract.
_ESTIMATE_MARGIN = 4.0

#: Samples that defect correction cannot repair are re-solved by pivoted
#: dense f64 LU, in chunks of at most this many bytes of matrices.  Above
#: this n the dense rescue is skipped and such samples keep their values.
_ESCALATE_DENSE_MAX_N = 4096
_ESCALATE_CHUNK_BYTES = 1 << 28

#: Auto-selection refuses the dense tiers above this many unknowns (the
#: JAX package's bound: a batch of [n, n] systems does not fit).
_DENSE_BATCH_MAX_N = 16384

#: The node-block SPD probe of the schur tier is a dense f64 Cholesky up to
#: this many nodes and a banded Cholesky on the block-band plan past it.
_SCHUR_DENSE_PROBE_MAX_NK = 8192

_METHODS = ("auto", "tridiag", "sband", "band", "block", "schur", "dense")

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class _RowFold:
    """COO entries folded into their rows in a fixed order, with no atomics.

    Narrow (``offsets`` None): ``ids`` [n, w], w at most
    ``_RESID_FOLD_MAX_WIDTH``, are row i's entries (indices into the value
    vector) and ``valid`` their 1.0/0.0 slot mask, summed by ``sum(-1)``.
    Wide: ``ids`` [nnz] are the entries sorted by row, stably, and row i
    their segment ``offsets[i]:offsets[i + 1]``, which
    ``torch.segment_reduce`` sums left to right, one thread a row and
    sample on the card.  Either way a row's sum depends neither on the
    batch nor on the device's scheduling.
    """

    ids: np.ndarray
    valid: np.ndarray | None = None
    offsets: np.ndarray | None = None


def _row_fold(rows: np.ndarray, n: int) -> _RowFold:
    """The :class:`_RowFold` of entries landing on ``rows`` [nnz]: narrow
    when no row takes more than ``_RESID_FOLD_MAX_WIDTH``, else wide."""
    nnz = len(rows)
    counts = np.bincount(rows, minlength=n)
    width = int(counts.max()) if nnz else 1
    order = np.argsort(rows, kind="stable")
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    if width > _RESID_FOLD_MAX_WIDTH:
        return _RowFold(order, offsets=np.append(offsets, nnz))
    pos = np.arange(nnz, dtype=np.int64) - offsets[rows[order]]
    ids = np.zeros((n, max(width, 1)), dtype=np.int32)
    valid = np.zeros((n, max(width, 1)), dtype=np.float64)
    ids[rows[order], pos] = order
    valid[rows[order], pos] = 1.0
    return _RowFold(ids, valid)


def _resid_gather_tables(stamps: StampTensors):
    """The residual's fold tables ``(g_fold, x_cols, rhs_fold)``: the
    :class:`_RowFold` of the G entries over their rows, each slot's column
    as an index into x, and the fold of the RHS entries.  Built vectorized
    (argsort + cumcount) and cached on the StampTensors as numpy.
    """
    cached = stamps.__dict__.get("_resid_gf")
    if cached is not None:
        return cached
    g = _row_fold(stamps.g_rows.astype(np.int64), stamps.n)
    if g.offsets is None:
        x_cols = np.zeros_like(g.ids)
        x_cols[g.valid > 0] = stamps.g_cols[
            g.ids[g.valid > 0].astype(np.int64)]
    else:
        x_cols = stamps.g_cols[g.ids]
    out = (g, x_cols, _row_fold(stamps.rhs_rows.astype(np.int64), stamps.n))
    stamps.__dict__["_resid_gf"] = out
    return out


def _fold_rows(stamps: StampTensors, key: str, fold: _RowFold,
               vals: torch.Tensor, xs: torch.Tensor | None = None,
               cols: np.ndarray | None = None) -> torch.Tensor:
    """[B, n]: each row's entries of ``vals`` [B, nnz], each times
    ``xs[:, col]`` when ``xs`` is given, summed as ``fold`` orders them;
    the device tables are cached on the stamps under ``key``."""
    dev = vals.device
    ids = device_table(stamps, f"{key}_ids", fold.ids, dev, torch.long)
    if xs is not None:
        cols = device_table(stamps, f"{key}_cols", cols, dev, torch.long)
    if fold.offsets is None:
        w = device_table(stamps, f"{key}_valid", fold.valid, dev, vals.dtype)
        t = vals[:, ids] * w
        return (t if xs is None else t * xs[:, cols]).sum(-1)
    t = vals[:, ids]
    if xs is not None:
        t.mul_(xs[:, cols])
    offsets = device_table(stamps, f"{key}_offsets", fold.offsets, dev,
                           torch.long)
    # unsafe: no check of the offsets, which would read them on the host.
    return torch.segment_reduce(t, "sum", offsets=offsets.expand(len(t), -1),
                                axis=1, unsafe=True)


def _coo_apply(stamps: StampTensors, g_vals: torch.Tensor,
               xs: torch.Tensor) -> torch.Tensor:
    """``y = G·x`` straight from the COO stamp entries — no matrix built —
    as a fixed-order fold of each row's entries (:class:`_RowFold`)."""
    g, x_cols, _ = _resid_gather_tables(stamps)
    return _fold_rows(stamps, "resid", g, g_vals, xs, x_cols)


def _coo_rhs_vec(stamps: StampTensors, rhs_vals: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
    """Natural-order RHS vector ``b`` from the COO RHS entries; ``like``
    fixes the [B, n] output shape, dtype and device."""
    if not len(stamps.rhs_rows):
        return torch.zeros_like(like)
    _, _, rhs = _resid_gather_tables(stamps)
    return _fold_rows(stamps, "resid_rhs", rhs, rhs_vals)


def _coo_residuals(stamps: StampTensors, params_batch: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """Relative residuals ``max|b − G·x| / max(max|b|, 1)`` per sample,
    straight from the COO stamp entries (no matrix built), O(B·nnz), in the
    dtype of the inputs."""
    g_vals, rhs_vals = stamp_values(stamps, params_batch)
    y = _coo_apply(stamps, g_vals, xs)
    b = _coo_rhs_vec(stamps, rhs_vals, xs)
    return (b - y).abs().amax(dim=1) / b.abs().amax(dim=1).clamp_min(1.0)


@dataclasses.dataclass(frozen=True)
class _Operator:
    """A batched tier in prepared form, in one working dtype.

    ``prepare(pb) -> resolve(rhs=None)`` assembles (and factors) the
    systems of a params batch once; ``resolve`` solves them for the
    stamped right-hand side (``rhs=None``) or a given natural-order one,
    [B, n] -> [B, n], as often as asked.  ``prepare_t`` is the same for
    the transposed systems (``prepare`` itself for the symmetric resistive
    tiers).  ``passes`` is the fixed number of defect passes that
    ``refine=True`` takes on this tier.  ``once``, where set, is the pair
    ``(prepare, prepare_t)`` for a call that solves once: it holds nothing
    for a later solve (the ``band`` tier's kept elimination).
    """

    prepare: Callable
    prepare_t: Callable
    passes: int
    once: tuple | None = None


class _DefectPass:
    """Exact-f64 defect correction against the COO operator, for one run.

    The f64 stamp values and ``b64`` (the given natural-order RHS, or the
    stamped one) are formed once.  A call is one pass with the f32 solve
    ``resolve``: ``dx = resolve(b64 − G·x)``, returning ``(x + dx, dx)``.
    Refining against the COO entries rather than the assembled,
    f32-rounded matrix is what buys true f64 accuracy instead of a floor
    set by assembly rounding.
    """

    def __init__(self, stamps: StampTensors, params_batch: torch.Tensor,
                 rhs, x: torch.Tensor):
        self.stamps = stamps
        self.g_vals, rhs_vals = stamp_values(stamps,
                                             params_batch.to(torch.float64))
        self.b64 = (_coo_rhs_vec(stamps, rhs_vals, x) if rhs is None
                    else rhs.to(torch.float64))

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        return self.b64 - _coo_apply(self.stamps, self.g_vals, x)

    def __call__(self, x: torch.Tensor, resolve):
        tracing.count("contract_passes")
        dx = resolve(self.residual(x).to(torch.float32)).to(torch.float64)
        return x + dx, dx


def _refined_solver(stamps: StampTensors, prepare, passes: int,
                    transpose: bool = False):
    """The ``refine=True`` policy: the f32 operator ``prepare`` prepared
    once a run, its solve, then ``passes`` defect passes on it; f64 out."""
    st = _transposed_stamps(stamps) if transpose else stamps

    def solve_batch(params_batch, rhs=None):
        resolve = prepare(params_batch)
        x = resolve(rhs).to(torch.float64)
        defect = _DefectPass(st, params_batch, rhs, x)
        for _ in range(passes):
            x, _ = defect(x, resolve)
        return x

    return solve_batch


def _escalating_solver(stamps: StampTensors, prepare,
                       transpose: bool = False):
    """The ``refine="auto"`` policy: f32 solves + exact-f64-COO defect
    correction until a correction-based ERROR estimate meets the 1e-6
    contract.

    ``prepare(pb) -> resolve(rhs=None)`` is the tier's f32 operator (the
    transposed one for ``transpose=True``, whose callers always give
    ``rhs``, in natural order).  It is prepared once a run, and every
    pass solves on it.

    Why error, not residual: the f32 solves are backward-stable, so their
    residual sits at ~ε₃₂ whatever the conditioning while the error is
    κ(A)·ε₃₂.  The correction ``dx = Ã⁻¹(b − A x_k)`` estimates the
    current error, and successive corrections contract by the solver's own
    relative error ρ.  So one pass always runs, and more follow while the
    predicted post-pass error ``‖dx‖·ρ̂``, times ``_ESTIMATE_MARGIN``,
    exceeds ``_CONTRACT_TOL``.
    Samples still off the contract afterwards (a failed no-pivot
    factorization, e.g. a zero pivot) are re-solved by pivoted f64 LU.
    Output is f64.
    """
    st = _transposed_stamps(stamps) if transpose else stamps

    def run(params_batch, rhs=None):
        with tracing.span("contract.run", params_batch):
            return _run(params_batch, rhs)

    def _run(params_batch, rhs):
        with tracing.span("tier.solve", params_batch):
            resolve = prepare(params_batch)
            x = resolve(rhs)
        x = x.to(torch.float64)
        defect = _DefectPass(st, params_batch, rhs, x)
        b_scale = defect.b64.abs().amax(dim=1).clamp_min(1.0)

        def solve(r):
            with tracing.span("tier.solve", params_batch):
                return resolve(r)

        def correct(x):
            """One defect pass: (x+dx, dx_rel), dx_rel the worst
            per-sample ‖dx‖∞/‖x‖∞ — the error estimate of x."""
            with tracing.span("contract.pass"):
                x_next, dx = defect(x, solve)
                x_scale = x.abs().amax(dim=1).clamp_min(1e-30)
                # The loop condition reads this scalar on the host: one
                # device synchronisation per pass.
                tracing.count("host_syncs")
                dx_rel = float((dx.abs().amax(dim=1) / x_scale).max())
            return x_next, dx_rel

        # Pass 1, unconditional: dx₁ estimates the raw solve's error, which
        # for a single solve is the contraction factor ρ.
        x, dx_rel = correct(x)
        rho, k = dx_rel, 1
        while (dx_rel * rho * _ESTIMATE_MARGIN > _CONTRACT_TOL
               and math.isfinite(dx_rel) and k < _ESCALATE_MAX_PASSES):
            x, dx_new = correct(x)
            # Measured contraction; ≥1 means divergence — keep 1.0 so the
            # loop runs to the cap and hands off to the rescue.
            rho = min(dx_new / max(dx_rel, 1e-300), 1.0)
            dx_rel, k = dx_new, k + 1
        # The prepared operator goes before the rescue, whose peak it
        # would raise.
        del resolve

        if stamps.n > _ESCALATE_DENSE_MAX_N:
            return x
        rel_s = defect.residual(x).abs().amax(dim=1) / b_scale
        bad = (rel_s > _CONTRACT_TOL) | ~torch.isfinite(rel_s)
        # Host synchronisation: which samples take the pivoted rescue.
        tracing.count("host_syncs")
        idx = torch.nonzero(bad).flatten()
        tracing.count("rescued_samples", idx.numel())
        if idx.numel():
            rescue = _dense_operator(stamps, torch.float64)
            rescue = rescue.prepare_t if transpose else rescue.prepare
            chunk = max(1, _ESCALATE_CHUNK_BYTES // (stamps.n * stamps.n * 8))
            for lo in range(0, idx.numel(), chunk):
                sel = idx[lo:lo + chunk]
                x[sel] = rescue(params_batch[sel])(
                    None if rhs is None else rhs[sel])
        return x

    return run


def _contract_layer(stamps: StampTensors, build, dtype, refine):
    """The precision policy, the one reader of ``refine``:
    ``(operator, solve_batch, solve_rhs_t)`` for the tier whose
    :class:`_Operator` ``build(working_dtype)`` builds.

    * Raw (``refine=False``, or ``"auto"`` with f64): the operator in
      ``dtype``, prepared and solved once a call (its ``once`` form where
      it has one).
    * ``refine=True``: the f32 operator and the tier's fixed number of
      exact-f64 defect passes (:func:`_refined_solver`); f64 out.
    * ``refine="auto"`` with f32: the f32 operator in the escalating
      contract layer (:func:`_escalating_solver`); f64 out.

    ``solve_batch(pb, rhs=None)`` solves G x = b (or the given
    natural-order RHS), ``solve_rhs_t(pb, rhs)`` the transposed system.
    """
    if not refine or (refine == "auto" and dtype != torch.float32):
        op = build(dtype)
        prepare, prepare_t = op.once or (op.prepare, op.prepare_t)
        return (op, lambda pb, rhs=None: prepare(pb)(rhs),
                lambda pb, rhs: prepare_t(pb)(rhs))
    op = build(torch.float32)
    if refine == "auto":
        return (op, _escalating_solver(stamps, op.prepare),
                _escalating_solver(stamps, op.prepare_t, transpose=True))
    return (op, _refined_solver(stamps, op.prepare, op.passes),
            _refined_solver(stamps, op.prepare_t, op.passes,
                            transpose=True))


def _dense_operator(stamps: StampTensors, dtype) -> _Operator:
    """The dense pivoted-LU MNA solve: the ``dense`` tier and (f64) the
    contract layer's rescue.

    ``prepare`` assembles G and b once, at the wider of the params' dtype
    and ``dtype``, then rounds them to ``dtype`` (the JAX package's
    variant: an f64 solver with ``refine=True`` rounds its f64 matrices to
    f32); ``resolve`` is ``torch.linalg.solve`` on them.  The
    factorization is the library's pivoted LU, as XLA's is in the JAX
    package: no TPU kernel of the repo computes it, so this is no kernel
    port.
    """

    def prepare(params_batch, transpose=False):
        G, b = assemble_dense(
            stamps, params_batch,
            dtype=torch.promote_types(params_batch.dtype, dtype))
        if transpose:
            G = G.transpose(1, 2)
        G, b = G.to(dtype), b.to(dtype)

        def resolve(rhs=None):
            r = b if rhs is None else rhs.to(dtype)
            return dense_solve.solve_dense(G, r.unsqueeze(-1)).squeeze(-1)

        return resolve

    return _Operator(prepare, functools.partial(prepare, transpose=True),
                     passes=3)


class _AdjointSolve(torch.autograd.Function):
    """The implicit-function VJP of :func:`make_adjoint_solver`."""

    @staticmethod
    def forward(ctx, params_batch, stamps, solve_batch, solve_rhs_t):
        # Autograd never sees the inside of the solve, whose kernels have no
        # autograd rule and whose plain versions update in place.
        with torch.no_grad():
            x = solve_batch(params_batch)
        ctx.save_for_backward(params_batch, x)
        ctx.stamps, ctx.solve_rhs_t = stamps, solve_rhs_t
        return x

    @staticmethod
    def backward(ctx, xbar):
        pb, x = ctx.saved_tensors
        stamps = ctx.stamps
        lam = ctx.solve_rhs_t(pb, xbar.contiguous())
        wd = torch.promote_types(lam.dtype, x.dtype)
        lam, x = lam.to(wd), x.to(wd)
        dev = x.device
        g_rows, g_cols, rhs_rows = (
            device_table(stamps, name, getattr(stamps, name), dev, torch.long)
            for name in ("g_rows", "g_cols", "rhs_rows"))
        gbar = -(lam[:, g_rows] * x[:, g_cols])
        rhsbar = lam[:, rhs_rows]
        with torch.enable_grad():
            p = pb.detach().requires_grad_()
            g_vals, rhs_vals = stamp_values(stamps, p)
            (pbar,) = torch.autograd.grad(
                (g_vals, rhs_vals), p, (gbar.to(p.dtype), rhsbar.to(p.dtype)))
        return pbar.to(pb.dtype), None, None, None


def make_adjoint_solver(stamps: StampTensors, solve_batch, solve_rhs_t):
    """Implicit-function VJP around a batched MNA solve: the counterpart of
    the JAX package's ``custom_vjp``.

    ``solve_batch(pb) -> x`` solves ``G(p)·x = b(p)`` per batch row;
    ``solve_rhs_t(pb, rhs) -> λ`` solves the transposed system against a
    natural-order RHS.  The forward pass runs ``solve_batch`` outside
    autograd; reverse mode is one adjoint solve ``Gᵀλ = x̄`` (the same
    kernels: resistive operators are symmetric, branch-equation ones
    transpose by swapping the Schur border), cast to the promoted working
    dtype, then the COO chain rule ``v̄_G[e] = −λ[row_e]·x[col_e]``,
    ``v̄_rhs[e] = λ[row_e]``, pulled back to the parameters through
    ``stamp_values``'s own autograd.  The gradient comes back in the
    parameters' dtype.  Cost: one extra solve a backward pass.  Reverse
    mode only; a second derivative is not supported.
    """

    def solve(params_batch):
        return _AdjointSolve.apply(params_batch, stamps, solve_batch,
                                   solve_rhs_t)

    return solve


def _transposed_stamps(stamps: StampTensors) -> StampTensors:
    """A view of the stamps with G's rows/cols swapped (Gᵀ), for transposed
    solves.  The RHS template is untouched — transpose callers always
    supply an explicit RHS.  Cached; the copy carries its own caches."""
    cached = stamps.__dict__.get("_transposed")
    if cached is None:
        cached = dataclasses.replace(
            stamps, g_rows=stamps.g_cols, g_cols=stamps.g_rows)
        stamps.__dict__["_transposed"] = cached
    return cached


def _stamps_of(circuit_or_stamps) -> StampTensors:
    """Accept a Circuit or bare StampTensors."""
    stamps = getattr(circuit_or_stamps, "stamps", circuit_or_stamps)
    if not isinstance(stamps, StampTensors):
        raise TypeError(
            f"expected Circuit or StampTensors, got {type(circuit_or_stamps)}"
            " (convert a nodal_tpu StampTensors with stamps_from_reference)"
        )
    return stamps


def _tridiag_operator(stamps: StampTensors, dtype) -> _Operator:
    """The ``tridiag`` tier: the three bands assembled once
    (:func:`assemble_tridiag`), then parallel cyclic reduction on them
    (:func:`pcr_solve`: the CUDA kernel on the card, the plain torch PCR
    for CPU tensors), which does not write its bands."""

    def prepare(params_batch):
        dl, d, du, b = assemble_tridiag(stamps, params_batch, dtype=dtype)

        def resolve(rhs=None):
            rb = b if rhs is None else rhs.to(dtype).contiguous()
            return pcr_solve(dl, d, du, rb)

        return resolve

    # Resistive ⇒ symmetric operator: the transposed solve is the same
    # solve with the given RHS.
    return _Operator(prepare, prepare, passes=2)


def _band_operator(stamps: StampTensors, plan, solve, dtype) -> _Operator:
    """A banded resistive tier: ``sband`` (a scalar-band plan and
    ``sband_solve``), or ``band`` for a call that solves once (a
    :class:`~nodal_tpu_torch.ops.band.BandPlan` and ``band_solve``, the
    block-Thomas kernel; :func:`_thomas_operator`'s ``once``).

    ``prepare`` assembles the band once; ``resolve`` runs the kernel on
    it (f64 runs the kernel's f64 instantiation on the card).  Neither
    kernel writes its band.  Under the f64 defect passes the band is
    never materialised in f64: they read the stamp entries (O(B·nnz))
    instead of an f64 copy of the band, which would be the largest tensor
    of the call.
    """

    def prepare(params_batch):
        with tracing.span("band.assemble", params_batch):
            W, b = plan.assemble(stamps, params_batch, dtype=dtype)
            tracing.count("band_assemblies")

        def resolve(rhs=None):
            rb = b if rhs is None else plan.rhs_to_band(rhs, dtype)
            return plan.unpermute(solve(W, rb))

        return resolve

    return _Operator(prepare, prepare, passes=2)  # symmetric


def _thomas_operator(stamps: StampTensors, plan, dtype) -> _Operator:
    """The ``band`` tier: a :class:`~nodal_tpu_torch.ops.band.BandPlan`
    and the block-Thomas kernels.

    ``prepare`` assembles the band once.  The first ``resolve`` eliminates
    and keeps every S_t⁻¹ and C_t where they fit (``band_factor``: kb =
    128 and at most ``SCRATCH_BYTES_MAX``, ~2.2 GB at the lattice's B 1024
    in f32), and each later one only substitutes on them
    (``band_substitute``), in the bits of a fresh solve; the contract
    layer's ``del resolve`` frees them.  Where nothing is kept, each
    ``resolve`` eliminates again.  A call that solves once takes ``once``,
    :func:`_band_operator` on the same plan, which keeps nothing.
    """

    def prepare(params_batch):
        with tracing.span("band.assemble", params_batch):
            W, b = plan.assemble(stamps, params_batch, dtype=dtype)
            tracing.count("band_assemblies")
        held = None

        def resolve(rhs=None):
            nonlocal held
            rb = b if rhs is None else plan.rhs_to_band(rhs, dtype)
            R = rb.unsqueeze(-1).contiguous()
            if held is None:
                X, held = band_factor(W, R)
            else:
                X = band_substitute(held, R)
            return plan.unpermute(X[..., 0])

        return resolve

    once = _band_operator(stamps, plan, band_solve, dtype).prepare
    return _Operator(prepare, prepare, passes=2, once=(once, once))


def _block_operator(stamps: StampTensors, dtype) -> _Operator:
    """The ``block`` tier: dense assembly straight into the 128-padded
    shape and the no-pivot blocked LU factorization (:func:`lu_factor`),
    once; each solve is :func:`lu_solve_factored` on the factor, then the
    first n unknowns.  The CUDA kernel on the card (f64 runs its f64
    instantiation), the plain ``blocked_factor`` /
    ``blocked_solve_factored`` on the CPU.  The assembly is a
    ``dense.assemble`` span, counted by ``dense_assemblies``.
    """
    n = stamps.n
    n_pad = -(-n // _BLOCK) * _BLOCK

    def prepare(params_batch):
        with tracing.span("dense.assemble", params_batch):
            G, b = assemble_dense(stamps, params_batch, dtype=dtype,
                                  pad_to=n_pad)
            tracing.count("dense_assemblies")
        F = lu_factor(G)
        del G  # on the card F is G, factored in place

        def resolve(rhs=None):
            R = b.unsqueeze(-1) if rhs is None else torch.nn.functional.pad(
                rhs.to(dtype), (0, n_pad - n)).unsqueeze(-1)
            return lu_solve_factored(F, R)[:, :n, 0]

        return resolve

    return _Operator(prepare, prepare, passes=2)  # symmetric


def _schur_supported(stamps: StampTensors) -> bool:
    """Host-side probe: is the resistive node block A = G[:nk, :nk] SPD?

    Only resistor stamps land in A, so SPD-ness means every node is
    resistively tied to ground directly or transitively; a node held only
    by voltage sources makes A singular.  Run once at the netlist's default
    parameters and cached on the stamps:

    * nk ≤ 8192: a dense f64 Cholesky;
    * nk > 8192: a banded f64 Cholesky on the node block's band plan
      (:func:`_banded_spd_probe`); a node block without one (or with one
      block row) is refused, since only the banded sub-branches serve such
      sizes.

    A barely positive pivot (below 1e-6 of the largest) counts as a
    failure, since the f32 no-pivot kernels would blow up on it.
    """
    cached = stamps.__dict__.get("_schur_ok")
    if cached is not None:
        return cached
    nk = stamps.n_kcl
    ok = False
    if 0 < nk <= _SCHUR_DENSE_PROBE_MAX_NK and stamps.n > nk:
        mask = (stamps.g_rows < nk) & (stamps.g_cols < nk)
        g_np, _ = stamp_values_np(stamps, stamps.params)
        A = np.zeros((nk, nk))
        np.add.at(A, (stamps.g_rows[mask], stamps.g_cols[mask]), g_np[mask])
        try:
            L = np.linalg.cholesky(A)
            ok = bool(np.min(np.diag(L)) > 1e-6 * np.max(np.diag(L)))
        except np.linalg.LinAlgError:
            ok = False
    elif nk > _SCHUR_DENSE_PROBE_MAX_NK and stamps.n > nk:
        plan = node_band_plan(stamps)
        if plan is not None and plan.nb >= 2:
            ok = _banded_spd_probe(stamps, plan)
    stamps.__dict__["_schur_ok"] = ok
    return ok


def _banded_spd_probe(stamps: StampTensors, plan) -> bool:
    """f64 banded Cholesky (scipy ``cholesky_banded``, LAPACK pbtrf) of the
    reordered node block: O(nk·halfbw²) work, where the dense probe's
    O(nk³) is unpayable past ~8k nodes.  False (not an exception) for a
    block that is not SPD, with the dense probe's pivot margin."""
    import scipy.linalg as sla

    nk = stamps.n_kcl
    g_np, _ = stamp_values_np(stamps, stamps.params)
    mask = (stamps.g_rows < nk) & (stamps.g_cols < nk)
    r = plan.rank[stamps.g_rows[mask].astype(np.int64)]
    c = plan.rank[stamps.g_cols[mask].astype(np.int64)]
    v = g_np[mask]
    upper = c >= r
    u = plan.halfbw
    ab = np.zeros((u + 1, nk))
    np.add.at(ab, (u + r[upper] - c[upper], c[upper]), v[upper])
    try:
        with np.errstate(all="ignore"):
            cb = sla.cholesky_banded(ab, lower=False)
    except (np.linalg.LinAlgError, ValueError):
        return False
    d = cb[u, :]
    return bool(np.all(np.isfinite(d)) and np.min(d) > 1e-6 * np.max(d))


def _schur_band_assembler(stamps: StampTensors, dtype, bplan):
    """``blocks(pb) -> (W, Bm, C, D, bk, bb)``: the MNA 2×2 partition with
    the resistive node block in band storage.

    W and bk [B, n_pad] come from the node block's plan ``bplan``: W is
    [B, n_pad, W1] for a scalar-band plan, [B, nb, kb, 3kb] for a
    block-band plan.  The border blocks Bm [B, n_pad, kbe], C [B, kbe, n_pad],
    D [B, kbe, kbe] and bb [B, kbe] are gather-folds of the stamp values,
    with Bm's rows and C's columns in the plan's order so only the final
    node voltages need un-permuting.
    """
    nk = stamps.n_kcl
    kbe = stamps.n - nk
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    rank = bplan.rank
    n_pad = bplan.n_pad
    iB = np.nonzero((gr < nk) & (gc >= nk))[0]
    iC = np.nonzero((gr >= nk) & (gc < nk))[0]
    iD = np.nonzero((gr >= nk) & (gc >= nk))[0]
    rr = stamps.rhs_rows.astype(np.int64)
    ib = np.nonzero(rr >= nk)[0]
    border = {
        "schur_B": (rank[gr[iB]] * kbe + gc[iB] - nk, iB, n_pad * kbe),
        "schur_C": ((gr[iC] - nk) * n_pad + rank[gc[iC]], iC, kbe * n_pad),
        "schur_D": ((gr[iD] - nk) * kbe + gc[iD] - nk, iD, kbe * kbe),
    }

    def blocks(params_batch):
        g_vals, rhs_vals = stamp_values(stamps, params_batch.to(dtype))
        W, bk = bplan.assemble_from_values(g_vals, rhs_vals)
        B = g_vals.shape[0]
        Bm, C, D = (gather_fold(stamps, name, g_vals, *tables)
                    for name, tables in border.items())
        bb = gather_fold(stamps, "schur_b", rhs_vals, rr[ib] - nk, ib, kbe)
        return (W, Bm.view(B, n_pad, kbe), C.view(B, kbe, n_pad),
                D.view(B, kbe, kbe), bk, bb)

    return blocks


@dataclasses.dataclass(frozen=True)
class _PaddedPlan:
    """The plan interface (``n_pad``, ``rhs_to_band``, ``unpermute``) of an
    unreordered node block of ``n`` unknowns padded to ``n_pad``: the
    schur tier's dense node block."""

    n: int
    n_pad: int

    def rhs_to_band(self, rhs: torch.Tensor, dtype) -> torch.Tensor:
        """The first n columns of a natural-order [B, m] RHS, zero-padded
        to [B, n_pad]."""
        return torch.nn.functional.pad(rhs[:, :self.n].to(dtype),
                                       (0, self.n_pad - self.n))

    def unpermute(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., :self.n]


def _schur_block_assembler(stamps: StampTensors, dtype, nk_pad: int):
    """``blocks(pb) -> (A, Bm, C, D, bk, bb)``: the MNA 2×2 partition with
    a dense node block, the layout the blocked LU takes.

    A [B, nk_pad, nk_pad] has a unit diagonal on the pad; Bm
    [B, nk_pad, kbe], C [B, kbe, nk_pad] and bk [B, nk_pad] are zero past
    row (column) nk; D [B, kbe, kbe] and bb [B, kbe].  Each is a
    :func:`gather_fold` of the stamp values, so f64 assembly equals the
    JAX package's ``_schur_block_assembler`` (whose Bm, C and bk stop at
    nk) exactly.
    """
    nk = stamps.n_kcl
    kbe = stamps.n - nk
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    rr = stamps.rhs_rows.astype(np.int64)
    iA = np.nonzero((gr < nk) & (gc < nk))[0]
    iB = np.nonzero((gr < nk) & (gc >= nk))[0]
    iC = np.nonzero((gr >= nk) & (gc < nk))[0]
    iD = np.nonzero((gr >= nk) & (gc >= nk))[0]
    ik = np.nonzero(rr < nk)[0]
    ib = np.nonzero(rr >= nk)[0]
    folds = {
        f"schurd_A{nk_pad}": (gr[iA] * nk_pad + gc[iA], iA, nk_pad * nk_pad),
        f"schurd_B{nk_pad}": (gr[iB] * kbe + gc[iB] - nk, iB, nk_pad * kbe),
        f"schurd_C{nk_pad}": ((gr[iC] - nk) * nk_pad + gc[iC], iC,
                              kbe * nk_pad),
        "schurd_D": ((gr[iD] - nk) * kbe + gc[iD] - nk, iD, kbe * kbe),
    }
    pad = np.arange(nk, nk_pad, dtype=np.int64) * (nk_pad + 1)

    def blocks(params_batch):
        g_vals, rhs_vals = stamp_values(stamps, params_batch.to(dtype))
        B = g_vals.shape[0]
        A, Bm, C, D = (gather_fold(stamps, name, g_vals, *tables)
                       for name, tables in folds.items())
        if len(pad):
            A.index_fill_(1, device_table(stamps, f"schurd_pad{nk_pad}", pad,
                                          A.device, torch.long), 1.0)
        bk = gather_fold(stamps, f"schurd_bk{nk_pad}", rhs_vals, rr[ik], ik,
                         nk_pad)
        bb = gather_fold(stamps, "schurd_bb", rhs_vals, rr[ib] - nk, ib, kbe)
        return (A.view(B, nk_pad, nk_pad), Bm.view(B, nk_pad, kbe),
                C.view(B, kbe, nk_pad), D.view(B, kbe, kbe), bk, bb)

    return blocks


def _schur_operator(stamps: StampTensors, dtype) -> _Operator:
    """The ``schur`` tier.

    The sub-branches, in the JAX package's order:

    * The narrow node block: a scalar-band plan whose W1 band slots
      plus the kbe + 1 border and RHS columns fit the scalar-band
      kernel.
    * The bandable node block: a block-band plan with nb ≥ 2 and
      (kb = 128 or nk > 1024), and kbe + 1 ≤ 128 right-hand sides.
    * The band scan: a block-band plan with nb ≥ 2 and nk > 2048, any
      number of right-hand sides (the block-Thomas wrapper launches
      once per 128 of them).
    * Any other node block: dense, 128-padded, factored by the blocked
      LU (:func:`lu_factor`, then :func:`lu_solve_factored` with kbe + 1
      right-hand sides, any kbe: the CUDA kernel on the card; on the CPU
      the plain ``blocked_factor`` and ``blocked_solve_factored``, which
      is ``schur_solve``'s arithmetic).  One sub-branch takes the place of
      the JAX package's Pallas LU multi (TPU, kbe < 128, nk ≤ 1024) and
      dense ``schur_solve`` ones.

    The middle two run the block-Thomas kernel on the card (the plain
    solver on the CPU).  ``refine=True`` takes two defect passes on the
    banded node blocks and three on the dense one, as the JAX package's
    sub-branches take.  (On the CPU the JAX package takes its dense
    sub-branch for node blocks up to 2048 nodes and a direct f64 band
    scan for ``refine=True``; the tier is the same.)

    ``prepare`` assembles the node block in its plan's layout (a band, or
    the dense padded block of :class:`_PaddedPlan`) with the border
    blocks in the same row order, and factors a dense one.  ``resolve``
    solves Y = A⁻¹[B | rk] and the Schur algebra
    (:func:`schur_eliminate`, which assumes PyTorch's default of no TF32
    in float32 matmuls).  The node block A is symmetric (SPD, the Schur
    precondition), so the transposed system only swaps the border blocks
    B ↔ Cᵀ and D → Dᵀ.
    """
    nk = stamps.n_kcl
    kbe = stamps.n - nk
    factor = None
    nsplan = node_sband_plan(stamps)
    if nsplan is not None and sband_fits(nsplan.W1, kbe + 1):
        plan, multi_solve, passes = nsplan, sband_solve_multi, 2
        assemble = _schur_band_assembler(stamps, dtype, plan)
    elif (nplan := node_band_plan(stamps)) is not None \
            and nplan.nb >= 2 and (
            (nplan.kb == 128 or nk > 1024) and kbe + 1 <= MAX_R
            or nk > 2048):
        plan, multi_solve, passes = nplan, band_solve_multi, 2
        assemble = _schur_band_assembler(stamps, dtype, plan)
    else:
        plan = _PaddedPlan(nk, -(-nk // _BLOCK) * _BLOCK)
        factor, multi_solve, passes = lu_factor, lu_solve_factored, 3
        assemble = _schur_block_assembler(stamps, dtype, plan.n_pad)

    def prepare(params_batch, transpose=False):
        W, Bm, C, D, bk, bb = assemble(params_batch)
        if factor is not None:
            W = factor(W)  # on the card the factor is W, factored in place
        if transpose:
            Bm, C, D = C.transpose(1, 2), Bm.transpose(1, 2), D.transpose(1, 2)

        def resolve(rhs=None):
            if rhs is None:
                rk, rb = bk, bb
            else:
                rk = plan.rhs_to_band(rhs, dtype)
                rb = rhs[:, nk:].to(dtype)
            R = torch.cat([Bm, rk.unsqueeze(-1)], dim=-1).contiguous()
            xk, xb = schur_eliminate(multi_solve(W, R), C, D, rb, kbe)
            return torch.cat([plan.unpermute(xk), xb], dim=-1)

        return resolve

    return _Operator(prepare, functools.partial(prepare, transpose=True),
                     passes)


class BatchedSolver:
    """Batched assemble+solve for one netlist topology.

    The solver method follows the circuit's structure.  Ported so far:

    * ``tridiag`` — chain/ladder topologies (bandwidth ≤ 1, purely
      resistive): band assembly + parallel cyclic reduction in the CUDA
      kernel (the plain torch PCR for CPU tensors), O(n log n) work, no
      dense matrix ever built.
    * ``sband`` — narrow-band resistive circuits (half-bandwidth ≤ 56
      after RCM, e.g. 2-D meshes): scalar band assembly + the no-pivot
      banded LDLᵀ in the CUDA kernel (the plain torch solver for CPU
      tensors), O(n·w²) work.
    * ``band`` — wider resistive bands (half-bandwidth ≤ 384 after RCM,
      e.g. large 2-D meshes and 3-D lattices): block-band assembly with
      kb ∈ {128, 256, 384} + the no-pivot block-Thomas solve in the CUDA
      kernel (the plain torch solver for CPU tensors), O(n·kb²) work.
    * ``block`` — resistive circuits without a band (half-bandwidth over
      384, e.g. random networks), n ≤ 16384: dense assembly padded to a
      multiple of 128 + the no-pivot blocked LU in the CUDA kernel (the
      plain torch solver for CPU tensors), O(n³) work.
    * ``schur`` — branch-equation circuits with n_kcl ≥ 256 whose
      resistive node block is SPD (a host-side Cholesky probe): the
      scalar-band, block-Thomas or blocked-LU kernel, as the node block
      bands, solves A⁻¹[B | b] with the border columns as extra
      right-hand sides, then a small pivoted solve on the branch Schur
      complement.
    * ``dense`` — everything else (small or non-SPD node blocks, e.g.
      opamp macromodels), n ≤ 16384: dense assembly + the library's
      pivoted LU (``torch.linalg.solve``).

    Args:
        circuit: the compiled circuit, or bare :class:`StampTensors`.
        dtype: ``torch.float32`` (default) or ``torch.float64``.
        refine: ``"auto"`` (default, with f32) wraps the raw tier in the
            exact-f64 contract layer and returns f64; ``True`` adds the
            tier's fixed number of f64 defect passes over f32 solves (two;
            three on ``dense`` and ``schur``'s dense node block; f64
            output); ``False`` is the raw tier in ``dtype``.
        method: override the structure-based choice.
        device: where every tensor of a solve lives; default ``"cuda"``.
    """

    def __init__(
        self,
        circuit: Circuit | StampTensors,
        *,
        dtype=torch.float32,
        refine: bool | str = "auto",
        method: str = "auto",
        device="cuda",
    ):
        self.stamps: StampTensors = _stamps_of(circuit)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(
                f"dtype must be torch.float32 or torch.float64, not {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.refine = refine

        if method not in _METHODS:
            raise ValueError(
                f"unknown method {method!r}; expected one of "
                "'auto', 'tridiag', 'sband', 'band', 'block', 'schur', "
                "'dense'"
            )
        stamps = self.stamps
        resistive = stamps.n == stamps.n_kcl  # no branch equations
        if method == "auto":
            if resistive and bandwidth(stamps) <= 1:
                method = "tridiag"
            elif resistive and sband_plan(stamps) is not None:
                method = "sband"
            elif resistive and (plan := band_plan(stamps)) is not None \
                    and plan.nb >= 2 and (plan.kb == 128 or plan.n > 1024):
                # Wide bands (kb ≥ 256) only pay off past n = 1024 in the
                # JAX package's measurements; below it the dense LU wins.
                method = "band"
            elif resistive:
                if stamps.n > _DENSE_BATCH_MAX_N:
                    raise ValueError(
                        f"circuit has no banded structure and n={stamps.n} "
                        "exceeds the dense batch tier (n <= "
                        f"{_DENSE_BATCH_MAX_N}); use Circuit.solve (sparse "
                        "AMG-CG), grid_solve for regular grids, or "
                        "equivalent_resistance_stamps for probe solves")
                method = "block"
            elif stamps.n_kcl >= 256 and _schur_supported(stamps):
                method = "schur"
            elif stamps.n > _DENSE_BATCH_MAX_N:
                raise ValueError(
                    f"circuit needs the dense batch tier but n={stamps.n} "
                    f"exceeds its bound (n <= {_DENSE_BATCH_MAX_N}); use "
                    "Circuit.solve with sparse=True (bordered elimination) "
                    "for one-shot solves of large general circuits")
            else:
                method = "dense"
        elif method in ("tridiag", "sband", "band", "block") \
                and not resistive:
            raise ValueError(
                f"method={method!r} requires a purely resistive circuit "
                "(branch equations put zeros on the diagonal)"
            )
        elif method == "sband" and sband_plan(stamps) is None:
            raise ValueError(
                "method='sband' requires a narrow symmetric band after "
                f"RCM reordering (half-bandwidth <= {MAX_W}); this "
                "circuit does not qualify — use 'band' or 'block'"
            )
        elif method == "band" and band_plan(stamps) is None:
            raise ValueError(
                "method='band' requires half-bandwidth <= 384 after RCM "
                "reordering; this circuit does not band — use 'block'"
            )
        elif method == "schur":
            if resistive:
                raise ValueError(
                    "method='schur' requires branch equations (use 'block' "
                    "for purely resistive circuits)"
                )
            if not _schur_supported(stamps):
                raise ValueError(
                    "method='schur' requires an SPD resistive node block "
                    "(every node resistively connected, ground included); "
                    "the Cholesky probe failed — use 'dense'"
                )
        elif method == "tridiag" and bandwidth(stamps) > 1:
            # Band assembly silently drops out-of-band entries; forcing the
            # method on a wider matrix would return wrong answers.
            raise ValueError(
                f"method='tridiag' requires bandwidth <= 1; this circuit "
                f"has bandwidth {bandwidth(stamps)}"
            )
        self.method = method

        if method == "tridiag":
            build = functools.partial(_tridiag_operator, stamps)
        elif method == "sband":
            build = functools.partial(_band_operator, stamps,
                                      sband_plan(stamps), sband_solve)
        elif method == "band":
            build = functools.partial(_thomas_operator, stamps,
                                      band_plan(stamps))
        elif method == "block":
            build = functools.partial(_block_operator, stamps)
        elif method == "schur":
            build = functools.partial(_schur_operator, stamps)
        else:
            build = functools.partial(_dense_operator, stamps)
        self._finalize(build)

    def _finalize(self, build):
        """Build the method's operator under the precision policy
        (:func:`_contract_layer`), then wrap its solve in the adjoint
        (:func:`make_adjoint_solver`): every solver is differentiable, on
        the card through its tier's kernels, which have no autograd rule
        of their own."""
        # _operator and _solve_rhs_t: tests and diagnostics.
        self._operator, solve_batch, self._solve_rhs_t = _contract_layer(
            self.stamps, build, self.dtype, self.refine)
        self._solve = make_adjoint_solver(self.stamps, solve_batch,
                                          self._solve_rhs_t)

    def _params(self, params_batch, dtype) -> torch.Tensor:
        params_batch = torch.as_tensor(params_batch, dtype=dtype,
                                       device=self.device)
        if params_batch.ndim != 2:
            raise ValueError(
                "params_batch must be [B, n_components], got "
                f"{tuple(params_batch.shape)}")
        return params_batch

    def __call__(self, params_batch) -> torch.Tensor:
        """Solve for a [B, n_components] batch of parameter vectors (numpy
        or tensor; cast to ``dtype`` on the solver's device).

        Returns [B, n_unknowns] solutions (potentials then branch currents).
        """
        with tracing.root("batch.call"):
            return self._solve(self._params(params_batch, self.dtype))

    def residuals(self, params_batch, solutions) -> torch.Tensor:
        """Relative residuals ``max|G x - b| / max(max|b|, 1)`` per batch
        element, in f64 on the solver's device.

        The audit is assembly-free: ``G x`` is evaluated straight from the
        COO stamp entries, O(B·nnz) work with no matrix ever built.
        """
        pb = self._params(params_batch, torch.float64)
        xs = torch.as_tensor(solutions, dtype=torch.float64,
                             device=self.device)
        return _coo_residuals(self.stamps, pb, xs)

    def params_with(self, overrides: dict[str, np.ndarray]) -> np.ndarray:
        """Build a params batch from per-component value arrays.

        ``overrides`` maps component name -> [B] array; all other components
        keep their netlist values.
        """
        arrays = list(overrides.values())
        if not arrays:
            raise ValueError("no overrides given")
        B = len(arrays[0])
        batch = np.tile(self.stamps.params, (B, 1))
        for name, values in overrides.items():
            batch[:, self.stamps.param_slot[name]] = np.asarray(values)
        return batch


class BatchResult:
    """Named access to a batch of solutions ([B, n_unknowns]).

    ``potential(node)`` and ``current(component)`` return [B] tensors.
    """

    def __init__(self, solutions: torch.Tensor, netlist):
        self.solutions = solutions
        self._netlist = netlist

    def potential(self, node: str) -> torch.Tensor:
        if node == self._netlist.ground:
            return torch.zeros(self.solutions.shape[0],
                               dtype=self.solutions.dtype,
                               device=self.solutions.device)
        return self.solutions[:, self._netlist.nodenum[node]]

    def current(self, name: str) -> torch.Tensor:
        """Branch current of the anomalous component ``name`` (a voltage
        source or controlled source with a branch equation)."""
        i = self._netlist.nums["kcl"] + self._netlist.anomnum[name]
        return self.solutions[:, i]


def sweep(
    circuit: Circuit,
    component: str,
    values,
    *,
    dtype=torch.float32,
    refine: bool | str = False,
    method: str = "auto",
    device=None,
) -> BatchResult:
    """Solve the circuit once per value of one component (all others at
    their netlist values): the classic DC sweep, one batched solve, on
    ``device`` (default: the circuit's own)."""
    solver = circuit.batched_solver(dtype=dtype, refine=refine,
                                    method=method, device=device)
    batch = solver.params_with({component: np.asarray(values)})
    return BatchResult(solver(batch), circuit.netlist)


def monte_carlo(
    circuit: Circuit | StampTensors,
    tolerances: dict[str, float],
    n: int,
    *,
    seed: int = 0,
    dtype=torch.float32,
    refine: bool | str = "auto",
    return_solutions: bool = False,
    audit: bool | str = True,
    device=None,
) -> dict:
    """Monte Carlo component-tolerance sweep on the device.

    Each named component's value is drawn i.i.d. normal around its netlist
    value with relative standard deviation ``tolerances[name]``, from
    ``torch.Generator(device).manual_seed(seed)``, in ``dtype``.  Sampling,
    the batched solve and the summary statistics stay on the device; only
    what is returned leaves it.  Returns a dict with ``mean`` and ``std``
    (over the samples, dividing by n) and, if asked, ``solutions``.

    With ``audit=True`` (the default) every sample's solution is checked
    against the exact COO operator in f64, reported as ``max_residual``,
    with a logged warning when a sample exceeds ``_AUDIT_WARN_TOL``
    relative: normal draws with a large tolerance can produce negative
    component values, outside the diagonal dominance the no-pivot tiers
    assume.  ``audit="exact"`` runs the same f64 check through
    :meth:`BatchedSolver.residuals` on the returned batch.

    ``circuit`` may also be bare :class:`StampTensors`; ``device=None`` is
    the circuit's own device (``"cuda"`` for bare stamps).  The solver is
    memoized on a circuit.
    """
    stamps = _stamps_of(circuit)
    if device is None:
        device = getattr(circuit, "device", "cuda")
    if hasattr(circuit, "batched_solver"):
        solver = circuit.batched_solver(dtype=dtype, refine=refine,
                                        device=device)
    else:
        solver = BatchedSolver(circuit, dtype=dtype, refine=refine,
                               device=device)
    dev = solver.device
    names = list(tolerances)
    slots = torch.as_tensor([stamps.param_slot[m] for m in names],
                            dtype=torch.long, device=dev)
    sigmas = torch.as_tensor([tolerances[m] for m in names], dtype=dtype,
                             device=dev)
    base = torch.as_tensor(stamps.params, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(n, len(names), generator=gen, dtype=dtype,
                        device=dev)

    exact = audit == "exact"
    mean, std, xs, batch, audit_out = _mc_run(
        solver, stamps, base, slots, sigmas, noise,
        want=return_solutions or exact, check=bool(audit) and not exact)
    out = {"mean": mean, "std": std}
    if return_solutions:
        out["solutions"] = xs
    if exact:
        res = solver.residuals(batch, xs)
        audit_out = (res.max(), (res > _AUDIT_WARN_TOL).sum())
    if audit:
        max_residual = float(audit_out[0])
        out["max_residual"] = max_residual
        if not np.isfinite(max_residual) or max_residual > _AUDIT_WARN_TOL:
            logger.warning(
                "monte_carlo: %d of %d samples exceed residual %.0e "
                "(worst %.2e) — large tolerances can draw negative "
                "component values outside the fast paths' "
                "diagonal-dominance domain; consider refine=True or a "
                "smaller tolerance",
                int(audit_out[1]), n, _AUDIT_WARN_TOL, max_residual,
            )
    return out


def _mc_run(solver: BatchedSolver, stamps: StampTensors,
            base: torch.Tensor, slots: torch.Tensor, sigmas: torch.Tensor,
            noise: torch.Tensor, want: bool, check: bool):
    """The body of :func:`monte_carlo` for given draws ``noise`` [n, k]:
    ``(mean, std, xs, batch, audit)``.

    ``xs`` and the sampled ``batch`` come back only with ``want``;
    ``audit`` is ``(max residual, samples over _AUDIT_WARN_TOL)``, two
    0-dim tensors, only with ``check``.  The residuals are the f64 ones of
    the exact COO operator whatever the sweep's dtype (the JAX package's
    fused audit reads an f32 sweep at f32).  Runs without autograd: a
    large batch keeps no graph alive.
    """
    with torch.no_grad():
        values = base[slots] * (1.0 + sigmas * noise)
        batch = base.expand(noise.shape[0], -1).clone()
        batch[:, slots] = values
        xs = solver._solve(batch)
        mean = xs.mean(dim=0)
        std = xs.std(dim=0, correction=0)
        audit_out = None
        if check:
            res = _coo_residuals(stamps, batch.to(torch.float64),
                                 xs.to(torch.float64))
            audit_out = (res.max(), (res > _AUDIT_WARN_TOL).sum())
    return (mean, std, xs if want else None, batch if want else None,
            audit_out)


def sensitivities(
    circuit: Circuit | StampTensors,
    *,
    potential: str | None = None,
    current: str | None = None,
    dtype=torch.float64,
) -> dict[str, float]:
    """d(output)/d(component value) for every component, from one solve
    plus one adjoint solve (``backward()`` through :class:`BatchedSolver`'s
    adjoint), on the circuit's device.

    Pass exactly one of ``potential=<node name>`` or
    ``current=<anomalous component name>``.  Returns ``{component name:
    d output / d value}`` over all components, in netlist units.  The cost
    does not grow with the component count; finite differences would take
    one extra solve per component.

    A circuit built with ``sparse=True`` that the bordered elimination
    can serve (:func:`~nodal_tpu_torch.ops.sparse_schur.
    general_auto_viable`) takes its adjoint instead: one forward and one
    transposed solve through the cached factorization, with no dense
    [n, n] assembly; it raises ``numpy.linalg.LinAlgError`` when either
    solve does not converge.
    """
    netlist = circuit.netlist
    stamps = _stamps_of(circuit)
    if (potential is None) == (current is None):
        raise ValueError(
            "pass exactly one of potential=<node> or current=<component>")
    if potential is not None:
        if potential == netlist.ground:
            return {name: 0.0 for name in stamps.param_slot}
        if potential not in netlist.nodenum:
            raise KeyError(f"unknown node {potential!r}")
        idx = netlist.nodenum[potential]
    else:
        if current not in netlist.anomnum:
            raise KeyError(
                f"{current!r} is not an anomalous component (no branch "
                "current variable)")
        idx = netlist.nums["kcl"] + netlist.anomnum[current]
    if getattr(circuit, "sparse", False):
        dev = resolve_device(circuit.device, "sensitivities")
        if general_auto_viable(stamps, device=dev):
            pbar, _, info_f, info_a = general_sparse_adjoint_gradient(
                stamps, idx, device=dev)
            if not (bool(info_f.converged) and bool(info_a.converged)):
                raise np.linalg.LinAlgError(
                    "adjoint solve did not converge (residuals "
                    f"{float(info_f.residual):.2e} fwd / "
                    f"{float(info_a.residual):.2e} adj)")
            return {name: float(pbar[slot])
                    for name, slot in stamps.param_slot.items()}

    g = _adjoint_grad(circuit, {idx: 1.0}, dtype)
    return {name: float(g[slot]) for name, slot in stamps.param_slot.items()}


def _adjoint_grad(circuit: Circuit, weights: dict[int, float],
                  dtype=torch.float64) -> np.ndarray:
    """d(Σ_i w_i·x_i)/d(component values) of ``circuit`` at its own
    values: one solve plus one adjoint solve (``backward()`` through
    :class:`BatchedSolver`'s adjoint) on the circuit's device.  ``weights``
    maps unknowns to their weights; none gives zeros.  Returns host f64
    [n_components]."""
    stamps = circuit.stamps
    if not weights:
        return np.zeros(len(stamps.params))
    solver = circuit.batched_solver(dtype=dtype)
    p = torch.tensor(stamps.params, dtype=solver.dtype,
                     device=solver.device)[None].requires_grad_()
    x = solver(p)[0]
    sum(w * x[i] for i, w in weights.items()).backward()
    return p.grad[0].to(torch.float64).cpu().numpy()


#: Relative-residual level above which monte_carlo's audit warns.  An f32
#: fast-path solve of a well-conditioned system lands around 1e-6; crossing
#: 1e-3 means the solver left its assumptions (e.g. negative samples).
_AUDIT_WARN_TOL = 1e-3
