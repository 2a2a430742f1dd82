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
left: the library's pivoted LU), and the exact-f64 defect-correction
contract layer that ``refine="auto"`` wraps around each.  The adjoint,
Monte Carlo and sensitivities are absent (ROADMAP.md Queue 1).

Device policy: a solver runs on the device it is given (default
``"cuda"``, which raises when CUDA is absent).  Every tensor of a solve,
the f64 audit included, stays on that device.
"""

from __future__ import annotations

import dataclasses
import math

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
from nodal_tpu_torch.ops.block_thomas import (MAX_R, band_solve,
                                              band_solve_multi)
from nodal_tpu_torch.ops.lu import (lu_factor, lu_solve_factored,
                                    lu_solve_multi)
from nodal_tpu_torch.ops.pcr import pcr_solve
from nodal_tpu_torch.ops.sband import (sband_fits, sband_solve,
                                       sband_solve_multi)
from nodal_tpu_torch.ops.scalar_band import (MAX_W, node_sband_plan,
                                             sband_plan)
from nodal_tpu_torch.ops.tridiag import tridiag_matvec

#: Rows with more COO entries than this keep the scatter-add audit (the
#: gather-fold pass reads ``width`` slots per output row).
_RESID_FOLD_MAX_WIDTH = 16

#: The default accuracy contract: node voltages within 1e-6 *of the f64
#: reference*, an error bound, not a residual bound.
_CONTRACT_TOL = 1e-6

#: Escalation pass cap: each exact-COO defect correction contracts the
#: error by about the f32 tier's own relative error; the cap only bites for
#: near-divergent systems, which then take the pivoted rescue.
_ESCALATE_MAX_PASSES = 4

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


def _resid_gather_tables(stamps: StampTensors):
    """Per-MNA-row gather lists over the COO stamp entries, or None when
    some row is denser than ``_RESID_FOLD_MAX_WIDTH``.

    Returns ``(entry_ids, x_cols, valid, rhs_ids, rhs_valid)`` — the first
    three [n, width] (entry index into the raw stamp-value vector, the
    entry's column as an index into x, 1.0/0.0 slot mask), the last two
    [n, rhs_width] for the RHS.  Built vectorized (argsort + cumcount) and
    cached on the StampTensors as numpy.
    """
    cached = stamps.__dict__.get("_resid_gf", False)
    if cached is not False:
        return cached

    def fold(rows, nnz):
        counts = np.bincount(rows, minlength=stamps.n)
        width = int(counts.max()) if nnz else 1
        if width > _RESID_FOLD_MAX_WIDTH:
            return None
        order = np.argsort(rows, kind="stable")
        offsets = np.zeros(stamps.n, dtype=np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        pos = np.arange(nnz, dtype=np.int64) - offsets[rows[order]]
        ids = np.zeros((stamps.n, max(width, 1)), dtype=np.int32)
        valid = np.zeros((stamps.n, max(width, 1)), dtype=np.float64)
        ids[rows[order], pos] = order
        valid[rows[order], pos] = 1.0
        return ids, valid

    out = None
    g = fold(stamps.g_rows.astype(np.int64), len(stamps.g_rows))
    r = fold(stamps.rhs_rows.astype(np.int64), len(stamps.rhs_rows))
    if g is not None and r is not None:
        entry_ids, valid = g
        rhs_ids, rhs_valid = r
        x_cols = np.zeros_like(entry_ids)
        x_cols[valid > 0] = stamps.g_cols[
            entry_ids[valid > 0].astype(np.int64)]
        out = (entry_ids, x_cols, valid, rhs_ids, rhs_valid)
    stamps.__dict__["_resid_gf"] = out
    return out


def _coo_apply(stamps: StampTensors, g_vals: torch.Tensor,
               xs: torch.Tensor) -> torch.Tensor:
    """``y = G·x`` straight from the COO stamp entries — no matrix built.

    Folds each row's few entries with dense gathers when rows are narrow
    (the common case); dense rows fall back to a scatter-add.
    """
    dev = xs.device
    gf = _resid_gather_tables(stamps)
    if gf is not None:
        entry_ids, x_cols, valid, _, _ = gf
        ids = device_table(stamps, "resid_ids", entry_ids, dev, torch.long)
        cols = device_table(stamps, "resid_cols", x_cols, dev, torch.long)
        w = device_table(stamps, "resid_valid", valid, dev, g_vals.dtype)
        return (g_vals[:, ids] * w * xs[:, cols]).sum(-1)
    rows = device_table(stamps, "g_rows", stamps.g_rows, dev, torch.long)
    cols = device_table(stamps, "g_cols", stamps.g_cols, dev, torch.long)
    return torch.zeros_like(xs).index_add_(1, rows, g_vals * xs[:, cols])


def _coo_rhs_vec(stamps: StampTensors, rhs_vals: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
    """Natural-order RHS vector ``b`` from the COO RHS entries; ``like``
    fixes the [B, n] output shape, dtype and device."""
    if not len(stamps.rhs_rows):
        return torch.zeros_like(like)
    dev = like.device
    gf = _resid_gather_tables(stamps)
    if gf is not None:
        _, _, _, rhs_ids, rhs_valid = gf
        ids = device_table(stamps, "resid_rhs_ids", rhs_ids, dev, torch.long)
        w = device_table(stamps, "resid_rhs_valid", rhs_valid, dev,
                         rhs_vals.dtype)
        return (rhs_vals[:, ids] * w).sum(-1)
    rows = device_table(stamps, "rhs_rows", stamps.rhs_rows, dev, torch.long)
    return torch.zeros_like(like).index_add_(1, rows, rhs_vals)


def _coo_residuals(stamps: StampTensors, params_batch: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """Relative residuals ``max|b − G·x| / max(max|b|, 1)`` per sample,
    straight from the COO stamp entries (no matrix built), O(B·nnz), in the
    dtype of the inputs."""
    g_vals, rhs_vals = stamp_values(stamps, params_batch)
    y = _coo_apply(stamps, g_vals, xs)
    b = _coo_rhs_vec(stamps, rhs_vals, xs)
    return (b - y).abs().amax(dim=1) / b.abs().amax(dim=1).clamp_min(1.0)


def _coo_defect_refine(stamps: StampTensors, params_batch: torch.Tensor,
                       rhs, x: torch.Tensor, resolve,
                       iters: int = 2) -> torch.Tensor:
    """f64 defect correction against the *exact* COO operator.

    ``x`` is the f32-tier solution (promoted to f64); ``rhs`` is an
    explicit natural-order RHS or None for the stamped one; ``resolve``
    maps an f32 natural-order residual to an f32 correction.  Refining
    against the COO entries rather than the assembled, f32-rounded matrix
    is what buys true f64 accuracy instead of a floor set by assembly
    rounding.
    """
    g_vals, rhs_vals = stamp_values(stamps, params_batch.to(torch.float64))
    x = x.to(torch.float64)
    if rhs is None:
        b64 = _coo_rhs_vec(stamps, rhs_vals, x)
    else:
        b64 = rhs.to(torch.float64)
    for _ in range(iters):
        r = b64 - _coo_apply(stamps, g_vals, x)
        x = x + resolve(r.to(torch.float32)).to(torch.float64)
    return x


def _escalating_solver(stamps: StampTensors, inner, transpose: bool = False):
    """The ``refine="auto"`` tier: f32 solves + exact-f64-COO defect
    correction until a correction-based ERROR estimate meets the 1e-6
    contract.

    ``inner(pb, rhs=None)`` is the tier's raw f32 solve (``rhs`` in natural
    order; for ``transpose=True`` it solves the transposed system and
    ``rhs`` is required).

    Why error, not residual: the f32 solves are backward-stable, so their
    residual sits at ~ε₃₂ whatever the conditioning while the error is
    κ(A)·ε₃₂.  The correction ``dx = Ã⁻¹(b − A x_k)`` estimates the
    current error, and successive corrections contract by the solver's own
    relative error ρ.  So one pass always runs, and more follow while the
    predicted post-pass error ``‖dx‖·ρ̂`` exceeds ``_CONTRACT_TOL``.
    Samples still off the contract afterwards (a failed no-pivot
    factorization, e.g. a zero pivot) are re-solved by pivoted f64 LU.
    Output is f64.
    """
    st = _transposed_stamps(stamps) if transpose else stamps

    def run(params_batch, rhs=None):
        x = inner(params_batch, rhs).to(torch.float64)
        g_vals, rhs_vals = stamp_values(st, params_batch.to(torch.float64))
        if rhs is None:
            b64 = _coo_rhs_vec(st, rhs_vals, x)
        else:
            b64 = rhs.to(torch.float64)
        b_scale = b64.abs().amax(dim=1).clamp_min(1.0)

        def correct(x):
            """One defect pass: (x+dx, dx_rel), dx_rel the worst
            per-sample ‖dx‖∞/‖x‖∞ — the error estimate of x."""
            r = b64 - _coo_apply(st, g_vals, x)
            dx = inner(params_batch, r.to(torch.float32)).to(torch.float64)
            x_scale = x.abs().amax(dim=1).clamp_min(1e-30)
            # The loop condition reads this scalar on the host: one device
            # synchronisation per pass.
            dx_rel = float((dx.abs().amax(dim=1) / x_scale).max())
            return x + dx, dx_rel

        # Pass 1, unconditional: dx₁ estimates the raw solve's error, which
        # for a single solve is the contraction factor ρ.
        x, dx_rel = correct(x)
        rho, k = dx_rel, 1
        while (dx_rel * rho > _CONTRACT_TOL and math.isfinite(dx_rel)
               and k < _ESCALATE_MAX_PASSES):
            x, dx_new = correct(x)
            # Measured contraction; ≥1 means divergence — keep 1.0 so the
            # loop runs to the cap and hands off to the rescue.
            rho = min(dx_new / max(dx_rel, 1e-300), 1.0)
            dx_rel, k = dx_new, k + 1

        if stamps.n > _ESCALATE_DENSE_MAX_N:
            return x
        r = b64 - _coo_apply(st, g_vals, x)
        rel_s = r.abs().amax(dim=1) / b_scale
        bad = (rel_s > _CONTRACT_TOL) | ~torch.isfinite(rel_s)
        # Host synchronisation: which samples take the pivoted rescue.
        idx = torch.nonzero(bad).flatten()
        if idx.numel():
            core = make_dense_core(stamps, torch.float64)
            chunk = max(1, _ESCALATE_CHUNK_BYTES // (stamps.n * stamps.n * 8))
            for lo in range(0, idx.numel(), chunk):
                sel = idx[lo:lo + chunk]
                x[sel] = core(params_batch[sel],
                              None if rhs is None else rhs[sel], transpose)
        return x

    return run


def make_dense_core(stamps: StampTensors, dtype, refine: bool = False):
    """``core(pb, rhs=None, transpose=False)``: the dense pivoted-LU MNA
    solve, the ``dense`` tier and (f64, no ``refine``) the contract layer's
    rescue.

    Raw: assembly and ``torch.linalg.solve`` in ``dtype``.  ``refine``: the
    matrices cast to f32, an f32 pivoted solve, then three exact-COO f64
    defect passes on the same f32 matrices, f64 out (the JAX package's
    variant).  The factorization
    is the library's pivoted LU, as XLA's is in the JAX package: no TPU
    kernel of the repo computes it, so this is no kernel port.
    """

    def core(params_batch, rhs=None, transpose=False):
        G, b = assemble_dense(stamps, params_batch, dtype=dtype)
        if rhs is not None:
            b = rhs.to(b.dtype)
        if transpose:
            G = G.transpose(1, 2)
        if refine:
            G, b = G.to(torch.float32), b.to(torch.float32)

        def resolve(r):
            return dense_solve.solve_dense(G, r.unsqueeze(-1)).squeeze(-1)

        if not refine:
            return resolve(b)
        st = _transposed_stamps(stamps) if transpose else stamps
        return _coo_defect_refine(st, params_batch, rhs, resolve(b),
                                  resolve, iters=3)

    return core


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


def _refined_tridiag_solver(stamps: StampTensors, iters: int = 2):
    """Band-space mixed precision: f32 PCR solves, f64 band residuals.

    The returned callable also accepts an optional explicit RHS (natural
    order, [B, n]) replacing the stamped one.
    """

    def solve_batch(params_batch, rhs=None):
        dl, d, du, b = assemble_tridiag(stamps, params_batch,
                                        dtype=torch.float64)
        if rhs is not None:
            b = rhs.to(torch.float64).contiguous()
        dl32, d32, du32 = (t.to(torch.float32) for t in (dl, d, du))
        x = pcr_solve(dl32, d32, du32, b.to(torch.float32)).to(torch.float64)
        for _ in range(iters):
            r = b - tridiag_matvec(dl, d, du, x)
            dx = pcr_solve(dl32, d32, du32, r.to(torch.float32))
            x = x + dx.to(torch.float64)
        return x

    return solve_batch


def _band_solver(stamps: StampTensors, plan, dtype, refine: bool, solve):
    """The solve ``(pb, rhs=None) -> [B, n]`` of a banded resistive tier:
    ``band`` (a :class:`~nodal_tpu_torch.ops.band.BandPlan` and
    ``band_solve``, the block-Thomas kernel) or ``sband`` (a scalar-band
    plan and ``sband_solve``).

    Raw: assembly and the kernel in ``dtype`` (f64 runs the kernel's f64
    instantiation on the card).  ``refine``: the band assembled in f32
    only, f32 kernel solves, and two exact-COO f64 defect passes, f64 out.
    The band is never materialised in f64: the passes read the stamp
    entries (O(B·nnz)) instead of an f64 copy of the band, which would be
    the largest tensor of the call.
    """
    if not refine:

        def solve_batch(params_batch, rhs=None):
            W, b = plan.assemble(stamps, params_batch, dtype=dtype)
            if rhs is not None:
                b = plan.rhs_to_band(rhs, dtype)
            return plan.unpermute(solve(W, b))

        return solve_batch

    def solve_batch(params_batch, rhs=None):
        W, b = plan.assemble(stamps, params_batch, dtype=torch.float32)
        if rhs is not None:
            b = plan.rhs_to_band(rhs, torch.float32)
        x = plan.unpermute(solve(W, b))
        return _coo_defect_refine(
            stamps, params_batch, rhs, x,
            lambda r: plan.unpermute(
                solve(W, plan.rhs_to_band(r, torch.float32))))

    return solve_batch


def _block_solver(stamps: StampTensors, dtype, refine: bool):
    """The solve ``(pb, rhs=None) -> [B, n]`` of the ``block`` tier: dense
    assembly straight into the 128-padded shape, then the no-pivot blocked
    LU (:func:`lu_factor` and :func:`lu_solve_factored`: the CUDA kernel on
    the card, the plain ``blocked_factor`` / ``blocked_solve_factored`` on
    the CPU), then the first n unknowns.

    Raw: assembly and the LU in ``dtype`` (f64 runs the kernel's f64
    instantiation on the card).  ``refine``: f32 assembly, one f32
    factorization, and two exact-COO f64 defect passes, each a solve on
    the same factor; f64 out.
    """
    n = stamps.n
    n_pad = -(-n // _BLOCK) * _BLOCK

    def rhs_cols(v):  # [B, n] -> [B, n_pad, 1]
        return torch.nn.functional.pad(v, (0, n_pad - n)).unsqueeze(-1)

    def solve_batch(params_batch, rhs=None):
        G, b = assemble_dense(stamps, params_batch,
                              dtype=torch.float32 if refine else dtype,
                              pad_to=n_pad)
        if rhs is not None:
            b = rhs_cols(rhs.to(G.dtype))[..., 0]
        F = lu_factor(G)
        del G  # on the card F is G, factored in place
        x = lu_solve_factored(F, b.unsqueeze(-1))[:, :n, 0]
        if not refine:
            return x
        return _coo_defect_refine(
            stamps, params_batch, rhs, x,
            lambda r: lu_solve_factored(F, rhs_cols(r))[:, :n, 0])

    return solve_batch


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


def _make_schur_solver(assemble, multi_solve, nplan, nk: int, kbe: int):
    """(solve_batch, solve_rhs_t) of the schur tier's sub-branches.

    ``assemble`` gives the node block in ``nplan``'s layout (a band, or the
    dense padded block of :class:`_PaddedPlan`) with the border blocks in
    the same row order; ``multi_solve`` is the node block's multi-RHS
    solve (the scalar-band, block-Thomas or blocked-LU kernel).
    ``solve_batch(pb, rhs=None)`` solves G x = b (or the given
    natural-order RHS); ``solve_rhs_t(pb, rhs)`` solves the transposed
    system Gᵀλ = rhs.  The node block A is symmetric (SPD, the Schur
    precondition), so transposition only swaps the border blocks B ↔ Cᵀ
    and D → Dᵀ; the same solve Y = A⁻¹[B | bk] and Schur algebra
    (:func:`schur_eliminate`, which assumes PyTorch's default of no TF32
    in float32 matmuls) run unchanged.
    """

    def core(params_batch, rhs=None, transpose=False):
        W, Bm, C, D, bk, bb = assemble(params_batch)
        if rhs is None:
            rk, rb = bk, bb
        else:
            rk = nplan.rhs_to_band(rhs, W.dtype)
            rb = rhs[:, nk:].to(W.dtype)
        if transpose:
            Bm, C, D = C.transpose(1, 2), Bm.transpose(1, 2), D.transpose(1, 2)
        R = torch.cat([Bm, rk.unsqueeze(-1)], dim=-1).contiguous()
        xk, xb = schur_eliminate(multi_solve(W, R), C, D, rb, kbe)
        return torch.cat([nplan.unpermute(xk), xb], dim=-1)

    return core, (lambda pb, rhs: core(pb, rhs, transpose=True))


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedSolver(device='cuda'): CUDA is not available; pass "
                "device='cpu' for the plain torch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


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
            exact-f64 contract layer and returns f64; ``True`` adds two
            f64 refinement passes over f32 solves (f64 output); ``False``
            is the raw tier in ``dtype``.
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
        self.device = _resolve_device(device)
        self.dtype = dtype
        self.refine = refine
        # refine="auto" (the default): build the raw f32 tier and wrap it
        # in the escalating contract layer at _finalize.  refine=False:
        # raw tier, no audit.
        self._auto_escalate = refine == "auto" and dtype == torch.float32
        if refine == "auto":
            refine = False

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
                    f"exceeds its bound (n <= {_DENSE_BATCH_MAX_N})")
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
            if refine:
                solve_batch = _refined_tridiag_solver(stamps)
            else:

                def solve_batch(params_batch, rhs=None):
                    dl, d, du, b = assemble_tridiag(stamps, params_batch,
                                                    dtype=dtype)
                    if rhs is not None:
                        b = rhs.to(dtype).contiguous()
                    return pcr_solve(dl, d, du, b)

            # Resistive ⇒ symmetric operator: the transposed solve is the
            # same solve with the given RHS.
            self._finalize(solve_batch, solve_batch)
        elif method in ("sband", "band"):
            if method == "sband":
                plan, solve = sband_plan(stamps), sband_solve
            else:
                plan, solve = band_plan(stamps), band_solve
            solve_batch = _band_solver(stamps, plan, dtype, bool(refine),
                                       solve)
            self._finalize(solve_batch, solve_batch)  # symmetric
        elif method == "block":
            solve_batch = _block_solver(stamps, dtype, bool(refine))
            self._finalize(solve_batch, solve_batch)  # symmetric
        elif method == "schur":
            self._finalize(*self._schur_solvers(dtype, bool(refine)))
        else:
            core = make_dense_core(stamps, dtype, bool(refine))
            self._finalize(core,
                           lambda pb, rhs: core(pb, rhs, transpose=True))

    def _schur_solvers(self, dtype, refine: bool):
        """(solve_batch, solve_rhs_t) of the ``schur`` tier.

        The sub-branches, in the JAX package's order:

        * The narrow node block: a scalar-band plan whose W1 band slots
          plus the kbe + 1 border and RHS columns fit the scalar-band
          kernel.
        * The bandable node block: a block-band plan with nb ≥ 2 and
          (kb = 128 or nk > 1024), and kbe + 1 ≤ 128 right-hand sides.
        * The band scan: a block-band plan with nb ≥ 2 and nk > 2048, any
          number of right-hand sides (the block-Thomas wrapper launches
          once per 128 of them).
        * Any other node block: dense, 128-padded, solved by the blocked
          LU (the CUDA kernel on the card, with kbe + 1 right-hand sides,
          any kbe; on the CPU the plain ``blocked_factor`` and
          ``blocked_solve_factored``, which is ``schur_solve``'s
          arithmetic).  One sub-branch takes the place of the JAX
          package's Pallas LU multi (TPU, kbe < 128, nk ≤ 1024) and dense
          ``schur_solve`` ones.

        The middle two run the block-Thomas kernel on the card (the plain
        solver on the CPU).  ``refine`` wraps both directions in
        exact-COO f64 defect passes over f32 solves (f64 out): two on the
        banded node blocks, three on the dense one, as the JAX package's
        sub-branches take; otherwise the solve runs in ``dtype``.  (On the
        CPU the JAX package takes its dense sub-branch for node blocks up
        to 2048 nodes and a direct f64 band scan for ``refine=True``; the
        tier is the same.)
        """
        stamps = self.stamps
        nk = stamps.n_kcl
        kbe = stamps.n - nk
        sdtype = torch.float32 if refine else dtype
        nsplan = node_sband_plan(stamps)
        if nsplan is not None and sband_fits(nsplan.W1, kbe + 1):
            plan, multi, iters = nsplan, sband_solve_multi, 2
            assemble = _schur_band_assembler(stamps, sdtype, plan)
        elif (nplan := node_band_plan(stamps)) is not None \
                and nplan.nb >= 2 and (
                (nplan.kb == 128 or nk > 1024) and kbe + 1 <= MAX_R
                or nk > 2048):
            plan, multi, iters = nplan, band_solve_multi, 2
            assemble = _schur_band_assembler(stamps, sdtype, plan)
        else:
            plan = _PaddedPlan(nk, -(-nk // _BLOCK) * _BLOCK)
            multi, iters = lu_solve_multi, 3
            assemble = _schur_block_assembler(stamps, sdtype, plan.n_pad)
        core_b, core_t = _make_schur_solver(assemble, multi, plan, nk, kbe)
        if not refine:
            return core_b, core_t
        stamps_t = _transposed_stamps(stamps)

        def solve_batch(pb, rhs=None):
            return _coo_defect_refine(stamps, pb, rhs, core_b(pb, rhs),
                                      lambda r: core_b(pb, r), iters)

        def solve_rhs_t(pb, rhs):
            return _coo_defect_refine(stamps_t, pb, rhs, core_t(pb, rhs),
                                      lambda r: core_t(pb, r), iters)

        return solve_batch, solve_rhs_t

    def _finalize(self, solve_batch, solve_rhs_t):
        """Wrap the method's raw solver in the contract layer when
        ``refine="auto"`` asked for it."""
        if self._auto_escalate:
            solve_batch = _escalating_solver(self.stamps, solve_batch)
            solve_rhs_t = _escalating_solver(self.stamps, solve_rhs_t,
                                             transpose=True)
        self._solve = solve_batch
        self._solve_rhs_t = solve_rhs_t

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
    device="cuda",
) -> BatchResult:
    """Solve the circuit once per value of one component (all others at
    their netlist values): the classic DC sweep, one batched solve."""
    solver = circuit.batched_solver(dtype=dtype, refine=refine,
                                    method=method, device=device)
    batch = solver.params_with({component: np.asarray(values)})
    return BatchResult(solver(batch), circuit.netlist)
