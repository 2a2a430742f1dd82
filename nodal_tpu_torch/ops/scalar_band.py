"""Scalar banded LDLᵀ: plan, batched assembly, and the plain solver.

Counterpart of ``nodal_tpu/ops/scalar_band.py``.  The host-side plan
(:class:`ScalarBandPlan`, :func:`make_scalar_band_plan`, the cached
:func:`sband_plan` / :func:`node_sband_plan`) is a copy of the JAX
package's, array for array; assembly, the band matvec and the solver are
torch over a leading batch dimension.  :func:`scalar_band_solve_scan` is
the plain version of the CUDA kernel in :mod:`nodal_tpu_torch.ops.sband`.

Math: the system is the reverse-Cuthill-McKee-reordered grounded resistor
Laplacian, symmetric positive definite, so the no-pivot banded LDLᵀ

    for i:  d = A[i,i];  m_r = A[i, i+r]/d
            A[i+a, i+b] -= m_a · A[i, i+b]          (1 ≤ a ≤ b ≤ w)
            b[i+r]      -= m_r · b[i]
    backward:  x_i = b'_i/d_i − Σ_r m_r · x_{i+r}

is stable on exactly the circuits this plan accepts.  Only the upper band
is stored: ``U[i, k] = A[i, i+k]``, k = 0..w.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nodal_tpu_torch.models.stamps import (StampTensors, device_table,
                                           stamp_values)
from nodal_tpu_torch.ops.assemble import gather_fold
from nodal_tpu_torch.ops.band import rcm_order

#: Widest half-bandwidth the plan accepts (the JAX package's threshold,
#: set from TPU measurements; not yet re-derived on the H100).
MAX_W = 56

#: Plans are only built up to this many unknowns (the JAX package's
#: bound): the kernel keeps the factored band, O(B·n·W1) values, in device
#: memory between its forward and backward sweeps.
_MAX_N = 16384


@dataclass
class ScalarBandPlan:
    """Host-side plan: RCM order + symmetric upper-band assembly tables.

    Built once per topology by :func:`make_scalar_band_plan`, cached on the
    stamps by :func:`sband_plan` / :func:`node_sband_plan`.
    """

    n: int
    w: int             # half-bandwidth after reordering
    W1: int            # stored slots per row = w + 1 (diagonal first)
    n_pad: int         # n rounded up to a multiple of 8
    order: np.ndarray  # [n] order[new] = old
    rank: np.ndarray   # [n] rank[old] = new
    sel: np.ndarray    # stamp entries in the upper band (row' <= col')
    u_flat: np.ndarray     # flat targets of ``sel`` in [n_pad * W1]
    unit_flat: np.ndarray  # unit-diagonal targets for pad rows
    rhs_sel: np.ndarray
    rhs_perm_rows: np.ndarray

    def assemble(self, stamps: StampTensors, params: torch.Tensor,
                 dtype=None):
        """``[B, n_components]`` params -> (U [B, n_pad, W1], b [B, n_pad])
        in the dtype given (default: the params').  Upper band only: the
        system is symmetric by construction."""
        if dtype is not None:
            params = params.to(dtype)
        g_vals, rhs_vals = stamp_values(stamps, params)
        return self.assemble_from_values(g_vals, rhs_vals)

    def assemble_from_values(self, g_vals: torch.Tensor,
                             rhs_vals: torch.Tensor):
        """Stamp values ``[B, nnz]``, ``[B, m]`` -> (U, b) as in
        :meth:`assemble`.

        Each non-empty band slot is a gather-fold of the few stamp entries
        landing on it (:func:`gather_fold`); the pad rows get a unit
        diagonal.  The transient is ``[B, slots, K]`` for the non-empty
        slots only (about 3 of a mesh row's W1 = 27), never the one-hot
        ``[B, n_pad, width, W1]`` product of the JAX package's fold.
        """
        B = g_vals.shape[0]
        U = gather_fold(self, "u", g_vals, self.u_flat, self.sel,
                        self.n_pad * self.W1)
        if len(self.unit_flat):
            U.index_fill_(1, device_table(self, "unit_flat", self.unit_flat,
                                          g_vals.device, torch.long), 1.0)
        b = gather_fold(self, "b", rhs_vals, self.rhs_perm_rows,
                        self.rhs_sel, self.n_pad)
        return U.view(B, self.n_pad, self.W1), b

    def rhs_to_band(self, rhs: torch.Tensor, dtype=None) -> torch.Tensor:
        """Natural-order [..., m] RHS (m ≥ n) -> [..., n_pad] in band
        order."""
        dt = rhs.dtype if dtype is None else dtype
        out = torch.zeros(rhs.shape[:-1] + (self.n_pad,), dtype=dt,
                          device=rhs.device)
        idx = device_table(self, "order", self.order, rhs.device, torch.long)
        out[..., :self.n] = rhs[..., idx].to(dt)
        return out

    def unpermute(self, x: torch.Tensor) -> torch.Tensor:
        """Reordered [..., n_pad] solution -> natural [..., n]."""
        if x.shape[-1] != self.n_pad:
            raise ValueError(
                f"expected [..., {self.n_pad}] band-order rows, got "
                f"{tuple(x.shape)}")
        idx = device_table(self, "rank", self.rank, x.device, torch.long)
        return x.index_select(-1, idx)


def make_scalar_band_plan(
    stamps: StampTensors, n_limit: int | None = None, max_w: int = MAX_W,
) -> ScalarBandPlan | None:
    """Scalar-band plan for the leading ``n_limit`` unknowns, or None when
    the system is not symmetric-banded under ``max_w``.

    Requires a *symmetric* block.  Only resistor stamps write node-node
    entries, so the node block (``n_limit = stamps.n_kcl``) is symmetric
    by construction; the full system is only accepted when it has no
    branch equations, whose couplings are value-antisymmetric.  Structural
    symmetry is checked as well.
    """
    n = stamps.n if n_limit is None else n_limit
    if n == 0 or n > _MAX_N:
        return None
    if n > stamps.n_kcl:  # includes branch rows: not symmetric
        return None
    if n_limit is None:
        sel_all = np.arange(len(stamps.g_rows), dtype=np.int64)
    else:
        sel_all = np.nonzero(
            (stamps.g_rows < n) & (stamps.g_cols < n)
        )[0]
    rows = stamps.g_rows[sel_all].astype(np.int64)
    cols = stamps.g_cols[sel_all].astype(np.int64)
    if len(rows) == 0:
        return None
    # Structural symmetry of the pattern.
    key_fwd = np.unique(rows * n + cols)
    key_bwd = np.unique(cols * n + rows)
    if len(key_fwd) != len(key_bwd) or not np.array_equal(key_fwd, key_bwd):
        return None

    natural_bw = int(np.max(np.abs(rows - cols)))
    order = rcm_order(n, rows, cols)
    rank = np.argsort(order)
    rcm_bw = int(np.max(np.abs(rank[rows] - rank[cols])))
    if natural_bw <= rcm_bw:  # keep the netlist's own ordering if no worse
        order = np.arange(n, dtype=np.int64)
        rank = order
        w = natural_bw
    else:
        w = rcm_bw
    if w > max_w:
        return None
    W1 = w + 1
    n_pad = -(-n // 8) * 8

    pr, pc = rank[rows], rank[cols]
    upper = pr <= pc
    sel = sel_all[upper]
    u_flat = pr[upper] * W1 + (pc[upper] - pr[upper])
    pad_rows = np.arange(n, n_pad, dtype=np.int64)
    unit_flat = pad_rows * W1  # slot 0 (diagonal)
    rhs_sel = np.nonzero(stamps.rhs_rows < n)[0]
    rhs_perm_rows = rank[stamps.rhs_rows[rhs_sel].astype(np.int64)]
    return ScalarBandPlan(
        n=n, w=w, W1=W1, n_pad=n_pad,
        order=order, rank=rank, sel=sel,
        u_flat=u_flat.astype(np.int64),
        unit_flat=unit_flat,
        rhs_sel=rhs_sel,
        rhs_perm_rows=rhs_perm_rows.astype(np.int64),
    )


def sband_plan(stamps: StampTensors) -> ScalarBandPlan | None:
    """Cached full-system scalar-band plan (None if not applicable)."""
    cached = stamps.__dict__.get("_sband_plan", False)
    if cached is False:
        cached = make_scalar_band_plan(stamps)
        stamps.__dict__["_sband_plan"] = cached
    return cached


def node_sband_plan(stamps: StampTensors) -> ScalarBandPlan | None:
    """Cached scalar-band plan of the resistive node block (Schur path)."""
    cached = stamps.__dict__.get("_node_sband_plan", False)
    if cached is False:
        cached = make_scalar_band_plan(stamps, n_limit=stamps.n_kcl)
        stamps.__dict__["_node_sband_plan"] = cached
    return cached


def sband_matvec(U: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Symmetric band matvec ``y = A·x`` from upper storage.

    ``U`` [..., n_pad, W1], ``x`` [..., n_pad].  O(n·w), any dtype.
    """
    W1 = U.shape[-1]
    y = U[..., 0] * x
    for k in range(1, min(W1, x.shape[-1])):
        uk = U[..., :-k, k]
        y[..., :-k] += uk * x[..., k:]
        y[..., k:] += uk * x[..., :-k]
    return y


def _aug_index_mask(W1: int, W1a: int, n_rhs: int):
    """Constant gather/mask tables for the augmented update.

    Augmented rows are [d, u_1..u_w, rhs_0..rhs_{n_rhs-1}] of width
    ``W1a``.  The elimination update of row i+r reads q_r[k]:

        q_r[k] = row_i[k + r]   for band slots k ≤ w − r
        q_r[k] = row_i[k]       for RHS slots (they never shift)

    Returns ``IDX`` [W1a, W1a] gather indices into row_i and ``MASK``
    [W1a, W1a] with zeros where no update applies (r = 0, out-of-band).
    """
    w = W1 - 1
    r_ = np.arange(W1a)[:, None]
    k_ = np.arange(W1a)[None, :]
    is_rhs = (k_ >= W1) & (k_ < W1 + n_rhs)
    idx = np.where(is_rhs, k_, np.minimum(r_ + k_, W1a - 1))
    mask = (r_ >= 1) & (r_ <= w) & (((k_ + r_) <= w) | is_rhs)
    return idx.astype(np.int64), mask.astype(np.float64)


def scalar_band_solve_scan(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain banded LDLᵀ solve: ``U`` [..., n_pad, W1] upper band, ``b``
    [..., n_pad] (or [..., n_pad, r] multi-RHS) -> x of b's shape and
    dtype.

    One Python step per row, each over the whole batch (the JAX package's
    ``lax.scan`` under ``vmap``), in any float dtype.  The CUDA kernel
    (:mod:`nodal_tpu_torch.ops.sband`) computes the same recurrence.
    """
    vector_rhs = b.dim() == U.dim() - 1
    if vector_rhs:
        b = b[..., None]
    *batch, n_pad, W1 = U.shape
    n_rhs = b.shape[-1]
    w = W1 - 1
    W1a = W1 + n_rhs
    dtype, dev = b.dtype, b.device

    def const(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    # Trailing scratch rows so every [W1a, W1a] window is in bounds (unit
    # diagonal; their m is 0 so they never touch the solution).
    unit = torch.zeros(W1a, dtype=dtype, device=dev)
    unit[0] = 1.0
    A = torch.cat([torch.cat([U.to(dtype), b], dim=-1),
                   unit.expand(*batch, W1a, W1a)], dim=-2).contiguous()

    IDX, MASK = _aug_index_mask(W1, W1a, n_rhs)
    idx = torch.as_tensor(IDX, device=dev)
    mask = const(MASK)
    slots = np.arange(W1a)
    # Slots of the factored row kept from the raw row (d and the rhs).
    keep = const(((slots == 0) | (slots >= W1)).astype(np.float64))
    mslot = const(((slots >= 1) & (slots <= w)).astype(np.float64))

    for i in range(n_pad):
        win = A[..., i:i + W1a, :]
        row = win[..., 0, :].clone()
        m = row / row[..., :1]
        q = row[..., idx] * mask                    # [..., W1a (r), W1a (k)]
        win -= m[..., :, None] * q
        win[..., 0, :] = keep * row + (1.0 - keep) * m

    x = torch.zeros(*batch, n_pad + W1a, n_rhs, dtype=dtype, device=dev)
    for i in range(n_pad - 1, -1, -1):
        row = A[..., i, :]
        s = ((mslot * row)[..., :, None] * x[..., i:i + W1a, :]).sum(-2)
        x[..., i, :] = row[..., W1:W1a] / row[..., :1] - s
    x = x[..., :n_pad, :]
    return x[..., 0] if vector_rhs else x
