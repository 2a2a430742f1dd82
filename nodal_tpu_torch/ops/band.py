"""Banded (block-tridiagonal) systems: reordering, plan, batched assembly,
the band matvec and the plain block-Thomas solver.

Counterpart of ``nodal_tpu/ops/band.py``.  The host-side parts
(:func:`rcm_order`, :class:`BandPlan`'s arrays, :func:`make_band_plan`,
the cached :func:`band_plan` / :func:`node_band_plan`) are copies of the
JAX package's (importing ``nodal_tpu`` would import ``jax``): the same
``scipy.sparse.csgraph.reverse_cuthill_mckee`` call and the same rules, so
the port's plans equal the JAX package's array for array.  Assembly, the
matvec and the solver are torch over a leading batch dimension.
:func:`band_thomas_solve` is the plain version of the CUDA kernel in
:mod:`nodal_tpu_torch.ops.block_thomas`.

Layout: ``W[b, t, i, c]`` holds block row ``t`` as the [kb, 3kb]
concatenation ``[L_t | D_t | U_t]`` (columns ``(t−1)·kb .. (t+2)·kb`` of
the reordered matrix), and the system is solved by no-pivot block Thomas:

    S_t = D_t − L_t C_{t−1},  C_t = S_t⁻¹ U_t,  y_t = S_t⁻¹ (b_t − L_t y_{t−1})
    x_{nb−1} = y_{nb−1},      x_t = y_t − C_t x_{t+1}

which is stable on the diagonally dominant and SPD systems the resistive
plans and the schur tier's node block give.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from nodal_tpu_torch.models.stamps import (StampTensors, device_table,
                                           stamp_values)
from nodal_tpu_torch.ops.assemble import gather_fold

#: Block sizes are multiples of this.
_K = 128

#: Candidate block sizes.  Work grows as n·kb², so the plan picks the
#: smallest that covers the half-bandwidth; past 384 it returns None.
_KB_CHOICES = (_K, 2 * _K, 3 * _K)

#: Plan nothing above this many unknowns (the JAX package's bound: band
#: storage is ~400 MB a sample in f32 there, past any direct batch tier).
_BAND_PLAN_MAX_N = 262144


def rcm_order(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the sparsity graph of the
    ``(rows, cols)`` pattern.

    Returns ``order`` with ``order[new] = old``.  Host work, done once per
    topology.
    """
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    off = rows != cols
    adj = sp.csr_matrix(
        (np.ones(int(off.sum()), dtype=np.float32),
         (rows[off], cols[off])),
        shape=(n, n),
    )
    perm = reverse_cuthill_mckee(adj, symmetric_mode=False)
    return np.asarray(perm, dtype=np.int64)


@dataclass
class BandPlan:
    """Host-side plan turning COO stamp entries into block-band storage.

    Built once per (topology, unknown subset) by :func:`make_band_plan`,
    cached on the stamps by :func:`band_plan` / :func:`node_band_plan`.
    """

    n: int             # unknowns covered by this plan
    kb: int            # block size (one of _KB_CHOICES)
    n_pad: int         # n rounded up to a multiple of kb
    nb: int            # number of kb-sized block rows
    halfbw: int        # half-bandwidth after reordering
    order: np.ndarray  # [n] order[new] = old
    rank: np.ndarray   # [n] rank[old] = new
    sel: np.ndarray    # stamp-entry indices included in this plan
    g_flat: np.ndarray     # flat targets of ``sel`` in [n_pad * 3kb]
    rhs_sel: np.ndarray    # rhs-entry indices with row < n
    rhs_perm_rows: np.ndarray  # permuted rhs rows
    unit_flat: np.ndarray      # unit-diagonal flat targets for pad rows

    def assemble(self, stamps: StampTensors, params: torch.Tensor,
                 dtype=None):
        """``[B, n_components]`` params -> (W [B, nb, kb, 3kb], b [B,
        n_pad]) in the dtype given (default: the params')."""
        if dtype is not None:
            params = params.to(dtype)
        g_vals, rhs_vals = stamp_values(stamps, params)
        return self.assemble_from_values(g_vals, rhs_vals)

    def assemble_from_values(self, g_vals: torch.Tensor,
                             rhs_vals: torch.Tensor):
        """Stamp values ``[B, nnz]``, ``[B, m]`` -> (W, b) as in
        :meth:`assemble`.

        Each non-empty band slot is a gather-fold of the few stamp entries
        landing on it (:func:`gather_fold`), copied into a zero band; the
        pad rows get a unit diagonal.  The transient is ``[B, slots, K]``
        for the non-empty slots only, never the one-hot ``[B, n_pad,
        width, 3kb]`` product of the JAX package's fold (~22 GB at
        B = 1024 on a 20×10×10 lattice).
        """
        B = g_vals.shape[0]
        W = gather_fold(self, "w", g_vals, self.g_flat, self.sel,
                        self.n_pad * 3 * self.kb)
        if len(self.unit_flat):
            W.index_fill_(1, device_table(self, "unit_flat", self.unit_flat,
                                          g_vals.device, torch.long), 1.0)
        b = gather_fold(self, "b", rhs_vals, self.rhs_perm_rows,
                        self.rhs_sel, self.n_pad)
        return W.view(B, self.nb, self.kb, 3 * self.kb), b

    def rhs_to_band(self, rhs: torch.Tensor, dtype=None) -> torch.Tensor:
        """Natural-order [..., m] RHS (m ≥ n; the schur paths pass the full
        MNA vector) -> [..., n_pad] in band order, zero-padded."""
        dt = rhs.dtype if dtype is None else dtype
        out = torch.zeros(rhs.shape[:-1] + (self.n_pad,), dtype=dt,
                          device=rhs.device)
        idx = device_table(self, "order", self.order, rhs.device, torch.long)
        out[..., :self.n] = rhs[..., idx].to(dt)
        return out

    def unpermute(self, x: torch.Tensor, *, rows_axis: int = -1
                  ) -> torch.Tensor:
        """Reordered solution -> natural order.  ``rows_axis`` names the
        axis of length ``n_pad`` (-2 for multi-RHS [..., n_pad, r]); it
        comes back with length n."""
        if x.shape[rows_axis] != self.n_pad:
            raise ValueError(
                f"expected {self.n_pad} band-order rows on axis {rows_axis}, "
                f"got {tuple(x.shape)}")
        idx = device_table(self, "rank", self.rank, x.device, torch.long)
        return x.index_select(rows_axis, idx)


def make_band_plan(
    stamps: StampTensors, n_limit: int | None = None,
    max_kb: int = _KB_CHOICES[-1],
) -> BandPlan | None:
    """Band plan for the leading ``n_limit`` unknowns (default: all).

    ``n_limit=stamps.n_kcl`` plans the resistive node block only, for the
    schur tier.  Returns None when the reordered half-bandwidth exceeds
    ``max_kb`` (the block-tridiagonal layout cannot hold it).
    """
    n = stamps.n if n_limit is None else n_limit
    if n == 0 or n > _BAND_PLAN_MAX_N:
        return None
    if n_limit is None:
        sel = np.arange(len(stamps.g_rows), dtype=np.int64)
    else:
        sel = np.nonzero((stamps.g_rows < n) & (stamps.g_cols < n))[0]
    rows = stamps.g_rows[sel].astype(np.int64)
    cols = stamps.g_cols[sel].astype(np.int64)
    if len(rows) == 0:
        return None
    natural_bw = int(np.max(np.abs(rows - cols)))
    order = rcm_order(n, rows, cols)
    rank = np.argsort(order)
    rcm_bw = int(np.max(np.abs(rank[rows] - rank[cols])))
    if natural_bw <= rcm_bw:  # keep the netlist's own ordering if no worse
        order = np.arange(n, dtype=np.int64)
        rank = order
        halfbw = natural_bw
    else:
        halfbw = rcm_bw
    kb = next((k for k in _KB_CHOICES if halfbw <= k <= max_kb), None)
    if kb is None:
        return None
    n_pad = -(-n // kb) * kb
    nb = n_pad // kb
    pr, pc = rank[rows], rank[cols]
    # Row r', column c' lands in block row t = r'//kb at band column
    # c' − (t − 1)·kb ∈ [0, 3kb), since halfbw ≤ kb.
    g_flat = pr * (3 * kb) + (pc - (pr // kb) * kb + kb)
    pad_rows = np.arange(n, n_pad, dtype=np.int64)
    unit_flat = pad_rows * (3 * kb) + (pad_rows % kb) + kb
    rhs_sel = np.nonzero(stamps.rhs_rows < n)[0]
    rhs_perm_rows = rank[stamps.rhs_rows[rhs_sel].astype(np.int64)]
    return BandPlan(
        n=n, kb=kb, n_pad=n_pad, nb=nb, halfbw=halfbw,
        order=order, rank=rank, sel=sel,
        g_flat=g_flat.astype(np.int64),
        rhs_sel=rhs_sel, rhs_perm_rows=rhs_perm_rows.astype(np.int64),
        unit_flat=unit_flat,
    )


def band_plan(stamps: StampTensors) -> BandPlan | None:
    """Cached full-system band plan (None if not bandable)."""
    cached = stamps.__dict__.get("_band_plan", False)
    if cached is False:
        cached = make_band_plan(stamps)
        stamps.__dict__["_band_plan"] = cached
    return cached


def node_band_plan(stamps: StampTensors) -> BandPlan | None:
    """Cached band plan of the resistive node block (schur tier)."""
    cached = stamps.__dict__.get("_node_band_plan", False)
    if cached is False:
        cached = make_band_plan(stamps, n_limit=stamps.n_kcl)
        stamps.__dict__["_node_band_plan"] = cached
    return cached


def band_matvec(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-band matvec ``y = W·x``: ``W`` [..., nb, kb, 3kb], ``x``
    [..., n_pad] -> y [..., n_pad].  Plain products in the inputs' dtype
    (f64 never goes through TF32)."""
    nb, kb = W.shape[-3], W.shape[-2]
    xb = x.reshape(x.shape[:-1] + (nb, kb, 1))
    zeros = torch.zeros_like(xb[..., :1, :, :])
    x_lo = torch.cat([zeros, xb[..., :-1, :, :]], dim=-3)
    x_hi = torch.cat([xb[..., 1:, :, :], zeros], dim=-3)
    y = (W[..., :kb] @ x_lo + W[..., kb:2 * kb] @ xb
         + W[..., 2 * kb:] @ x_hi)
    return y.reshape(x.shape)


def band_thomas_solve(W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain no-pivot block-Thomas solve: ``W`` [..., nb, kb, 3kb], ``b``
    [..., nb·kb] (one RHS) or [..., nb·kb, r] -> x of b's shape and dtype.

    One Python step per block row over the whole batch (the JAX package's
    ``lax.scan`` under ``vmap``); each step solves ``S_t [C_t | y_t] =
    [U_t | b_t − L_t y_{t−1}]`` with ``torch.linalg.solve`` (pivoted inside
    the block, as ``jnp.linalg.solve`` is).  Block row 0 reads no carry.
    Any float dtype.  The CUDA kernel (:mod:`nodal_tpu_torch.ops.
    block_thomas`) computes the same recursion.
    """
    nb, kb = W.shape[-3], W.shape[-2]
    vector_rhs = b.dim() == W.dim() - 2
    if vector_rhs:
        b = b[..., None]
    bb = b.reshape(b.shape[:-2] + (nb, kb, b.shape[-1]))
    Cs, ys = [], []
    for t in range(nb):
        Wt = W[..., t, :, :].to(b.dtype)
        L, S, U = Wt[..., :kb], Wt[..., kb:2 * kb], Wt[..., 2 * kb:]
        rhs = bb[..., t, :, :]
        if t:
            S = S - L @ Cs[-1]
            rhs = rhs - L @ ys[-1]
        sol = torch.linalg.solve(S, torch.cat([U, rhs], dim=-1))
        Cs.append(sol[..., :kb])
        ys.append(sol[..., kb:])
    xs = [ys[-1]]
    for t in range(nb - 2, -1, -1):
        xs.append(ys[t] - Cs[t] @ xs[-1])
    x = torch.stack(xs[::-1], dim=-3).reshape(b.shape)
    return x[..., 0] if vector_rhs else x


@dataclass(frozen=True)
class ThomasFactors:
    """The elimination :func:`band_thomas_factor` kept of the band ``W``:
    for each block row the LU factors and pivots of S_t and C_t =
    S_t⁻¹U_t."""

    W: torch.Tensor
    lu: list
    C: list


def band_thomas_factor(W: torch.Tensor, b: torch.Tensor):
    """:func:`band_thomas_solve` keeping the elimination: ``(x,
    ThomasFactors)`` for :func:`band_thomas_substitute`.  Each step takes
    the LU that ``torch.linalg.solve`` takes, so x is
    :func:`band_thomas_solve`'s bit for bit.  The plain version of the
    block-Thomas kernel's held factorization."""
    nb, kb = W.shape[-3], W.shape[-2]
    vector_rhs = b.dim() == W.dim() - 2
    if vector_rhs:
        b = b[..., None]
    bb = b.reshape(b.shape[:-2] + (nb, kb, b.shape[-1]))
    lus, Cs, ys = [], [], []
    for t in range(nb):
        Wt = W[..., t, :, :].to(b.dtype)
        L, S, U = Wt[..., :kb], Wt[..., kb:2 * kb], Wt[..., 2 * kb:]
        rhs = bb[..., t, :, :]
        if t:
            S = S - L @ Cs[-1]
            rhs = rhs - L @ ys[-1]
        lus.append(torch.linalg.lu_factor(S))
        sol = torch.linalg.lu_solve(*lus[-1], torch.cat([U, rhs], dim=-1))
        Cs.append(sol[..., :kb])
        ys.append(sol[..., kb:])
    x = _back_substitute(Cs, ys).reshape(b.shape)
    return (x[..., 0] if vector_rhs else x), ThomasFactors(W, lus, Cs)


def band_thomas_substitute(f: ThomasFactors, b: torch.Tensor
                           ) -> torch.Tensor:
    """x = W⁻¹b on the elimination ``f`` of W, for b shaped as in
    :func:`band_thomas_solve`: only the substitutions

        y_t = S_t⁻¹ (b_t − L_t y_{t−1}),  x_t = y_t − C_t x_{t+1},

    which give the bits :func:`band_thomas_solve` gives for the same W
    and b.  The plain version of ``block_thomas_subst``."""
    W = f.W
    kb = W.shape[-2]
    vector_rhs = b.dim() == W.dim() - 2
    if vector_rhs:
        b = b[..., None]
    r = b.shape[-1]
    bb = b.reshape(b.shape[:-2] + (len(f.lu), kb, r))
    ys = []
    for t, (LU, piv) in enumerate(f.lu):
        rhs = bb[..., t, :, :]
        if t:
            rhs = rhs - W[..., t, :, :].to(b.dtype)[..., :kb] @ ys[-1]
        # The triangular solves take one column by another path than
        # several: a lone right-hand side goes with a zero column, as it
        # goes beside U_t in the elimination, and comes out in its bits.
        if r == 1:
            rhs = torch.cat([rhs, torch.zeros_like(rhs)], dim=-1)
        ys.append(torch.linalg.lu_solve(LU, piv, rhs)[..., :r])
    x = _back_substitute(f.C, ys).reshape(b.shape)
    return x[..., 0] if vector_rhs else x


def _back_substitute(Cs: list, ys: list) -> torch.Tensor:
    """x_{nb−1} = y_{nb−1}, x_t = y_t − C_t x_{t+1}: [..., nb, kb, r]."""
    xs = [ys[-1]]
    for t in range(len(ys) - 2, -1, -1):
        xs.append(ys[t] - Cs[t] @ xs[-1])
    return torch.stack(xs[::-1], dim=-3)
