"""Scalable general sparse MNA: bordered block elimination over AMG-CG.

Counterpart of ``nodal_tpu/ops/sparse_schur.py``.  The reference hands any
sparse MNA system (voltage sources, controlled sources, opamp
macromodels) to SuperLU (reference nodal.py:325).  Plain Krylov on the full
indefinite system stalls on the circuits that matter (branch equations put
zeros on the diagonal), so the solve here is a direct method whose only
iterative piece is CG on an SPD block, where multigrid is reliable.

Structure: MNA orders unknowns [node potentials | branch currents], and
only resistor stamps produce node-node entries, so the node block of G is
the grounded resistor Laplacian.  Partition the unknowns into

* **K1**: nodes with a resistive path to ground (and all but one node of
  each ungrounded resistor component).  The K1×K1 block A11 is SPD;
* **border**: everything else (every branch-current row, the
  representative of each ungrounded component), usually tiny next to n.

No resistor edge crosses the partition, so A12/A21 carry only source
couplings::

    [A11 A12] [x1]   [b1]        S = A22 - A21 A11^-1 A12
    [A21 A22] [x2] = [b2]        (m x m, dense, pivoted f64)

Solve: the m + 1 right-hand sides ``A11⁻¹ [A12 | b1]``, a pivoted dense f64
LU of S, back-substitution, then full-system f64 defect correction that
reuses both factorizations (each pass one A11 solve and one dense
back-substitution).

Routes of the A11 solves, by device (``a11="auto"``):

* **CPU**: the JAX package's order: the native skyline LDLᵀ
  (:mod:`nodal_tpu_torch.ops.skyline`, method ``schur-skyline``), then f64
  AMG-CG on the host (``schur``);
* **CUDA**: f64 AMG-CG on the card over the hierarchy of
  :func:`nodal_tpu_torch.ops.amg.build_hierarchy` (``schur-cuda``), and
  nothing else: no host skyline, no host fallback when CG stalls.  YB, S
  and the LU of S stay on the card.

``a11="skyline"`` takes the skyline alone (CPU only), ``a11="cg"`` AMG-CG
alone, so the card's route runs on the CPU too.  The JAX package's f32
accelerator tier is not carried over: the H100 has native f64.

Caps: the bordered elimination serves borders of at most ``_BORDER_CAP``
rows through CG on the CPU and ``_BORDER_CAP_NATIVE`` through the skyline,
as in the JAX package; on CUDA the card's CG tier serves up to
``_BORDER_CAP_NATIVE``.  Every route keeps A11⁻¹A12 (``YB``, [m, n1] f64)
under ``_YB_BYTES_CAP``; it is filled in place, one chunk of columns at a
time, with no transposed second copy.

Sums that run on the card do so in a fixed order (``segment_reduce`` over
sorted entries, no atomics), so a repeat of a solve gives the same bits.
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from numpy.linalg import LinAlgError

from nodal_tpu_torch.models.stamps import (_INV, _LIN, StampTensors,
                                           stamp_values_np)
from nodal_tpu_torch.ops import amg, reduce_e, skyline
from nodal_tpu_torch.ops.cg import cg
from nodal_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class GeneralSolveInfo(NamedTuple):
    """Host-side SolveInfo analogue (numpy scalars) with a solver label."""

    residual: np.float64
    iterations: np.int64
    converged: np.bool_
    method: str = "schur"


#: Border rows the host CG tier serves: beyond it the dense Schur
#: complement (m² f64) and the m + 1 CG right-hand sides are the stall the
#: cap prevents on the CPU.
_BORDER_CAP = 4096

#: Border rows of the native skyline tier (m direct backsolves and one m²
#: dense LU are seconds of host BLAS up to ~16k rows) and of the card's
#: CG tier, whose m batched solves and m² LU are work the card is for.
_BORDER_CAP_NATIVE = 16384

#: Cap on the dense A11⁻¹·A12 block (n1 × m f64): 8 GB.
_YB_BYTES_CAP = 8 << 30

#: Right-hand-side columns of one A11 solve on the CPU.
_RHS_CHUNK = 32

#: On the card, one batch of A11 solves may take this share of the card's
#: memory (its total, so the chunking, and with it the bits, is the same
#: on every run): ``1 / _CARD_CG_SHARE``.
_CARD_CG_SHARE = 8

#: Working vectors of a batched AMG-CG column, in units of n1 (CG's state,
#: its updates, the V-cycle's levels), and gathered entries in units of
#: A11's nnz (the matvec's gather and products).
_CG_VECTORS = 16
_CG_GATHERS = 3

#: Bytes of the gathered A21 entries that one step of the Schur
#: complement's assembly may hold.
_S_GATHER_BYTES = 1 << 30

_A11_ROUTES = ("auto", "skyline", "cg")


@dataclass
class GeneralPlan:
    """Host-side partition + index plan for one netlist topology.

    Built once per StampTensors (structure only — values fold in per
    parameter vector) and cached on the stamps object.
    """

    n: int
    n1: int  # |K1|
    m: int   # border size
    k1: np.ndarray       # int64[n1] original MNA rows of K1, ascending
    border: np.ndarray   # int64[m] original MNA rows of the border
    pos: np.ndarray      # int64[n]: position within its block (K1 or border)
    in_k1: np.ndarray    # bool[n]
    # Deduplicated A11 COO in K1-local numbering, row-sorted.
    a11_rows: np.ndarray
    a11_cols: np.ndarray
    a11_slot_of_entry: np.ndarray  # slot for each selected stamp entry
    a11_sel: np.ndarray            # stamp-entry indices landing in A11
    # Off-diagonal / border entry selections (raw stamp entries, not deduped
    # — np.add.at folds duplicates when the blocks are materialized).
    a12_sel: np.ndarray
    a21_sel: np.ndarray
    a22_sel: np.ndarray

    @property
    def viable(self) -> bool:
        return _border_fits(self, _BORDER_CAP)


def _border_fits(plan: GeneralPlan, cap: int) -> bool:
    return plan.m <= cap and plan.n1 * max(plan.m, 1) * 8 <= _YB_BYTES_CAP


def resistively_grounded_nodes(stamps: StampTensors) -> np.ndarray:
    """Boolean mask over the ``n_kcl`` node rows: True where the node has a
    resistive path to ground.

    Only resistor stamps create node-node entries (source couplings go to
    branch rows/columns — see models/stamps.py), so the node block is the
    grounded resistor Laplacian: a node's row sum over that block equals its
    total conductance to ground.  Connected components of the off-diagonal
    graph whose total row-sum excess is positive are grounded.  Component
    labeling runs through scipy.sparse.csgraph; cached on the stamps object.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    cached = getattr(stamps, "_grounded_mask", None)
    if cached is not None:
        return cached
    nk = stamps.n_kcl
    mask = (stamps.g_rows < nk) & (stamps.g_cols < nk)
    rows = stamps.g_rows[mask].astype(np.int64)
    cols = stamps.g_cols[mask].astype(np.int64)
    vals, _ = stamp_values_np(stamps, stamps.params)
    vals = vals[mask]

    off = rows != cols
    adj = sp.csr_matrix(
        (np.ones(int(off.sum())), (rows[off], cols[off])), shape=(nk, nk)
    )
    _, roots = connected_components(adj, directed=False)
    # Row-sum excess per component = conductance to ground.  Scale-relative
    # threshold: a component is grounded when its excess is more than
    # rounding noise relative to its own diagonal mass.
    excess = np.zeros(nk)
    np.add.at(excess, roots[rows], vals)
    diag_mass = np.zeros(nk)
    np.add.at(diag_mass, roots[rows[~off]], np.abs(vals[~off]))
    grounded_root = excess > 1e-12 * np.maximum(diag_mass, 1e-300)
    out = grounded_root[roots]
    stamps._grounded_mask = out  # type: ignore[attr-defined]
    return out


def _k1_node_mask(stamps: StampTensors) -> np.ndarray:
    """Node rows whose A11 sub-block is guaranteed SPD.

    Nodes in resistively-grounded components all qualify.  A component of
    the resistor graph *without* a ground path (e.g. a mesh held only by
    voltage sources) has a singular Laplacian block, but deleting any single
    vertex of a connected component makes the remaining principal
    submatrix SPD — so one representative node per ungrounded component
    moves to the border and the rest stay in K1.  Nodes with no resistor
    entries at all are their own ungrounded singleton components and land
    in the border as their own representatives.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    nk = stamps.n_kcl
    mask = (stamps.g_rows < nk) & (stamps.g_cols < nk)
    rows = stamps.g_rows[mask].astype(np.int64)
    cols = stamps.g_cols[mask].astype(np.int64)
    vals, _ = stamp_values_np(stamps, stamps.params)
    vals = vals[mask]
    off = rows != cols
    adj = sp.csr_matrix(
        (np.ones(int(off.sum())), (rows[off], cols[off])), shape=(nk, nk)
    )
    ncomp, labels = connected_components(adj, directed=False)
    excess = np.zeros(ncomp)
    np.add.at(excess, labels[rows], vals)
    diag_mass = np.zeros(ncomp)
    np.add.at(diag_mass, labels[rows[~off]], np.abs(vals[~off]))
    grounded_comp = excess > 1e-12 * np.maximum(diag_mass, 1e-300)
    # Representative (first node) of each component; a node with no
    # resistor entries forms a singleton component and is its own rep.
    has_entries = np.zeros(nk, dtype=bool)
    has_entries[rows] = True
    _, rep = np.unique(labels, return_index=True)
    k1 = grounded_comp[labels] & has_entries
    ungrounded_rep = rep[~grounded_comp]
    promote = ~grounded_comp[labels] & has_entries
    promote[ungrounded_rep] = False
    k1 |= promote
    return k1


def general_plan(stamps: StampTensors) -> GeneralPlan:
    """Cached partition plan (see module docstring) for one topology."""
    cached = getattr(stamps, "_general_plan", None)
    if cached is not None:
        return cached
    n, nk = stamps.n, stamps.n_kcl
    in_k1 = np.zeros(n, dtype=bool)
    in_k1[:nk] = _k1_node_mask(stamps)
    k1 = np.nonzero(in_k1)[0]
    border = np.nonzero(~in_k1)[0]
    pos = np.empty(n, dtype=np.int64)
    pos[k1] = np.arange(len(k1))
    pos[border] = np.arange(len(border))

    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    rk = in_k1[gr]
    ck = in_k1[gc]
    a11_sel = np.nonzero(rk & ck)[0]
    a12_sel = np.nonzero(rk & ~ck)[0]
    a21_sel = np.nonzero(~rk & ck)[0]
    a22_sel = np.nonzero(~rk & ~ck)[0]

    n1 = len(k1)
    r11 = pos[gr[a11_sel]]
    c11 = pos[gc[a11_sel]]
    key = r11 * max(n1, 1) + c11
    uniq, inverse = np.unique(key, return_inverse=True)
    plan = GeneralPlan(
        n=n, n1=n1, m=len(border),
        k1=k1, border=border, pos=pos, in_k1=in_k1,
        a11_rows=(uniq // max(n1, 1)).astype(np.int32),
        a11_cols=(uniq % max(n1, 1)).astype(np.int32),
        a11_slot_of_entry=inverse.astype(np.int64),
        a11_sel=a11_sel,
        a12_sel=a12_sel, a21_sel=a21_sel, a22_sel=a22_sel,
    )
    stamps._general_plan = plan  # type: ignore[attr-defined]
    return plan


def _skyline_plan_of(stamps: StampTensors, plan: GeneralPlan):
    """Cached pattern plan for the native skyline direct tier, or None
    when the RCM profile of A11 blows the memory/FLOP caps (irregular
    graphs) — topology-level, shared across parameter values."""
    sentinel = getattr(stamps, "_skyline_plan", "missing")
    if sentinel != "missing":
        return sentinel
    splan = None
    if skyline.available() and plan.n1 > 0:
        splan = skyline.plan_skyline(plan.n1, plan.a11_rows, plan.a11_cols)
    stamps._skyline_plan = splan  # type: ignore[attr-defined]
    return splan


def _native_viable(stamps: StampTensors, plan: GeneralPlan,
                   dev: torch.device, a11: str) -> bool:
    """Is the native skyline tier worth attempting?  Only on the CPU, when
    ``a11`` allows it and A11's pattern fits the skyline's caps."""
    if dev.type != "cpu" or a11 == "cg":
        return False
    return _skyline_plan_of(stamps, plan) is not None


def _cg_cap(dev: torch.device) -> int:
    """Border rows the CG tier serves on ``dev``."""
    return _BORDER_CAP if dev.type == "cpu" else _BORDER_CAP_NATIVE


def _plan_viable(stamps: StampTensors, plan: GeneralPlan,
                 dev: torch.device, a11: str) -> bool:
    """Can any tier of ``dev`` serve this partition?  The CG tier keeps
    its device's cap (:func:`_cg_cap`); on the CPU the native skyline tier
    extends it to ``_BORDER_CAP_NATIVE``."""
    if a11 != "skyline" and _border_fits(plan, _cg_cap(dev)):
        return True
    return (_border_fits(plan, _BORDER_CAP_NATIVE)
            and _native_viable(stamps, plan, dev, a11))


def _check_route(a11: str, dev: torch.device) -> None:
    if a11 not in _A11_ROUTES:
        raise ValueError(f"unknown a11 route {a11!r}; use one of "
                         f"{_A11_ROUTES}")
    if a11 == "skyline" and dev.type != "cpu":
        raise ValueError("a11='skyline' is the host skyline LDLᵀ; on "
                         f"{dev.type} the A11 solves run AMG-CG on the card")


def _couplings(stamps: StampTensors, plan: GeneralPlan, g_vals):
    """The A21 and A12 couplings of one value vector as block-local
    triplets ``(rows, cols, vals)``."""
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    return tuple((plan.pos[gr[sel]], plan.pos[gc[sel]], g_vals[sel])
                 for sel in (plan.a21_sel, plan.a12_sel))


def _value_blocks(stamps: StampTensors, plan: GeneralPlan, g_vals):
    """Numeric blocks of the partition for one value vector: deduped A11
    values, the dense A22 block, and the A21/A12 couplings as
    block-local triplets ``(rows, cols, vals)``."""
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    a11_vals = np.zeros(len(plan.a11_rows))
    np.add.at(a11_vals, plan.a11_slot_of_entry, g_vals[plan.a11_sel])
    m = plan.m
    A22 = np.zeros((m, m))
    np.add.at(
        A22,
        (plan.pos[gr[plan.a22_sel]], plan.pos[gc[plan.a22_sel]]),
        g_vals[plan.a22_sel],
    )
    a21, a12 = _couplings(stamps, plan, g_vals)
    return a11_vals, A22, a21, a12


def _column_chunk(dev: torch.device, n1: int, nnz: int) -> int:
    """Right-hand-side columns of one batched A11 solve: ``_RHS_CHUNK`` on
    the CPU, as the JAX package batches; on the card as many as
    ``1 / _CARD_CG_SHARE`` of its memory holds."""
    if dev.type == "cpu":
        return _RHS_CHUNK
    total = torch.cuda.get_device_properties(dev).total_memory
    per_column = 8 * (_CG_VECTORS * n1 + _CG_GATHERS * nnz)
    return max(1, total // _CARD_CG_SHARE // per_column)


def _a11_solver(stamps: StampTensors, plan: GeneralPlan, a11_vals, tol,
                backend: str, dev: torch.device):
    """The solver of the SPD grounded node block on ``dev``: ``solve_cols``
    maps a [c, n1] f64 right-hand-side batch on ``dev`` to ``(X [c, n1],
    iterations summed over the columns, every column converged)``.

    ``backend``: ``"native"``, the host skyline LDLᵀ (CPU only), or
    ``"cg"``, AMG-preconditioned CG at ``tol`` with ``maxiter = min(4·n1 +
    100, 100000)``.  The AMG hierarchy is cached on the stamps object per
    A11 fingerprint (set-up is value-dependent) and shared across
    tolerances; its tensors are cached per device.
    """
    # Exact-bytes fingerprint: a permuted value vector (two resistors
    # swapped) must not hit a stale hierarchy.
    fingerprint = hashlib.sha1(
        np.ascontiguousarray(a11_vals, dtype=np.float64).tobytes()
    ).hexdigest()
    cache = getattr(stamps, "_a11_cache", None)
    if cache is None or cache["fp"] != fingerprint:
        cache = {"fp": fingerprint, "levels": None, "solvers": {},
                 "arrays": {}}
        stamps._a11_cache = cache  # type: ignore[attr-defined]
    key = (float(tol), backend, str(dev))
    hit = cache["solvers"].get(key)
    if hit is not None:
        return hit

    if backend == "native":
        if cache.get("native_failed"):
            # Pivot failure is a property of this value vector — don't
            # re-pay the full factorization attempt on every warm solve.
            raise skyline.SkylineUnavailable(
                "non-positive pivot (A11 not SPD here)")
        splan = _skyline_plan_of(stamps, plan)
        if splan is None:
            raise skyline.SkylineUnavailable("profile over caps")
        fact = skyline.factor(splan, plan.a11_rows, plan.a11_cols, a11_vals)
        if fact is None:
            cache["native_failed"] = True
            raise skyline.SkylineUnavailable(
                "non-positive pivot (A11 not SPD here)")

        def solve_cols(B):
            X = skyline.solve(fact, B.numpy())
            return torch.from_numpy(X), B.shape[0], True
    else:
        arrays = cache["arrays"].get(str(dev))
        if arrays is None:
            if cache["levels"] is None:
                cache["levels"] = amg.build_hierarchy(
                    plan.n1, plan.a11_rows, plan.a11_cols, a11_vals)
            arrays = amg.hierarchy_arrays(cache["levels"], torch.float64,
                                          dev)
            cache["arrays"][str(dev)] = arrays
        M = amg.make_vcycle(arrays)
        lv0 = arrays[0]
        maxiter = min(4 * plan.n1 + 100, 100_000)

        def mv(x):
            return amg.csr_matvec(lv0["offsets"], lv0["cols"], lv0["vals"],
                                  x)

        def solve_cols(B):
            X, info = cg(mv, B, preconditioner=M, tol=float(tol),
                         maxiter=maxiter)
            return (X, int(info.iterations.sum()),
                    bool(info.converged.all()))

    cache["solvers"][key] = solve_cols
    return solve_cols


@dataclass
class _Factor:
    """The b-independent block factorization on ``dev``: the A11 solver,
    YB = A11⁻¹A12 ([m, n1]) and the pivoted LU of the Schur complement.
    Its methods take and return host f64 numpy vectors."""

    dev: torch.device
    solve_cols: Callable | None
    YB: torch.Tensor
    lu: torch.Tensor | None
    piv: torch.Tensor | None

    def a11(self, r: np.ndarray):
        """``(A11⁻¹ r, iterations)``; None for the solution when CG
        stalled or it is not finite."""
        X, iters, ok = self.solve_cols(
            torch.as_tensor(r, dtype=torch.float64, device=self.dev)[None])
        w = X[0].cpu().numpy()
        if not ok or not np.all(np.isfinite(w)):
            return None, iters
        return w, iters

    def schur(self, r: np.ndarray, trans: bool = False) -> np.ndarray:
        """``S⁻¹ r`` (``S⁻ᵀ r`` with ``trans``) by the pivoted LU.  A zero
        pivot gives inf/NaN, which the residual gate reports."""
        if self.lu is None:
            return np.zeros(0)
        rhs = torch.as_tensor(r, dtype=torch.float64, device=self.dev)
        out = torch.linalg.lu_solve(self.lu, self.piv, rhs[:, None],
                                    adjoint=trans)
        return out[:, 0].cpu().numpy()

    def yb_t(self, x2: np.ndarray) -> np.ndarray:
        """``YBᵀ x2`` ([n1])."""
        x = torch.as_tensor(x2, dtype=torch.float64, device=self.dev)
        return (x @ self.YB).cpu().numpy()


def _a12_columns(a12, n1: int):
    """A12's entries as unique (border column, K1 row) pairs sorted by
    column, duplicates summed in entry order: ``(cols, rows, vals)``."""
    rows, cols, vals = a12
    key = cols.astype(np.int64) * max(n1, 1) + rows
    uniq, inverse = np.unique(key, return_inverse=True)
    summed = np.bincount(inverse, weights=vals, minlength=len(uniq))
    return uniq // max(n1, 1), uniq % max(n1, 1), summed


def _schur_complement(A22: np.ndarray, a21, YB: torch.Tensor,
                      dev: torch.device) -> torch.Tensor:
    """``S = A22 − A21 YBᵀ`` on ``dev``: each entry of A21 gathers its
    column of YB, and each border row sums its entries in order
    (``segment_reduce`` over the entries sorted by row), a chunk of YB's
    rows at a time."""
    S = torch.as_tensor(A22, dtype=torch.float64, device=dev).clone()
    rows, cols, vals = a21
    if not len(vals):
        return S
    m = S.shape[0]
    order = np.argsort(rows, kind="stable")
    c = torch.as_tensor(cols[order], device=dev)
    v = torch.as_tensor(vals[order], dtype=torch.float64, device=dev)
    offsets = torch.as_tensor(
        np.searchsorted(rows[order], np.arange(m + 1)), device=dev)
    step = max(1, _S_GATHER_BYTES // (8 * len(vals)))
    for j0 in range(0, m, step):
        block = YB[j0:j0 + step]
        terms = block[:, c] * v
        T = torch.segment_reduce(
            terms, "sum", offsets=offsets.expand(block.shape[0], -1),
            axis=1)
        S[:, j0:j0 + step] -= T.T
    return S


def _schur_lu(S: torch.Tensor):
    """Pivoted f64 LU of the Schur complement on its device.  A non-finite
    LU raises LinAlgError, the surface of the reference's dense path
    (numpy.linalg.solve at reference nodal.py:327); an exactly zero pivot
    does not raise here: its back-substitutions give inf/NaN, which the
    residual gate catches."""
    if S.shape[0] == 0:
        return None, None
    lu, piv, _ = torch.linalg.lu_factor_ex(S)
    if not bool(torch.isfinite(lu).all()):
        raise LinAlgError("Singular matrix")
    return lu, piv


def _factorization(stamps: StampTensors, plan: GeneralPlan, g_vals,
                   cg_tol: float, backend: str, dev: torch.device):
    """b-independent block factorization at ``cg_tol``: ``(_Factor,
    iterations)``, or ``(None, iterations)`` when CG stalled building YB.

    Cached on the stamps object keyed by (SHA-1 of the stamp values, tol,
    backend, device): YB is m A11 solves, the dominant cost, while each
    solve with the factorization needs one A11 pass for its own RHS.  The
    same factorization serves the transposed system (adjoint solves): A11
    is symmetric, so only the Schur LU needs the transpose.
    """
    key = (hashlib.sha1(g_vals.tobytes()).hexdigest(), float(cg_tol),
           backend, str(dev))
    cache = getattr(stamps, "_general_fact", None)
    if cache is not None and cache["key"] == key:
        return cache["fact"], 0

    a11_vals, A22, a21, a12 = _value_blocks(stamps, plan, g_vals)
    n1, m = plan.n1, plan.m
    iters = 0
    solve_cols = None
    YB = torch.zeros((m, n1), dtype=torch.float64, device=dev)
    if n1 > 0:
        solve_cols = _a11_solver(stamps, plan, a11_vals, cg_tol, backend,
                                 dev)
        cols, rows, vals = _a12_columns(a12, n1)
        starts = np.searchsorted(cols, np.arange(m + 1))
        chunk = _column_chunk(dev, n1, len(plan.a11_rows))
        ok = True
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            s, e = starts[lo], starts[hi]
            R = torch.zeros((hi - lo, n1), dtype=torch.float64, device=dev)
            R[torch.as_tensor(cols[s:e] - lo, device=dev),
              torch.as_tensor(rows[s:e], device=dev)] = torch.as_tensor(
                  vals[s:e], dtype=torch.float64, device=dev)
            X, it, conv = solve_cols(R)
            YB[lo:hi] = X
            iters += it
            ok = ok and conv
        if not ok or not bool(torch.isfinite(YB).all()):
            logger.error(
                "AMG-CG stalled on the grounded node block (n1=%d)", n1)
            return None, iters
    S = _schur_complement(A22, a21, YB, dev)
    lu, piv = _schur_lu(S)
    fact = _Factor(dev, solve_cols, YB, lu, piv)
    stamps._general_fact = {"key": key,  # type: ignore[attr-defined]
                            "fact": fact}
    return fact, iters


def _tiers(attempt, stamps: StampTensors, plan: GeneralPlan,
           dev: torch.device, a11: str, tol: float, setup_tol: float,
           label: str):
    """The tiers of one bordered solve, in the JAX package's order for the
    device: ``(x, rel, method)``, x None when no tier produced one.

    ``attempt(cg_tol, backend) -> (x, rel, stalled)`` solves with the
    (cached) factorization and refines.  On the CPU the native skyline
    goes first; a border over the CG cap that it could not serve raises
    ValueError with the residual it reached.  Then AMG-CG at the loose
    ``setup_tol``, rebuilt once at ``tol`` when refinement stalled.
    """
    def good(r):
        return np.isfinite(r) and r <= tol

    x, rel = None, np.inf
    if _native_viable(stamps, plan, dev, a11):
        try:
            x, rel, _ = attempt(tol, "native")
        except skyline.SkylineUnavailable as e:
            logger.info("skyline tier unavailable (%s); falling back", e)
        if x is not None and good(rel):
            return x, rel, f"{label}-skyline"
    if a11 == "skyline":
        return x, rel, label
    if plan.m > _cg_cap(dev):
        raise ValueError(
            f"the native direct tier reached a residual of {rel:.2e} "
            f"(target {tol:.0e}) and the border (m={plan.m}) is over the "
            f"iterative tier's cap of {_cg_cap(dev)} rows on {dev.type}")
    cg_tol = min(max(setup_tol, tol), 1e-3)
    method = label if dev.type == "cpu" else f"{label}-{dev.type}"
    x2, rel2, stalled = attempt(cg_tol, "cg")
    if x2 is not None and (x is None or rel2 < rel or not np.isfinite(rel)):
        x, rel = x2, rel2
    if x2 is not None and stalled and rel > tol and cg_tol > tol * 10:
        # A sloppy factorization could not carry refinement to tol:
        # rebuild at the target tolerance (the exact path).
        logger.info(
            "bordered elimination: refinement stalled at %.2e with "
            "setup_tol=%.0e; rebuilding at %.0e", rel, cg_tol, tol)
        x2, rel2, _ = attempt(tol, "cg")
        if x2 is not None and (rel2 < rel or not np.isfinite(rel)):
            x, rel = x2, rel2
    return x, rel, method


def _refine(x, residual_fn, scale, tol, refine_passes, correct):
    """Defect correction of a block solve against the exact f64 residual,
    reusing the factorization: ``(x, rel, stalled)``.  ``correct(r) ->
    dx | None`` is one solve with the factorization; a pass contracting
    by less than 0.3 reports a stall (the factorization is too sloppy)."""
    rel = np.inf
    for _ in range(max(refine_passes, 1)):
        r = residual_fn(x)
        rel_new = float(np.max(np.abs(r))) / scale
        if rel_new <= tol or not np.isfinite(rel_new):
            return x, rel_new, False
        if rel_new > 0.3 * rel:
            return x, rel_new, True
        rel = rel_new
        dx = correct(r)
        if dx is None:
            return x, rel, True
        x = x + dx
    r = residual_fn(x)
    return x, float(np.max(np.abs(r))) / scale, True


def _prepare(stamps, params, device, a11, who):
    dev = resolve_device(device, who)
    _check_route(a11, dev)
    if params is None:
        params = stamps.params
    return dev, np.asarray(params, dtype=np.float64)


def _failed(n: int, total_iters: int, method: str):
    return np.full(n, np.nan), GeneralSolveInfo(
        residual=np.float64(np.inf), iterations=np.int64(total_iters),
        converged=np.bool_(False), method=method)


def _coo_residual(stamps: StampTensors, g_vals, b, transpose=False):
    """``v -> b − G v`` (``b − Gᵀ v`` with ``transpose``) in host f64."""
    gr = stamps.g_rows.astype(np.int64)
    gc = stamps.g_cols.astype(np.int64)
    out_idx, in_idx = (gc, gr) if transpose else (gr, gc)

    def residual(v):
        y = np.zeros(stamps.n)
        with np.errstate(invalid="ignore"):  # singular systems carry NaNs
            np.add.at(y, out_idx, g_vals * v[in_idx])
        return b - y

    return residual


def solve_general_sparse(
    stamps: StampTensors,
    params=None,
    *,
    rhs=None,
    tol: float = 1e-9,
    setup_tol: float = 1e-4,
    refine_passes: int = 14,
    a11: str = "auto",
    device="cuda",
):
    """Direct-quality f64 solve of a general sparse MNA system on
    ``device``.

    Args:
        stamps: compiled stamp tensors (any structure — branch equations,
            source-held nodes, opamp macromodels).
        params: component parameter vector (defaults to netlist values).
        rhs: optional override of the netlist's source vector (length n).
        tol: target relative residual ``max|Gx-b| / max(max|b|, 1)`` of the
            final, audited full-system solution.
        setup_tol: CG tolerance for *building* the factorization (the m+1
            ``A11⁻¹[A12 | b1]`` solves).  Deliberately loose: defect
            correction contracts by roughly ``setup_tol`` per pass while
            each pass costs one A11 solve.  If refinement stalls
            (contraction worse than 0.3 a pass), the factorization is
            rebuilt once at ``tol``.
        refine_passes: refinement-pass cap per attempt.
        a11: ``"auto"``, ``"skyline"`` or ``"cg"`` (module docstring).
        device: ``"cuda"`` (default) or ``"cpu"``.

    Returns ``(x, GeneralSolveInfo)`` with ``x`` host float64 numpy.
    ``info.converged`` is False when CG stalled or refinement could not
    reach ``tol``; a non-finite Schur LU raises
    ``numpy.linalg.LinAlgError``; a border over the caps ``ValueError``.
    """
    dev, params = _prepare(stamps, params, device, a11,
                           "solve_general_sparse")
    plan = general_plan(stamps)
    if not _plan_viable(stamps, plan, dev, a11):
        raise ValueError(
            f"border too large for bordered elimination "
            f"(m={plan.m}, n1={plan.n1}); use an iterative path"
        )
    g_vals, rhs_vals = stamp_values_np(stamps, params)
    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, rhs_vals)
    if rhs is not None:
        b = np.asarray(rhs, dtype=np.float64)
    b1 = b[plan.k1]
    b2 = b[plan.border]
    n1, m = plan.n1, plan.m
    (a21_r, a21_c, a21_v), _ = _couplings(stamps, plan, g_vals)
    b_scale = max(float(np.max(np.abs(b))) if stamps.n else 0.0, 1.0)
    full_residual = _coo_residual(stamps, g_vals, b)
    total_iters = 0

    def solve_blocks(fact, r1, r2):
        """One solve with the block factorization: ``(x1, x2)``, None
        when the A11 solve stalled."""
        nonlocal total_iters
        if n1:
            w1, it = fact.a11(r1)
            total_iters += it
            if w1 is None:
                return None
        else:
            w1 = np.zeros(0)
        rs = np.asarray(r2, dtype=np.float64).copy()
        if len(a21_v):
            np.subtract.at(rs, a21_r, a21_v * w1[a21_c])
        with np.errstate(invalid="ignore"):  # zero pivots -> NaNs, gated
            x2 = fact.schur(rs)
            x1 = w1 - fact.yb_t(x2) if n1 else np.zeros(0)
        return x1, x2

    def attempt(cg_tol, backend):
        nonlocal total_iters
        fact, f_iters = _factorization(stamps, plan, g_vals, cg_tol,
                                       backend, dev)
        total_iters += f_iters
        if fact is None:
            return None, np.inf, False
        blocks = solve_blocks(fact, b1, b2)
        if blocks is None:
            logger.error(
                "AMG-CG stalled on the grounded node block (n1=%d)", n1)
            return None, np.inf, False
        x = np.empty(stamps.n)
        x[plan.k1], x[plan.border] = blocks

        def correct(r):
            d = solve_blocks(fact, r[plan.k1], r[plan.border])
            if d is None:
                return None
            dx = np.empty(stamps.n)
            dx[plan.k1], dx[plan.border] = d
            return dx

        return _refine(x, full_residual, b_scale, tol, refine_passes,
                       correct)

    x, rel, method = _tiers(attempt, stamps, plan, dev, a11, tol,
                            setup_tol, "schur")
    if x is None:
        return _failed(stamps.n, total_iters, method)
    return x, GeneralSolveInfo(
        residual=np.float64(rel),
        iterations=np.int64(total_iters),
        converged=np.bool_(bool(np.isfinite(rel) and rel <= tol)),
        method=method,
    )


def _outer_defect_loop(x, residual_fn, scale, tol, converged,
                       solve_reduced_fn):
    """Shared outer defect-correction loop for :func:`solve_general_auto`
    and its transpose.

    ``solve_reduced_fn(r) -> (dx | None, iters)`` solves the reduced
    system for a full-system residual ``r`` and lifts it back.  The loop
    drives the residual toward the f64 floor while contraction is strong,
    but exits as soon as the delivered residual is inside the ``10·tol``
    acceptance bound and a pass contracted by less than 10× — for
    right-hand sides with scale ≈ 1 the inner solve's own tolerance is
    the achievable floor, and chasing further only burns passes.

    Returns ``(x, rel, extra_iters)``.
    """
    r = residual_fn(x)
    rel = float(np.max(np.abs(r))) / scale
    floor = min(tol, 1e-13)
    iters = 0
    passes = 0
    while np.isfinite(rel) and rel > floor and passes < 4 and converged:
        dx, it = solve_reduced_fn(r)
        iters += it
        if dx is None:
            break
        x_new = x + dx
        r_new = residual_fn(x_new)
        rel_new = float(np.max(np.abs(r_new))) / scale
        passes += 1
        if not np.isfinite(rel_new) or rel_new >= rel:
            break  # no improvement — keep x; roundoff floor reached
        weak = rel_new >= 0.1 * rel
        stalled = rel_new >= 0.5 * rel
        x, r, rel = x_new, r_new, rel_new
        if rel <= 10 * tol and weak:
            break  # inside the acceptance bound and converging slowly
        if stalled:
            break  # improvement but no real contraction
    return x, rel, iters


def _require_viable(stamps, red, dev, a11):
    """ValueError when no tier of ``dev`` can serve the border of the
    stamps the bordered elimination runs on (the reduced ones when ideal
    sources were eliminated)."""
    target = stamps if red is None else red.stamps_red
    plan = general_plan(target)
    if not _plan_viable(target, plan, dev, a11):
        after = "" if red is None else " even after ideal-source reduction"
        raise ValueError(
            f"bordered elimination cannot serve this circuit{after}: "
            f"{plan.m} border rows (cap {_cg_cap(dev)} on {dev.type}) — "
            f"controlled sources/ungrounded-island representatives; split "
            f"the sweep or ground the islands resistively"
        )


def _auto(stamps, params, rhs, tol, setup_tol, a11, device, transpose):
    """:func:`solve_general_auto` and its transpose: reduction, bordered
    elimination on the reduced system, lift, outer defect correction."""
    who = "solve_general_auto" + ("_transpose" if transpose else "")
    dev, params = _prepare(stamps, params, device, a11, who)
    inner = (solve_general_sparse_transpose if transpose
             else solve_general_sparse)
    red = reduce_e.e_reduction_or_none(stamps)
    if red is None or red.n_red:
        _require_viable(stamps, red, dev, a11)
    if red is None:
        return inner(stamps, params, rhs=rhs, tol=tol, setup_tol=setup_tol,
                     a11=a11, device=dev)

    g_vals, rhs_vals = stamp_values_np(stamps, params)
    if transpose:
        b_full = np.asarray(rhs, dtype=np.float64)
    else:
        b_full = np.zeros(stamps.n)
        np.add.at(b_full, stamps.rhs_rows, rhs_vals)
        if rhs is not None:
            b_full = np.asarray(rhs, dtype=np.float64)

    def reduce(r):
        """``(offsets, reduced right-hand side)`` of a full one."""
        if transpose:
            p = reduce_e.offsets_transpose(red, r)
            return p, reduce_e.reduced_rhs_transpose(red, stamps, g_vals, r,
                                                     p)
        V = (r[red.n_kcl + red.tree_edge] if len(red.tree_edge)
             else np.zeros(0))
        q = reduce_e.offsets_from_branch_values(red, V)
        return q, reduce_e.reduced_rhs(red, stamps, g_vals, r, q)

    lift = (reduce_e.expand_solution_transpose if transpose
            else reduce_e.expand_solution)
    if transpose:
        q, b_red = reduce(b_full)
    else:
        # The netlist's own branch voltages, as the JAX package reads them.
        q = reduce_e.offsets(red, stamps, params)
        b_red = reduce_e.reduced_rhs(red, stamps, g_vals, b_full, q)

    base = "ereduce-T" if transpose else "ereduce"
    if red.n_red == 0:
        # Pure ideal-source circuit: every potential is an offset and
        # every current comes from tree peeling.
        x_red = np.zeros(0)
        info = GeneralSolveInfo(
            residual=np.float64(0.0), iterations=np.int64(0),
            converged=np.bool_(True), method=base)
    else:
        x_red, info = inner(red.stamps_red, params, rhs=b_red, tol=tol,
                            setup_tol=setup_tol, a11=a11, device=dev)
        if not np.all(np.isfinite(x_red)):
            return np.full(stamps.n, np.nan), info

    x = lift(red, stamps, x_red, g_vals, b_full, q)

    # Audit on the ORIGINAL system: the inner residual (relative to the
    # reduced right-hand side) is amplified by the lift — group sums and
    # tree-peeled currents spread one reduced-row defect over several
    # original rows (the JAX package measured ~350x at 40k nodes).
    b_scale = max(float(np.max(np.abs(b_full))) if stamps.n else 0.0, 1.0)
    full_residual = _coo_residual(stamps, g_vals, b_full, transpose)

    def solve_reduced(r):
        q0, r_red = reduce(r)
        if red.n_red:
            dx_red, dinfo = inner(red.stamps_red, params, rhs=r_red,
                                  tol=tol, setup_tol=setup_tol, a11=a11,
                                  device=dev)
            if not (bool(dinfo.converged) and np.all(np.isfinite(dx_red))):
                return None, int(dinfo.iterations)
            it = int(dinfo.iterations)
        else:
            dx_red, it = np.zeros(0), 0
        return lift(red, stamps, dx_red, g_vals, r, q0), it

    x, rel, extra = _outer_defect_loop(
        x, full_residual, b_scale, tol, bool(info.converged), solve_reduced)
    ok = np.isfinite(rel) and rel <= 10 * tol and bool(info.converged)
    return x, GeneralSolveInfo(
        residual=np.float64(rel),
        iterations=np.int64(int(info.iterations) + extra),
        converged=np.bool_(bool(ok)),
        method=f"ereduce+{info.method}" if red.n_red else base,
    )


def solve_general_auto(
    stamps: StampTensors,
    params=None,
    *,
    rhs=None,
    tol: float = 1e-9,
    setup_tol: float = 1e-4,
    a11: str = "auto",
    device="cuda",
):
    """Structure-routed general sparse solve on ``device``: ideal-voltage-
    constraint reduction first (:mod:`nodal_tpu_torch.ops.reduce_e`),
    bordered elimination on the (possibly reduced) system.

    This is the SuperLU-robustness entry point (reference nodal.py:325):
    "mostly-branch-equation" circuits (tens of thousands of E sources)
    reduce to supernodes before the Schur border is formed, so the border
    cap only bites on circuits with more *controlled* sources than the
    device's cap, which raise a clear ValueError.

    Returns ``(x, GeneralSolveInfo)`` with ``x`` host float64 over the
    ORIGINAL unknown ordering.  Raises ``numpy.linalg.LinAlgError`` for
    structural singularities (E-cycles, a non-finite Schur LU).
    """
    return _auto(stamps, params, rhs, tol, setup_tol, a11, device, False)


def solve_general_sparse_transpose(
    stamps: StampTensors,
    params=None,
    *,
    rhs,
    tol: float = 1e-9,
    setup_tol: float = 1e-4,
    refine_passes: int = 14,
    a11: str = "auto",
    device="cuda",
):
    """f64 solve of the TRANSPOSED general sparse system ``Gᵀ y = rhs``.

    The bordered factorization of :func:`solve_general_sparse` is reused
    verbatim (and shared through the same cache) because A11 is
    symmetric, and the Schur complement of Gᵀ is exactly Sᵀ:

        Gᵀ = [A11  A21ᵀ]      Schur(Gᵀ) = A22ᵀ − A12ᵀ A11⁻¹ A21ᵀ = Sᵀ.
             [A12ᵀ A22ᵀ]

    One transpose solve costs two A11 solves plus one transposed
    back-substitution on the cached Schur LU.  Refinement runs against the
    exact f64 COO residual of Gᵀ.  Returns ``(y, GeneralSolveInfo)`` like
    the forward solve.
    """
    dev, params = _prepare(stamps, params, device, a11,
                           "solve_general_sparse_transpose")
    plan = general_plan(stamps)
    if not _plan_viable(stamps, plan, dev, a11):
        raise ValueError(
            f"border too large for bordered elimination "
            f"(m={plan.m}, n1={plan.n1}); use an iterative path"
        )
    g_vals, _ = stamp_values_np(stamps, params)
    c = np.asarray(rhs, dtype=np.float64)
    n1, m = plan.n1, plan.m
    (a21_r, a21_c, a21_v), (a12_r, a12_c, a12_v) = _couplings(
        stamps, plan, g_vals)
    c_scale = max(float(np.max(np.abs(c))) if stamps.n else 0.0, 1.0)
    full_residual_t = _coo_residual(stamps, g_vals, c, transpose=True)
    total_iters = 0

    def solve_a11(fact, r):
        nonlocal total_iters
        w, it = fact.a11(r)
        total_iters += it
        if w is None:
            logger.error(
                "AMG-CG stalled on the grounded node block (n1=%d)", n1)
        return w

    def solve_blocks_t(fact, r1, r2):
        """One Gᵀ solve with the block factorization: eliminate y1 =
        A11⁻¹(r1 − A21ᵀ y2), Schur system Sᵀ y2 = r2 − A12ᵀ A11⁻¹ r1."""
        if n1:
            w1 = solve_a11(fact, r1)
            if w1 is None:
                return None
        else:
            w1 = np.zeros(0)
        rs = np.asarray(r2, dtype=np.float64).copy()
        if len(a12_v):
            np.subtract.at(rs, a12_c, a12_v * w1[a12_r])
        with np.errstate(invalid="ignore"):
            y2 = fact.schur(rs, trans=True)
        if not n1:
            return np.zeros(0), y2
        if not len(a21_v):
            return w1, y2
        t = np.zeros(n1)
        np.add.at(t, a21_c, a21_v * y2[a21_r])
        w2 = solve_a11(fact, t)
        if w2 is None:
            return None
        return w1 - w2, y2

    def attempt(cg_tol, backend):
        nonlocal total_iters
        fact, f_iters = _factorization(stamps, plan, g_vals, cg_tol,
                                       backend, dev)
        total_iters += f_iters
        if fact is None:
            return None, np.inf, False
        blocks = solve_blocks_t(fact, c[plan.k1], c[plan.border])
        if blocks is None:
            return None, np.inf, False
        y = np.empty(stamps.n)
        y[plan.k1], y[plan.border] = blocks

        def correct(r):
            d = solve_blocks_t(fact, r[plan.k1], r[plan.border])
            if d is None:
                return None
            dy = np.empty(stamps.n)
            dy[plan.k1], dy[plan.border] = d
            return dy

        return _refine(y, full_residual_t, c_scale, tol, refine_passes,
                       correct)

    y, rel, method = _tiers(attempt, stamps, plan, dev, a11, tol,
                            setup_tol, "schur-T")
    if y is None:
        return _failed(stamps.n, total_iters, method)
    return y, GeneralSolveInfo(
        residual=np.float64(rel),
        iterations=np.int64(total_iters),
        converged=np.bool_(bool(np.isfinite(rel) and rel <= tol)),
        method=method,
    )


def general_auto_viable(stamps: StampTensors, a11: str = "auto",
                        device="cuda") -> bool:
    """Can :func:`solve_general_auto` serve this circuit on ``device``?
    Viability of the bordered elimination AFTER ideal-source reduction
    (raises LinAlgError on a structural E-cycle, which is singular
    regardless)."""
    dev = torch.device(device)
    target = stamps
    red = reduce_e.e_reduction_or_none(stamps)
    if red is not None:
        if red.n_red == 0:
            return True
        target = red.stamps_red
    return _plan_viable(target, general_plan(target), dev, a11)


def solve_general_auto_transpose(
    stamps: StampTensors,
    params=None,
    *,
    rhs,
    tol: float = 1e-9,
    setup_tol: float = 1e-4,
    a11: str = "auto",
    device="cuda",
):
    """Transpose counterpart of :func:`solve_general_auto`: ``Gᵀ y = rhs``
    with the same ideal-source reduction.

    ``(L G R)ᵀ = Rᵀ Gᵀ Lᵀ``, so the reduced transpose system is exactly
    the reduced forward matrix transposed — the adjoint shares the
    forward's cached factorization.  The eliminated sources' current
    *columns* become tree constraints on the adjoint node-row values, and
    their branch-row adjoints are recovered by peeling the same tree
    against the grouped node columns' transpose equations (see
    ops/reduce_e.py).
    """
    return _auto(stamps, params, rhs, tol, setup_tol, a11, device, True)


def general_sparse_adjoint_gradient(
    stamps: StampTensors,
    out_index: int,
    params=None,
    *,
    tol: float = 1e-9,
    a11: str = "auto",
    device="cuda",
):
    """d x[out_index] / d(every component value) by the adjoint method,
    the at-scale counterpart of :func:`nodal_tpu_torch.batch.sensitivities`.

    Cost: one forward solve + one transpose solve on ``device`` (both
    reuse the cached bordered factorization) + the COO chain rule on the
    host; independent of the component count.  Returns ``(pbar
    [n_components] float64, x, info_forward, info_adjoint)``.
    """
    if params is None:
        params = stamps.params
    params = np.asarray(params, dtype=np.float64)

    x, info_f = solve_general_auto(stamps, params, tol=tol, a11=a11,
                                   device=device)
    e = np.zeros(stamps.n)
    e[out_index] = 1.0
    lam, info_a = solve_general_auto_transpose(stamps, params, rhs=e,
                                               tol=tol, a11=a11,
                                               device=device)

    # x̄ = λᵀ(∂b/∂p − ∂G/∂p·x): per-entry cotangents, then the product-
    # rule pullback of stamp values v = coeff · f(p₁,e₁) · f(p₂,e₂) with
    # f = p, 1/p, or 1.
    gbar = -(lam[stamps.g_rows.astype(np.int64)]
             * x[stamps.g_cols.astype(np.int64)])
    rhsbar = lam[stamps.rhs_rows.astype(np.int64)]

    def fac(pidx, exp):
        v = params[pidx]
        return np.where(exp == _LIN, v, np.where(exp == _INV, 1.0 / v, 1.0))

    def dfac(pidx, exp):
        v = params[pidx]
        with np.errstate(divide="ignore"):
            d = np.where(exp == _INV, -1.0 / (v * v), 0.0)
        return np.where(exp == _LIN, 1.0, d)

    pbar = np.zeros_like(params)
    for pidx1, exp1, pidx2, exp2, coeff, bar in (
        (stamps.g_p1, stamps.g_e1, stamps.g_p2, stamps.g_e2,
         stamps.g_coeff, gbar),
        (stamps.rhs_p1, stamps.rhs_e1, stamps.rhs_p2, stamps.rhs_e2,
         stamps.rhs_coeff, rhsbar),
    ):
        f1 = fac(pidx1, exp1)
        f2 = fac(pidx2, exp2)
        np.add.at(pbar, pidx1, bar * coeff * dfac(pidx1, exp1) * f2)
        np.add.at(pbar, pidx2, bar * coeff * f1 * dfac(pidx2, exp2))
    return pbar, x, info_f, info_a
