"""Algebraic multigrid (smoothed aggregation) for general resistive
networks.

Counterpart of ``nodal_tpu/ops/amg.py``.  The host setup is a copy of the
JAX package's (greedy or vectorized neighborhood aggregation, tentative
prolongation smoothed by one damped-Jacobi step ``P = (I − ω D⁻¹A)
P_tent``, exact Galerkin coarse operators through scipy.sparse), so both
packages build identical levels.  The device half is torch on tensors of
an explicit device: the V(1,1) cycle with weighted-Jacobi smoothing and
smoothed-aggregation transfers, and ``_COARSE_SWEEPS`` Jacobi sweeps at the
coarsest level.

Every sum over a row runs in a fixed order (``torch.segment_reduce`` over
row-sorted entries, or over the prolongator's entries sorted by coarse
column for the restriction), never an atomic scatter-add, so two solves on
the card agree bit for bit.  The coarsest level's 2 + ``_COARSE_SWEEPS``
sweeps from zero are one linear map of the right-hand side; it is formed
once in f64 at set-up as a dense [n_c, n_c] matrix when n_c <= 256 (the
coarsest level of every hierarchy that coarsens to the end), so the cycle
applies it with one product instead of 66 sweeps of launches.

The V(1,1) cycle with symmetric smoothing and Galerkin coarse operators is
SPD, so plain CG remains valid.  Not carried over: ``pack_hierarchy`` /
``unpack_hierarchy``, the JAX package's packing of the hierarchy into two
transfer buffers for its remote accelerator; the general sparse backend
here (:mod:`nodal_tpu_torch.ops.sparse_schur`) takes
:func:`hierarchy_arrays` on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

_JACOBI_OMEGA = 0.7
#: Damping for the prolongator smoother: ω = 4/(3 λmax(D⁻¹A)); λmax ≤ 2
#: for Laplacian-like matrices, so 2/3 is the standard safe choice.
_P_SMOOTH_OMEGA = 2.0 / 3.0
#: Revert a level to the tentative (unsmoothed) prolongator when the
#: smoothed Galerkin operator's nnz exceeds this multiple of the fine
#: level's — on mesh-like graphs the ratio is ~2.2 and smoothing cuts CG
#: iterations ~5x; on expander-like graphs it blows past 25x while the
#: iteration count barely moves (measured on 200x200 weighted mesh: 82->16
#: iters; random ring+chords graph: 12->11 iters at 26x the memory).
_SA_FILL_CAP = 4.0
_COARSEST_N = 256
_COARSE_SWEEPS = 64
_MAX_LEVELS = 12


@dataclass(frozen=True)
class _Level:
    n: int
    rows: np.ndarray  # int32[nnz], row-sorted
    cols: np.ndarray
    vals: np.ndarray  # float64[nnz]
    diag: np.ndarray  # float64[n]
    # Prolongator COO (None at the coarsest level), row-sorted.
    p_rows: np.ndarray | None
    p_cols: np.ndarray | None
    p_vals: np.ndarray | None
    n_coarse: int


#: Above this many vertices aggregation runs the vectorized rounds;
#: below it the O(n)-Python greedy loop is faster and keeps the exact
#: historical aggregates (its per-vertex cost only matters at scale —
#: measured 0.46 s at 40k / 1.16 s at 100k vertices, the dominant AMG
#: setup cost and squarely on the cold-solve critical path).
_VECTORIZED_AGG_N = 4096


def _aggregate(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Greedy neighborhood aggregation: each seed swallows its unassigned
    neighbors; leftovers join a neighboring aggregate.

    Large graphs take the vectorized randomized-MIS rounds
    (:func:`_aggregate_vectorized`) — same aggregate-quality class
    (seed + its free neighbors), O(nnz) numpy work per round and
    O(log n) expected rounds instead of a Python loop over vertices.
    """
    if n > _VECTORIZED_AGG_N:
        return _aggregate_vectorized(n, rows, cols)
    neighbors_start, neighbors = _adjacency(n, rows, cols)
    agg = np.full(n, -1, dtype=np.int32)
    next_agg = 0
    for v in range(n):
        if agg[v] >= 0:
            continue
        nbrs = neighbors[neighbors_start[v]:neighbors_start[v + 1]]
        if np.all(agg[nbrs] >= 0) and len(nbrs):
            agg[v] = agg[nbrs[0]]  # orphan joins a neighbor
            continue
        agg[v] = next_agg
        free = nbrs[agg[nbrs] < 0]
        agg[free] = next_agg
        next_agg += 1
    return agg


def _aggregate_vectorized(n: int, rows: np.ndarray,
                          cols: np.ndarray) -> np.ndarray:
    """Vectorized aggregation: rounds of randomized-priority maximal
    independent seeding (Luby-style), each seed swallowing its unassigned
    neighbors; orphans (unassigned vertices whose whole neighborhood got
    assigned) join a neighbor's aggregate, mirroring the greedy loop.

    Deterministic (fixed permutation seed).  Each round is O(nnz) numpy
    ``minimum.at`` work; expected O(log n) rounds.
    """
    off = rows != cols
    r = rows[off].astype(np.int64)
    c = cols[off].astype(np.int64)

    agg = np.full(n, -1, dtype=np.int32)
    pri = np.random.default_rng(0).permutation(n).astype(np.int64)
    INF = np.iinfo(np.int64).max
    next_agg = 0
    for _ in range(256):  # far above the expected O(log n) rounds
        un = agg < 0
        if not un.any():
            break
        active = un[r]
        # Orphans first (greedy parity): unassigned vertices with
        # neighbors but none unassigned join the aggregate of their
        # min-index assigned neighbor.
        nbr_assigned_min = np.full(n, INF, np.int64)
        sel = active & ~un[c]
        np.minimum.at(nbr_assigned_min, r[sel], c[sel])
        nbr_un_min_pri = np.full(n, INF, np.int64)
        sel = active & un[c]
        np.minimum.at(nbr_un_min_pri, r[sel], pri[c[sel]])
        orphan = un & (nbr_un_min_pri == INF) & (nbr_assigned_min < INF)
        if orphan.any():
            agg[orphan] = agg[nbr_assigned_min[orphan]]
            un = agg < 0
            if not un.any():
                break
        # Seeds: unassigned vertices beating every unassigned neighbor's
        # priority (isolated/all-assigned-neighbor vertices seed too).
        seed = un & (pri < nbr_un_min_pri)
        ids = (np.cumsum(seed) - 1 + next_agg).astype(np.int32)
        agg[seed] = ids[seed]
        next_agg += int(seed.sum())
        # Unassigned non-seeds adjacent to a seed join their best
        # (min-priority) seed neighbor.  Encode (priority, vertex) in one
        # int64 key so minimum.at doubles as argmin.
        un2 = agg < 0
        sel = un2[r] & seed[c]
        best = np.full(n, INF, np.int64)
        np.minimum.at(best, r[sel], pri[c[sel]] * n + c[sel])
        join = un2 & (best < INF)
        agg[join] = agg[best[join] % n]
    else:  # pragma: no cover - safety net
        un = agg < 0
        agg[un] = next_agg + np.arange(int(un.sum()), dtype=np.int32)
    return agg


def _adjacency(n, rows, cols):
    off = rows != cols
    r, c = rows[off], cols[off]
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    start = np.searchsorted(r, np.arange(n + 1))
    return start.astype(np.int64), c


def build_hierarchy(n, rows, cols, vals, *,
                    smooth_prolongation: bool = True) -> list[_Level]:
    """Host-side AMG setup from deduped COO (numpy float64 values)."""
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float64)
    levels: list[_Level] = []
    for _ in range(_MAX_LEVELS):
        diag = np.zeros(n)
        on_diag = rows == cols
        np.add.at(diag, rows[on_diag], vals[on_diag])
        if n <= _COARSEST_N:
            levels.append(_Level(n, rows, cols, vals, diag,
                                 None, None, None, 0))
            break
        agg = _aggregate(n, rows, cols)
        n_coarse = int(agg.max()) + 1
        if n_coarse >= n:  # no coarsening progress; stop
            levels.append(_Level(n, rows, cols, vals, diag,
                                 None, None, None, 0))
            break

        A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
        P_tent = sp.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, n_coarse)
        )
        P = P_tent
        if smooth_prolongation:
            dinv = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag),
                            1.0)
            # P <- (I - ω D⁻¹ A) P_tent: spreads each aggregate's basis
            # function over its neighbors, so the coarse space captures
            # smooth error the piecewise-constant space misses.
            P = P_tent - sp.diags(_P_SMOOTH_OMEGA * dinv) @ (A @ P_tent)
        Ac = (P.T @ A @ P).tocoo()
        Ac.eliminate_zeros()
        if smooth_prolongation and Ac.nnz > _SA_FILL_CAP * max(A.nnz, 1):
            # Expander-like level: smoothing buys nothing and the Galerkin
            # fill compounds down the hierarchy — revert to tentative.
            P = P_tent
            Ac = (P.T @ A @ P).tocoo()
            Ac.eliminate_zeros()

        Pc = P.tocoo()
        order = np.argsort(
            Pc.row.astype(np.int64) * n_coarse + Pc.col, kind="stable"
        )
        levels.append(_Level(
            n, rows, cols, vals, diag,
            Pc.row[order].astype(np.int32),
            Pc.col[order].astype(np.int32),
            Pc.data[order],
            n_coarse,
        ))

        order = np.argsort(
            Ac.row.astype(np.int64) * n_coarse + Ac.col, kind="stable"
        )
        rows = Ac.row[order].astype(np.int32)
        cols = Ac.col[order].astype(np.int32)
        vals = Ac.data[order]
        n = n_coarse
    return levels


def _dinv(diag: np.ndarray) -> np.ndarray:
    return np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 1.0)


def _offsets(rows: np.ndarray, n: int) -> np.ndarray:
    """CSR row offsets [n + 1] of sorted ``rows``."""
    return np.searchsorted(rows, np.arange(n + 1)).astype(np.int64)


def coarse_operator(lv: _Level) -> np.ndarray:
    """The coarsest level's 2 + ``_COARSE_SWEEPS`` weighted-Jacobi sweeps
    from zero as one dense f64 map ``S`` (x = S r): the sweep is ``x ←
    (I − ωD⁻¹A) x + ωD⁻¹ r``, so ``S = Σ_j (I − ωD⁻¹A)^j ωD⁻¹``."""
    A = np.zeros((lv.n, lv.n))
    np.add.at(A, (lv.rows, lv.cols), lv.vals)
    wd = _JACOBI_OMEGA * _dinv(lv.diag)
    E = np.eye(lv.n) - wd[:, None] * A
    S = np.zeros((lv.n, lv.n))
    for _ in range(2 + _COARSE_SWEEPS):
        S = E @ S + np.diag(wd)
    return S


def hierarchy_arrays(levels: list[_Level], dtype, device) -> list[dict]:
    """The host hierarchy as tensors of ``dtype`` on ``device``, one dict a
    level: the operator in CSR form (``offsets``, ``cols``, ``vals``), the
    inverse diagonal ``dinv`` and, but at the coarsest level, the
    prolongator by fine row (``p_offsets``, ``p_cols``, ``p_vals``) and
    by coarse column (``r_offsets``, ``r_rows``, ``r_vals``); at a
    coarsest level of at most ``_COARSEST_N`` unknowns the dense sweep map
    ``coarse`` (:func:`coarse_operator`).
    """
    dev = torch.device(device)

    def t(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=dtype if dt is None else dt,
                               device=dev)

    out = []
    for lv in levels:
        d = {"n": lv.n, "offsets": t(_offsets(lv.rows, lv.n), torch.long),
             "cols": t(lv.cols, torch.long), "vals": t(lv.vals),
             "dinv": t(_dinv(lv.diag))}
        if lv.p_rows is None:
            if lv.n <= _COARSEST_N:
                d["coarse"] = t(coarse_operator(lv))
        else:
            # P^T by coarse column, stable in the fine row, so each coarse
            # slot sums its terms in the order a sequential scatter would.
            order = np.argsort(lv.p_cols, kind="stable")
            d.update(
                p_offsets=t(_offsets(lv.p_rows, lv.n), torch.long),
                p_cols=t(lv.p_cols, torch.long), p_vals=t(lv.p_vals),
                r_offsets=t(_offsets(lv.p_cols[order], lv.n_coarse),
                            torch.long),
                r_rows=t(lv.p_rows[order], torch.long),
                r_vals=t(lv.p_vals[order]))
        out.append(d)
    return out


def csr_matvec(offsets: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y [B, n] = A x`` for ``x`` [B, m], A in CSR form (``offsets``
    [n + 1]): a gather, a product and one ``segment_reduce`` over each
    row's entries in order."""
    prods = vals * x[:, cols]
    B = x.shape[0]
    return torch.segment_reduce(prods, "sum",
                                offsets=offsets.expand(B, -1), axis=1)


def make_vcycle(arrays: list[dict]):
    """V(1,1)-cycle closure ``M(r)`` over :func:`hierarchy_arrays`,
    batched over r [B, n]."""

    def matvec(lv, x):
        return csr_matvec(lv["offsets"], lv["cols"], lv["vals"], x)

    def vcycle(r, i):
        lv = arrays[i]
        if "coarse" in lv:
            return r @ lv["coarse"].T
        if "p_vals" not in lv:  # a coarsest level that stopped coarsening
            x = torch.zeros_like(r)
            for _ in range(2 + _COARSE_SWEEPS):
                x = x + _JACOBI_OMEGA * lv["dinv"] * (r - matvec(lv, x))
            return x
        x = _JACOBI_OMEGA * lv["dinv"] * r  # one sweep from zero
        res = r - matvec(lv, x)
        rc = csr_matvec(lv["r_offsets"], lv["r_rows"], lv["r_vals"], res)
        xc = vcycle(rc, i + 1)
        x = x + csr_matvec(lv["p_offsets"], lv["p_cols"], lv["p_vals"], xc)
        return x + _JACOBI_OMEGA * lv["dinv"] * (r - matvec(lv, x))

    def M(r):
        return vcycle(r, 0)

    return M


def make_amg_preconditioner(levels: list[_Level], dtype, device):
    """Device-side V(1,1) application closure for the host hierarchy, on
    tensors of ``dtype`` on ``device``."""
    return make_vcycle(hierarchy_arrays(levels, dtype, device))
