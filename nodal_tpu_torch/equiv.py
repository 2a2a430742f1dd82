"""Two-point equivalent resistance of resistive networks.

Counterpart of ``nodal_tpu/equiv.py``.  Parity target: reference
equiv.py:22-61.  A 1 A probe current source goes in between the two nodes,
the circuit is solved, and the potential difference is read off; the probe
gets a fresh name (the reference hardcodes ``a1`` and clobbers a component
of that name, quirk Q4).  :func:`equivalent_resistance_many` factors the
conductance matrix once for many probe pairs, and
:func:`equivalent_resistance_stamps` injects the probe straight into the
sparse solve of compiled stamps (the native parser's path).

For large uniform grids, prefer :mod:`nodal_tpu_torch.ops.grid`'s
matrix-free path, which never builds the netlist at all.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from numpy.linalg import LinAlgError

from nodal_tpu_torch.batch import _adjoint_grad
from nodal_tpu_torch.circuit import Circuit
from nodal_tpu_torch.models.stamps import StampTensors, compile_stamps
from nodal_tpu_torch.netlist import (Netlist, UnconnectedCircuitError,
                                     is_connected)
from nodal_tpu_torch.ops import skyline
from nodal_tpu_torch.ops.assemble import assemble_dense
from nodal_tpu_torch.ops.band import band_matvec, band_plan
from nodal_tpu_torch.ops.block_thomas import band_solve_multi
from nodal_tpu_torch.ops.sparse import (_topology, solve_sparse_system,
                                        spd_factor)
from nodal_tpu_torch.utils.device import resolve_device

#: Largest unbanded circuit the multi-probe path solves densely: one
#: [n, n] f64 matrix is 2 GB at this bound.  Bigger circuits without a band
#: plan solve pair by pair through :func:`equivalent_resistance_stamps`.
_DENSE_MANY_MAX_N = 16384

#: The scale-relative residual gate of the multi-probe solves, by dtype.
_MANY_TOL = {torch.float32: 3e-2, torch.float64: 1e-6}


class NotConvergedError(RuntimeError):
    """The Krylov solve of :func:`equivalent_resistance_stamps` missed its
    tolerance."""


def check_resistive(netlist: Netlist) -> bool:
    """True iff every component in the netlist is a resistor
    (reference equiv.py:22-28)."""
    return all(c.type == "R" for c in netlist.components.values())


def _probed(netlist: Netlist, a: str, b: str) -> Netlist:
    """The netlist with a 1 A probe source from ``a`` to ``b``, after the
    validation both functions share."""
    if not check_resistive(netlist):
        raise ValueError("Network is not resistive")
    for node in (a, b):
        if node not in netlist.nodenum and node != netlist.ground:
            raise KeyError(f"Node `{node}` not found in netlist")
    probe = netlist.fresh_name("a1")
    return netlist.with_component([probe, "A", "1", a, b])


def equivalent_resistance(
    netlist: Netlist, a: str, b: str, sparse: bool = False, *,
    dtype=torch.float64, device="cuda",
) -> float:
    """Equivalent resistance seen through nodes ``a`` and ``b``: one
    :meth:`Circuit.solve` on ``device``.

    Raises:
        ValueError: the netlist contains a non-resistor component.
        KeyError: either probe node is absent from the netlist.
    """
    probed = _probed(netlist, a, b)
    solution = Circuit(probed, sparse=sparse, dtype=dtype,
                       device=device).solve()
    return _potential_difference(solution, probed, a, b)


def resistance_sensitivities(netlist: Netlist, a: str, b: str, *,
                             device="cuda") -> dict[str, float]:
    """d R_eq(a, b) / d R_k for every resistor, by the adjoint method: one
    f64 solve plus one adjoint solve on ``device``, whatever the number of
    resistors.  Returns ``{resistor name: dR_eq/dR}`` in Ω/Ω.  Same
    validation as :func:`equivalent_resistance`.
    """
    probed = _probed(netlist, a, b)
    circuit = Circuit(probed, device=device)
    # 1 A probe: the potential difference is R_eq; ground is 0 V.
    weights: dict[int, float] = {}
    for node, sign in ((a, 1.0), (b, -1.0)):
        if node != probed.ground:
            i = probed.nodenum[node]
            weights[i] = weights.get(i, 0.0) + sign
    g = _adjoint_grad(circuit, weights)
    slot = circuit.stamps.param_slot
    return {name: float(g[slot[name]])
            for name, comp in probed.components.items()
            if comp.type == "R"}


def _potential_difference(solution, probed: Netlist, a: str, b: str
                          ) -> float:
    # Ground is the 0 V reference; the literal label "g" is special-cased to
    # 0 exactly as the reference does (equiv.py:55-61) even when a different
    # node was elected ground.
    def potential(node: str) -> float:
        if node == "g":
            return 0.0
        if node == probed.ground:
            return 0.0
        return float(solution.result[probed.nodenum[node]])

    return potential(a) - potential(b)


def _probe_rows(netlist: Netlist, pairs) -> tuple[np.ndarray, np.ndarray]:
    """MNA rows of each pair's nodes, -1 for ground."""
    def row(node):
        return -1 if node == netlist.ground else netlist.nodenum[node]

    return (np.array([row(a) for a, _ in pairs], dtype=np.int64),
            np.array([row(b) for _, b in pairs], dtype=np.int64))


def _probe_rhs(rows_a: np.ndarray, rows_b: np.ndarray, n: int,
               rank: np.ndarray | None = None) -> np.ndarray:
    """[n, k] unit injections, +1 at a and −1 at b of each pair, in the
    order ``rank`` gives (``rank[old] = new``) or the natural one."""
    k = len(rows_a)
    R = np.zeros((n, k))
    idx = np.arange(k)
    for rows, sign in ((rows_a, 1.0), (rows_b, -1.0)):
        sel = rows >= 0
        r = rows[sel] if rank is None else rank[rows[sel]]
        np.add.at(R, (r, idx[sel]), sign)
    return R


def _read_pairs(X: np.ndarray, rows_a: np.ndarray,
                rows_b: np.ndarray) -> np.ndarray:
    """e(a) − e(b) of each pair's column of ``X`` [n, k]."""
    k = np.arange(len(rows_a))
    ea = np.where(rows_a >= 0, X[np.maximum(rows_a, 0), k], 0.0)
    eb = np.where(rows_b >= 0, X[np.maximum(rows_b, 0), k], 0.0)
    return ea - eb


def _gate(netlist: Netlist, rmax: float, X: np.ndarray, scale: float,
          dtype) -> None:
    """The two-level gate of every multi-probe route: the scale-relative
    residual ``rmax`` against ``_MANY_TOL``, and the forward-amplification
    tripwire ``scale = max(1, max|G|·max|X|) > 0.01/eps``, which a
    no-pivot solve of an exactly singular system trips with a finite
    garbage X.  A suspicious solve runs the connectivity diagnosis; a
    connected netlist whose residual passes is returned as it is."""
    tol = _MANY_TOL[dtype]
    eps = float(torch.finfo(dtype).eps)
    bad = not np.isfinite(rmax) or rmax > tol or not np.isfinite(X).all()
    if bad or scale > 0.01 / eps:
        if not is_connected(netlist):
            raise UnconnectedCircuitError
        if bad:
            raise LinAlgError("Singular matrix")


def _equiv_many_skyline(netlist: Netlist, stamps: StampTensors,
                        rows_a: np.ndarray, rows_b: np.ndarray):
    """All probe pairs through the skyline LDLᵀ on the host: one
    factorization and k backsolves in f64.  Returns the resistances, or
    None when the profile is over the caps or a pivot is not positive.
    Shares the factor cached on the stamps by the sparse solve."""
    if stamps.n == 0:
        return None
    got = spd_factor(stamps, _topology(stamps),
                     stamps.params.astype(np.float64))
    if got is None:
        return None
    fact, g_vals = got
    R = _probe_rhs(rows_a, rows_b, stamps.n)
    X = skyline.solve(fact, R.T).T
    # Residual through one CSR product (a scatter-add formulation is the
    # slow path at 64 probes and 40k nodes).
    A = sp.csr_matrix((g_vals, (stamps.g_rows.astype(np.int64),
                                stamps.g_cols.astype(np.int64))),
                      shape=(stamps.n, stamps.n))
    with np.errstate(invalid="ignore"):
        rmax = float(np.max(np.abs(A @ X - R)))
    g_max = float(np.max(np.abs(g_vals))) if len(g_vals) else 0.0
    scale = max(1.0, g_max * float(np.max(np.abs(X))))
    _gate(netlist, rmax / scale, X, scale, torch.float64)
    return _read_pairs(X, rows_a, rows_b)


def equivalent_resistance_many(netlist: Netlist, pairs, *,
                               dtype=torch.float64,
                               device="cuda") -> np.ndarray:
    """Equivalent resistance for many probe pairs of one netlist at once.

    ``pairs`` is a sequence of ``(a, b)`` node-label pairs; returns a
    float64 numpy array of the same length.  The conductance matrix is
    factored once and every pair rides a multi-RHS solve:

    * on the CPU, the skyline LDLᵀ first (f64, whatever ``dtype``);
    * a banded circuit (the band plan with two block rows or more): one
      block-Thomas factorization with one right-hand side a pair
      (``band_solve_multi`` at (1, nb, kb, k), the CUDA kernels on the
      card), gated by the band matvec;
    * no band and more than ``_DENSE_MANY_MAX_N`` unknowns: each pair
      through :func:`equivalent_resistance_stamps`;
    * else one dense assembly and the library's pivoted LU with k columns.

    Raises like :func:`equivalent_resistance`: ValueError on non-resistive
    netlists, KeyError on unknown probe nodes, UnconnectedCircuitError or
    LinAlgError on singular systems (every route is residual-gated).
    """
    if not check_resistive(netlist):
        raise ValueError("Network is not resistive")
    pairs = list(pairs)
    for a, b in pairs:
        for node in (a, b):
            if node not in netlist.nodenum and node != netlist.ground:
                raise KeyError(f"Node `{node}` not found in netlist")
    if not pairs:
        return np.zeros(0)
    dev = resolve_device(device, "equivalent_resistance_many")
    stamps = compile_stamps(netlist)
    rows_a, rows_b = _probe_rows(netlist, pairs)
    if dev.type == "cpu":
        sky = _equiv_many_skyline(netlist, stamps, rows_a, rows_b)
        if sky is not None:
            return sky

    n = stamps.n
    plan = band_plan(stamps)
    params = torch.as_tensor(stamps.params, dtype=dtype, device=dev)[None]
    if plan is not None and plan.nb >= 2:
        R = torch.as_tensor(_probe_rhs(rows_a, rows_b, plan.n_pad,
                                       plan.rank), dtype=dtype,
                            device=dev)[None]
        W, _ = plan.assemble(stamps, params)
        Xp = band_solve_multi(W, R)
        resid = band_matvec(W[:, None], Xp.transpose(1, 2)) \
            - R.transpose(1, 2)
        G_max = W.abs().max()
        X = plan.unpermute(Xp, rows_axis=-2)[0]
    elif n > _DENSE_MANY_MAX_N:
        out = np.empty(len(pairs))
        for j, (ra, rb) in enumerate(zip(rows_a, rows_b)):
            try:
                out[j] = equivalent_resistance_stamps(
                    stamps, int(ra), int(rb), dtype=dtype, device=dev)
            except NotConvergedError as exc:
                if not is_connected(netlist):
                    raise UnconnectedCircuitError from exc
                raise LinAlgError(str(exc)) from exc
        return out
    else:
        R = torch.as_tensor(_probe_rhs(rows_a, rows_b, n), dtype=dtype,
                            device=dev)[None]
        G, _ = assemble_dense(stamps, params)
        try:
            X = torch.linalg.solve(G, R)
        except torch.linalg.LinAlgError:  # an exactly singular factor
            X = torch.full_like(R, torch.nan)
        resid = G @ X - R
        G_max = G.abs().max()
        X = X[0]
    # Scale-relative gate: normalized by max(1, max|G|·max|X|), so badly
    # scaled netlists neither trip it spuriously nor slip through.
    scale = torch.clamp(G_max * X.abs().max(), min=1.0)
    rmax = float(resid.abs().max() / scale)
    Xn = X.to(torch.float64).cpu().numpy()
    _gate(netlist, rmax, Xn, float(scale), dtype)
    return _read_pairs(Xn, rows_a, rows_b)


def equivalent_resistance_stamps(stamps: StampTensors, row_a: int,
                                 row_b: int, *, dtype=torch.float64,
                                 tol: float = 1e-9, device="cuda") -> float:
    """Equivalent resistance straight from compiled stamp tensors.

    ``row_a`` / ``row_b`` are the MNA rows of the probe nodes (-1 for the
    ground node).  The unit probe current goes straight into the RHS (no
    netlist, no re-parse), and the resistive system is solved by
    :func:`~nodal_tpu_torch.ops.sparse.solve_sparse_system` on ``device``
    at ``tol``: Jacobi- or AMG-CG on the card, the skyline LDLᵀ first on
    the CPU.  This is the ``nodal-resistance --native`` path.

    Raises:
        ValueError: the stamps have branch rows (not resistive).
        NotConvergedError: the Krylov solve missed ``tol``.
    """
    if stamps.n != stamps.n_kcl:
        raise ValueError("Network is not resistive")
    dev = resolve_device(device, "equivalent_resistance_stamps")
    rhs = torch.zeros(stamps.n, dtype=dtype, device=dev)
    if row_a >= 0:
        rhs[row_a] += 1.0
    if row_b >= 0:
        rhs[row_b] -= 1.0
    x, info = solve_sparse_system(stamps, stamps.params, dtype=dtype,
                                  tol=tol, rhs=rhs, device=dev)
    if not info.converged:
        raise NotConvergedError(
            f"CG did not converge (residual {info.residual:.2e})")
    ea = float(x[row_a]) if row_a >= 0 else 0.0
    eb = float(x[row_b]) if row_b >= 0 else 0.0
    return ea - eb
