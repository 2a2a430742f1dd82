"""Circuit and Solution: the user-facing solve API.

Counterpart of ``nodal_tpu/circuit.py``, with the reference's documented
entry pattern:

    from nodal_tpu_torch import Circuit, Netlist
    print(Circuit(Netlist("netlist.csv")).solve())

``Circuit`` compiles the netlist once to stamp tensors; ``solve()``
assembles and solves on the circuit's device (default ``"cuda"``, which
raises when CUDA is absent; ``device="cpu"`` runs the plain torch path).
There is no automatic routing of small circuits to the host: a circuit
runs where it is asked.  ``Circuit(..., sparse=True)`` solves through the
sparse backend (:func:`~nodal_tpu_torch.ops.sparse.solve_sparse_system`:
a resistive circuit by Jacobi- or AMG-CG on the card, the skyline LDLᵀ
first on the CPU; a circuit with branch rows by ideal-source reduction and
bordered elimination, :mod:`nodal_tpu_torch.ops.sparse_schur`).

Error policy, as in the JAX package: after every solve the relative
residual ``max|G x − b| / max(|b|, 1)`` is checked.  A non-finite or
large-residual solution takes a pivoted f64 dense rescue on the same
device (above ``_DENSE_RESCUE_MAX_N`` unknowns the bordered elimination);
if that fails too, the connectivity diagnosis runs: a node that
cannot reach ground raises :class:`UnconnectedCircuitError`, anything else
``numpy.linalg.LinAlgError``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch
from numpy.linalg import LinAlgError

from nodal_tpu_torch.models.stamps import Quirks, StampTensors, compile_stamps
from nodal_tpu_torch.netlist import (Netlist, UnconnectedCircuitError,
                                     is_connected)
from nodal_tpu_torch.ops import dense_solve
from nodal_tpu_torch.ops.assemble import assemble_dense
from nodal_tpu_torch.ops.band import band_matvec, band_plan
from nodal_tpu_torch.ops.block_thomas import band_solve
from nodal_tpu_torch.ops.sparse import solve_sparse_system
from nodal_tpu_torch.ops.sparse_schur import solve_general_auto
from nodal_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# Relative-residual ceiling above which a solve is declared failed.  Scaled
# for ill-conditioned but solvable systems (the OPMODEL macromodel reaches
# cond ~1e12 in f64: its residual stays ~1e-4 relative at worst).
_RESIDUAL_TOL = {torch.float32: 3e-2, torch.float64: 1e-3}

# A solve that clears the failure ceiling but sits above this is returned
# with a logged warning: an f32 answer can be ~1 % wrong yet pass the
# singularity gate.
_RESIDUAL_WARN = 1e-4

# Above this many unknowns the dense f64 rescue is not attempted (an n² f64
# matrix would be enormous): the rescue there is the bordered elimination.
_DENSE_RESCUE_MAX_N = 16384


class Circuit:
    """A compiled circuit: netlist lowered to stamp tensors.

    Args:
        netlist: a finalized :class:`Netlist`.
        sparse: parity flag with the reference CLI ``-s``: solve through
            the sparse backend.
        dtype: ``torch.float64`` (default, the JAX package's dtype under
            x64) or ``torch.float32``.
        quirks: reference bit-compatibility switches.
        device: where ``solve()`` and, by default, the batched solvers
            run: ``"cuda"`` (default) or ``"cpu"``.  Checked when a solve
            starts, not here.
    """

    def __init__(
        self,
        netlist: Netlist,
        sparse: bool = False,
        *,
        dtype=torch.float64,
        quirks: Quirks | None = None,
        device="cuda",
    ):
        if not isinstance(netlist, Netlist):
            raise TypeError("Input isn't a netlist")
        if dtype not in _RESIDUAL_TOL:
            raise ValueError(
                f"dtype must be torch.float32 or torch.float64, not {dtype}")
        self.netlist = netlist
        self.sparse = bool(sparse)
        self.dtype = dtype
        self.device = torch.device(device)
        self.stamps: StampTensors = compile_stamps(netlist, quirks)

    # -- solving ---------------------------------------------------------------

    def solve(self) -> "Solution":
        """Assemble and solve ``G e = b``; return a printable Solution.

        Raises UnconnectedCircuitError for floating subcircuits and
        numpy.linalg.LinAlgError for genuinely singular systems, like the
        reference (nodal.py:313-336).
        """
        t0 = time.perf_counter()
        dev = resolve_device(self.device, "Circuit.solve")
        dtype_name = str(self.dtype).removeprefix("torch.")
        stats: dict = {"dtype": dtype_name, "backend": dev.type}
        if self.sparse:
            try:
                x, info = solve_sparse_system(self.stamps,
                                              self.stamps.params,
                                              dtype=self.dtype, device=dev)
            except LinAlgError:
                # A structural singularity inside the bordered elimination:
                # the reference's diagnosis of its dense LinAlgError
                # (nodal.py:328-335), floating subcircuit or singular.
                self._raise_singular()
            residual = float(info.residual)
            stats["method"] = info.method
            stats["iterations"] = int(info.iterations)
        else:
            params = torch.as_tensor(self.stamps.params, dtype=self.dtype,
                                     device=dev)[None]
            x, residual, stats["method"] = self._solve_primary(params)

        x = x.to(torch.float64).cpu().numpy()
        if not self._acceptable(residual) or not np.all(np.isfinite(x)):
            x, residual = self._rescue(dev)
            stats["method"] = "f64_rescue"
            if not self._acceptable(residual, torch.float64) or not np.all(
                np.isfinite(x)
            ):
                self._raise_singular()
        stats["residual"] = residual
        if residual > _RESIDUAL_WARN:
            logger.warning(
                "solve residual %.2e exceeds %.0e: the %s answer is "
                "degraded (ill-conditioned system); re-run with dtype=f64 "
                "(--dtype f64) for a refined solve",
                residual, _RESIDUAL_WARN, stats["dtype"],
            )
            stats["accuracy_warning"] = True
        stats["solve_s"] = time.perf_counter() - t0
        return Solution(x, self.netlist, stats=stats)

    def _band_plan(self):
        """The block-band plan of the band route, or None.

        Purely resistive circuits whose half-bandwidth after RCM fits a
        block of at most 384 and that span two block rows or more solve
        block-tridiagonally: O(n·kb²) work and no n² matrix."""
        stamps = self.stamps
        if stamps.n != stamps.n_kcl:
            return None
        plan = band_plan(stamps)
        return plan if plan is not None and plan.nb >= 2 else None

    def _solve_primary(self, params: torch.Tensor):
        """``(x [n], residual, method)`` of the primary solve of the
        ``[1, n_components]`` params, in their dtype and on their device.

        The band route runs the block-Thomas solve at B = 1 (the CUDA
        kernel on the card, the plain pivoted version on the CPU); the
        dense route the library's pivoted LU on the card and scipy's LAPACK
        on the CPU (:func:`_solve_dense`).  The residual is the
        assembled system's, in the solve's dtype; products run without
        TF32 (PyTorch's default).
        """
        plan = self._band_plan()
        if plan is not None:
            W, b = plan.assemble(self.stamps, params)
            x = band_solve(W, b)
            residual = _max_rel(b - band_matvec(W, x), b)
            return plan.unpermute(x)[0], residual, "band_thomas"
        G, b = assemble_dense(self.stamps, params)
        try:
            x = _solve_dense(G, b)
        except torch.linalg.LinAlgError:  # an exactly singular factor
            return torch.full_like(b[0], torch.nan), np.inf, "dense_lu"
        return x[0], _rel_residual(G, b, x), "dense_lu"

    def _rescue(self, dev: torch.device):
        """Last-resort pivoted f64 dense LU on the circuit's device, for
        systems too ill-conditioned for the primary path (e.g. an f32
        solve of an opamp macromodel).  Returns ``(x, residual)`` with
        ``x`` host numpy f64, NaN with an infinite residual when the f64
        factorization fails too.

        Above ``_DENSE_RESCUE_MAX_N`` unknowns the rescue is the bordered
        elimination (:func:`~nodal_tpu_torch.ops.sparse_schur.
        solve_general_auto`) on the same device.  Only its LinAlgError
        (a singular system) and ValueError (a border over the caps) count
        as a failed rescue: anything else, a CUDA fault among them,
        propagates.
        """
        n = self.stamps.n
        if n > _DENSE_RESCUE_MAX_N:
            try:
                x, info = solve_general_auto(self.stamps, self.stamps.params,
                                             device=dev)
            except (LinAlgError, ValueError) as e:
                logger.error(
                    "the primary solve of %d unknowns missed its residual "
                    "gate and the bordered-elimination rescue failed: %s",
                    n, e)
                return np.full(n, np.nan), np.inf
            return x, float(info.residual)
        logger.debug("primary solve failed residual check; retrying in f64")
        params = torch.as_tensor(self.stamps.params, dtype=torch.float64,
                                 device=dev)[None]
        G, b = assemble_dense(self.stamps, params)
        try:
            x = _solve_dense(G, b)
        except torch.linalg.LinAlgError:
            return np.full(n, np.nan), np.inf
        return x[0].cpu().numpy(), _rel_residual(G, b, x)

    def _acceptable(self, residual: float, dtype=None) -> bool:
        tol = _RESIDUAL_TOL[dtype or self.dtype]
        return bool(np.isfinite(residual)) and residual <= tol

    def _raise_singular(self):
        if not is_connected(self.netlist):
            logger.error("Model error: unconnected circuit")
            raise UnconnectedCircuitError
        logger.error("Model error: matrix is singular")
        raise LinAlgError("Singular matrix")

    def batched_solver(self, *, dtype=torch.float32,
                       refine: bool | str = "auto", method: str = "auto",
                       device=None):
        """Memoized :class:`~nodal_tpu_torch.batch.BatchedSolver` for this
        circuit, one per (dtype, refine, method, device); ``device=None``
        is the circuit's own."""
        from nodal_tpu_torch.batch import BatchedSolver

        device = self.device if device is None else torch.device(device)
        key = (dtype, refine, method, str(device))
        cache = self.__dict__.setdefault("_batched_solvers", {})
        if key not in cache:
            cache[key] = BatchedSolver(self, dtype=dtype, refine=refine,
                                       method=method, device=device)
        return cache[key]

    # -- inspection (parity helpers) --------------------------------------------

    def build_model(self):
        """``(G, b)`` as numpy f64 arrays, assembled on the host — the
        parity helper mirroring the reference Circuit.build_model
        (nodal.py:338-398)."""
        params = torch.as_tensor(self.stamps.params, dtype=torch.float64)
        G, b = assemble_dense(self.stamps, params[None])
        return G[0].numpy(), b[0].numpy()


def _solve_dense(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dense route's pivoted LU: on the CPU scipy's LAPACK, for the JAX
    package's bytes (:func:`~nodal_tpu_torch.ops.dense_solve.
    solve_dense_host`); on the card the library's."""
    if G.device.type == "cpu":
        return dense_solve.solve_dense_host(G, b)
    return dense_solve.solve_dense(G, b)


def _max_rel(r: torch.Tensor, b: torch.Tensor) -> float:
    """``max|r| / max(max|b|, 1)`` as a Python float (one host sync)."""
    return float(r.abs().max() / b.abs().max().clamp_min(1.0))


def _rel_residual(G: torch.Tensor, b: torch.Tensor, x: torch.Tensor
                  ) -> float:
    """Relative residual of ``G [1, n, n] x [1, n] = b [1, n]`` in the
    solve's dtype."""
    return _max_rel(b - (G @ x.unsqueeze(-1)).squeeze(-1), b)


@dataclass
class Solution:
    """Solved circuit variables, printable in the reference's format
    (reference nodal.py:401-434).

    ``result[:kcl]`` are node potentials indexed by ``nodenum``;
    ``result[kcl:]`` are branch currents of anomalous components indexed by
    ``anomnum``.  ``stats`` carries solver observability (method, residual,
    wall time).

    The third positional argument matches the reference constructor
    ``Solution(e, netlist, currents)`` (reference nodal.py:414-420), where
    ``currents`` is the list collected during stamping.  The reference
    stores it write-only (its ``__str__`` reads ``anomnum`` instead); it is
    kept here purely so code constructing Solutions directly ports
    unchanged.
    """

    result: np.ndarray
    netlist: Netlist
    currents: list | None = None
    stats: dict | None = None

    def __post_init__(self):
        self.nodenum = self.netlist.nodenum
        self.anomnum = self.netlist.anomnum
        self.nums = self.netlist.nums
        self.ground = self.netlist.ground

    def potential(self, node: str) -> float:
        """Node potential in volts; ground is the 0 V reference."""
        if node == self.ground:
            return 0.0
        return float(self.result[self.nodenum[node]])

    def current(self, name: str) -> float:
        """Branch current (ampere) of an anomalous component."""
        return float(self.result[self.nums["kcl"] + self.anomnum[name]])

    def __str__(self) -> str:
        out = [f"Ground node: {self.ground}"]
        for name in sorted(self.nodenum):
            out.append(f"e({name}) \t= {self.result[self.nodenum[name]]}")
        for name in sorted(self.anomnum):
            i = self.nums["kcl"] + self.anomnum[name]
            out.append(f"i({name}) \t= {self.result[i]}")
        return "\n".join(out)
