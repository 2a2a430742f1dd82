"""Matrix-free resistor-grid solver: stencil Laplacian + multigrid CG.

Counterpart of ``nodal_tpu/ops/grid.py``: equivalent resistance across a
uniform H×W grid of unit resistors (the xkcd-356 problem and the 1M-node
grid of BASELINE.json) and the grid solve for any zero-sum injection field,
without ever building a netlist.  The MNA system of a resistive grid is
the graph Laplacian, whose matvec is a 5-point stencil.  We solve the
*Neumann* (ungrounded) system ``L x = b`` with zero-sum ``b``, regularized
by a rank-one mean shift (``A = L + mean``), which is SPD on the whole
space and agrees with the grounded solve on potential *differences*; the
equivalent resistance R = x[a] - x[b] is exactly the netlist path's.

Preconditioner: one geometric multigrid V(nu, nu) cycle with bilinear
transfers and the same edge weight on every level
(:func:`nodal_tpu_torch.ops.stencil.vcycle`).  On CUDA tensors its stencil
work runs in the hand-written kernels of ``csrc/stencil.cu``; the CG's
vector algebra, its dot products, the operator's matvec and the final mean
projection stay torch, unless ``fused_cg=True`` asks for the fused loop of
:mod:`nodal_tpu_torch.ops.fused_cg`, whose matvec, update and their
reductions run in ``csrc/cg.cu``.  Everything is batched over a leading
dimension, so many injection fields (:func:`grid_equivalent_resistance_many`)
solve as one batched CG.

Entry points run on the card (``device="cuda"``) and raise when CUDA is
absent; the CPU, with the plain torch cycle, only when asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from nodal_tpu_torch.ops import stencil
from nodal_tpu_torch.ops.cg import SolveInfo, cg
from nodal_tpu_torch.ops.fused_cg import fused_grid_cg
from nodal_tpu_torch.utils import tracing
from nodal_tpu_torch.utils.device import resolve_device

# Weighted-Jacobi smoothing factor: 4/5 is optimal-ish for the 2D 5-point
# stencil's high-frequency band.
_JACOBI_OMEGA = 0.8
_COARSEST_SIZE = 8  # stop coarsening when min(H, W) <= this
# Jacobi sweeps of the coarsest level, mean-projected.  Tuned on a 512-grid
# point-source problem: (sweeps=96, coarsest=8, nu=1) gives 42 CG
# iterations vs 50 for (48, 4, 1).
_COARSE_SWEEPS = 96

_MG_BACKENDS = ("auto", "plain")


def _neighbor_sum_replicate(x: torch.Tensor) -> torch.Tensor:
    """Sum of 4-neighbour values of [B, h, w] fields under edge-replicate
    padding: for a boundary node the replicated 'neighbour' is the node
    itself, so ``4x - nbr_replicate(x) == deg⊙x - nbr_zero(x)`` exactly."""
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="replicate")
    return (xp[:, :-2, 1:-1] + xp[:, 2:, 1:-1] + xp[:, 1:-1, :-2]
            + xp[:, 1:-1, 2:])


def laplacian_matvec(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """y = weight * (deg ⊙ x - Σ_neighbours x): the grid-graph Laplacian of
    an H×W grid of equal resistors (conductance ``weight`` per edge), for
    [B, h, w] or [h, w] fields."""
    if x.dim() == 2:
        return laplacian_matvec(x[None], weight)[0]
    return weight * (4.0 * x - _neighbor_sum_replicate(x))


def _dense_laplacian(h: int, w: int, weight: float) -> np.ndarray:
    """Materialized Laplacian (the tests' oracle)."""
    n = h * w
    L = np.zeros((n, n))
    for i in range(h):
        for j in range(w):
            k = i * w + j
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < h and 0 <= jj < w:
                    L[k, k] += weight
                    L[k, ii * w + jj] -= weight
    return L


def make_mg_preconditioner(nu: int = 1, backend: str = "auto"):
    """Symmetric V(nu, nu) multigrid cycle as a linear preconditioner on
    [B, h, w] fields.

    Returns M(r) ≈ L⁺ r (mean-zero in, mean-zero out), fixed and SPD, safe
    inside CG.  ``backend``: ``"auto"`` runs the CUDA kernels on CUDA
    tensors and the plain torch cycle on CPU ones, ``"plain"`` the plain
    cycle on any device.  The cycle adapts to the field it is given, so,
    unlike the JAX package's, it takes no grid shape or dtype.
    """
    if backend not in _MG_BACKENDS:
        raise ValueError(f"mg_backend must be one of {_MG_BACKENDS}, not "
                         f"{backend!r}")
    cycle = stencil.vcycle_plain if backend == "plain" else stencil.vcycle
    return lambda r: cycle(r, weight=1.0, omega=_JACOBI_OMEGA, nu=nu,
                           coarse_sweeps=_COARSE_SWEEPS,
                           coarsest=_COARSEST_SIZE)


def grid_operator(x: torch.Tensor) -> torch.Tensor:
    """The SPD regularized Neumann operator ``A x = L x + mean(x)`` on
    [B, h, w] fields.

    For mean-zero b, ``A x = b`` has the unique mean-zero solution of the
    singular system ``L x = b``: potential differences match the grounded
    netlist solve exactly.
    """
    return laplacian_matvec(x) + x.mean(dim=(1, 2), keepdim=True)


def grid_solve(h: int, w: int, b, *, dtype=torch.float32, tol=1e-7,
               maxiter=None, mg=True, mg_backend: str = "auto",
               fused_cg: bool = False, device="cuda"):
    """Solve the grid system for zero-sum injection fields ``b``, [h, w] or
    a batch [B, h, w].

    Returns ``(x, SolveInfo)`` with x mean-zero, in the shape of ``b``; the
    SolveInfo fields are [B] for a batch and scalars for one field.

    ``fused_cg`` (opt-in, as in the JAX package) runs the CG of
    :func:`~nodal_tpu_torch.ops.fused_cg.fused_grid_cg` with the kernel
    cycle as its preconditioner when the fields are on CUDA, ``mg`` is set
    and ``mg_backend`` is ``"auto"``; elsewhere (the CPU, the plain cycle,
    no multigrid) the flag is ignored, as the JAX package ignores it away
    from its Pallas backend.
    """
    if mg_backend not in _MG_BACKENDS:
        raise ValueError(f"mg_backend must be one of {_MG_BACKENDS}, not "
                         f"{mg_backend!r}")
    dev = resolve_device(device, "grid_solve")
    b = torch.as_tensor(b, dtype=dtype, device=dev)
    single = b.dim() == 2
    if single:
        b = b[None]
    if b.shape[1:] != (h, w):
        raise ValueError(f"grid_solve: b has shape {tuple(b.shape)}, "
                         f"expected [B, {h}, {w}] or [{h}, {w}]")
    if maxiter is None:
        maxiter = 200 if mg else 20 * max(h, w)
    with tracing.root("grid.solve"):
        M = make_mg_preconditioner(backend=mg_backend) if mg else None
        b = b - b.mean(dim=(1, 2), keepdim=True)
        if fused_cg and mg and mg_backend == "auto" and dev.type == "cuda":
            x, info = fused_grid_cg(b, M, tol=tol, maxiter=maxiter)
        else:
            x, info = cg(grid_operator, b, preconditioner=M, tol=tol,
                         maxiter=maxiter)
    if single:
        return x[0], SolveInfo(*(t[0] for t in info))
    return x, info


def _probe_fields(h: int, w: int, pairs: np.ndarray, dtype, device):
    """Injection fields [P, h, w]: +1 at each pair's a, -1 at its b."""
    P = len(pairs)
    rhs = torch.zeros(P, h * w, dtype=dtype, device=device)
    idx = torch.arange(P, device=device)
    a = torch.as_tensor(pairs[:, 0, 0] * w + pairs[:, 0, 1], device=device)
    b = torch.as_tensor(pairs[:, 1, 0] * w + pairs[:, 1, 1], device=device)
    rhs[idx, a] += 1.0
    rhs[idx, b] -= 1.0
    return rhs.reshape(P, h, w), idx, a, b


def _pairs_array(pairs, h: int, w: int) -> np.ndarray:
    pairs = np.asarray(pairs, dtype=np.int64)
    if pairs.ndim != 3 or pairs.shape[1:] != (2, 2):
        raise ValueError(f"pairs must be [P, 2, 2], got {pairs.shape}")
    rows, cols = pairs[..., 0], pairs[..., 1]
    if (rows < 0).any() or (rows >= h).any() or (cols < 0).any() \
            or (cols >= w).any():
        raise ValueError(f"probe coordinates outside the {h}x{w} grid")
    return pairs


def grid_equivalent_resistance_many(
    h: int,
    w: int,
    pairs,
    *,
    resistance: float = 1.0,
    dtype=torch.float32,
    tol=1e-7,
    maxiter=None,
    mg: bool = True,
    mg_backend: str = "auto",
    device="cuda",
):
    """Equivalent resistance for MANY probe pairs at once.

    ``pairs`` is [P, 2, 2] int: P pairs of (row, col) probe coordinates.
    The operator is the same for every pair (only the injection field
    changes), so the whole family solves as one batched MG-CG.
    Returns ``(R [P], residuals [P])``.
    """
    pairs = _pairs_array(pairs, h, w)
    dev = resolve_device(device, "grid_solve")
    rhs, idx, a, b = _probe_fields(h, w, pairs, dtype, dev)
    x, info = grid_solve(h, w, rhs, dtype=dtype, tol=tol, maxiter=maxiter,
                         mg=mg, mg_backend=mg_backend, device=dev)
    x = x.reshape(len(pairs), h * w)
    return (x[idx, a] - x[idx, b]) * resistance, info.residual


def grid_equivalent_resistance(
    h: int,
    w: int,
    a: tuple[int, int],
    b: tuple[int, int],
    *,
    resistance: float = 1.0,
    dtype=torch.float32,
    tol=1e-7,
    maxiter=None,
    mg: bool = True,
    mg_backend: str = "auto",
    device="cuda",
):
    """Equivalent resistance between grid nodes ``a`` and ``b`` on an H×W
    grid of equal resistors (1 A probe current, R = potential difference;
    reference equiv.py:31-61 semantics without the netlist).

    Returns ``(R, SolveInfo)``: R a 0-dim tensor, SolveInfo of scalars.
    """
    _pairs_array([[a, b]], h, w)
    a, b = (int(a[0]), int(a[1])), (int(b[0]), int(b[1]))
    dev = resolve_device(device, "grid_solve")
    rhs = torch.zeros(h, w, dtype=dtype, device=dev)
    rhs[a] += 1.0
    rhs[b] -= 1.0
    x, info = grid_solve(h, w, rhs, dtype=dtype, tol=tol, maxiter=maxiter,
                         mg=mg, mg_backend=mg_backend, device=dev)
    return (x[a] - x[b]) * resistance, info
