"""Native skyline (profile) LDLᵀ direct solver for SPD systems.

Counterpart of ``nodal_tpu/ops/skyline.py``, host code as there: RCM-order
the grounded resistive system, pack its lower profile, factor once in C++
(``nodal_tpu_torch/cpp/skyline.cpp``, a copy of the JAX package's), then
answer every right-hand side with one O(profile) forward/backward sweep.
This is the role SuperLU plays for the reference (reference
nodal/nodal.py:325), built natively: no iteration, no device.

Feasibility is decided from the pattern alone (:func:`plan_skyline`): RCM
keeps mesh-like circuit graphs narrow (a 100×1000 grid profiles at ~100
entries a row), and the caps below bound memory and factor FLOPs; a plan
over them is ``None`` and the caller takes a Krylov route.

The library is built with ``g++`` by
:func:`nodal_tpu_torch.utils.kernels.build_host_library` into the package's
private ``_build/`` directory, never a shared temporary one.  A failed
build raises :class:`SkylineUnavailable` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np

from nodal_tpu_torch.ops.band import rcm_order
from nodal_tpu_torch.utils import kernels

#: The JAX package's flags: the factor and solve loops are FMA chains, so
#: the host's own vector units (-march=native) matter.
FLAGS = ("-O3", "-march=native", "-funroll-loops", "-std=c++17", "-shared",
         "-fPIC", "-fopenmp")

#: Profile-entry cap (f64 each): 2e8 ≈ 1.6 GB of factor storage.
MAX_PROFILE_NNZ = 200_000_000
#: Factor-FLOP cap: ~4e10 MACs ≈ a few seconds single-threaded.
MAX_FACTOR_FLOPS = 4e10


class SkylineUnavailable(RuntimeError):
    pass


@functools.cache
def _load() -> ctypes.CDLL:
    src = kernels.CPP_DIR / "skyline.cpp"
    if not src.exists():
        raise SkylineUnavailable(f"source not found: {src}")
    try:
        path = kernels.build_host_library(src, FLAGS)
    except RuntimeError as e:
        raise SkylineUnavailable(f"native build failed: {e}") from None
    lib = ctypes.CDLL(str(path))
    lib.sk_factor.restype = ctypes.c_int64
    lib.sk_factor.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 4
    lib.sk_solve.restype = None
    lib.sk_solve.argtypes = ([ctypes.c_int64] + [ctypes.c_void_p] * 5
                             + [ctypes.c_int64])
    lib.sk_solve_blocked.restype = None
    lib.sk_solve_blocked.argtypes = lib.sk_solve.argtypes
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@dataclass(frozen=True)
class SkylinePlan:
    """Pattern-only factorization plan (reusable across parameter values)."""

    n: int
    perm: np.ndarray      # int64[n]: position -> original index (RCM)
    iperm: np.ndarray     # int64[n]: original index -> position
    jmin: np.ndarray      # int32[n]: first column of each permuted row
    rowptr: np.ndarray    # int64[n+1]: row spans into the profile array
    profile_nnz: int
    factor_flops: float


@dataclass
class SkylineFactor:
    plan: SkylinePlan
    sky: np.ndarray   # float64[profile_nnz]: L off-diagonals
    diag: np.ndarray  # float64[n]: D


def plan_skyline(
    n: int,
    rows: np.ndarray,
    cols: np.ndarray,
    *,
    max_nnz: int | None = None,
    max_flops: float | None = None,
) -> SkylinePlan | None:
    """RCM + profile computation from the symmetric pattern; ``None`` when
    the profile blows past the memory/FLOP caps (caller falls back)."""
    if n == 0:
        return SkylinePlan(0, np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.int32), np.zeros(1, np.int64),
                           0, 0.0)
    perm = np.asarray(rcm_order(n, rows, cols), dtype=np.int64)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n, dtype=np.int64)

    pi = iperm[np.asarray(rows, dtype=np.int64)]
    pj = iperm[np.asarray(cols, dtype=np.int64)]
    hi = np.maximum(pi, pj)
    lo = np.minimum(pi, pj)
    jmin = np.arange(n, dtype=np.int64)
    np.minimum.at(jmin, hi, lo)
    widths = np.arange(n, dtype=np.int64) - jmin
    profile_nnz = int(widths.sum())
    # Off-diagonal row j of the factor is consumed as a dot-product
    # operand once per later row overlapping it; the classic estimate
    # Σ w_i² / 2 bounds the MAC count.
    flops = float(np.sum(widths.astype(np.float64) ** 2)) / 2.0
    if profile_nnz > (max_nnz if max_nnz is not None else MAX_PROFILE_NNZ):
        return None
    if flops > (max_flops if max_flops is not None else MAX_FACTOR_FLOPS):
        return None
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(widths, out=rowptr[1:])
    return SkylinePlan(n, perm, iperm, jmin.astype(np.int32), rowptr,
                       profile_nnz, flops)


def factor(
    plan: SkylinePlan,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
) -> SkylineFactor | None:
    """Pack COO values (duplicates accumulate) into the profile and factor
    in place.  ``None`` on a non-positive pivot (not SPD — fall back)."""
    lib = _load()
    n = plan.n
    sky = np.zeros(plan.profile_nnz, dtype=np.float64)
    diag = np.zeros(n, dtype=np.float64)
    pi = plan.iperm[np.asarray(rows, dtype=np.int64)]
    pj = plan.iperm[np.asarray(cols, dtype=np.int64)]
    vals = np.asarray(vals, dtype=np.float64)
    on_diag = pi == pj
    np.add.at(diag, pi[on_diag], vals[on_diag])
    low = pi > pj  # keep the lower triangle only (input is symmetric)
    ii, jj, vv = pi[low], pj[low], vals[low]
    slots = plan.rowptr[ii] + (jj - plan.jmin[ii])
    np.add.at(sky, slots, vv)
    rc = lib.sk_factor(n, _ptr(plan.jmin), _ptr(plan.rowptr), _ptr(sky),
                       _ptr(diag))
    if rc != 0:
        return None
    return SkylineFactor(plan, sky, diag)


def solve(fact: SkylineFactor, B: np.ndarray) -> np.ndarray:
    """Solve A X^T = B^T for a [c, n] batch of right-hand-side rows."""
    lib = _load()
    plan = fact.plan
    B = np.asarray(B, dtype=np.float64)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[None]
    X = np.ascontiguousarray(B[:, plan.perm])
    # Blocked kernel for multi-RHS batches: streams the factor once per
    # 32-RHS block instead of once per RHS.
    fn = lib.sk_solve if X.shape[0] == 1 else lib.sk_solve_blocked
    fn(plan.n, _ptr(plan.jmin), _ptr(plan.rowptr),
       _ptr(fact.sky), _ptr(fact.diag), _ptr(X), X.shape[0])
    out = X[:, plan.iperm]
    return out[0] if squeeze else out


def available() -> bool:
    """True when the library builds and loads on this host."""
    try:
        _load()
        return True
    except SkylineUnavailable:
        return False
