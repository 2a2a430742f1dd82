"""Dense MNA solves.

Counterpart of ``nodal_tpu/ops/dense_solve.py``.  :func:`solve_dense`
serves the ``dense`` tier (``batch._dense_operator``), the pivoted f64
rescue of the contract layer (``batch._escalating_solver``, on an f64
``_dense_operator``) and
``Circuit.solve``'s dense route and rescue on the card;
:func:`solve_dense_host` serves ``Circuit.solve``'s dense route and rescue
for CPU tensors.  As in the JAX package, the LU runs outside any kernel of
this repository: it is the library's.

Every solve runs in its own dtype on the device where its matrix lives:
on the card through ``torch.linalg.solve``, and for ``Circuit``'s CPU
tensors through scipy's LAPACK and BLAS (``getrf``, ``trsm``), which jaxlib
calls on the CPU.  So a single solve on the CPU prints
the JAX package's bytes; ``torch.linalg.solve`` on the CPU (MKL) differs
from them in the last digits.  The batched ``dense`` tier keeps
``torch.linalg.solve`` on either device.

The JAX package's TPU branches (``solve_on_cpu``, and ``solve_auto``'s
f32-LU-plus-refinement for f64 on a TPU, whose compiler has no f64 LU) are
not carried over: the card has an f64 LU.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.linalg
import torch

#: Refinement passes of :func:`solve_refined`: each gains about seven
#: decimal digits (ε₃₂), so three take an f32 factorization to f64 accuracy
#: with margin.
_REFINE_ITERS = 3


def solve_dense(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pivoted LU solve ``G x = b`` in the dtype of ``G``, batched over the
    leading dimensions."""
    return torch.linalg.solve(G, b)


def solve_dense_host(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pivoted LU solve ``G x = b`` of CPU tensors ``G`` [B, n, n], ``b``
    [B, n] through scipy's LAPACK and BLAS, in the dtype of ``G``: bit for
    bit what ``jnp.linalg.solve`` gives on the CPU, whose steps these are
    (``getrf``, the row permutation, then two ``trsm``; ``getrs`` or
    ``trsv`` in their place differ from it in the last digits).  As there,
    an exactly singular factor gives non-finite values, not an error."""
    out = torch.empty_like(b)
    for k in range(G.shape[0]):
        with warnings.catch_warnings():  # the singular factor's warning
            warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
            lu, piv = scipy.linalg.lu_factor(G[k].numpy(), check_finite=False)
        perm = np.arange(len(piv))
        for i, p in enumerate(piv):
            perm[i], perm[p] = perm[p], perm[i]
        trsm = scipy.linalg.get_blas_funcs("trsm", (lu,))
        x = b[k].numpy()[perm][:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            x = trsm(1.0, lu, x, lower=1, diag=1)
            x = trsm(1.0, lu, x, lower=0, diag=0)
        out[k] = torch.from_numpy(x[:, 0])
    return out


def solve_refined(G: torch.Tensor, b: torch.Tensor,
                  iters: int = _REFINE_ITERS) -> torch.Tensor:
    """f32 pivoted LU with f64-residual iterative refinement: ``G``
    [..., n, n], ``b`` [..., n] in any float dtype -> x [..., n] in f64.

    The factorization runs once in f32; each pass solves the f64 residual
    ``b − G x`` (rounded to f32) with it and adds the correction in f64.
    It converges to f64 accuracy while cond(G) ≲ 1/ε₃₂.  Products in f64
    never go through TF32.
    """
    G64 = G.to(torch.float64)
    b64 = b.to(torch.float64).unsqueeze(-1)
    lu, piv = torch.linalg.lu_factor(G.to(torch.float32))

    def resolve(r):
        return torch.linalg.lu_solve(lu, piv, r.to(torch.float32)).to(
            torch.float64)

    x = resolve(b64)
    for _ in range(iters):
        x = x + resolve(b64 - G64 @ x)
    return x.squeeze(-1)


def solve_auto(G: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """The direct pivoted LU in ``dtype`` on the device where ``G`` lives
    (every dtype has an LU on the card and on the CPU)."""
    return solve_dense(G.to(dtype), b.to(dtype))
