"""Dense MNA solves.

Counterpart of ``nodal_tpu/ops/dense_solve.py:solve_dense``.  It serves the
``dense`` tier (``batch.make_dense_core``) and the pivoted f64 rescue of the
contract layer (``batch._escalating_solver``).  As in the JAX package, the
LU runs outside any kernel of this repository: it is the library's.
"""

from __future__ import annotations

import torch


def solve_dense(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pivoted LU solve ``G x = b`` in the dtype of ``G``, batched over the
    leading dimensions."""
    return torch.linalg.solve(G, b)
