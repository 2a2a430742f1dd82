"""Dense MNA solves.

Counterpart of ``nodal_tpu/ops/dense_solve.py:solve_dense``.  Here it serves
only the pivoted rescue of the contract layer (``batch._escalating_solver``),
in float64: the H100 has native f64, so no f32-LU-plus-refinement detour is
needed.  As in the JAX package, the LU runs outside any kernel of this
repository.
"""

from __future__ import annotations

import torch


def solve_dense(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pivoted LU solve ``G x = b`` in the dtype of ``G``, batched over the
    leading dimensions."""
    return torch.linalg.solve(G, b)
