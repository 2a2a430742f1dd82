"""Bandwidth-reducing reordering of the stamp pattern (host side).

Copy of :func:`rcm_order` from ``nodal_tpu/ops/band.py`` (importing
``nodal_tpu`` would import ``jax``).  It makes the same
``scipy.sparse.csgraph.reverse_cuthill_mckee`` call, so the port's plans
order the unknowns exactly as the JAX package's do.  The block-band plan
(``BandPlan``) of that module is not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


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
