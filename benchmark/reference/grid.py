"""Plain reference of the equivalent resistance of an h×w grid of equal
resistors, exact to rounding.

The grid graph's Laplacian is ``L_h ⊗ I + I ⊗ L_w``, and the path graph's
Laplacian ``L_n`` is diagonalised by the orthonormal DCT-II basis
``u_j(i) = c_j cos(π j (i + ½) / n)`` with eigenvalues
``4 sin²(π j / 2n)``.  So the potential of a unit current into a and out
of b, taken mean-zero, is ``x(p) = Σ φ(p) (φ(a) − φ(b)) / λ`` over every
mode but the constant one, and ``R = x(a) − x(b) = Σ (φ(a) − φ(b))² / λ``:
a sum of 1M positive terms at 1024², in float64.  No iteration, no
tolerance, nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def _basis(n: int, i: int) -> np.ndarray:
    j = np.arange(n)
    c = np.where(j == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
    return c * np.cos(np.pi * j * (i + 0.5) / n)


def _inverse_eigenvalues(h: int, w: int) -> np.ndarray:
    lam = (4 * np.sin(np.pi * np.arange(h) / (2 * h)) ** 2)[:, None] \
        + (4 * np.sin(np.pi * np.arange(w) / (2 * w)) ** 2)[None, :]
    lam[0, 0] = np.inf  # the constant mode carries no current
    return 1.0 / lam


def potentials(h: int, w: int, a, b, resistance: float = 1.0):
    """(x(a), x(b)) of the mean-zero potential when 1 A enters at a and
    leaves at b, float64."""
    inv = _inverse_eigenvalues(h, w)
    pa = np.outer(_basis(h, a[0]), _basis(w, a[1]))
    pb = np.outer(_basis(h, b[0]), _basis(w, b[1]))
    coef = (pa - pb) * inv
    return (resistance * float((pa * coef).sum()),
            resistance * float((pb * coef).sum()))


def resistance(h: int, w: int, a, b, resistance: float = 1.0) -> float:
    """The equivalent resistance between nodes a and b, float64."""
    xa, xb = potentials(h, w, a, b, resistance)
    return xa - xb


def resistance_bf16(h: int, w: int, a, b, resistance: float = 1.0) -> float:
    """The control: R read from the exact potential field held in
    bfloat16, the least error that any solver whose state is bfloat16
    can have."""
    x = torch.tensor(potentials(h, w, a, b, resistance),
                     dtype=torch.float64).to(torch.bfloat16)
    return float(x[0] - x[1])
