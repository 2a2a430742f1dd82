"""Plain reference of a resistive MNA sweep: the nodal equations of the
rows built and solved here, in float64, with SciPy's sparse LU.

Semantics (the reference front-end's, which the program documents too):
nodes are numbered in order of first appearance in the rows, the node
``g`` is ground and gets no unknown; a resistor of value R between a and b
stamps 1/R on the diagonal of a and b and -1/R off it; a current source of
value I between a and b injects I into a and draws I from b.  A sample's
parameters are the rows' values in row order.  Imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

GROUND = "g"


class ResistiveMNA:
    """The stamp pattern of ``rows`` (types R and A only)."""

    def __init__(self, rows):
        self.index: dict[str, int] = {}
        for row in rows:
            for node in row[3:5]:
                if node != GROUND and node not in self.index:
                    self.index[node] = len(self.index)
        self.n = len(self.index)
        self.m = len(rows)
        g_r, g_c, g_s, g_p = [], [], [], []
        b_r, b_s, b_p = [], [], []
        for k, (name, kind, _, a, b) in enumerate(rows):
            ia, ib = self.index.get(a), self.index.get(b)
            if kind == "R":
                for r, c, s in ((ia, ia, 1.0), (ib, ib, 1.0),
                                (ia, ib, -1.0), (ib, ia, -1.0)):
                    if r is not None and c is not None:
                        g_r.append(r), g_c.append(c), g_s.append(s)
                        g_p.append(k)
            elif kind == "A":
                for r, s in ((ia, 1.0), (ib, -1.0)):
                    if r is not None:
                        b_r.append(r), b_s.append(s), b_p.append(k)
            else:
                raise ValueError(f"{name}: the reference stamps R and A "
                                 f"rows only, not {kind!r}")
        self.g = (np.array(g_r), np.array(g_c), np.array(g_s), np.array(g_p))
        self.b = (np.array(b_r), np.array(b_s), np.array(b_p))

    def values(self, rows) -> np.ndarray:
        """The rows' values, in row order: the nominal parameter vector."""
        return np.array([float(row[2]) for row in rows])

    def system(self, params: np.ndarray):
        """(G as CSC, b) of one sample's parameters [m], float64."""
        r, c, s, p = self.g
        G = sp.csc_matrix((s / params[p], (r, c)), shape=(self.n, self.n))
        br, bs, bp = self.b
        rhs = np.zeros(self.n)
        np.add.at(rhs, br, bs * params[bp])
        return G, rhs

    def solve(self, params: np.ndarray) -> np.ndarray:
        """Node potentials [S, n] of parameter samples [S, m], float64."""
        params = np.asarray(params, dtype=np.float64)
        out = np.empty((len(params), self.n))
        for i, pv in enumerate(params):
            G, rhs = self.system(pv)
            out[i] = spla.splu(G).solve(rhs)
        return out


def rel_errors(x: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per sample, the largest deviation from the reference over its
    largest magnitude: max|x - ref| / max|ref|."""
    return (np.abs(x - ref).max(axis=1)
            / np.maximum(np.abs(ref).max(axis=1), 1e-300))
