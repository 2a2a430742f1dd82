"""Plain reference of a resistive MNA sweep in PyTorch: the nodal equations
of the rows built here as dense float64 matrices and solved with
``torch.linalg.solve``, on any device, a block of samples at a time.

Semantics (those of ``reference/mna.py``, which the program documents
too): nodes are numbered in order of first appearance in the rows, the
node ``g`` is ground and gets no unknown; a resistor of value R between a
and b stamps 1/R on the diagonal of a and b and -1/R off it; a current
source of value I between a and b injects I into a and draws I from b.  A
sample's parameters are the rows' values in row order.  Imports nothing
but torch: no JAX, nothing of either package.

On the CPU run it on one intra-op thread: torch 2.13's CPU build was seen
to hang in the batched f64 solve (MKL's ``DLASWP`` rejecting its
arguments) at two threads or more on systems of 431 unknowns.
"""

from __future__ import annotations

import contextlib

import torch

GROUND = "g"

#: Samples whose dense systems one ``torch.linalg.solve`` takes: 32 of
#: 1999 unknowns are 1.0 GB of float64.
BLOCK = 32


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and convolutions, so that nothing here
    runs below the precision it states; restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class NodalTorch:
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
        i64, f64 = torch.int64, torch.float64
        self.g = (torch.tensor(g_r, dtype=i64), torch.tensor(g_c, dtype=i64),
                  torch.tensor(g_s, dtype=f64), torch.tensor(g_p, dtype=i64))
        self.b = (torch.tensor(b_r, dtype=i64), torch.tensor(b_s, dtype=f64),
                  torch.tensor(b_p, dtype=i64))

    @staticmethod
    def values(rows) -> torch.Tensor:
        """The rows' values, in row order: the nominal parameters [m]."""
        return torch.tensor([float(row[2]) for row in rows],
                            dtype=torch.float64)

    def system(self, params: torch.Tensor):
        """(G [S, n, n], b [S, n]) of the parameter samples ``params``
        [S, m], float64, on their device: every stamp added into place
        (``index_put_`` with ``accumulate``)."""
        params = params.to(torch.float64)
        dev, S = params.device, params.shape[0]
        r, c, s, p = (t.to(dev) for t in self.g)
        G = torch.zeros((S, self.n, self.n), dtype=torch.float64, device=dev)
        at = torch.arange(S, device=dev)[:, None]
        G.index_put_((at.expand(S, len(r)), r.expand(S, -1),
                      c.expand(S, -1)), s / params[:, p], accumulate=True)
        br, bs, bp = (t.to(dev) for t in self.b)
        rhs = torch.zeros((S, self.n), dtype=torch.float64, device=dev)
        rhs.index_put_((at.expand(S, len(br)), br.expand(S, -1)),
                       bs * params[:, bp], accumulate=True)
        return G, rhs

    def solve(self, params: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
        """Node potentials [S, n] of the parameter samples [S, m], float64,
        on the parameters' device, ``block`` samples a dense solve."""
        out = torch.empty((params.shape[0], self.n), dtype=torch.float64,
                          device=params.device)
        with no_tf32():
            for lo in range(0, params.shape[0], block):
                G, rhs = self.system(params[lo:lo + block])
                out[lo:lo + block] = torch.linalg.solve(G, rhs)
        return out


def rel_errors(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per sample, the largest deviation from the reference over its
    largest magnitude: max|x - ref| / max|ref|."""
    return ((x - ref).abs().amax(dim=1)
            / ref.abs().amax(dim=1).clamp_min(1e-300))
