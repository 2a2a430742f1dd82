"""Explicit-collective grid CG: halo exchange and all-reduces over ranks.

Counterpart of ``nodal_tpu/parallel/halo.py``.  A grid's rows are split
over the ranks of an ``sp`` process group, each rank holding the block
[B, H/sp, W] of every sample of a batch.  Each application of the 5-point
stencil exchanges one boundary row with each neighbour rank
(``batch_isend_irecv``, peer to peer), and the CG's dot products and the
operator's mean are all-reduced over the group; everything else is local
torch work.  The multigrid preconditioner smooths and transfers the fine
levels the same way and, once a level's blocks would hold fewer than
``_GATHER_ROWS`` rows, gathers the level on every rank
(``all_gather_into_tensor``) and finishes the cycle there through
:func:`nodal_tpu_torch.ops.stencil.vcycle`: the CUDA cycle on the card,
its plain version on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from nodal_tpu_torch.ops import stencil
from nodal_tpu_torch.ops.cg import cg
from nodal_tpu_torch.parallel.mesh import grid_block
from nodal_tpu_torch.utils.device import resolve_device

#: Gather the (small) coarse field onto every rank once its blocks would
#: hold fewer rows than this: the remaining levels run replicated, which
#: costs less than halo exchanges on slivers.
_GATHER_ROWS = 16

_MG_BACKENDS = ("auto", "plain")


def _place(group) -> tuple[list[int], int]:
    """The global ranks of ``group`` in its order, and this rank's index
    among them."""
    ranks = dist.get_process_group_ranks(group)
    return ranks, ranks.index(dist.get_rank())


def _exchange_halos(x: torch.Tensor, group):
    """The last row of the previous rank's block and the first row of the
    next rank's, each [B, 1, W]; at the grid's edges the rank's own
    boundary row (the edge-replicate Neumann stencil of ``ops.grid``)."""
    ranks, i = _place(group)
    first = x[:, :1].contiguous()
    last = x[:, -1:].contiguous()
    top = first if i == 0 else torch.empty_like(first)
    bottom = last if i == len(ranks) - 1 else torch.empty_like(last)
    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, first, ranks[i - 1], group),
                dist.P2POp(dist.irecv, top, ranks[i - 1], group)]
    if i < len(ranks) - 1:
        ops += [dist.P2POp(dist.isend, last, ranks[i + 1], group),
                dist.P2POp(dist.irecv, bottom, ranks[i + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return top, bottom


def halo_laplacian_matvec(x: torch.Tensor, group,
                          weight: float = 1.0) -> torch.Tensor:
    """This rank's block of ``L x`` for a row-split grid field [B, hl, W]:
    vertical neighbours across the block's edges come from the exchange,
    horizontal ones from edge-replicate padding (the whole width is
    here)."""
    top, bottom = _exchange_halos(x, group)
    xv = torch.cat([top, x, bottom], dim=1)
    xp = F.pad(xv, (1, 1), mode="replicate")
    nbr = (xp[:, :-2, 1:-1] + xp[:, 2:, 1:-1] + xp[:, 1:-1, :-2]
           + xp[:, 1:-1, 2:])
    return weight * (4.0 * x - nbr)


def _fold_cols_restrict(f: torch.Tensor) -> torch.Tensor:
    """Column half of the bilinear restriction, local to a block: weights
    3/4, 3/4, 1/4, 1/4 with the edges folded back (the transpose of the
    prolongation's column pass)."""
    a = 0.75 * (f[:, :, 0::2] + f[:, :, 1::2])
    fp = F.pad(f, (1, 1))
    out = a + 0.25 * (fp[:, :, 0:-2:2] + fp[:, :, 3::2])
    out[:, :, 0] += 0.25 * f[:, :, 0]
    out[:, :, -1] += 0.25 * f[:, :, -1]
    return out


def _expand_cols_prolong(x: torch.Tensor) -> torch.Tensor:
    """Column half of the bilinear prolongation (edge-replicated)."""
    B, rows, wc = x.shape
    xp = F.pad(x, (1, 1), mode="replicate")
    left = 0.75 * xp[:, :, 1:-1] + 0.25 * xp[:, :, :-2]
    right = 0.75 * xp[:, :, 1:-1] + 0.25 * xp[:, :, 2:]
    return torch.stack([left, right], dim=3).reshape(B, rows, 2 * wc)


def halo_restrict_bilinear(r: torch.Tensor, group) -> torch.Tensor:
    """Bilinear restriction of a row-split field, block [B, hl, W] ->
    [B, hl/2, W/2].  The quarter weights reach one fine row past the
    block, which the stencil's exchange supplies; at the grid's edges the
    replicated row is the fold-back, so the result is
    ``stencil._restrict_bilinear``'s exactly."""
    top, bottom = _exchange_halos(r, group)
    rv = torch.cat([top, r, bottom], dim=1)  # block row i is rv[:, i + 1]
    rows = (0.75 * (r[:, 0::2] + r[:, 1::2])
            + 0.25 * (rv[:, 0:-2:2] + rv[:, 3::2]))
    return _fold_cols_restrict(rows)


def halo_prolong_bilinear(xc: torch.Tensor, group) -> torch.Tensor:
    """Bilinear prolongation of a row-split coarse field, block
    [B, hc, Wc] -> [B, 2hc, 2Wc]; the weights that cross the block's edges
    come from the coarse exchange (at the grid's edges, replication)."""
    B, hc, wc = xc.shape
    top, bottom = _exchange_halos(xc, group)
    xv = torch.cat([top, xc, bottom], dim=1)
    up = 0.75 * xv[:, 1:-1] + 0.25 * xv[:, :-2]
    dn = 0.75 * xv[:, 1:-1] + 0.25 * xv[:, 2:]
    rows = torch.stack([up, dn], dim=2).reshape(B, 2 * hc, wc)
    return _expand_cols_prolong(rows)


def _group_sum(v: torch.Tensor, group) -> torch.Tensor:
    """Each sample's sum over the whole grid, [B]: the block's sums
    all-reduced over ``group``."""
    s = v.sum(dim=(1, 2))
    dist.all_reduce(s, group=group)
    return s


def _gather_rows(r: torch.Tensor, group) -> torch.Tensor:
    """The whole field [B, sp·hl, W] from every rank's block [B, hl, W]."""
    sp = dist.get_world_size(group)
    B, hl, w = r.shape
    out = r.new_empty((sp * B, hl, w))
    dist.all_gather_into_tensor(out, r.contiguous(), group=group)
    return out.reshape(sp, B, hl, w).transpose(0, 1).reshape(B, sp * hl, w)


def make_halo_mg_preconditioner(h: int, w: int, group, *,
                                omega: float = 0.8, nu: int = 1,
                                coarse_sweeps: int = 96, coarsest: int = 8,
                                backend: str = "auto"):
    """The row-split multigrid V(nu, nu) cycle (bilinear transfers, the
    same edge weight on every level: ``ops.grid``'s cycle over ranks).
    Returns ``M(r_block) -> z_block`` for [B, h/sp, w] blocks.

    Fine levels smooth with the halo stencil and transfer with the halo
    transfers; once a level's blocks would hold fewer than
    ``_GATHER_ROWS`` rows (or the level does not halve evenly over the
    ranks) the level is gathered and the rest of the cycle runs on every
    rank: ``stencil.vcycle`` (``backend="auto"``: the CUDA cycle on the
    card, the plain one on the CPU) or ``stencil.vcycle_plain``
    (``"plain"``).  That cycle subtracts its mean at the end; the global
    mean removal of ``M`` takes the same constant off every rank's block.
    """
    if backend not in _MG_BACKENDS:
        raise ValueError(f"mg_backend must be one of {_MG_BACKENDS}, not "
                         f"{backend!r}")
    cycle = stencil.vcycle_plain if backend == "plain" else stencil.vcycle
    sp = dist.get_world_size(group)
    _, index = _place(group)
    c = omega / 4.0

    def local_sweep(x, r, sweeps):
        for _ in range(sweeps):
            x = x + c * (r - halo_laplacian_matvec(x, group))
        return x

    def vcycle(r, hh, ww):
        hl = hh // sp
        if hl < _GATHER_ROWS or hh % (2 * sp) or ww % 2 or hl % 2:
            z = cycle(_gather_rows(r, group), weight=1.0, omega=omega, nu=nu,
                      coarse_sweeps=coarse_sweeps, coarsest=coarsest)
            return z[:, index * hl:(index + 1) * hl]
        x = local_sweep(torch.zeros_like(r), r, nu)
        res = r - halo_laplacian_matvec(x, group)
        zc = vcycle(halo_restrict_bilinear(res, group), hh // 2, ww // 2)
        x = x + halo_prolong_bilinear(zc, group)
        return local_sweep(x, r, nu)

    n_total = h * w

    def M(r):
        out = vcycle(r, h, w)
        return out - (_group_sum(out, group) / n_total)[:, None, None]

    return M


def make_halo_grid_solver(h: int, w: int, mesh, *, dtype=torch.float32,
                          tol: float = 1e-6, maxiter: int | None = None,
                          mg: bool = True, mg_backend: str = "auto",
                          device="cuda"):
    """A batched grid solver with explicit collectives over ``mesh``.

    Every rank passes the same global ``b_batch`` [B, H, W]; samples are
    split over ``dp`` and each sample's rows over ``sp``.  Returns this
    rank's ``(x [B/dp, H/sp, W], residuals [B/dp], iterations [B/dp])``;
    :func:`~nodal_tpu_torch.parallel.mesh.grid_block` gives the block's
    place.  ``mg=True`` preconditions with
    :func:`make_halo_mg_preconditioner`, ``mg=False`` is the plain halo
    CG.  The default ``maxiter`` is 100 with multigrid, ``20·max(h, w)``
    without.  ``device`` is the mesh's: ``"cuda"`` (this rank's card) or
    ``"cpu"``.
    """
    dev = resolve_device(device, "make_halo_grid_solver")
    sp_group = mesh.get_group("sp")
    sp = mesh.size(1)
    if h % sp:
        raise ValueError(f"grid rows {h} not divisible by sp={sp}")
    iters = maxiter if maxiter is not None else (
        100 if mg else 20 * max(h, w))
    M = (make_halo_mg_preconditioner(h, w, sp_group, backend=mg_backend)
         if mg else None)
    n_total = h * w

    def matvec(x):
        return (halo_laplacian_matvec(x, sp_group)
                + (_group_sum(x, sp_group) / n_total)[:, None, None])

    def solver(b_batch):
        b = torch.as_tensor(b_batch, dtype=dtype, device=dev)
        if b.dim() != 3 or b.shape[1:] != (h, w):
            raise ValueError(f"b_batch has shape {tuple(b.shape)}, expected "
                             f"[B, {h}, {w}]")
        samples, rows = grid_block(b.shape[0], h, mesh)
        bl = b[samples, rows].contiguous()
        bl = bl - (_group_sum(bl, sp_group) / n_total)[:, None, None]
        x, info = cg(matvec, bl, preconditioner=M, tol=tol, maxiter=iters,
                     group=sp_group)
        return x, info.residual, info.iterations

    return solver
