"""Fused CG algebra of the grid solve: plain torch versions, the
hand-written CUDA kernels' wrappers and their launch counts, and the fused
CG loop.

Counterpart of ``nodal_tpu/ops/pallas_cg.py``; the kernels are
``csrc/cg.cu``.  Fields are ``[B, h, w]`` (a leading batch) in float32 or
float64, any h, w >= 1:

* :func:`stencil_partials` — ``Lp = L_w p`` (the edge-replicate 5-point
  Laplacian with edge weight ``weight``) and, per (sample, part), the
  partial sums of ``p·Lp`` and of ``p``: the matvec and its dot product in
  one pass;
* :func:`update_partials` — ``x' = x + α p``, ``r' = r − α (Lp + mean_p)``
  and per (sample, tile) the partial sum of ``r'²``: both AXPYs and the
  convergence dot in one pass, with ``α`` and ``mean_p`` per-sample [B]
  tensors on the fields' device.

:func:`stencil_partials` cuts a field into row segments × column strips
(:func:`plan_of`; on the card :func:`partials_plan`: strips of
``STRIP_THREADS`` 16-byte columns, as many segments as fill the card for
one sample, the same for every B), its parts numbered by segment, then
strip; partials are ``[B, parts, 2]``.
:func:`update_partials` cuts it into ``TILE_H × TILE_W`` tiles (the last
ones ragged), numbered row-major; partials are ``[B, n_tiles]``.  Each
plain version (``*_plain``) takes its kernel's partition.  Each wrapper
takes its plain version for CPU tensors and, for CUDA tensors, launches
its kernel or raises: there is no fallback.  Each adds one to its
``.launches`` per launch.

:func:`fused_grid_cg` is the JAX package's ``fused_grid_cg`` over a batch:
the preconditioned CG on ``A = L + mean`` whose step takes α and mean p
from the first kernel's partials and the stopping test from the
second's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from nodal_tpu_torch.ops import stencil
from nodal_tpu_torch.ops.cg import (SolveInfo, _continuation, _dot,
                                    _per_sample, _safe_div)
from nodal_tpu_torch.utils import tracing

#: Tile of ``update_partials``; must match ``kTileH`` and ``kTileW`` in
#: cg.cu.
TILE_H = 32
TILE_W = 64

#: Threads of a ``stencil_partials`` strip block, each forming 16 bytes of
#: columns (``kStripThreads`` in cg.cu).
STRIP_THREADS = 128


def n_tiles(h: int, w: int) -> int:
    """Tiles of an h×w field: ``update_partials``' second dimension."""
    return -(-h // TILE_H) * -(-w // TILE_W)


@dataclass(frozen=True)
class PartialsPlan:
    """How ``stencil_partials`` cuts an h×w field: ``strips`` column strips
    of ``strip_cols`` columns and ``segments`` row segments of ``segment``
    rows (the last strip and segment may be shorter)."""

    strip_cols: int
    segment: int
    strips: int
    segments: int

    @property
    def parts(self) -> int:
        return self.strips * self.segments


@functools.cache
def partials_plan(h: int, w: int, itemsize: int, sms: int) -> PartialsPlan:
    """``stencil_partials``' partition of an h×w field on a card of ``sms``
    SMs: segments as long as ``stencil.STRIP_BLOCKS_PER_SM`` blocks an SM
    for one sample allow, down to one row.  It does not depend on the
    batch, so a sample's partials are the same alone or in a batch."""
    cols = STRIP_THREADS * (16 // itemsize)
    strips = -(-w // cols)
    seg = max(1, -(-h * strips // (stencil.STRIP_BLOCKS_PER_SM * sms)))
    segments = -(-h // seg)
    return PartialsPlan(cols, -(-h // segments), strips, segments)


def plan_of(p: torch.Tensor) -> PartialsPlan:
    """``stencil_partials``' partition of a [B, h, w] field: on CUDA
    :func:`partials_plan` for its card; on the CPU, where no kernel runs,
    ``update_partials``' ``TILE_H × TILE_W`` tiles, so that the CPU path
    rounds its sums as the plain versions always have."""
    h, w = p.shape[1], p.shape[2]
    if p.device.type != "cuda":
        return PartialsPlan(TILE_W, TILE_H, -(-w // TILE_W), -(-h // TILE_H))
    return partials_plan(h, w, p.element_size(), stencil._sm_count(p.device))


def _block_sums(f: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Sums of [B, h, w] fields over blocks of rows × cols, [B, blocks]
    row-major (the last blocks ragged)."""
    B, h, w = f.shape
    bh, bw = -(-h // rows), -(-w // cols)
    f = F.pad(f, (0, bw * cols - w, 0, bh * rows - h))
    return f.reshape(B, bh, rows, bw, cols).sum(dim=(2, 4)).reshape(
        B, bh * bw)


def _tile_sums(f: torch.Tensor) -> torch.Tensor:
    """Per-tile sums of [B, h, w] fields, [B, n_tiles]."""
    return _block_sums(f, TILE_H, TILE_W)


def part_sums(f: torch.Tensor) -> torch.Tensor:
    """Sums of [B, h, w] fields over ``stencil_partials``' parts on f's
    device (:func:`plan_of`), [B, parts]."""
    plan = plan_of(f)
    return _block_sums(f, plan.segment, plan.strip_cols)


# ------------------------------------------------------------ plain versions

def stencil_partials_plain(p, *, weight: float = 1.0):
    lp = stencil._lap(p, weight)
    return lp, torch.stack([part_sums(p * lp), part_sums(p)], dim=-1)


def update_partials_plain(x, r, p, lp, alpha, mean_p):
    a, m = _per_sample(alpha, x), _per_sample(mean_p, x)
    x_new = x + a * p
    r_new = r - a * (lp + m)
    return x_new, r_new, _tile_sums(r_new * r_new)


# ------------------------------------------------------------------ wrappers

def _launcher(name: str, dtype: torch.dtype):
    from nodal_tpu_torch.utils.kernels import load_library

    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(load_library(), f"cg_{name}_{suffix}")


def _raise_on(err: int, what: str, shape, dtype) -> None:
    if err != 0:
        raise RuntimeError(f"cg {what} kernel launch failed with CUDA error "
                           f"{err} ({shape}, {dtype})")


def stencil_partials(p: torch.Tensor, *, weight: float = 1.0):
    """``(Lp, partials [B, parts, 2])``: partial 0 Σ p·Lp, 1 Σ p, over the
    parts of :func:`plan_of`."""
    stencil._check("stencil_partials", p)
    if p.device.type == "cpu":
        return stencil_partials_plain(p, weight=weight)
    B, h, w = p.shape
    plan = plan_of(p)
    lp = torch.empty_like(p)
    part = torch.empty(B, plan.parts, 2, dtype=p.dtype, device=p.device)
    if p.numel() == 0:
        return lp, part.zero_()
    wide = w * p.element_size() % 16 == 0 and p.data_ptr() % 16 == 0
    with torch.cuda.device(p.device):
        err = _launcher("stencil_partials", p.dtype)(
            p.data_ptr(), lp.data_ptr(), part.data_ptr(), B, h, w,
            plan.segment, int(wide), weight, stencil._stream(p))
    _raise_on(err, "stencil_partials", tuple(p.shape), p.dtype)
    stencil_partials.launches += 1
    return lp, part


stencil_partials.launches = 0


def update_partials(x, r, p, lp, alpha, mean_p):
    """``(x + α p, r − α (Lp + mean_p), partials [B, n_tiles])``: partial
    Σ r'²; ``alpha`` and ``mean_p`` are [B]."""
    stencil._check("update_partials", x, r=r, p=p, lp=lp, alpha=alpha,
                   mean_p=mean_p)
    stencil._same_shape("update_partials", x, r=r, p=p, lp=lp)
    B, h, w = x.shape
    for name, t in (("alpha", alpha), ("mean_p", mean_p)):
        if t.shape != (B,):
            raise ValueError(f"update_partials: {name} has shape "
                             f"{tuple(t.shape)}, expected ({B},)")
    if x.device.type == "cpu":
        return update_partials_plain(x, r, p, lp, alpha, mean_p)
    x_new, r_new = torch.empty_like(x), torch.empty_like(r)
    part = torch.empty(B, n_tiles(h, w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return x_new, r_new, part.zero_()
    with torch.cuda.device(x.device):
        err = _launcher("update_partials", x.dtype)(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), lp.data_ptr(),
            alpha.data_ptr(), mean_p.data_ptr(), x_new.data_ptr(),
            r_new.data_ptr(), part.data_ptr(), B, h, w, stencil._stream(x))
    _raise_on(err, "update_partials", tuple(x.shape), x.dtype)
    update_partials.launches += 1
    return x_new, r_new, part


update_partials.launches = 0


# ---------------------------------------------------------------- the loop

def fused_grid_cg(b: torch.Tensor, preconditioner, *, weight: float = 1.0,
                  tol: float = 1e-6, maxiter: int = 200):
    """CG on the rank-one-regularized grid operator ``A = L_w + mean`` with
    the fused kernels, batched over ``b`` [B, h, w] (each sample
    mean-zero).

    ``preconditioner`` maps [B, h, w] residual fields to corrections.  As
    in :func:`~nodal_tpu_torch.ops.cg.cg`, the loop runs while any sample
    is unconverged and under ``maxiter`` and a stopped sample is frozen:
    it steps with α = 0, which leaves its x and r as they were, and keeps
    its p, rz, r·r and count, so each sample is its own single solve.  One
    host sync an iteration, the continuation test.  Returns ``(x,
    SolveInfo)`` with SolveInfo fields of shape [B].
    """
    B, h, w = b.shape
    n_total = h * w
    tiny = torch.finfo(b.dtype).tiny
    b_norm2 = _dot(b, b)
    atol2 = (tol * tol) * torch.clamp(b_norm2, min=tiny)

    x = torch.zeros_like(b)
    r = b  # A @ 0 = 0
    p = preconditioner(r)
    rz = _dot(r, p)
    rr = b_norm2
    k = torch.zeros(B, dtype=torch.int32, device=b.device)
    while True:
        active = (rr > atol2) & (k < maxiter)
        # The loop's one host sync an iteration: the continuation test.
        n_active = _continuation(active)
        if n_active == 0:
            break
        with tracing.span("cg.iteration"):
            lp, part_s = stencil_partials(p, weight=weight)
            p_lp, sum_p = part_s.sum(dim=1).unbind(-1)
            mean_p = sum_p / n_total
            p_ap = p_lp + mean_p * sum_p  # pᵀ(L + mean)p
            alpha = _safe_div(rz, p_ap)
            if n_active < B:
                alpha = torch.where(active, alpha, torch.zeros_like(alpha))
            x, r, part_u = update_partials(x, r, p, lp, alpha, mean_p)
            rr_new = part_u.sum(dim=1)
            z = preconditioner(r)
            rz_new = _dot(r, z)
            p_new = z + _per_sample(_safe_div(rz_new, rz), p) * p
            if n_active == B:
                p, rz, rr = p_new, rz_new, rr_new
                k = k + 1
            else:
                p = torch.where(_per_sample(active, p), p_new, p)
                rz = torch.where(active, rz_new, rz)
                rr = torch.where(active, rr_new, rr)
                k = k + active.to(torch.int32)
    res = torch.sqrt(rr / torch.clamp(b_norm2, min=tiny))
    return x, SolveInfo(residual=res, iterations=k, converged=res <= tol)
