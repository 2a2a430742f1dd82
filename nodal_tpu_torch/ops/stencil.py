"""Multigrid stencil kernels of the grid solve: plain torch versions, the
hand-written CUDA kernels' wrappers and their launch counts.

Counterpart of the Pallas kernels of ``nodal_tpu/ops/pallas_stencil.py``
(``fused_jacobi``, ``fused_presmooth_restrict``, ``fused_prolong_postsmooth``,
``fused_vcycle``); the kernels are ``csrc/stencil.cu``.  Every function
takes fields ``[B, h, w]`` (a leading batch) in float32 or float64:

* :func:`jacobi_sweeps` — ``sweeps`` weighted-Jacobi sweeps
  ``x <- x + c (r - L_w x)``, ``c = omega / (4 weight)``, of the
  edge-replicate 5-point Laplacian ``L_w``;
* :func:`presmooth_restrict` — x = c r (one sweep from zero, or a given
  pre-smoothed x), then the bilinear restriction of ``r - L_w x``;
* :func:`prolong_postsmooth` — x = c r (or the given x) plus the bilinear
  prolongation of the coarse correction ``zc``, then one sweep;
* :func:`vcycle` — one V(nu, nu) multigrid cycle (bilinear transfers, the
  same edge weight on every level, ``coarse_sweeps`` mean-projected sweeps
  on the coarsest level), mean-zero output.  It is the JAX package's xla
  cycle (``nodal_tpu/ops/grid.py:make_mg_preconditioner``) and computes
  what ``fused_vcycle`` computes.

Each wrapper takes its plain version (``*_plain``) for CPU tensors and, for
CUDA tensors, launches its kernel or raises: there is no fallback.  Each
adds one to its ``.launches`` per kernel launch.  The CUDA :func:`vcycle`
takes any field: the levels above the largest one whose hierarchy fits a
thread-block cluster (:func:`vcycle_cluster_plan`) go through the
restriction and prolongation kernels, and the rest runs in one cluster
launch a sample (``vcycle_cluster``: row strips in the shared memory of up
to 16 CTAs, halos read across the cluster), or in one single-block launch
where one block holds as many levels.  A coarsest level alone that fits a
cluster runs its mean-projected sweeps in one ``jacobi_cluster`` launch; one
too large for a cluster runs through :func:`jacobi_sweeps` with two
deterministic mean projections.  :func:`jacobi_sweeps` itself runs a field
past one block but within a cluster in one ``jacobi_cluster`` launch.  A
batch's clusters are kept small enough to fit the card at once
(:func:`batch_cluster_cap`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

#: Shared memory one block may use on Hopper (227 KB).
SMEM_BYTES_MAX = 232_448
#: Threads of the single-block and cluster kernels; ``vcycle_block`` and
#: each cluster CTA keep one value a thread of static shared memory for
#: their reductions (``kBlockThreads``).
BLOCK_THREADS = 512
#: Sweeps a tiled Jacobi launch runs (its halo); must match ``kMaxHalo``.
MAX_HALO = 8
#: The CUDA grid's third dimension carries the batch.
MAX_BATCH = 65_535
#: Values each block of the first mean-projection pass sums (``kMeanChunk``).
MEAN_CHUNK = 4096
#: Largest thread-block cluster the kernels launch (``kMaxCluster``); a
#: cluster of 16 is past the portable 8 and needs the non-portable attribute.
MAX_CLUSTER = 16
#: A level whose row strips would hold fewer rows than this lives whole in
#: rank 0 of the cluster (``kRank0Rows``).
RANK0_ROWS = 4
#: Values of the cluster cycle's entry strip at most: a level whose strips
#: hold more costs more in the cluster (16 SMs, barriers, issue-bound
#: passes) than in the tiled kernels (measured on the H100: 512² f32 at 16
#: CTAs, 16,384 values a CTA).  A coarsest level alone has no such passes.
CLUSTER_ENTRY_VALUES = 8192
#: Static shared values of a cluster kernel beside the reduction's: the two
#: slots its cluster sums alternate between (``kSlots``).
CLUSTER_SLOTS = 2


def _cluster_static_bytes(itemsize: int) -> int:
    """A cluster kernel's static shared memory: the reduction's values and
    the slots, in the 16-byte units the compiler lays them out in."""
    return -(-(BLOCK_THREADS + CLUSTER_SLOTS) * itemsize // 16) * 16


# ------------------------------------------------------------ plain versions

def _lap(v: torch.Tensor, weight: float) -> torch.Tensor:
    """``weight * (4 v - neighbour sum)`` under edge-replicate padding."""
    xp = F.pad(v, (1, 1, 1, 1), mode="replicate")
    nbr = (xp[:, :-2, 1:-1] + xp[:, 2:, 1:-1] + xp[:, 1:-1, :-2]
           + xp[:, 1:-1, 2:])
    return weight * (4.0 * v - nbr)


def _sweep(v: torch.Tensor, r: torch.Tensor, weight: float,
           omega: float) -> torch.Tensor:
    """One weighted-Jacobi sweep of the edge-replicate 5-point stencil."""
    return v + (omega / (4.0 * weight)) * (r - _lap(v, weight))


def _mean(v: torch.Tensor) -> torch.Tensor:
    return v.mean(dim=(1, 2), keepdim=True)


def _prolong_bilinear(xc: torch.Tensor) -> torch.Tensor:
    """Cell-centred bilinear prolongation [B, hc, wc] -> [B, 2hc, 2wc]
    (1-D weights 3/4, 1/4, edge-replicated; rows sum to 1, so constants
    are kept exactly)."""
    B, hc, wc = xc.shape
    xp = F.pad(xc, (1, 1, 1, 1), mode="replicate")
    up = 0.75 * xp[:, 1:-1, :] + 0.25 * xp[:, :-2, :]
    dn = 0.75 * xp[:, 1:-1, :] + 0.25 * xp[:, 2:, :]
    rows = torch.stack([up, dn], dim=2).reshape(B, 2 * hc, wc + 2)
    left = 0.75 * rows[:, :, 1:-1] + 0.25 * rows[:, :, :-2]
    right = 0.75 * rows[:, :, 1:-1] + 0.25 * rows[:, :, 2:]
    return torch.stack([left, right], dim=3).reshape(B, 2 * hc, 2 * wc)


def _fold(f: torch.Tensor, dim: int) -> torch.Tensor:
    """The restriction along one axis: the adjoint of the prolongation's,
    whose out-of-range quarter weights fold back onto the edge cells."""
    f = f.movedim(dim, 1)
    a = 0.75 * (f[:, 0::2] + f[:, 1::2])
    fp = F.pad(f, (0, 0, 1, 1))
    out = a + 0.25 * (fp[:, 0:-2:2] + fp[:, 3::2])
    out[:, 0] += 0.25 * f[:, 0]
    out[:, -1] += 0.25 * f[:, -1]
    return out.movedim(1, dim)


def _restrict_bilinear(r: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`_prolong_bilinear`, [B, h, w] -> [B, h/2, w/2]."""
    return _fold(_fold(r, 2), 1)


def level_shapes(h: int, w: int, coarsest: int = 8) -> list[tuple[int, int]]:
    """The multigrid hierarchy: halve both dimensions while both are even
    and the smaller is above ``coarsest``."""
    shapes = [(h, w)]
    while min(h, w) > coarsest and h % 2 == 0 and w % 2 == 0:
        h, w = h // 2, w // 2
        shapes.append((h, w))
    return shapes


def jacobi_sweeps_plain(x, r, *, weight: float = 1.0, omega: float = 0.8,
                        sweeps: int = 1):
    for _ in range(sweeps):
        x = _sweep(x, r, weight, omega)
    return x


def presmooth_restrict_plain(r, *, weight: float = 1.0, omega: float = 0.8,
                             x=None):
    if x is None:
        x = (omega / (4.0 * weight)) * r
    return _restrict_bilinear(r - _lap(x, weight))


def prolong_postsmooth_plain(r, zc, *, weight: float = 1.0,
                             omega: float = 0.8, x=None):
    c = omega / (4.0 * weight)
    x = (c * r if x is None else x) + _prolong_bilinear(zc)
    return x + c * (r - _lap(x, weight))


def vcycle_plain(r, *, weight: float = 1.0, omega: float = 0.8, nu: int = 1,
                 coarse_sweeps: int = 96, coarsest: int = 8):
    def cycle(rr):
        h, w = rr.shape[1:]
        if min(h, w) <= coarsest or h % 2 or w % 2:
            # Coarsest: many cheap sweeps, mean-projected (the Neumann
            # nullspace component must not accumulate).
            x = jacobi_sweeps_plain(torch.zeros_like(rr), rr - _mean(rr),
                                    weight=weight, omega=omega,
                                    sweeps=coarse_sweeps)
            return x - _mean(x)
        x = jacobi_sweeps_plain(torch.zeros_like(rr), rr, weight=weight,
                                omega=omega, sweeps=nu)
        res = rr - _lap(x, weight)
        x = x + _prolong_bilinear(cycle(_restrict_bilinear(res)))
        return jacobi_sweeps_plain(x, rr, weight=weight, omega=omega,
                                   sweeps=nu)

    out = cycle(r)
    return out - _mean(out)


# ------------------------------------------------------------------ wrappers

def _check(fn: str, ref: torch.Tensor, **others) -> None:
    """``ref`` is a [B, h, w] field; ``others`` share its dtype and device
    (and must be contiguous on CUDA)."""
    if ref.dim() != 3:
        raise ValueError(f"{fn} expects [B, h, w] fields, got "
                         f"{tuple(ref.shape)}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fn} supports float32 and float64, not {ref.dtype}")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on CPU or CUDA tensors, not {ref.device}")
    for name, t in others.items():
        if t.dtype != ref.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, not {ref.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, not "
                             f"{ref.device}")
    if ref.device.type == "cuda":
        if ref.shape[0] > MAX_BATCH:
            raise ValueError(f"{fn}: batch {ref.shape[0]} is past "
                             f"{MAX_BATCH}")
        for name, t in {"field": ref, **others}.items():
            if not t.is_contiguous():
                raise ValueError(f"{fn}: {name} must be contiguous")


def _same_shape(fn: str, ref: torch.Tensor, **others) -> None:
    for name, t in others.items():
        if t.shape != ref.shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(ref.shape)}")


def _even(fn: str, r: torch.Tensor) -> None:
    if r.shape[1] % 2 or r.shape[2] % 2 or r.shape[1] < 2 or r.shape[2] < 2:
        raise ValueError(f"{fn} needs even h, w >= 2, got "
                         f"{tuple(r.shape[1:])}")


def _launcher(name: str, dtype: torch.dtype):
    from nodal_tpu_torch.utils.kernels import load_library

    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(load_library(), f"stencil_{name}_{suffix}")


def _raise_on(err: int, what: str, shape, dtype) -> None:
    if err != 0:
        raise RuntimeError(f"stencil {what} kernel launch failed with CUDA "
                           f"error {err} ({shape}, {dtype})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def jacobi_single_block(h: int, w: int, itemsize: int) -> bool:
    """Whether a field runs every sweep in one single-block launch a sample
    (x, its ping-pong copy and r in shared memory) rather than in tiles of
    at most ``MAX_HALO`` sweeps a launch."""
    return 3 * h * w * itemsize <= SMEM_BYTES_MAX


def jacobi_sweeps(x: torch.Tensor, r: torch.Tensor, *, weight: float = 1.0,
                  omega: float = 0.8, sweeps: int = 1) -> torch.Tensor:
    """``sweeps`` weighted-Jacobi sweeps of x against r, [B, h, w]: on CUDA
    in one single-block launch a sample where a block holds the field, else
    in one cluster launch where a cluster does (``jacobi_cluster``, with
    clusters no larger than :func:`batch_cluster_cap` allows), else in
    tiled launches of at most ``MAX_HALO`` sweeps.

    ``jacobi_sweeps.launches`` counts every launch of these kernels,
    ``jacobi_sweeps.cluster_launches`` those of ``jacobi_cluster`` (the
    V-cycle's coarsest solve among them)."""
    _check("jacobi_sweeps", x, r=r)
    _same_shape("jacobi_sweeps", x, r=r)
    if sweeps < 0:
        raise ValueError(f"jacobi_sweeps: sweeps = {sweeps} < 0")
    if x.device.type == "cpu":
        return jacobi_sweeps_plain(x, r, weight=weight, omega=omega,
                                   sweeps=sweeps)
    B, h, w = x.shape
    if sweeps == 0 or x.numel() == 0:
        return x.clone()
    single = jacobi_single_block(h, w, x.element_size())
    with torch.cuda.device(x.device):
        cluster = None if single else jacobi_cluster_size(
            h, w, x.element_size(), _cluster_cap(x))
        if cluster is not None:
            out = torch.empty_like(x)
            _jacobi_cluster(x, r, out, sweeps, cluster, weight, omega)
            return out
    fn = _launcher("jacobi", x.dtype)
    c = omega / (4.0 * weight)
    if single:
        chunks, single = [sweeps], 1
    else:
        chunks = [MAX_HALO] * (sweeps // MAX_HALO)
        chunks += [sweeps % MAX_HALO] if sweeps % MAX_HALO else []
        single = 0
    # Launches ping-pong between two buffers, the last one writing ``out``.
    out = torch.empty_like(x)
    bufs = [out, torch.empty_like(x) if len(chunks) > 1 else None]
    src = x
    with torch.cuda.device(x.device):
        for i, k in enumerate(chunks):
            dst = bufs[(len(chunks) - 1 - i) % 2]
            err = fn(src.data_ptr(), r.data_ptr(), dst.data_ptr(), B, h, w,
                     k, single, weight, c, _stream(x))
            _raise_on(err, "Jacobi", tuple(x.shape), x.dtype)
            jacobi_sweeps.launches += 1
            src = dst
    return out


jacobi_sweeps.launches = 0
jacobi_sweeps.cluster_launches = 0


def presmooth_restrict(r: torch.Tensor, *, weight: float = 1.0,
                       omega: float = 0.8,
                       x: torch.Tensor | None = None) -> torch.Tensor:
    """Restricted residual [B, h/2, w/2] of the pre-smoothed field: x = c r
    (one sweep from zero) unless ``x`` is given."""
    _check("presmooth_restrict", r, **({} if x is None else {"x": x}))
    _even("presmooth_restrict", r)
    if x is not None:
        _same_shape("presmooth_restrict", r, x=x)
    if r.device.type == "cpu":
        return presmooth_restrict_plain(r, weight=weight, omega=omega, x=x)
    B, h, w = r.shape
    rc = torch.empty(B, h // 2, w // 2, dtype=r.dtype, device=r.device)
    if B == 0:
        return rc
    with torch.cuda.device(r.device):
        err = _launcher("presmooth_restrict", r.dtype)(
            r.data_ptr(), _ptr(x), rc.data_ptr(), B, h, w, weight,
            omega / (4.0 * weight), _stream(r))
    _raise_on(err, "presmooth_restrict", tuple(r.shape), r.dtype)
    presmooth_restrict.launches += 1
    return rc


presmooth_restrict.launches = 0


def prolong_postsmooth(r: torch.Tensor, zc: torch.Tensor, *,
                       weight: float = 1.0, omega: float = 0.8,
                       x: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep of x = c r (or the given ``x``) plus the prolongation of
    ``zc`` [B, h/2, w/2], against r [B, h, w]."""
    _check("prolong_postsmooth", r, zc=zc, **({} if x is None else {"x": x}))
    _even("prolong_postsmooth", r)
    B, h, w = r.shape
    if zc.shape != (B, h // 2, w // 2):
        raise ValueError(f"prolong_postsmooth: zc has shape "
                         f"{tuple(zc.shape)}, expected {(B, h // 2, w // 2)}")
    if x is not None:
        _same_shape("prolong_postsmooth", r, x=x)
    if r.device.type == "cpu":
        return prolong_postsmooth_plain(r, zc, weight=weight, omega=omega,
                                        x=x)
    out = torch.empty_like(r)
    if B == 0:
        return out
    with torch.cuda.device(r.device):
        err = _launcher("prolong_postsmooth", r.dtype)(
            r.data_ptr(), zc.data_ptr(), _ptr(x), out.data_ptr(), B, h, w,
            weight, omega / (4.0 * weight), _stream(r))
    _raise_on(err, "prolong_postsmooth", tuple(r.shape), r.dtype)
    prolong_postsmooth.launches += 1
    return out


prolong_postsmooth.launches = 0


def vcycle_block_bytes(shapes, itemsize: int) -> int:
    """Shared memory of one single-block V-cycle from ``shapes[0]`` down:
    a scratch field, x of every level and r of every level below the entry
    (whose r stays in device memory); a one-level cycle needs a third field
    for its projected r.  Plus the reduction's static values."""
    n = [h * w for h, w in shapes]
    values = 2 * n[0] + 2 * sum(n[1:]) + (n[0] if len(n) == 1 else 0)
    return (values + BLOCK_THREADS) * itemsize


def vcycle_entry(shapes, itemsize: int) -> int | None:
    """Index of the largest level whose hierarchy fits one block, or None
    when not even the coarsest does."""
    return next((l for l in range(len(shapes))
                 if vcycle_block_bytes(shapes[l:], itemsize)
                 <= SMEM_BYTES_MAX), None)


def strip_bounds(h: int, cluster: int) -> list[int]:
    """First rows of the ``cluster`` row strips of an h-row level, and h:
    rank k owns rows ``[b[k], b[k + 1])``."""
    return [k * h // cluster for k in range(cluster + 1)]


def cluster_levels(tail, cluster: int) -> int:
    """How many levels of ``tail`` (entry first) a cluster cuts in row
    strips: those whose every strip keeps ``RANK0_ROWS`` rows.  The levels
    after them live whole in rank 0."""
    return next((l for l, (h, _) in enumerate(tail)
                 if h // cluster < RANK0_ROWS), len(tail))


def cluster_strip_rows(tail, cluster: int) -> list[int]:
    """Rows of the largest strip of each cut level.  The strips are those of
    the last cut level (:func:`strip_bounds`) doubled level by level, so a
    coarse strip is the restriction of its fine strip."""
    d = cluster_levels(tail, cluster)
    rows = -(-tail[d - 1][0] // cluster)
    return [rows << (d - 1 - l) for l in range(d)]


def vcycle_cluster_bytes(tail, cluster: int, itemsize: int) -> int | None:
    """Shared memory of each CTA of one cluster V-cycle from ``tail[0]``
    down, or None when the entry level's strips would be too thin.  Every
    CTA holds, for its strip of each cut level, x and (below the entry) r,
    and a scratch field as large as the entry strip or the largest
    rank-0 level; rank 0's layout (which every CTA mirrors) adds x and r of
    the levels it holds whole.  A one-level cycle keeps its projected r in
    a third strip.  Plus the static values (:func:`_cluster_static_bytes`)."""
    d = cluster_levels(tail, cluster)
    if d == 0:
        return None
    strips = [rows * w for rows, (_, w) in
              zip(cluster_strip_rows(tail, cluster), tail)]
    whole = [h * w for h, w in tail[d:]]
    values = (max(strips[0], whole[0] if whole else 0)
              + strips[0] * (2 if len(tail) == 1 else 1)
              + 2 * sum(strips[1:]) + 2 * sum(whole))
    return values * itemsize + _cluster_static_bytes(itemsize)


@dataclass(frozen=True)
class ClusterPlan:
    """Where the cluster V-cycle enters ``shapes`` and how it is cut."""

    entry: int    # index of the entry level
    cluster: int  # CTAs a sample, a power of two
    rank0: int    # index of the first level whole in rank 0 (len(shapes): none)


def vcycle_cluster_plan(shapes, itemsize: int,
                        max_cluster: int = MAX_CLUSTER) -> ClusterPlan | None:
    """The largest level whose hierarchy fits a cluster of at most
    ``max_cluster`` CTAs of ``SMEM_BYTES_MAX`` each, with entry strips of
    at most ``CLUSTER_ENTRY_VALUES`` values unless it is the coarsest
    level alone, cut over the largest cluster that holds it (more SMs a
    sample: a grid solve waits on one sample's cycle); None when not even
    the coarsest level fits."""
    for e in range(len(shapes)):
        tail = shapes[e:]
        cluster = max_cluster
        while cluster >= 2:
            b = vcycle_cluster_bytes(tail, cluster, itemsize)
            if (b is not None and b <= SMEM_BYTES_MAX
                    and (len(tail) == 1 or cluster_strip_rows(tail, cluster)[0]
                         * tail[0][1] <= CLUSTER_ENTRY_VALUES)):
                return ClusterPlan(e, cluster,
                                   e + cluster_levels(shapes[e:], cluster))
            cluster //= 2
    return None


def jacobi_cluster_size(h: int, w: int, itemsize: int,
                        max_cluster: int = MAX_CLUSTER) -> int | None:
    """The largest cluster of at most ``max_cluster`` CTAs whose row strips
    (at least one row each) hold x, its ping-pong copy and r, or None."""
    cluster = max_cluster
    while cluster >= 2:
        nbytes = (3 * -(-h // cluster) * w * itemsize
                  + _cluster_static_bytes(itemsize))
        if h >= cluster and nbytes <= SMEM_BYTES_MAX:
            return cluster
        cluster //= 2
    return None


@functools.cache
def max_cluster(dtype: torch.dtype) -> int:
    """The largest cluster (16 or 8) the card schedules for the cluster
    kernels at the full shared memory a CTA, as
    ``cudaOccupancyMaxActiveClusters`` reports it; raises when neither
    size can be scheduled."""
    out = ctypes.c_int(0)
    err = _launcher("max_cluster", dtype)(ctypes.byref(out))
    _raise_on(err, "cluster occupancy query", (), dtype)
    if out.value not in (8, 16):
        raise RuntimeError(f"the card schedules no cluster of 8 or 16 CTAs "
                           f"at {SMEM_BYTES_MAX} bytes of shared memory "
                           f"each ({dtype})")
    return out.value


def batch_cluster_cap(batch: int, max_cluster: int, sms: int) -> int:
    """The largest cluster, a power of two of at most ``max_cluster``,
    whose ``batch`` clusters fit the card's ``sms`` SMs at once (1: none).
    A batch that fills the card gains nothing from spreading a sample over
    more SMs, only barriers and a second wave."""
    cluster = max_cluster
    while cluster > 1 and batch * cluster > sms:
        cluster //= 2
    return cluster


def _cluster_cap(t: torch.Tensor) -> int:
    """:func:`batch_cluster_cap` for the batch of ``t`` on its card."""
    return batch_cluster_cap(t.shape[0], max_cluster(t.dtype),
                             _sm_count(t.device))


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _jacobi_cluster(x, r, out, sweeps: int, cluster: int, weight: float,
                    omega: float) -> None:
    """One ``jacobi_cluster`` launch into ``out``: ``sweeps`` sweeps of x
    against r, or with x None the coarsest solve, sweeps from zero against
    r minus its mean and the result minus its mean."""
    B, h, w = r.shape
    err = _launcher("jacobi_cluster", r.dtype)(
        _ptr(x), r.data_ptr(), out.data_ptr(), B, h, w, sweeps, cluster,
        int(x is None), weight, omega / (4.0 * weight), _stream(r))
    _raise_on(err, "Jacobi cluster", tuple(r.shape), r.dtype)
    jacobi_sweeps.launches += 1
    jacobi_sweeps.cluster_launches += 1


def _subtract_mean(x: torch.Tensor) -> torch.Tensor:
    """x minus its per-sample mean, by the two-pass deterministic
    reduction of ``csrc/stencil.cu``."""
    B, h, w = x.shape
    n = h * w
    part = torch.empty(B * (-(-n // MEAN_CHUNK)), dtype=x.dtype,
                       device=x.device)
    out = torch.empty_like(x)
    err = _launcher("subtract_mean", x.dtype)(
        x.data_ptr(), out.data_ptr(), part.data_ptr(), B, n, _stream(x))
    _raise_on(err, "mean projection", tuple(x.shape), x.dtype)
    vcycle.launches += 1
    return out


@dataclass(frozen=True)
class VcycleRoute:
    """How :func:`vcycle` runs a field on CUDA: ``stop`` levels above the
    entry through the tiled kernels, then the cluster cycle (``plan``), the
    single-block cycle (``block``) or the Jacobi route (neither)."""

    shapes: tuple
    stop: int
    plan: ClusterPlan | None
    block: bool
    hs: object  # the tail's level shapes as C int arrays
    ws: object


@functools.cache
def vcycle_route(h: int, w: int, coarsest: int, itemsize: int,
                 max_cluster: int) -> VcycleRoute:
    """The cluster cycle where its entry lies above the single-block
    cycle's, or where the coarsest level would take the Jacobi route;
    else the single-block cycle, else the Jacobi route."""
    shapes = tuple(level_shapes(h, w, coarsest))
    entry = vcycle_entry(shapes, itemsize)
    plan = None
    if entry != 0:
        plan = vcycle_cluster_plan(shapes, itemsize, max_cluster)
        if plan is not None and entry is not None and plan.entry >= entry:
            plan = None  # one block holds as many levels
    if plan is not None:
        stop = plan.entry
    else:
        stop = len(shapes) - 1 if entry is None else entry
    tail = shapes[stop:]
    return VcycleRoute(shapes, stop, plan, plan is None and entry is not None,
                       (ctypes.c_int * len(tail))(*(s[0] for s in tail)),
                       (ctypes.c_int * len(tail))(*(s[1] for s in tail)))


def vcycle(r: torch.Tensor, *, weight: float = 1.0, omega: float = 0.8,
           nu: int = 1, coarse_sweeps: int = 96,
           coarsest: int = 8) -> torch.Tensor:
    """One V(nu, nu) cycle of ``r`` [B, h, w] -> mean-zero [B, h, w].

    ``vcycle.launches`` counts the cluster and single-block cycles'
    launches and the mean projections of a coarsest level that no cluster
    holds, ``vcycle.cluster_launches`` the cluster cycle's alone; the
    levels above the entry and a coarsest level's sweeps count in their
    own wrappers.
    """
    _check("vcycle", r)
    if nu < 1 or coarse_sweeps < 0 or coarsest < 1:
        raise ValueError(f"vcycle: nu = {nu} (>= 1), coarse_sweeps = "
                         f"{coarse_sweeps} (>= 0), coarsest = {coarsest} "
                         "(>= 1)")
    if r.device.type == "cpu":
        return vcycle_plain(r, weight=weight, omega=omega, nu=nu,
                            coarse_sweeps=coarse_sweeps, coarsest=coarsest)
    B, h, w = r.shape
    if r.numel() == 0:
        return torch.empty_like(r)
    kw = {"weight": weight, "omega": omega}
    c = omega / (4.0 * weight)
    with torch.cuda.device(r.device):
        route = vcycle_route(h, w, coarsest, r.element_size(),
                             _cluster_cap(r))
        stop, plan, tail = route.stop, route.plan, route.shapes[route.stop:]
        rs, xs = [r], []
        for _ in range(stop):
            x = (None if nu == 1 else
                 jacobi_sweeps(torch.zeros_like(rs[-1]), rs[-1], sweeps=nu,
                               **kw))
            xs.append(x)
            rs.append(presmooth_restrict(rs[-1], x=x, **kw))
        hs, ws = route.hs, route.ws
        z = torch.empty_like(rs[-1])
        if plan is not None and len(tail) == 1:
            _jacobi_cluster(None, rs[-1], z, coarse_sweeps, plan.cluster,
                            weight, omega)
        elif plan is not None:
            err = _launcher("vcycle_cluster", r.dtype)(
                rs[-1].data_ptr(), z.data_ptr(), B, len(tail), hs, ws,
                plan.cluster, plan.rank0 - plan.entry, nu, coarse_sweeps,
                weight, c, _stream(r))
            _raise_on(err, "cluster V-cycle", tuple(rs[-1].shape), r.dtype)
            vcycle.launches += 1
            vcycle.cluster_launches += 1
        elif route.block:
            err = _launcher("vcycle", r.dtype)(
                rs[-1].data_ptr(), z.data_ptr(), B, len(tail), hs, ws, nu,
                coarse_sweeps, weight, c, _stream(r))
            _raise_on(err, "V-cycle", tuple(rs[-1].shape), r.dtype)
            vcycle.launches += 1
        else:
            rz = _subtract_mean(rs[-1])
            z = _subtract_mean(jacobi_sweeps(
                torch.zeros_like(rz), rz, sweeps=coarse_sweeps, **kw))
        for lv in reversed(range(stop)):
            z = prolong_postsmooth(rs[lv], z, x=xs[lv], **kw)
            if nu > 1:
                z = jacobi_sweeps(z, rs[lv], sweeps=nu - 1, **kw)
    return z - _mean(z) if stop else z


vcycle.launches = 0
vcycle.cluster_launches = 0
