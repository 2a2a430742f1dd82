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
takes any field: the levels above the largest one whose hierarchy fits one
block's shared memory go through the restriction and prolongation kernels,
the rest runs in one single-block launch a sample, and a coarsest level too
large for a block runs through :func:`jacobi_sweeps` with two deterministic
mean projections.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

#: Shared memory one block may use on Hopper (227 KB).
SMEM_BYTES_MAX = 232_448
#: Threads of the single-block kernels; ``vcycle_block`` keeps one value a
#: thread of static shared memory for its reductions (``kBlockThreads``).
BLOCK_THREADS = 512
#: Sweeps a tiled Jacobi launch runs (its halo); must match ``kMaxHalo``.
MAX_HALO = 8
#: The CUDA grid's third dimension carries the batch.
MAX_BATCH = 65_535
#: Values each block of the first mean-projection pass sums (``kMeanChunk``).
MEAN_CHUNK = 4096


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
    """``sweeps`` weighted-Jacobi sweeps of x against r, [B, h, w]."""
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
    fn = _launcher("jacobi", x.dtype)
    c = omega / (4.0 * weight)
    if jacobi_single_block(h, w, x.element_size()):
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


def vcycle(r: torch.Tensor, *, weight: float = 1.0, omega: float = 0.8,
           nu: int = 1, coarse_sweeps: int = 96,
           coarsest: int = 8) -> torch.Tensor:
    """One V(nu, nu) cycle of ``r`` [B, h, w] -> mean-zero [B, h, w].

    ``vcycle.launches`` counts the single-block cycle's launches and the
    mean projections of a coarsest level that no block holds; the levels
    above the entry count in their own wrappers.
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
    shapes = level_shapes(h, w, coarsest)
    entry = vcycle_entry(shapes, r.element_size())
    stop = len(shapes) - 1 if entry is None else entry
    with torch.cuda.device(r.device):
        rs, xs = [r], []
        for _ in range(stop):
            x = (None if nu == 1 else
                 jacobi_sweeps(torch.zeros_like(rs[-1]), rs[-1], sweeps=nu,
                               **kw))
            xs.append(x)
            rs.append(presmooth_restrict(rs[-1], x=x, **kw))
        if entry is None:
            rz = _subtract_mean(rs[-1])
            z = _subtract_mean(jacobi_sweeps(
                torch.zeros_like(rz), rz, sweeps=coarse_sweeps, **kw))
        else:
            tail = shapes[entry:]
            hs = (ctypes.c_int * len(tail))(*(s[0] for s in tail))
            ws = (ctypes.c_int * len(tail))(*(s[1] for s in tail))
            z = torch.empty_like(rs[-1])
            err = _launcher("vcycle", r.dtype)(
                rs[-1].data_ptr(), z.data_ptr(), B, len(tail), hs, ws, nu,
                coarse_sweeps, weight, omega / (4.0 * weight), _stream(r))
            _raise_on(err, "V-cycle", tuple(rs[-1].shape), r.dtype)
            vcycle.launches += 1
        for lv in reversed(range(stop)):
            z = prolong_postsmooth(rs[lv], z, x=xs[lv], **kw)
            if nu > 1:
                z = jacobi_sweeps(z, rs[lv], sweeps=nu - 1, **kw)
    return z - _mean(z) if stop else z


vcycle.launches = 0
