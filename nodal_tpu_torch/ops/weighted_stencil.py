"""Weighted-stencil kernels of the weighted grids and lattices: plain torch
versions, the hand-written CUDA kernels' wrappers and their launch counts.

The JAX package has no Pallas kernel here: under ``jit``, XLA fuses the
flux-form matvec of ``nodal_tpu/ops/grid_weighted.py`` (:34) and
``grid_weighted3.py`` (:42), each Jacobi sweep (:86-97 / :103-116) and the
block-sum restriction and replication prolongation (:99-105 / :118-127)
into loops over the field.  Eager torch would launch each of their ~11
(2-D) or ~17 (3-D) ops alone; the kernels of ``csrc/weighted_stencil.cu``
are the counterpart of those fusions.

Every function takes a batch of fields ``[B, d, h, w]`` and its
conductances ``g = (gx, gy, gz)``: ``gx [B, d, h, w-1]`` on the edges along
the last axis, ``gy [B, d, h-1, w]`` along the middle one and
``gz [B, d-1, h, w]`` along the leading one, in float32 or float64.  A 2-D
grid is d = 1 (``gz`` empty).  Coarsening halves h and w, and d too when
d > 1 (blocks of ``(fd, 2, 2)``, ``fd`` = :func:`depth_factor`).

* :func:`weighted_residual` — ``r − L_g x``, or ``L_g x + shift`` (the CG
  operator's matvec with its per-sample mean term) in place of ``r``; with
  ``restrict`` only the block sums of ``r − L_g x``, the coarse
  right-hand side;
* :func:`weighted_jacobi` — ``sweeps`` sweeps ``x ← x + ω / max(deg,
  tiny) · (r − L_g x)`` from ``x`` (zero when None), after adding the
  replicated coarse correction ``zc`` when given: one launch a sweep;
* :func:`weighted_jacobi_block` — the coarsest level's solve: all sweeps
  of a small field from zero in one block a sample, the field and its
  conductances in shared memory, between its two mean projections;
* :func:`coarse_solve` — the coarsest level of a V-cycle: the block
  kernel where the level fits one block (:func:`block_fits`), else the
  mean projections in torch around ``sweeps`` launches of
  :func:`weighted_jacobi`; ``coarse_solve.routes`` counts each route.

Each wrapper takes its plain version (``*_plain``) for CPU tensors and,
for CUDA tensors, launches its kernel or raises: there is no fallback.
Each adds one to its ``.launches`` per kernel launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Shared memory one block may use on Hopper (227 KB).
SMEM_BYTES_MAX = 232_448
#: Most threads of a block-kernel launch (``kBlockThreads``).
BLOCK_THREADS = 512
#: The CUDA grid's second dimension (or the block kernel's grid) carries
#: the batch.
MAX_BATCH = 65_535


# ------------------------------------------------------------ plain versions

def depth_factor(d: int) -> int:
    """How coarsening divides the leading axis: 1 for a grid (d = 1), else
    2 (a lattice coarsens only at even d)."""
    return 1 if d == 1 else 2


def _has_z(g) -> bool:
    return g[2].shape[1] > 0


def laplacian_plain(x: torch.Tensor, g) -> torch.Tensor:
    """``y = Σ_neighbours g_edge (x − x_neighbour)`` in the flux form and
    term order of the JAX package's ``weighted_laplacian_matvec(_3d)``."""
    gx, gy, gz = g
    fx = gx * (x[..., 1:] - x[..., :-1])
    fy = gy * (x[..., 1:, :] - x[..., :-1, :])
    y = (F.pad(fx, (1, 0)) - F.pad(fx, (0, 1))
         + F.pad(fy, (0, 0, 1, 0)) - F.pad(fy, (0, 0, 0, 1)))
    if _has_z(g):
        fz = gz * (x[:, 1:] - x[:, :-1])
        y = (y + F.pad(fz, (0, 0, 0, 0, 1, 0))
             - F.pad(fz, (0, 0, 0, 0, 0, 1)))
    return y


def degree(g) -> torch.Tensor:
    """Diagonal of the weighted Laplacian, in ``_degree(3)``'s term order."""
    gx, gy, gz = g
    deg = (F.pad(gx, (0, 1)) + F.pad(gx, (1, 0))
           + F.pad(gy, (0, 0, 0, 1)) + F.pad(gy, (0, 0, 1, 0)))
    if _has_z(g):
        deg = (deg + F.pad(gz, (0, 0, 0, 0, 0, 1))
               + F.pad(gz, (0, 0, 0, 0, 1, 0)))
    return deg


def coarsen_weights(g):
    """Exact Galerkin coarse conductances for replication prolongation: the
    sum of the fine edges crossing each coarse-cell face, in the term order
    of ``_coarsen_weights(3)``."""
    gx, gy, gz = g
    B, d, h = gx.shape[:3]
    w = gy.shape[3]
    cx = gx[..., 1::2]
    cy = gy[..., 1::2, :]
    if depth_factor(d) == 1:
        return (cx[:, :, 0::2] + cx[:, :, 1::2],
                cy[..., 0::2] + cy[..., 1::2],
                gz.new_zeros(B, 0, h // 2, w // 2))
    cz = gz[:, 1::2]
    return (cx[:, 0::2, 0::2] + cx[:, 0::2, 1::2]
            + cx[:, 1::2, 0::2] + cx[:, 1::2, 1::2],
            cy[:, 0::2, :, 0::2] + cy[:, 0::2, :, 1::2]
            + cy[:, 1::2, :, 0::2] + cy[:, 1::2, :, 1::2],
            cz[:, :, 0::2, 0::2] + cz[:, :, 0::2, 1::2]
            + cz[:, :, 1::2, 0::2] + cz[:, :, 1::2, 1::2])


def restrict_plain(r: torch.Tensor) -> torch.Tensor:
    """Block sums over ``(fd, 2, 2)`` blocks: [B, d, h, w] -> [B, d/fd,
    h/2, w/2]."""
    B, d, h, w = r.shape
    fd = depth_factor(d)
    return r.reshape(B, d // fd, fd, h // 2, 2, w // 2, 2).sum(dim=(2, 4, 6))


def prolong_plain(z: torch.Tensor, d: int) -> torch.Tensor:
    """Replication of a coarse field [B, d/fd, h/2, w/2] over the
    ``(fd, 2, 2)`` blocks of a fine field of depth ``d``."""
    z = z.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return z.repeat_interleave(2, dim=1) if depth_factor(d) == 2 else z


def _mean(v: torch.Tensor) -> torch.Tensor:
    return v.mean(dim=(1, 2, 3), keepdim=True)


def _dinv(g, omega: float) -> torch.Tensor:
    """``ω / max(deg, tiny)`` as a true division, as the JAX package and
    the kernels take it (``float / tensor`` in torch is a reciprocal times
    the float, which differs in the last bit)."""
    deg = degree(g)
    return deg.new_tensor(omega) / torch.clamp(deg,
                                               min=torch.finfo(deg.dtype).tiny)


def weighted_residual_plain(x, g, r=None, *, shift=None,
                            restrict: bool = False):
    y = laplacian_plain(x, g)
    if r is None:
        return y + shift.reshape(-1, 1, 1, 1)
    res = r - y
    return restrict_plain(res) if restrict else res


def weighted_jacobi_plain(x, r, g, *, omega: float = 0.8, sweeps: int = 1,
                          zc=None):
    dinv = _dinv(g, omega)
    x = torch.zeros_like(r) if x is None else x
    if zc is not None:
        x = x + prolong_plain(zc, r.shape[1])
    for _ in range(sweeps):
        x = x + dinv * (r - laplacian_plain(x, g))
    return x


def weighted_jacobi_block_plain(r, g, *, omega: float = 0.8,
                                sweeps: int = 1):
    r = r - _mean(r)
    x = weighted_jacobi_plain(None, r, g, omega=omega, sweeps=sweeps)
    return x - _mean(x)


# ------------------------------------------------------------------ wrappers

def _check(fn: str, ref: torch.Tensor, g, **others) -> None:
    """``ref`` is a [B, d, h, w] field, ``g`` its conductances; ``others``
    share its dtype and device (and all must be contiguous on CUDA).  It
    runs at every launch of a solve, so a message is built only on a
    failure."""
    if ref.dim() != 4:
        raise ValueError(f"{fn} expects [B, d, h, w] fields, got "
                         f"{tuple(ref.shape)}")
    dtype, dev = ref.dtype, ref.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{fn} supports float32 and float64, not {dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on CPU or CUDA tensors, not {dev}")
    B, d, h, w = ref.shape
    want = ((B, d, h, w - 1), (B, d, h - 1, w), (B, d - 1, h, w))
    if any(t.shape != s for t, s in zip(g, want)):
        raise ValueError(f"{fn}: conductances {[tuple(t.shape) for t in g]}"
                         f", expected {list(want)}")
    named = dict(zip(("gx", "gy", "gz"), g), **others)
    for name, t in named.items():
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, not {dtype}")
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, not {dev}")
    if dev.type == "cuda":
        if not (ref.is_contiguous()
                and all(t.is_contiguous() for t in named.values())):
            raise ValueError(f"{fn}: every field must be contiguous")
        if B > MAX_BATCH or d * h * w >= 2**31:
            raise ValueError(f"{fn}: a batch of at most {MAX_BATCH} "
                             f"samples of < 2^31 values, got "
                             f"{tuple(ref.shape)}")


def _coarse_shape(fn: str, shape) -> tuple:
    """The coarse shape of a fine [B, d, h, w] field, which must split
    into whole ``(fd, 2, 2)`` blocks."""
    B, d, h, w = shape
    fd = depth_factor(d)
    if h % 2 or w % 2 or d % fd or h < 2 or w < 2:
        raise ValueError(f"{fn} needs even h, w (and d when d > 1), got "
                         f"{tuple(shape[1:])}")
    return (B, d // fd, h // 2, w // 2)


def _launcher(name: str, dtype: torch.dtype):
    from nodal_tpu_torch.utils.kernels import load_library

    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(load_library(), f"wstencil_{name}_{suffix}")


def _raise_on(err: int, what: str, shape, dtype) -> None:
    if err != 0:
        raise RuntimeError(f"weighted {what} kernel launch failed with CUDA "
                           f"error {err} ({shape}, {dtype})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def weighted_residual(x: torch.Tensor, g, r: torch.Tensor | None = None, *,
                      shift: torch.Tensor | None = None,
                      restrict: bool = False) -> torch.Tensor:
    """``r − L_g x`` [B, d, h, w], its block sums [B, d/fd, h/2, w/2] with
    ``restrict``, or in place of ``r`` the matvec ``L_g x + shift``
    (``shift`` [B], one value a sample)."""
    others = {} if r is None else {"r": r}
    if shift is not None:
        others["shift"] = shift
    _check("weighted_residual", x, g, **others)
    if r is not None and r.shape != x.shape:
        raise ValueError(f"weighted_residual: r has shape {tuple(r.shape)}, "
                         f"expected {tuple(x.shape)}")
    if (r is None) == (shift is None) or (restrict and r is None):
        raise ValueError("weighted_residual takes r (with restrict or not) "
                         "or shift")
    if shift is not None and shift.shape != (x.shape[0],):
        raise ValueError(f"weighted_residual: shift has shape "
                         f"{tuple(shift.shape)}, expected ({x.shape[0]},)")
    out_shape = (_coarse_shape("weighted_residual", x.shape) if restrict
                 else x.shape)
    if x.device.type == "cpu":
        return weighted_residual_plain(x, g, r, shift=shift,
                                       restrict=restrict)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    B, d, h, w = x.shape
    with torch.cuda.device(x.device):
        err = _launcher("residual", x.dtype)(
            x.data_ptr(), _ptr(r), _ptr(shift), *(t.data_ptr() for t in g),
            out.data_ptr(), B, d, h, w, int(restrict), _stream(x))
    _raise_on(err, "residual", tuple(x.shape), x.dtype)
    weighted_residual.launches += 1
    return out


weighted_residual.launches = 0


def weighted_jacobi(x: torch.Tensor | None, r: torch.Tensor, g, *,
                    omega: float = 0.8, sweeps: int = 1,
                    zc: torch.Tensor | None = None) -> torch.Tensor:
    """``sweeps`` weighted-Jacobi sweeps against r [B, d, h, w] from ``x``
    (zero when None), the prolongation of ``zc`` [B, d/fd, h/2, w/2] added
    first when given; on CUDA one launch a sweep, the first adding ``zc``."""
    others = {} if x is None else {"x": x}
    if zc is not None:
        others["zc"] = zc
    _check("weighted_jacobi", r, g, **others)
    if x is not None and x.shape != r.shape:
        raise ValueError(f"weighted_jacobi: x has shape {tuple(x.shape)}, "
                         f"expected {tuple(r.shape)}")
    if zc is not None:
        want = _coarse_shape("weighted_jacobi", r.shape)
        if tuple(zc.shape) != want:
            raise ValueError(f"weighted_jacobi: zc has shape "
                             f"{tuple(zc.shape)}, expected {want}")
    if sweeps < 1:
        raise ValueError(f"weighted_jacobi: sweeps = {sweeps} < 1")
    if r.device.type == "cpu":
        return weighted_jacobi_plain(x, r, g, omega=omega, sweeps=sweeps,
                                     zc=zc)
    if r.numel() == 0:
        return torch.empty_like(r)
    B, d, h, w = r.shape
    fn = _launcher("jacobi", r.dtype)
    # Launches ping-pong between two buffers, the last one writing ``out``.
    out = torch.empty_like(r)
    bufs = [out, torch.empty_like(r) if sweeps > 1 else None]
    src = x
    with torch.cuda.device(r.device):
        for i in range(sweeps):
            dst = bufs[(sweeps - 1 - i) % 2]
            err = fn(_ptr(src), r.data_ptr(), _ptr(zc if i == 0 else None),
                     *(t.data_ptr() for t in g), dst.data_ptr(), B, d, h, w,
                     omega, _stream(r))
            _raise_on(err, "Jacobi", tuple(r.shape), r.dtype)
            weighted_jacobi.launches += 1
            src = dst
    return out


weighted_jacobi.launches = 0


def block_threads(n: int) -> int:
    """Threads of a block-kernel launch on an n-value field: the power of
    two at or above n, from 32 to ``BLOCK_THREADS``."""
    t = 32
    while t < n and t < BLOCK_THREADS:
        t *= 2
    return t


def block_bytes(d: int, h: int, w: int, itemsize: int) -> int:
    """Shared memory of a block-kernel launch: x, its ping-pong copy, r and
    one conductance slot a node for each axis (two in a grid, three in a
    lattice), then the reduction's values."""
    n = d * h * w
    fields = 5 if d == 1 else 6
    return (fields * n + block_threads(n)) * itemsize


def block_fits(d: int, h: int, w: int, itemsize: int) -> bool:
    """Whether one block holds a [d, h, w] field for
    :func:`weighted_jacobi_block`."""
    return block_bytes(d, h, w, itemsize) <= SMEM_BYTES_MAX


def weighted_jacobi_block(r: torch.Tensor, g, *, omega: float = 0.8,
                          sweeps: int = 1) -> torch.Tensor:
    """The coarsest level's solve in one launch, one block a sample:
    ``sweeps`` sweeps from zero against r [B, d, h, w] minus its mean, and
    the result minus its mean.  On CUDA the field must fit one block
    (:func:`block_fits`)."""
    _check("weighted_jacobi_block", r, g)
    if sweeps < 0:
        raise ValueError(f"weighted_jacobi_block: sweeps = {sweeps} < 0")
    if r.device.type == "cpu":
        return weighted_jacobi_block_plain(r, g, omega=omega, sweeps=sweeps)
    B, d, h, w = r.shape
    if not block_fits(d, h, w, r.element_size()):
        raise ValueError(f"weighted_jacobi_block: a {(d, h, w)} "
                         f"{r.dtype} field does not fit one block's "
                         f"{SMEM_BYTES_MAX} bytes")
    out = torch.empty_like(r)
    if r.numel() == 0:
        return out
    with torch.cuda.device(r.device):
        err = _launcher("jacobi_block", r.dtype)(
            r.data_ptr(), *(t.data_ptr() for t in g), out.data_ptr(), B, d,
            h, w, sweeps, block_threads(d * h * w), omega, _stream(r))
    _raise_on(err, "block Jacobi", tuple(r.shape), r.dtype)
    weighted_jacobi_block.launches += 1
    return out


weighted_jacobi_block.launches = 0


def coarse_solve(r: torch.Tensor, g, *, omega: float = 0.8,
                 sweeps: int = 96) -> torch.Tensor:
    """The coarsest level of a V-cycle: ``sweeps`` sweeps from zero against
    r minus its mean, then minus the result's mean.  On CUDA one
    :func:`weighted_jacobi_block` launch where the level fits a block (the
    ``"block"`` route), else ``sweeps`` launches of :func:`weighted_jacobi`
    between two torch mean projections (``"sweeps"``); the CPU takes the
    plain version.  ``coarse_solve.routes`` counts each route's calls."""
    if r.device.type == "cuda":
        B, d, h, w = r.shape
        if not block_fits(d, h, w, r.element_size()):
            coarse_solve.routes["sweeps"] += 1
            x = weighted_jacobi(None, r - _mean(r), g, omega=omega,
                                sweeps=sweeps)
            return x - _mean(x)
        coarse_solve.routes["block"] += 1
    return weighted_jacobi_block(r, g, omega=omega, sweeps=sweeps)


coarse_solve.routes = {"block": 0, "sweeps": 0}
