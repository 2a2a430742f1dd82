"""Batched tridiagonal solve: the hand-written CUDA kernel, its wrapper and
the plain version of its algorithm.

Counterpart of the Pallas kernel ``nodal_tpu/ops/pallas_tridiag.py``
(``pcr_solve``, ``pcr_solve_padded``).  The kernel is ``csrc/pcr.cu``: a
hybrid of Thomas and PCR, one warp a system (32 chunks of k rows, a Thomas
sweep in each chunk, the 64-row reduced system by PCR over shuffles, a
back substitution in each chunk).  :func:`thomas_pcr_solve` is that
algorithm in plain torch; the function is the plain PCR's,
:func:`nodal_tpu_torch.ops.tridiag.tridiag_solve`.

:func:`pcr_solve` takes :func:`tridiag_solve` only for tensors on the CPU,
so the CPU path keeps its parity with the JAX package.  For CUDA tensors
it launches the kernel or raises: there is no fallback.  Every chain length
runs in the kernel: a warp solves its systems in a buffer in shared memory
while one fits a block, else in a global scratch area allocated here
(:func:`launch_config`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from nodal_tpu_torch.ops import stencil
from nodal_tpu_torch.ops.tridiag import tridiag_solve

#: Shared memory one block may use on Hopper (227 KB).
SMEM_BYTES_MAX = 232_448

#: Shared memory of one SM (228 KB), of which each resident block
#: reserves ``SMEM_BLOCK_RESERVED``.
SMEM_SM_BYTES = 233_472
SMEM_BLOCK_RESERVED = 1024

#: Upper bound on the global scratch of the long-chain variant; the grid is
#: cut so that its buffers fit.
SCRATCH_BYTES_MAX = 1 << 30

#: Lanes of a warp: the chunks of a system.
LANES = 32

#: Warps a block at most; must match ``kMaxWarps`` in ``csrc/pcr.cu``.
MAX_WARPS = 8

#: Warps an SM the launch plan fills at most.
MAX_WARPS_PER_SM = 16

#: Warps a block of the long-chain (global scratch) variant.
SCRATCH_WARPS = 4


def chunk_rows(n: int, itemsize: int) -> int:
    """Rows k of a lane's chunk: ``ceil(n / 32)`` rounded up to the values
    a 16-byte access holds (at least 2)."""
    v = 16 // itemsize
    per_lane = -(-n // LANES)
    return v * max(1, -(-per_lane // v))


def chunk_stride(k: int, itemsize: int) -> int:
    """16-byte units between two chunks in a buffer: the chunk's units,
    made odd so that one unit of every chunk lies in 8 distinct bank
    groups per quarter warp."""
    return (k // (16 // itemsize)) | 1


def system_bytes(n: int, itemsize: int) -> int:
    """Bytes of one system's buffer: four arrays of 32 chunk slots."""
    return 4 * LANES * chunk_stride(chunk_rows(n, itemsize), itemsize) * 16


@dataclass(frozen=True)
class LaunchConfig:
    k: int              # rows a chunk
    warps: int          # warps a block, one system at a time each
    grid: int           # blocks; warp g solves systems g, g + G, ...
    smem_bytes: int     # dynamic shared memory (0 for the scratch variant)
    scratch_elems: int  # global scratch values (0 for the shared variant)


@functools.cache
def launch_config(B: int, n: int, itemsize: int, sms: int) -> LaunchConfig:
    """How :func:`pcr_solve` launches the kernel for B chains of length n
    on a card of ``sms`` SMs.

    Each warp solves one system at a time in a buffer of its own.  While a
    buffer fits a block's shared memory, each SM runs as many warps as
    buffers fit its shared memory (at most ``MAX_WARPS_PER_SM``, in blocks
    of at most ``MAX_WARPS``), since the solve is bound by the latency of
    its dependent chains and more warps hide more of it; every warp walks
    the batch.  Past that, blocks of ``SCRATCH_WARPS`` warps work on
    buffers in global scratch, with the grid bounded by
    ``SCRATCH_BYTES_MAX``.
    """
    k = chunk_rows(n, itemsize)
    per_system = system_bytes(n, itemsize)
    if per_system <= SMEM_BYTES_MAX:
        per_sm = max(1, min(MAX_WARPS_PER_SM, SMEM_SM_BYTES // (
            per_system + SMEM_BLOCK_RESERVED)))
        blocks = -(-per_sm // MAX_WARPS)
        warps = max(1, min(per_sm // blocks, B))
        grid = min(-(-B // warps), sms * blocks)
        return LaunchConfig(k, warps, grid, warps * per_system, 0)
    warps = min(SCRATCH_WARPS, B)
    grid = max(1, min(-(-B // warps),
                      SCRATCH_BYTES_MAX // (warps * per_system)))
    return LaunchConfig(k, warps, grid, 0,
                        grid * warps * per_system // itemsize)


def thomas_pcr_solve(dl, d, du, b):
    """The kernel's algorithm in plain torch, vectorised over the batch and
    the 32 chunks: ``[B, n]`` bands as :func:`tridiag_solve` takes them,
    chunks of :func:`chunk_rows` rows.

    The system is padded with identity rows to 32·k rows.  In each chunk
    s .. e a forward sweep writes every row i > s as a'[i] x[s] + x[i] +
    c'[i] x[i+1] = d'[i], and a backward one row s + 1 as x[s+1] +
    a''·x[s] + c''·x[e] = d''.  Row s with x[s+1] substituted and row e
    form the 64-row reduced system (order ..., e(l-1), s(l), e(l), ...),
    which :func:`tridiag_solve` solves by PCR as the kernel's shuffles do;
    then each chunk substitutes back from x[e].
    """
    B, n = d.shape
    k = chunk_rows(n, d.element_size())
    pad = LANES * k - n

    def chunks(t, fill, first=None, last=None):
        t = t.clone()
        if first is not None:
            t[:, 0] = first
        if last is not None:
            t[:, n - 1] = last
        t = torch.cat([t, t.new_full((B, pad), fill)], dim=1)
        return t.reshape(B, LANES, k)

    a = chunks(dl, 0.0, first=0.0)
    dd = chunks(d, 1.0)
    c = chunks(du, 0.0, last=0.0)
    r = chunks(b, 0.0)

    ap = torch.full_like(a[..., 0], -1.0)
    cp = torch.zeros_like(ap)
    dp = torch.zeros_like(ap)
    a1, c1, d1 = (torch.zeros_like(a) for _ in range(3))
    for i in range(1, k):
        inv = 1.0 / (dd[..., i] - a[..., i] * cp)
        ap = -a[..., i] * ap * inv
        cp = c[..., i] * inv
        dp = (r[..., i] - a[..., i] * dp) * inv
        a1[..., i], c1[..., i], d1[..., i] = ap, cp, dp

    ab, cb, db = torch.zeros_like(ap), -torch.ones_like(ap), torch.zeros_like(ap)
    for i in range(k - 2, 0, -1):
        ab = a1[..., i] - c1[..., i] * ab
        cb = -c1[..., i] * cb
        db = d1[..., i] - c1[..., i] * db

    s_c = c[..., 0]
    reduced = [torch.stack([s, e], dim=-1).reshape(B, 2 * LANES) for s, e in (
        (a[..., 0], ap),
        (dd[..., 0] - s_c * ab, torch.ones_like(ap)),
        (-s_c * cb, cp),
        (r[..., 0] - s_c * db, dp))]
    xr = tridiag_solve(*reduced).reshape(B, LANES, 2)
    xs, xe = xr[..., 0], xr[..., 1]

    x = torch.empty_like(a)
    x[..., 0], x[..., k - 1] = xs, xe
    xn = xe
    for i in range(k - 2, 0, -1):
        xn = d1[..., i] - a1[..., i] * xs - c1[..., i] * xn
        x[..., i] = xn
    return x.reshape(B, LANES * k)[:, :n]


def _check(dl, d, du, b) -> None:
    if d.dim() != 2:
        raise ValueError(f"pcr_solve expects [B, n] bands, got {tuple(d.shape)}")
    for name, t in (("dl", dl), ("du", du), ("b", b)):
        if t.shape != d.shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, d has {tuple(d.shape)}")
        if t.dtype != d.dtype:
            raise TypeError(f"{name} is {t.dtype}, d is {d.dtype}")
        if t.device != d.device:
            raise ValueError(f"{name} is on {t.device}, d is on {d.device}")
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pcr_solve supports float32 and float64, not {d.dtype}")


def pcr_solve(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Solve B tridiagonal systems ``[B, n]`` (conventions of
    :func:`~nodal_tpu_torch.ops.tridiag.tridiag_solve`).

    CPU tensors: the plain torch PCR.  CUDA tensors: the CUDA kernel, which
    adds one to ``pcr_solve.launches`` per launch.
    """
    _check(dl, d, du, b)
    if d.device.type == "cpu":
        return tridiag_solve(dl, d, du, b)
    if d.device.type != "cuda":
        raise ValueError(f"pcr_solve runs on CPU or CUDA tensors, not {d.device}")
    for name, t in (("dl", dl), ("d", d), ("du", du), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, n = d.shape
    x = torch.empty_like(d)
    if B == 0 or n == 0:
        return x

    from nodal_tpu_torch.utils.kernels import load_library

    lib = load_library()
    item = d.element_size()
    cfg = launch_config(B, n, item, stencil._sm_count(d.device))
    scratch = (torch.empty(cfg.scratch_elems, dtype=d.dtype, device=d.device)
               if cfg.scratch_elems else None)
    wide = n * item % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (dl, d, du, b, x))
    fn = lib.pcr_solve_f32 if d.dtype == torch.float32 else lib.pcr_solve_f64
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(),
                 x.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None,
                 B, n, cfg.k, cfg.warps, cfg.grid, int(wide), stream)
    if err != 0:
        raise RuntimeError(
            f"PCR kernel launch failed with CUDA error {err} "
            f"(B={B}, n={n}, {d.dtype}, {cfg})")
    pcr_solve.launches += 1
    return x


pcr_solve.launches = 0
