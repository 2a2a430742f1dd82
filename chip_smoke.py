"""Smoke test of nodal_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nodal_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card, then drives each main path
once through ``BatchedSolver(refine="auto")`` and checks its answers
against the f64 audit, every sample against the tier's raw f64 solve and
sample 0 against a numpy f64 dense solve:

* the 1000-node ladder (``tridiag`` tier, PCR kernel), B = 16384;
* the 25×40 resistor mesh (``sband`` tier, scalar-band kernel), B = 16384;
* the 25×200 and 25×400 meshes (``sband``), B = 256;
* the 25×40 mesh driven by a voltage source plus a VCCS (``schur`` tier,
  the scalar-band kernel with 3 right-hand sides), B = 16384;
* the 20×10×10 resistor lattice (``band`` tier, block-Thomas kernel at
  kb = 128), B = 1024;
* the 100×100 mesh (``band``, 79 block rows) and the 12×14×14 lattice
  (``band``, kb = 256), B = 256;
* the 64×64 mesh driven by a voltage source plus a VCCS (``schur`` tier's
  bandable node block, the block-Thomas kernel with 3 right-hand sides),
  B = 1024.

Each kernel is also timed against its plain version, against one PyTorch
call that computes the same function (``torch.linalg.solve`` on the dense
systems) and against its bound on the card.  Every phase asserts; any
failure exits non-zero.  The last line is ``{"ok": true, "device":
{...}}``.

Exits non-zero without a result when CUDA is unavailable or when the
``nodal_tpu_torch`` package is not beside this script.  Imports no JAX.
"""

from __future__ import annotations

import functools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

LADDER_RUNGS = 1000
BATCH = 16384
SWEEP_SIGMA = 0.05          # relative std of the parameter perturbations
CONTRACT_TOL = 1e-6         # node-voltage contract of refine="auto"
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNEL_SHAPES = [(n, b) for n in (1, 2, 3, 1000, 1024, 2048, 4097)
                 for b in (1, 7, BATCH)] + [(20000, 8)]

MESH_ROWS = 25              # the JAX package bench's meshes are 25 rows tall
MESH_NODES = 1000
MIDSIZE_NODES = (5000, 10000)
MIDSIZE_BATCH = 256         # bench.py --midsize-batch default
# The scalar-band kernel and its plain version run the same no-pivot
# recurrence on diagonally dominant bands, rounded differently (fused
# multiply-adds, the warp's reduction order).  The rounding differences
# stay near the unit roundoff times the modest growth along up to 16384
# rows: 1e-4 in f32 (ε ≈ 1.2e-7) and 1e-10 in f64 (ε ≈ 2.2e-16) leave
# two to three orders of margin above the observed differences.
SBAND_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# (B, n, w, n_rhs): each w in {1, 8, 26, 56}, each n in {1, 8, 999, 5000,
# 16384}, n_rhs in {1, 3, the widest with W1 + n_rhs = 128}; B in
# {1, 7, 256} (B <= 7 at n = 16384), and the mesh and branch batches.  The
# last three sit at the edge between the kernel's register variant
# (W1 + n_rhs <= 32) and its shared-memory variant.
SBAND_SHAPES = [
    (1, 1, 1, 1), (7, 1, 56, 3), (256, 8, 8, 1), (7, 8, 1, 126),
    (256, 999, 26, 1), (256, 999, 26, 3), (7, 999, 56, 71),
    (1, 999, 8, 119), (BATCH, 999, 26, 1), (BATCH, 1000, 26, 3),
    (256, 5000, 26, 1), (7, 5000, 8, 3), (1, 5000, 1, 1),
    (256, 5000, 56, 3), (7, 16384, 26, 3), (1, 16384, 56, 71),
    (7, 16384, 1, 126), (7, 999, 30, 1), (7, 999, 31, 1), (7, 999, 3, 28),
]
SBAND_TIME_SHAPES = [(BATCH, 999, 26, 1), (MIDSIZE_BATCH, 4999, 26, 1)]

GENERAL_BATCH = 1024        # bench.py --general-batch default
# The block-Thomas kernel eliminates each Schur block without pivoting
# (Gauss-Jordan in 32-column panels), the plain solver with partial
# pivoting inside each block (torch.linalg.solve).  On these diagonally
# dominant bands both are backward-stable and their answers differ by
# rounding: the unit roundoff times the modest growth along up to 300
# block rows.  1e-4 in f32 (ε ≈ 1.2e-7) and 1e-10 in f64 (ε ≈ 2.2e-16)
# leave about two orders of margin above the differences seen.
BAND_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# (B, nb, kb, r): every kb, one to 300 block rows (300 is past the TPU
# streaming kernel's cap of n·kb <= 32768·128), r in {1, 3, 128, 130}
# (130 takes two launches), the main paths' shapes, and batches larger
# than the grid (the lattice shape walks the batch in four waves).
BAND_SHAPES = [
    (1, 1, 128, 1), (7, 2, 128, 3), (GENERAL_BATCH, 16, 128, 1),
    (MIDSIZE_BATCH, 79, 128, 1), (GENERAL_BATCH, 32, 128, 3),
    (7, 16, 128, 128), (2, 300, 128, 1), (MIDSIZE_BATCH, 10, 256, 1),
    (7, 4, 256, 3), (1, 2, 256, 128), (7, 3, 384, 1), (1, 8, 384, 128),
    (3, 4, 128, 130),
]
BAND_TIME_SHAPES = [(GENERAL_BATCH, 16, 128, 1), (MIDSIZE_BATCH, 79, 128, 1),
                    (MIDSIZE_BATCH, 10, 256, 1)]

# Data-sheet peaks of the H100 SXM at full precision and its memory rate:
# f32 on the CUDA cores (the tensor cores' f32 path is TF32, which is not
# f32), f64 on the FP64 tensor cores (DMMA; the CUDA cores give half).
# The bound is the least the card could take, whichever unit a kernel uses.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12
# The library call's dense systems are timed in chunks of at most this
# many bytes of matrices, and the time scaled to the whole batch.
LIBRARY_CHUNK_BYTES = 4 << 30


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events over ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_bands(B: int, n: int, dtype, gen):
    """Diagonally dominant tridiagonal systems, as resistive chains give."""
    u = lambda: torch.rand(B, n, generator=gen, device="cuda",  # noqa: E731
                           dtype=torch.float64)
    dl = -(0.1 + 0.9 * u())
    du = -(0.1 + 0.9 * u())
    d = dl.abs() + du.abs() + 0.1 + 0.9 * u()
    b = torch.randn(B, n, generator=gen, device="cuda", dtype=torch.float64)
    return [t.to(dtype).contiguous() for t in (dl, d, du, b)]


def rel_diff(x: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst per-sample ‖x − ref‖∞ / ‖ref‖∞."""
    num = (x - ref).abs().amax(dim=1)
    den = ref.abs().amax(dim=1).clamp_min(torch.finfo(ref.dtype).tiny)
    return float((num / den).max())


def phase_kernels(pcr, tridiag):
    """PCR kernel vs the plain PCR on the same CUDA tensors."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for n, B in KERNEL_SHAPES:
            bands = random_bands(B, n, dtype, gen)
            got = pcr.pcr_solve(*bands)
            torch.cuda.synchronize()
            want = tridiag.tridiag_solve(*bands)
            check(got.dtype == dtype and got.shape == (B, n),
                  f"pcr_solve returned {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()),
                  f"pcr_solve non-finite at n={n} B={B} {dtype}")
            err = rel_diff(got, want)
            emit({"phase": "kernel_check", "kernel": "pcr_solve", "n": n,
                  "B": B, "dtype": str(dtype), "max_rel_diff": err,
                  "tol": KERNEL_RTOL[dtype],
                  "variant": "shared" if pcr.launch_config(
                      B, n, got.element_size()).scratch_elems == 0
                  else "global_scratch"})
            check(err <= KERNEL_RTOL[dtype],
                  f"pcr_solve differs from the plain PCR by {err:.3e} at "
                  f"n={n} B={B} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            del bands, got, want

    timing = {}
    for dtype in (torch.float32, torch.float64):
        bands = random_bands(BATCH, LADDER_RUNGS, dtype, gen)
        got = pcr.pcr_solve(*bands)
        want = tridiag.tridiag_solve(*bands)
        max_abs = float((got - want).abs().max())
        # Alternate plain, kernel, kernel, plain in one process.
        p1 = cuda_ms(lambda: tridiag.tridiag_solve(*bands))
        k1 = cuda_ms(lambda: pcr.pcr_solve(*bands))
        k2 = cuda_ms(lambda: pcr.pcr_solve(*bands))
        p2 = cuda_ms(lambda: tridiag.tridiag_solve(*bands))
        dl, d, du, b = bands
        lib = library_ms(
            lambda c: torch.diag_embed(d[:c]) + torch.diag_embed(
                dl[:c, 1:], -1) + torch.diag_embed(du[:c, :-1], 1),
            lambda c: b[:c].unsqueeze(-1), BATCH, LADDER_RUNGS, dtype)
        n = LADDER_RUNGS
        bound = bound_ms(14.0 * n * math.ceil(math.log2(n)) * BATCH,
                         5 * n * BATCH * got.element_size(), dtype)
        timing[dtype] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                         "max_abs_err": max_abs, **lib, **bound}
        emit({"phase": "kernel_time", "kernel": "pcr_solve", "n": LADDER_RUNGS,
              "B": BATCH, "dtype": str(dtype), "kernel_ms": [k1, k2],
              "plain_ms": [p1, p2], "max_abs_err": max_abs, **lib, **bound})
        del bands, got, want
    return worst, timing


def random_sband(B: int, n: int, w: int, n_rhs: int, dtype, gen):
    """Diagonally dominant symmetric bands ``U`` [B, n, w+1] (couplings
    past the last row zero, as plans give) and right-hand sides ``R``
    [B, n, n_rhs]."""
    W1 = w + 1
    U = -(0.1 + 0.9 * torch.rand(B, n, W1, generator=gen, device="cuda",
                                 dtype=torch.float64))
    row = torch.arange(n, device="cuda")[:, None]
    U = U * ((row + torch.arange(W1, device="cuda")) < n)
    diag = U[:, :, 1:].abs().sum(-1)
    for k in range(1, min(W1, n)):
        diag[:, k:] += U[:, :-k, k].abs()
    U[:, :, 0] = diag + 0.1 + 0.9 * torch.rand(
        B, n, generator=gen, device="cuda", dtype=torch.float64)
    R = torch.randn(B, n, n_rhs, generator=gen, device="cuda",
                    dtype=torch.float64)
    return U.to(dtype).contiguous(), R.to(dtype).contiguous()


def phase_sband_kernel(sband, scalar_band):
    """Scalar-band kernel vs the plain torch solver on the same CUDA
    tensors, then both timed at the mesh and midsize shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for B, n, w, n_rhs in SBAND_SHAPES:
            U, R = random_sband(B, n, w, n_rhs, dtype, gen)
            got = sband.sband_solve_multi(U, R)
            torch.cuda.synchronize()
            want = scalar_band.scalar_band_solve_scan(U, R)
            check(got.dtype == dtype and got.shape == R.shape,
                  f"sband_solve_multi returned {got.dtype} "
                  f"{tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()),
                  f"sband_solve_multi non-finite at {(B, n, w, n_rhs)}")
            err = rel_diff(got.reshape(B, -1), want.reshape(B, -1))
            emit({"phase": "kernel_check", "kernel": "sband_solve", "B": B,
                  "n": n, "w": w, "n_rhs": n_rhs, "dtype": str(dtype),
                  "max_rel_diff": err, "tol": SBAND_RTOL[dtype]})
            check(err <= SBAND_RTOL[dtype],
                  f"sband_solve_multi differs from the plain solver by "
                  f"{err:.3e} at {(B, n, w, n_rhs)} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            del U, R, got, want

    timing = {}
    for B, n, w, n_rhs in SBAND_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            U, R = random_sband(B, n, w, n_rhs, dtype, gen)
            got = sband.sband_solve_multi(U, R)
            want = scalar_band.scalar_band_solve_scan(U, R)
            max_abs = float((got - want).abs().max())
            # Alternate plain, kernel, kernel, plain; the plain solver
            # steps through the rows in Python, so it gets few reps.
            p1 = cuda_ms(lambda: scalar_band.scalar_band_solve_scan(U, R),
                         reps=2, warmup=1)
            k1 = cuda_ms(lambda: sband.sband_solve_multi(U, R))
            k2 = cuda_ms(lambda: sband.sband_solve_multi(U, R))
            p2 = cuda_ms(lambda: scalar_band.scalar_band_solve_scan(U, R),
                         reps=2, warmup=1)
            lib = library_ms(lambda c: dense_from_sband(U[:c]),
                             lambda c: R[:c], B, n, dtype)
            W1 = w + 1
            bound = bound_ms(2.0 * n * (W1 * W1 + 2 * W1 * n_rhs) * B,
                             n * (W1 + 2 * n_rhs) * B * U.element_size(),
                             dtype)
            timing[(B, n, dtype)] = {"ms": min(k1, k2),
                                     "plain_ms": min(p1, p2),
                                     "max_abs_err": max_abs, **lib, **bound}
            emit({"phase": "kernel_time", "kernel": "sband_solve", "B": B,
                  "n": n, "w": w, "n_rhs": n_rhs, "dtype": str(dtype),
                  "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                  "max_abs_err": max_abs, **lib, **bound})
            del U, R, got, want
    return worst, timing


def bound_ms(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: the larger of the operations
    over the CUDA cores' peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def library_ms(dense_of, rhs_of, B: int, n: int, dtype) -> dict:
    """Device time of ``torch.linalg.solve`` on the dense [B, n, n]
    systems: timed on a chunk of c systems (``dense_of(c)``, ``rhs_of(c)``)
    whose matrices fit ``LIBRARY_CHUNK_BYTES`` and scaled to B."""
    itemsize = torch.finfo(dtype).bits // 8
    c = max(1, min(B, LIBRARY_CHUNK_BYTES // (n * n * itemsize)))
    A, b = dense_of(c), rhs_of(c)
    ms = cuda_ms(lambda: torch.linalg.solve(A, b), reps=1, warmup=1)
    del A, b
    torch.cuda.empty_cache()
    return {"library_ms": ms * B / c, "library_chunk": c}


def dense_from_sband(U: torch.Tensor) -> torch.Tensor:
    """The dense symmetric matrices of upper bands ``U`` [c, n, W1]."""
    c, n, W1 = U.shape
    A = torch.diag_embed(U[:, :, 0])
    for k in range(1, min(W1, n)):
        A += torch.diag_embed(U[:, :n - k, k], k)
        A += torch.diag_embed(U[:, :n - k, k], -k)
    return A


def dense_from_block_band(W: torch.Tensor) -> torch.Tensor:
    """The dense matrices of block bands ``W`` [c, nb, kb, 3kb]."""
    c, nb, kb, _ = W.shape
    n = nb * kb
    A = torch.zeros(c, n, n, dtype=W.dtype, device=W.device)
    for t in range(nb):
        lo, hi = max(0, (t - 1) * kb), min(n, (t + 2) * kb)
        A[:, t * kb:(t + 1) * kb, lo:hi] = \
            W[:, t, :, lo - (t - 1) * kb:hi - (t - 1) * kb]
    return A


def block_thomas_flops(nb: int, kb: int, r: int) -> float:
    """Least flops of one block-Thomas solve with r right-hand sides: in
    every block row an LU of S (2/3·kb³) and S⁻¹·rhs (2·kb²·r); in every
    row but the first L·C and L·y (2·kb³ + 2·kb²·r); in every row but the
    last S⁻¹·U (2·kb³) and the backward C·x (2·kb²·r)."""
    return (nb * (2 / 3 * kb ** 3 + 2 * kb * kb * r)
            + (nb - 1) * (4 * kb ** 3 + 4 * kb * kb * r))


def random_block_band(B: int, nb: int, kb: int, r: int, dtype, gen):
    """Diagonally dominant block bands ``W`` [B, nb, kb, 3kb] (``L_0`` and
    ``U_{nb−1}`` zero, as plans give) and right-hand sides ``R``
    [B, nb·kb, r]."""
    W = 0.1 * torch.randn(B, nb, kb, 3 * kb, generator=gen, device="cuda",
                          dtype=dtype)
    W[:, 0, :, :kb] = 0.0
    W[:, -1, :, 2 * kb:] = 0.0
    i = torch.arange(kb, device="cuda")
    W[:, :, i, kb + i] = W.abs().sum(-1)[:, :, i] + 1.0
    R = torch.randn(B, nb * kb, r, generator=gen, device="cuda", dtype=dtype)
    return W.contiguous(), R


def phase_band_kernel(block_thomas, band):
    """Block-Thomas kernel vs the plain torch solver on the same CUDA
    tensors, then both, the dense library call and the bound timed at the
    main paths' shapes."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for B, nb, kb, r in BAND_SHAPES:
            W, R = random_block_band(B, nb, kb, r, dtype, gen)
            before = block_thomas.band_solve_multi.launches
            got = block_thomas.band_solve_multi(W, R)
            torch.cuda.synchronize()
            launches = block_thomas.band_solve_multi.launches - before
            want = band.band_thomas_solve(W, R)
            check(got.dtype == dtype and got.shape == R.shape,
                  f"band_solve_multi returned {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()),
                  f"band_solve_multi non-finite at {(B, nb, kb, r)}")
            err = rel_diff(got.reshape(B, -1), want.reshape(B, -1))
            cfg = block_thomas.launch_config(
                B, nb, kb, min(r, block_thomas.MAX_R), got.element_size(),
                sm_count)
            emit({"phase": "kernel_check", "kernel": "band_solve", "B": B,
                  "nb": nb, "kb": kb, "r": r, "dtype": str(dtype),
                  "max_rel_diff": err, "tol": BAND_RTOL[dtype],
                  "launches": launches, "grid": cfg.grid,
                  "waves": cfg.waves})
            check(err <= BAND_RTOL[dtype],
                  f"band_solve_multi differs from the plain solver by "
                  f"{err:.3e} at {(B, nb, kb, r)} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            del W, R, got, want
        # One right-hand side with the padded tail trimmed.
        W, R = random_block_band(7, 3, 128, 1, dtype, gen)
        n_valid = 3 * 128 - 37
        got = block_thomas.band_solve(W, R[..., 0], n_valid=n_valid)
        want = band.band_thomas_solve(W, R[..., 0])[:, :n_valid]
        err = rel_diff(got, want)
        emit({"phase": "kernel_check", "kernel": "band_solve", "B": 7,
              "nb": 3, "kb": 128, "r": 1, "n_valid": n_valid,
              "dtype": str(dtype), "max_rel_diff": err,
              "tol": BAND_RTOL[dtype]})
        check(got.shape == (7, n_valid) and err <= BAND_RTOL[dtype],
              f"band_solve(n_valid) gave {tuple(got.shape)}, {err:.3e}")

    timing = {}
    for B, nb, kb, r in BAND_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            W, R = random_block_band(B, nb, kb, r, dtype, gen)
            got = block_thomas.band_solve_multi(W, R)
            want = band.band_thomas_solve(W, R)
            max_abs = float((got - want).abs().max())
            del got, want
            p1 = cuda_ms(lambda: band.band_thomas_solve(W, R), reps=2,
                         warmup=1)
            k1 = cuda_ms(lambda: block_thomas.band_solve_multi(W, R))
            k2 = cuda_ms(lambda: block_thomas.band_solve_multi(W, R))
            p2 = cuda_ms(lambda: band.band_thomas_solve(W, R), reps=2,
                         warmup=1)
            n = nb * kb
            lib = library_ms(lambda c: dense_from_block_band(W[:c]),
                             lambda c: R[:c], B, n, dtype)
            bound = bound_ms(block_thomas_flops(nb, kb, r) * B,
                             n * (3 * kb + 2 * r) * B * W.element_size(),
                             dtype)
            timing[(B, nb, kb, dtype)] = {
                "ms": min(k1, k2), "plain_ms": min(p1, p2),
                "max_abs_err": max_abs, **lib, **bound}
            emit({"phase": "kernel_time", "kernel": "band_solve", "B": B,
                  "nb": nb, "kb": kb, "r": r, "dtype": str(dtype),
                  "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                  "max_abs_err": max_abs, **lib, **bound})
            del W, R
            torch.cuda.empty_cache()
    return worst, timing


def sweep_params(circuit, batch: int = BATCH):
    """The sweep batch, made as the JAX package's bench makes it."""
    rng = np.random.default_rng(0)
    base = circuit.stamps.params.astype(np.float32)
    return (base * (1.0 + SWEEP_SIGMA * rng.standard_normal(
        (batch, len(base))))).astype(np.float32)


def lattice_rows(d: int, h: int, w: int):
    """A d×h×w lattice of unit resistors between the corner probes ``1``
    and ``g``, driven by a 1 A source: a 3-D thermal or substrate
    network."""
    from nodal_tpu_torch.utils.gridgen import weighted_lattice_rows

    rows = list(weighted_lattice_rows(
        np.ones((d, h, w - 1)), np.ones((d, h - 1, w)),
        np.ones((d - 1, h, w)), (0, 0, 0), (d - 1, h - 1, w - 1)))
    return rows + [["src", "A", "1", "1", "g"]]


def grid_circuit_rows(h: int, w: int, branch: bool = False):
    """An h×w mesh between the corner probes, driven by a current source,
    or with ``branch`` by a voltage source plus a VCCS."""
    from nodal_tpu_torch.utils.gridgen import grid_rows

    rows = list(grid_rows(h, w, (0, 0), (h - 1, w - 1)))
    if branch:
        return rows + [["e1", "E", "2", "1", "g"],
                       ["d1", "VCCS", "0.5", "n3_3", "g", "1", "g"]]
    return rows + [["src", "A", "1", "1", "g"]]


def mesh_rows(n_nodes: int, branch: bool = False):
    """The JAX package bench's mesh circuit (``_mesh_circuit``), or with
    ``branch`` its branch circuit (``_branch_circuit``)."""
    return grid_circuit_rows(MESH_ROWS, -(-n_nodes // MESH_ROWS), branch)


def median_call_ms(solver, params, reps: int = 5):
    """Per-call device times (CUDA events) of ``solver(params)`` after one
    warm-up call, and their median."""
    solver(params)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solver(params)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, statistics.median(times)


def sample0_error(circuit, params_np, xs) -> float:
    """Relative distance of sample 0 from a numpy f64 dense solve."""
    from nodal_tpu_torch.ops.assemble import assemble_dense

    G, b = assemble_dense(circuit.stamps,
                          torch.as_tensor(params_np[:1], dtype=torch.float64))
    ref = np.linalg.solve(G[0].numpy(), b[0].numpy())
    del G
    x0 = xs[0].cpu().numpy()
    return float(np.abs(x0 - ref).max() / np.abs(ref).max())


def phase_path(label, rows, batch, method, kernel, rate_refines,
               extra_check=None):
    """Drive one main path through ``BatchedSolver(refine="auto")``: count
    ``kernel``'s launches over exactly that call, check the answers (every
    sample against the tier's raw f64 solve, sample 0 against numpy f64
    dense, the f64 audit), then time the ``rate_refines`` tiers.  Returns
    the launch count."""
    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist
    from nodal_tpu_torch.ops import block_thomas, pcr, sband

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    circuit = Circuit(Netlist.from_rows(rows))
    solver = BatchedSolver(circuit, dtype=torch.float32, refine="auto",
                           device="cuda")
    params_np = sweep_params(circuit, batch)
    params = torch.as_tensor(params_np, device="cuda")
    setup_s = time.perf_counter() - t0
    check(solver.method == method,
          f"{label}: method is {solver.method}, expected {method}")

    pcr.pcr_solve.launches = 0
    sband.sband_solve_multi.launches = 0
    sband.sband_solve_multi.last_shape = None
    block_thomas.band_solve_multi.launches = 0
    block_thomas.band_solve_multi.last_shape = None
    xs = solver(params)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches > 0, f"{label}: the main path never launched its kernel")
    check(xs.device.type == "cuda" and xs.dtype == torch.float64,
          f"{label}: output is {xs.dtype} on {xs.device}")
    check(xs.shape == (batch, circuit.stamps.n),
          f"{label}: shape {tuple(xs.shape)}")
    check(bool(torch.isfinite(xs).all()), f"{label}: non-finite solutions")
    info = extra_check(circuit, xs) if extra_check else {}

    res = solver.residuals(params, xs)
    check(res.device.type == "cuda" and res.dtype == torch.float64,
          f"{label}: the audit left the card or f64")
    max_res = float(res.max())
    check(max_res <= CONTRACT_TOL,
          f"{label}: full-batch residual {max_res:.3e}")
    err0 = sample0_error(circuit, params_np, xs)
    check(err0 <= CONTRACT_TOL,
          f"{label}: sample 0 is {err0:.3e} from f64 dense")
    # Every sample against the same tier solved raw in f64 (the kernels'
    # f64 instantiations: ~κ·1e-16 from the exact answer, far inside the
    # contract); the residual alone does not bound the error at this κ.
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    x64 = circuit.batched_solver(dtype=torch.float64, refine=False,
                                 device="cuda")(params)
    err_auto = rel_errors(xs, x64)
    worst = int(err_auto.argmax())
    check(float(err_auto[worst]) <= CONTRACT_TOL,
          f"{label}: sample {worst} is {float(err_auto[worst]):.3e} from the "
          "raw f64 solve")
    err_raw = rel_errors(circuit.batched_solver(
        dtype=torch.float32, refine=False, device="cuda")(params), x64)
    del xs, res, x64

    rates = {}
    for refine in rate_refines:
        s = circuit.batched_solver(dtype=torch.float32, refine=refine,
                                   device="cuda")
        times, ms = median_call_ms(s, params)
        rates[str(refine)] = batch / (ms / 1e3)
        emit({"phase": "main_path_time", "path": label, "refine": refine,
              "B": batch, "n": circuit.stamps.n, "ms_reps": times,
              "median_ms": ms, "solves_per_s": rates[str(refine)]})

    emit({"phase": "main_path", "path": label, "n": circuit.stamps.n,
          "nnz": circuit.stamps.nnz, "B": batch, "method": solver.method,
          "setup_s": setup_s, "launches": launches, "max_residual": max_res,
          "sample0_rel_err_vs_f64": err0,
          "batch_max_rel_err_vs_f64": float(err_auto[worst]),
          "worst_sample": worst,
          "raw_f32_rel_err_vs_f64": {"max": float(err_raw.max()),
                                     "median": float(err_raw.median()),
                                     "sample0": float(err_raw[0])},
          "peak_mem_gb": peak_gb, **info})
    return launches


def rel_errors(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-sample ‖x − ref‖∞ / ‖ref‖∞, on the host."""
    x = x.to(torch.float64)
    return ((x - ref).abs().amax(dim=1)
            / ref.abs().amax(dim=1).clamp_min(1e-300)).cpu()


def phase_band_accuracy(label, rows, batch):
    """Raw f32 error of the block-Thomas kernel and of its plain version
    (pivoted inside each block) on one band path's own f32 bands, each
    against the kernel's f64 solve of the f64 bands: does the kernel or the
    f32 band set the error the contract layer has to correct?"""
    from nodal_tpu_torch import Circuit, Netlist
    from nodal_tpu_torch.ops import band, block_thomas

    circuit = Circuit(Netlist.from_rows(rows))
    plan = band.band_plan(circuit.stamps)
    params = torch.as_tensor(sweep_params(circuit, batch), device="cuda")
    ref = block_thomas.band_solve(
        *plan.assemble(circuit.stamps, params, dtype=torch.float64))
    W, b = plan.assemble(circuit.stamps, params, dtype=torch.float32)
    out = {}
    for name, solve in (("kernel", block_thomas.band_solve),
                        ("plain", band.band_thomas_solve)):
        x = solve(W, b)
        check(bool(torch.isfinite(x).all()),
              f"band accuracy {label}: non-finite {name} solutions")
        err = rel_errors(x, ref)
        out[name] = {"max": float(err.max()), "median": float(err.median()),
                     "sample0": float(err[0])}
    emit({"phase": "band_accuracy", "path": label, "B": batch,
          "kb": plan.kb, "nb": plan.nb, "raw_f32_rel_err_vs_f64": out})


def branch_check(circuit, xs, kernel):
    """The branch paths' extra checks: ``kernel`` took the 3 right-hand
    sides of the schur tier, branch currents are finite, TF32 is off."""
    from nodal_tpu_torch.batch import BatchResult

    shape = kernel.last_shape
    check(shape is not None and shape[3] == 3,
          f"branch: the kernel's last launch had shape {shape}, "
          "expected 3 right-hand sides")
    current = BatchResult(xs, circuit.netlist).current("e1")
    check(bool(torch.isfinite(current).all()),
          "branch: non-finite current through e1")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: the Schur algebra needs full f32")
    return {"kernel_shape": list(shape),
            "e1_current_sample0": float(current[0])}


def phase_profile(label, rows, batch):
    """Device kernel time of one ``refine="auto"`` call by kind, from a
    ``torch.profiler`` trace of 3 calls after 2 warm-up calls, and the
    device's idle share of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    from nodal_tpu_torch import Circuit, Netlist

    circuit = Circuit(Netlist.from_rows(rows))
    solver = circuit.batched_solver(refine="auto", device="cuda")
    params = torch.as_tensor(sweep_params(circuit, batch), device="cuda")
    for _ in range(2):
        solver(params)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            solver(params)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(len(kernels) > 0, f"profile {label}: no kernel in the trace")
    kinds = {"block_thomas": ("block_thomas",), "sband": ("sband",),
             "pcr": ("pcr",),
             "gathers": ("index", "gather", "scatter"),
             "reductions": ("reduce", "sum", "max"),
             "dense algebra": ("gemm", "gemv", "getrf", "getrs", "trsm",
                               "solve", "lu", "cublas", "cusolver")}
    by_kind = {}
    for e in kernels:
        name = e.get("name", "").lower()
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "elementwise")
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1e3
    busy = sum(e["dur"] for e in kernels) / 1e3
    window = (max(e["ts"] + e["dur"] for e in kernels)
              - min(e["ts"] for e in kernels)) / 1e3
    emit({"phase": "profile", "path": label, "refine": "auto", "B": batch,
          "calls": calls, "device_ms_per_call": busy / calls,
          "kernels_per_call": len(kernels) / calls,
          "ms_per_call_by_kind": {k: v / calls for k, v in
                                  sorted(by_kind.items(),
                                         key=lambda kv: -kv[1])},
          "device_idle_share": max(0.0, 1.0 - busy / window)})


def phase_resources(library: Path):
    """Registers, stack and local (spill) bytes a thread and static shared
    bytes of every kernel in the built library, as ``cuobjdump -res-usage``
    reads them.  A diagnostic: without the tool it says "not measured"."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        proc = subprocess.run([tool, "-res-usage", str(library)],
                              capture_output=True, text=True, timeout=120)
    except OSError as e:
        emit({"phase": "resource_usage", "kernels": f"not measured ({e})"})
        return
    usage, name = {}, None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif name and line.startswith("REG:"):
            usage[name] = {k: v for k, v in (kv.split(":", 1) for kv in
                                             line.split() if ":" in kv)
                           if k in ("REG", "STACK", "SHARED", "LOCAL")}
            name = None
    emit({"phase": "resource_usage", "kernels": usage or
          f"not measured (cuobjdump rc {proc.returncode})"})


def kernel_entry(name, source, replaces, launches, t) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, str(ROOT))
    try:
        import nodal_tpu_torch
        from nodal_tpu_torch.ops import (band, block_thomas, pcr, sband,
                                         scalar_band, tridiag)
        from nodal_tpu_torch.utils import kernels
        from nodal_tpu_torch.utils.gridgen import ladder_rows
    except ImportError as e:
        fail(f"nodal_tpu_torch is not importable beside this script ({e})")
    pkg = Path(nodal_tpu_torch.__file__).resolve().parent
    check(pkg.parent == ROOT, f"nodal_tpu_torch was imported from {pkg}")
    check("jax" not in sys.modules, "jax was imported")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    emit(card)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    kernels.load_library()
    emit({"phase": "build", "library": kernels.library_path().name,
          "seconds": time.perf_counter() - t0})
    phase_resources(kernels.library_path())

    worst, timing = phase_kernels(pcr, tridiag)
    sb_worst, sb_timing = phase_sband_kernel(sband, scalar_band)
    bt_worst, bt_timing = phase_band_kernel(block_thomas, band)
    emit({"phase": "kernel_check_worst",
          "pcr_solve": {str(k): v for k, v in worst.items()},
          "sband_solve": {str(k): v for k, v in sb_worst.items()},
          "band_solve": {str(k): v for k, v in bt_worst.items()}})
    launches = phase_path("ladder", ladder_rows(LADDER_RUNGS), BATCH,
                          "tridiag", pcr.pcr_solve, ("auto", False))
    sb_launches = phase_path("mesh", mesh_rows(MESH_NODES), BATCH, "sband",
                             sband.sband_solve_multi, ("auto", False))
    for n_nodes in MIDSIZE_NODES:
        sb_launches += phase_path(f"midsize{n_nodes}", mesh_rows(n_nodes),
                                  MIDSIZE_BATCH, "sband",
                                  sband.sband_solve_multi, ("auto",))
    sb_launches += phase_path(
        "branch", mesh_rows(MESH_NODES, branch=True), BATCH, "schur",
        sband.sband_solve_multi, ("auto", False),
        functools.partial(branch_check, kernel=sband.sband_solve_multi))
    bt = block_thomas.band_solve_multi
    bt_launches = phase_path("lattice", lattice_rows(20, 10, 10),
                             GENERAL_BATCH, "band", bt, ("auto", False))
    bt_launches += phase_path("widemesh", grid_circuit_rows(100, 100),
                              MIDSIZE_BATCH, "band", bt, ("auto", False))
    bt_launches += phase_path("widelattice", lattice_rows(12, 14, 14),
                              MIDSIZE_BATCH, "band", bt, ("auto", False))
    bt_launches += phase_path(
        "widebranch", grid_circuit_rows(64, 64, branch=True), GENERAL_BATCH,
        "schur", bt, ("auto", False),
        functools.partial(branch_check, kernel=bt))
    phase_band_accuracy("lattice", lattice_rows(20, 10, 10), GENERAL_BATCH)
    phase_band_accuracy("widemesh", grid_circuit_rows(100, 100),
                        MIDSIZE_BATCH)
    phase_profile("lattice", lattice_rows(20, 10, 10), GENERAL_BATCH)

    emit(card)  # again beside the summary, which a tail of the output keeps
    emit({"kernels": [
        kernel_entry("pcr_solve", "nodal_tpu_torch/csrc/pcr.cu",
                     "nodal_tpu/ops/pallas_tridiag.py:74", launches,
                     timing[torch.float32]),
        kernel_entry("sband_solve", "nodal_tpu_torch/csrc/sband.cu",
                     "nodal_tpu/ops/pallas_scalar_band.py:152 and "
                     "nodal_tpu/ops/pallas_scalar_band.py:305", sb_launches,
                     sb_timing[(BATCH, 999, torch.float32)]),
        kernel_entry("band_solve", "nodal_tpu_torch/csrc/block_thomas.cu",
                     "nodal_tpu/ops/pallas_band.py:243, "
                     "nodal_tpu/ops/pallas_band.py:300 and "
                     "nodal_tpu/ops/pallas_band.py:476", bt_launches,
                     bt_timing[(GENERAL_BATCH, 16, 128, torch.float32)]),
    ]})
    check("jax" not in sys.modules, "jax was imported")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
