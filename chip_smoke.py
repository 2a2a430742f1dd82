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
  B = 1024;
* a 1000-node random resistor network grounded at every 50th node
  (``block`` tier, blocked-LU kernel, n_pad = 1024), B = 1024, and its
  4000-node sibling (n_pad = 4096), B = 64;
* the 1000-node network driven by a voltage source plus a VCCS (``schur``
  tier's dense node block, the blocked-LU kernel with 3 right-hand sides),
  B = 1024;
* a 60-stage chain of opamp-macromodel followers (``dense`` tier, the
  library's pivoted LU, no kernel of the repo), B = 16384.

Then the matrix-free grid solve (multigrid-preconditioned CG,
``grid_equivalent_resistance``): the four stencil kernels against their
plain versions at every shape class, and the knight's-move equivalent
resistance of the 1024×1024 grid of unit resistors (f32 and f64), of the
4096×4096 grid, of the 1000×1000 and 1022×1022 grids (whose coarsest levels,
125² and 511², run in a thread-block cluster, or in f64 at 511² take the
multi-launch Jacobi route) and of 16 probe pairs at once, each held against
the same solve with the plain cycle on the card, then a profile of the
1024² solve.  The transfer kernels also run a batch past 2³¹ values,
its last sample bit for bit against a launch on that sample alone.  The
cluster kernels (``vcycle_cluster``, ``jacobi_cluster``) are also read by
kernel name from traces at the grid paths' shapes.  The
fused-CG path (``grid_solve(fused_cg=True)``): its two kernels against
their plain versions, every grid solve above and the 16 pairs through it,
each held against the unfused kernel solve, and a profile of its 1024²
solve.
Last, the adjoint: ``backward()`` through each tier's solver on the card
against the same solver's gradient on the CPU and a dense f64 autograd
oracle, with the tier's kernel launched in the backward pass.

Each kernel is also timed against its plain version, against one PyTorch
call that computes the same function (``torch.linalg.solve`` on the dense
systems) and against its bound on the card; the blocked LU's and the block
Thomas's device time is split by kernel name from a profiler trace
(``kernel_split``: the factorization against the sweeps, the inverses
against the products).  Every phase asserts; any failure exits non-zero.  The last line is ``{"ok": true, "device":
{...}}``.

Exits non-zero without a result when CUDA is unavailable or when the
``nodal_tpu_torch`` package is not beside this script.  Imports no JAX.
"""

from __future__ import annotations

import functools
import json
import math
import re
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
# next three sit at the edge between the kernel's register variant
# (W1 + n_rhs <= 32) and its shared-memory variant; the last is a band
# without couplings (w = 0).
SBAND_SHAPES = [
    (1, 1, 1, 1), (7, 1, 56, 3), (256, 8, 8, 1), (7, 8, 1, 126),
    (256, 999, 26, 1), (256, 999, 26, 3), (7, 999, 56, 71),
    (1, 999, 8, 119), (BATCH, 999, 26, 1), (BATCH, 1000, 26, 3),
    (256, 5000, 26, 1), (7, 5000, 8, 3), (1, 5000, 1, 1),
    (256, 5000, 56, 3), (7, 16384, 26, 3), (1, 16384, 56, 71),
    (7, 16384, 1, 126), (7, 999, 30, 1), (7, 999, 31, 1), (7, 999, 3, 28),
    (7, 999, 0, 3),
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

RANDNET_NODES, RANDNET_EDGES = 1000, 4000
RANDNET4K_NODES, RANDNET4K_EDGES, RANDNET4K_BATCH = 4000, 16000, 64
RANDNET_TIE_EVERY = 50      # ground ties: the weakest the JAX tests use
OPCHAIN_STAGES = 60
# The blocked-LU kernel and its plain version both factor without pivoting
# (the kernel inverts each 128×128 diagonal block by Gauss-Jordan, the
# plain version by torch.linalg.inv) and differ by rounding.  On the
# diagonally dominant class (κ of a few) that is a small multiple of the
# unit roundoff, at most ~20ε on the card up to 16384 rows: 1e-4 (f32)
# and 1e-10 (f64) leave more than an order of margin.
LU_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# On the graph Laplacians (κ₁ ≈ 2e3) two backward-stable solves may differ
# by up to κ times as much: the Laplacian tolerance is the larger of
# LU_RTOL and LU_KAPPA_FACTOR·κ₁·ε (κ₁ of the batch's first system, ε the
# unit roundoff); the factor allows for modest growth.
LU_KAPPA_FACTOR = 8
# (B, n_pad, r): one panel to 128 panels, r from 1 to 130, and the main
# paths' shapes (randnet, randbranch, randnet4k).
LU_SHAPES = [(1, 128, 1), (7, 256, 3), (GENERAL_BATCH, 1024, 1),
             (GENERAL_BATCH, 1024, 3), (7, 1024, 128), (3, 1024, 130),
             (RANDNET4K_BATCH, 4096, 1), (2, 8192, 1), (1, 16384, 1)]
# f64 only: 2.3·10⁹ values (18 GB), past 2³¹, for the 64-bit offsets.
LU_HUGE = (2176, 1024, 1)
LU_TIME_SHAPES = [(GENERAL_BATCH, 1024, 1), (GENERAL_BATCH, 1024, 3),
                  (RANDNET4K_BATCH, 4096, 1)]

# The grid solve.  Shapes (B, h, w) of the stencil kernel checks: a 2×2
# grid, odd dimensions, the levels of the main paths, a batch of 16 and the
# 4096² grid; 125², 250², 511² and 16 × 512² are the cluster kernels'
# shapes (one-level coarsest routes, clusters of 16, a batch of clusters).
# presmooth_restrict and prolong_postsmooth take even h, w; 1022² f32 takes
# their narrow load path (a row pitch of 4088 bytes), and (3, 1030, 262)
# puts their strip and segment seams off powers of two (a partial second
# strip, 86 segments of 6 coarse rows, the last of 5; the narrow path in
# f32).
STENCIL_SHAPES = [(1, 2, 2), (1, 3, 5), (1, 8, 8), (1, 64, 64),
                  (1, 125, 125), (1, 250, 250), (1, 511, 511),
                  (1, 512, 512), (16, 512, 512), (1, 1000, 1000),
                  (1, 1022, 1022), (1, 1024, 1024), (16, 1024, 1024),
                  (1, 4096, 4096), (3, 1030, 262)]
JACOBI_SWEEPS = (1, 4, 9, 96)
# Kernel and plain version run the same operations in the same order but
# for fused multiply-adds, the reductions' order and (vcycle) where the
# mean projections fall: f32 1e-5 and f64 1e-12 of max|plain| leave one to
# two orders above that rounding.
STENCIL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# f32: three fields of 8.7 GB, past 2³¹ values.
STENCIL_HUGE = (130, 4096, 4096)
# Fields of this shape one value past a 16-byte boundary: the transfers'
# narrow path in both dtypes.
MISALIGNED_SHAPE = (2, 1024, 1024)
STENCIL_TIME_SHAPES = [(1, 1024, 1024), (1, 4096, 4096)]
TIME_JACOBI_SWEEPS = 8      # one full tiled launch
# Row 7 where the grid paths' coarsest levels run it: 96 sweeps at 511²
# (grid1022) and 125² (grid1000 f64), one cluster launch where a cluster
# holds the field.
CLUSTER_JACOBI_SHAPES = [(1, 511, 511, torch.float32),
                         (1, 511, 511, torch.float64),
                         (1, 125, 125, torch.float64)]
COARSE_SWEEPS = 96
# Row 10 by kernel name at the grid paths' finest shapes, beside the
# wrapper's event time; its kernel entry is the cluster cycle at its
# 1024² f32 entry, 256², where one launch is the whole call.
CLUSTER_TRACE_SIZES = (1024, 1022)
CLUSTER_VCYCLE_ENTRY = (1, 256, 256)
# (label, n, dtype, tol): the BASELINE's 1M-node solve (bench.py --grid
# 1024 --grid-tol 1e-6), its f64 twin, 16M nodes, and the grids whose
# coarsest level stops at 125² and 511² (511² f64, 6.3 MB in three fields,
# is past a cluster: the tiled Jacobi route).
GRID_RUNS = [("grid1024_f32", 1024, torch.float32, 1e-6),
             ("grid1024_f64", 1024, torch.float64, 1e-10),
             ("grid4096_f32", 4096, torch.float32, 1e-6),
             ("grid1000_f32", 1000, torch.float32, 1e-6),
             ("grid1000_f64", 1000, torch.float64, 1e-10),
             ("grid1022_f32", 1022, torch.float32, 1e-6),
             ("grid1022_f64", 1022, torch.float64, 1e-10)]
GRID_PAIRS = 16
GRID_PROFILE_SOLVES = 3     # traced 1024² solves, after a lead-in solve
GRID_PROFILE_TRIES = 3      # profiler sessions before a trace must be whole
KNIGHT_R = 4 / math.pi - 0.5  # the infinite grid's knight's-move resistance

# The adjoint phase: each tier's smoke circuit at this batch.  Its
# gradients are held to the bound of tests/test_torch_adjoint.py: in f64
# 1e-9 of the chain rule's magnitude S_k (chain_scale) for each parameter,
# the two solves' rounding; in f32 "auto" (2·1e-6 + ε₃₂)·S_k, the contract
# on λ and x plus the chain rule's f32 rounding.  The card and the CPU
# differ by at most twice the bound.
ADJOINT_BATCH = 8
ADJOINT_F64_TOL = 1e-9

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


def kernel_name(full: str) -> str:
    """A kernel's own name out of the profiler's demangled signature:
    ``void (anonymous namespace)::block_lu_gemm<float>(...)`` ->
    ``block_lu_gemm``."""
    m = re.search(r"::(\w+)\s*[<(]", full) or re.search(r"(\w+)\s*[<(]", full)
    return m.group(1) if m else full


def kernel_split(fn, calls: int = 3, tries: int = 3) -> dict:
    """Device ms a ``fn()`` call spends in each kernel, by kernel name, from
    a ``torch.profiler`` trace of ``calls`` calls after an untraced call
    and a traced warm-up call, both thrown away.  The profiler at times
    loses events, or a whole trace: a trace that is empty, or in which a
    kernel's launches are not a whole number a call, is taken again, up to
    ``tries`` times, and then reported as not measured (a diagnostic, not a
    check)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        events = []

        def ready(prof):
            with tempfile.TemporaryDirectory() as tmp:
                path = Path(tmp) / "trace.json"
                prof.export_chrome_trace(str(path))
                events.extend(json.loads(path.read_text())["traceEvents"])

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=1, warmup=1, active=calls),
                     on_trace_ready=ready) as prof:
            for _ in range(2 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        by_name, counts = {}, {}
        for e in events:
            if e.get("cat") != "kernel":
                continue
            name = kernel_name(e.get("name", ""))
            by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3 / calls
            counts[name] = counts.get(name, 0) + 1
        if by_name and all(n % calls == 0 for n in counts.values()):
            return {"device_ms": sum(by_name.values()),
                    "by_kernel_ms": dict(sorted(by_name.items(),
                                                key=lambda kv: -kv[1])),
                    "launches_per_call": {k: v / calls
                                          for k, v in counts.items()}}
    return {"device_ms": None, "by_kernel_ms": {}, "launches_per_call": {},
            "not_measured": f"no whole trace in {tries} tries"}


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
    """PCR kernel vs the plain PCR (the function, ``KERNEL_RTOL``) and vs
    the plain version of its own algorithm (``thomas_pcr_solve``, the same
    bound) on the same CUDA tensors."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
            del want
            err_algo = rel_diff(got, pcr.thomas_pcr_solve(*bands))
            cfg = pcr.launch_config(B, n, got.element_size(), sms)
            emit({"phase": "kernel_check", "kernel": "pcr_solve", "n": n,
                  "B": B, "dtype": str(dtype), "max_rel_diff": err,
                  "max_rel_diff_vs_thomas_pcr": err_algo,
                  "tol": KERNEL_RTOL[dtype],
                  "variant": "shared" if cfg.scratch_elems == 0
                  else "global_scratch", "launch": repr(cfg)})
            check(err <= KERNEL_RTOL[dtype],
                  f"pcr_solve differs from the plain PCR by {err:.3e} at "
                  f"n={n} B={B} {dtype}")
            check(err_algo <= KERNEL_RTOL[dtype],
                  f"pcr_solve differs from thomas_pcr_solve by "
                  f"{err_algo:.3e} at n={n} B={B} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err, err_algo)
            del bands, got
            torch.cuda.empty_cache()

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
        bound = pcr_bound(LADDER_RUNGS, BATCH, dtype)
        timing[dtype] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                         "max_abs_err": max_abs, **lib, **bound}
        emit({"phase": "kernel_time", "kernel": "pcr_solve", "n": LADDER_RUNGS,
              "B": BATCH, "dtype": str(dtype), "kernel_ms": [k1, k2],
              "plain_ms": [p1, p2], "max_abs_err": max_abs,
              "launch": repr(pcr.launch_config(BATCH, LADDER_RUNGS,
                                               got.element_size(), sms)),
              **lib, **bound})
        del bands, got, want
    return worst, timing


def pcr_bound(n: int, B: int, dtype) -> dict:
    """PCR's bound: 5 values a row moved (4 bands read, x written), and the
    8 flops a row of an O(n) tridiagonal solve (Thomas)."""
    return bound_ms(8.0 * n * B, 5 * n * B * (torch.finfo(dtype).bits // 8),
                    dtype)


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


def check_sband(sband, scalar_band, shape, dtype, gen) -> float:
    """The scalar-band kernel against the plain torch solver on the same
    CUDA tensors at one ``SBAND_SHAPES`` shape: the largest relative
    difference of a system, infinite if an answer is not finite (asserts
    the dtype and shape)."""
    B, n, w, n_rhs = shape
    U, R = random_sband(B, n, w, n_rhs, dtype, gen)
    got = sband.sband_solve_multi(U, R)
    torch.cuda.synchronize()
    want = scalar_band.scalar_band_solve_scan(U, R)
    check(got.dtype == dtype and got.shape == R.shape,
          f"sband_solve_multi returned {got.dtype} {tuple(got.shape)}")
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return rel_diff(got.reshape(B, -1), want.reshape(B, -1))


def time_sband(sband, scalar_band, U, R) -> dict:
    """The scalar-band kernel against its plain version on ``U``, ``R``:
    device ms in turns (plain, kernel, kernel, plain; the plain solver
    steps through the rows in Python, so it gets few reps), the largest
    difference, and the bound."""
    got = sband.sband_solve_multi(U, R)
    want = scalar_band.scalar_band_solve_scan(U, R)
    max_abs = float((got - want).abs().max())
    del got, want
    p1 = cuda_ms(lambda: scalar_band.scalar_band_solve_scan(U, R),
                 reps=2, warmup=1)
    k1 = cuda_ms(lambda: sband.sband_solve_multi(U, R))
    k2 = cuda_ms(lambda: sband.sband_solve_multi(U, R))
    p2 = cuda_ms(lambda: scalar_band.scalar_band_solve_scan(U, R),
                 reps=2, warmup=1)
    B, n, W1 = U.shape
    n_rhs = R.shape[2]
    bound = bound_ms(2.0 * n * (W1 * W1 + 2 * W1 * n_rhs) * B,
                     n * (W1 + 2 * n_rhs) * B * U.element_size(), U.dtype)
    return {"kernel_ms": [k1, k2], "plain_ms": [p1, p2],
            "max_abs_err": max_abs, **bound}


def phase_sband_kernel(sband, scalar_band):
    """Scalar-band kernel vs the plain torch solver on the same CUDA
    tensors, then both timed at the mesh and midsize shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for B, n, w, n_rhs in SBAND_SHAPES:
            err = check_sband(sband, scalar_band, (B, n, w, n_rhs), dtype,
                              gen)
            emit({"phase": "kernel_check", "kernel": "sband_solve", "B": B,
                  "n": n, "w": w, "n_rhs": n_rhs, "dtype": str(dtype),
                  "max_rel_diff": err, "tol": SBAND_RTOL[dtype]})
            check(err <= SBAND_RTOL[dtype],
                  f"sband_solve_multi differs from the plain solver by "
                  f"{err:.3e} at {(B, n, w, n_rhs)} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)

    timing = {}
    for B, n, w, n_rhs in SBAND_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            U, R = random_sband(B, n, w, n_rhs, dtype, gen)
            t = time_sband(sband, scalar_band, U, R)
            lib = library_ms(lambda c: dense_from_sband(U[:c]),
                             lambda c: R[:c], B, n, dtype)
            timing[(B, n, dtype)] = {**t, **lib, "ms": min(t["kernel_ms"]),
                                     "plain_ms": min(t["plain_ms"])}
            emit({"phase": "kernel_time", "kernel": "sband_solve", "B": B,
                  "n": n, "w": w, "n_rhs": n_rhs, "dtype": str(dtype),
                  **t, **lib})
            del U, R
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
            plan = block_thomas.launch_plan(
                B, nb, kb, min(r, block_thomas.MAX_R), got.element_size())
            emit({"phase": "kernel_check", "kernel": "band_solve", "B": B,
                  "nb": nb, "kb": kb, "r": r, "dtype": str(dtype),
                  "max_rel_diff": err, "tol": BAND_RTOL[dtype],
                  "launches": launches, "chunk": plan.chunk,
                  "calls": plan.calls})
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
            t = time_band(block_thomas, band, W, R)
            # The trace's launches against the host loop's plan.  The
            # profiler drops events at times (5 of 140 a call, seen on the
            # H100), never adds them: more than planned is a fault.
            plan = block_thomas.launch_plan(B, nb, kb, r, W.element_size())
            planned = plan.launches * plan.calls
            traced = sum(v for k, v in t["split"]["launches_per_call"].items()
                         if k.startswith("block_thomas"))
            check(t["split"]["device_ms"] is None
                  or 0.5 * planned <= traced <= planned,
                  f"band_solve traced {traced} kernels a call, the plan "
                  f"{planned}")
            n = nb * kb
            lib = library_ms(lambda c: dense_from_block_band(W[:c]),
                             lambda c: R[:c], B, n, dtype)
            bound = bound_ms(block_thomas_flops(nb, kb, r) * B,
                             n * (3 * kb + 2 * r) * B * W.element_size(),
                             dtype)
            timing[(B, nb, kb, dtype)] = {
                "ms": min(t["kernel_ms"]), "plain_ms": min(t["plain_ms"]),
                "max_abs_err": t["max_abs_err"], **lib, **bound}
            emit({"phase": "kernel_time", "kernel": "band_solve", "B": B,
                  "nb": nb, "kb": kb, "r": r, "dtype": str(dtype), **t,
                  "planned_launches": planned, **lib, **bound})
            del W, R
            torch.cuda.empty_cache()
    return worst, timing


def time_band(block_thomas, band, W, R) -> dict:
    """The block-Thomas kernels against their plain version on ``W``,
    ``R``: device ms in turns (plain, kernel, kernel, plain), the largest
    difference, and the kernels' device ms by name (``kernel_split``)."""
    got = block_thomas.band_solve_multi(W, R)
    want = band.band_thomas_solve(W, R)
    max_abs = float((got - want).abs().max())
    del got, want
    p1 = cuda_ms(lambda: band.band_thomas_solve(W, R), reps=2, warmup=1)
    k1 = cuda_ms(lambda: block_thomas.band_solve_multi(W, R))
    k2 = cuda_ms(lambda: block_thomas.band_solve_multi(W, R))
    p2 = cuda_ms(lambda: band.band_thomas_solve(W, R), reps=2, warmup=1)
    split = kernel_split(lambda: block_thomas.band_solve_multi(W, R))
    return {"kernel_ms": [k1, k2], "plain_ms": [p1, p2],
            "max_abs_err": max_abs, "split": split}


def random_dominant(B: int, n: int, r: int, dtype, gen):
    """Diagonally dominant symmetric matrices [B, n, n], made as the JAX
    package's dense-method tests make them, and right-hand sides
    [B, n, r]."""
    A = 0.5 * torch.randn(B, n, n, generator=gen, device="cuda", dtype=dtype)
    A = A + A.transpose(1, 2)
    A.diagonal(dim1=1, dim2=2).add_(
        A.abs().sum(-1).amax(-1, keepdim=True) + 1.0)
    R = torch.randn(B, n, r, generator=gen, device="cuda", dtype=dtype)
    return A.contiguous(), R


def random_laplacian(B: int, n: int, r: int, dtype, gen):
    """Grounded random-graph Laplacians [B, n, n], the ``randnet`` class:
    a path through the nodes (so no island floats) plus 3n random edges,
    conductances uniform in [0.5, 1.5], a unit tie to ground on every 50th
    node; and right-hand sides [B, n, r]."""
    A = torch.zeros(B, n, n, device="cuda", dtype=dtype)
    k = 3 * n
    a = torch.cat([torch.arange(n - 1, device="cuda").expand(B, -1),
                   torch.randint(0, n, (B, k), generator=gen,
                                 device="cuda")], dim=1)
    b = torch.cat([torch.arange(1, n, device="cuda").expand(B, -1),
                   torch.randint(0, n, (B, k), generator=gen,
                                 device="cuda")], dim=1)
    g = 0.5 + torch.rand(a.shape, generator=gen, device="cuda", dtype=dtype)
    s = torch.arange(B, device="cuda")[:, None].expand_as(a)
    for i, j, v in ((a, a, g), (b, b, g), (a, b, -g), (b, a, -g)):
        A.index_put_((s, i, j), v, accumulate=True)
    tie = torch.arange(0, n, RANDNET_TIE_EVERY, device="cuda")
    A[:, tie, tie] += 1.0
    R = torch.randn(B, n, r, generator=gen, device="cuda", dtype=dtype)
    return A, R


def lu_check_tol(A: torch.Tensor, cls: str) -> dict:
    """The stated tolerance of one check (see ``LU_RTOL`` and
    ``LU_KAPPA_FACTOR``), with κ₁ of the first system for the Laplacians."""
    tol = LU_RTOL[A.dtype]
    if cls == "dominant":
        return {"tol": tol}
    kappa = float(torch.linalg.cond(A[0].double(), p=1))
    eps = torch.finfo(A.dtype).eps / 2
    return {"tol": max(tol, LU_KAPPA_FACTOR * kappa * eps), "kappa1": kappa}


def lu_flops(n: int, r: int) -> float:
    """Least flops of one dense LU solve: the factorization (2/3·n³) and
    both sweeps (2·n²·r)."""
    return 2 / 3 * n ** 3 + 2 * n * n * r


def phase_lu_kernel(lu, block_lu):
    """Blocked-LU kernel vs the plain torch solver (``blocked_factor`` +
    ``blocked_solve_factored``) on the same CUDA tensors, in two matrix
    classes; a batch past 2³¹ values in f64; then the kernel, the plain
    version, the library call and the bound timed at the main paths'
    shapes."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for B, n, r in LU_SHAPES:
            for cls, make in (("dominant", random_dominant),
                              ("laplacian", random_laplacian)):
                A, R = make(B, n, r, dtype, gen)
                tol = lu_check_tol(A, cls)
                want = block_lu.blocked_solve_factored(
                    block_lu.blocked_factor(A), R)
                vs_f64 = {}
                if dtype == torch.float32:
                    # Which of the two f32 solves sets the difference:
                    # each against the f64 kernel on the same matrices.
                    x64 = lu.lu_solve_multi(A.double(), R.double())
                    vs_f64 = {"plain_vs_f64": rel_diff(
                        want.reshape(B, -1), x64.reshape(B, -1))}
                before = (lu.lu_factor.launches,
                          lu.lu_solve_factored.launches)
                got = lu.lu_solve_multi(A, R)  # factors A in place
                torch.cuda.synchronize()
                check((lu.lu_factor.launches, lu.lu_solve_factored.launches)
                      == (before[0] + 1, before[1] + 1),
                      "lu_solve_multi did not launch the kernel once")
                check(got.dtype == dtype and got.shape == R.shape,
                      f"lu_solve_multi returned {got.dtype} "
                      f"{tuple(got.shape)}")
                check(bool(torch.isfinite(got).all()),
                      f"lu_solve_multi non-finite at {(B, n, r)} {cls}")
                err = rel_diff(got.reshape(B, -1), want.reshape(B, -1))
                if vs_f64:
                    vs_f64["kernel_vs_f64"] = rel_diff(
                        got.reshape(B, -1), x64.reshape(B, -1))
                    del x64
                emit({"phase": "kernel_check", "kernel": "lu_solve", "B": B,
                      "n_pad": n, "r": r, "class": cls, "dtype": str(dtype),
                      "max_rel_diff": err, **tol, **vs_f64})
                check(err <= tol["tol"],
                      f"lu_solve_multi differs from the plain solver by "
                      f"{err:.3e} at {(B, n, r)} {cls} {dtype}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                del A, R, got, want
                torch.cuda.empty_cache()
    # 64-bit offsets: a batch of 2.3·10⁹ f64 values, whose last systems lie
    # past 2³¹ values (and 2³⁴ bytes); they are held against a kernel solve
    # of the same 8 systems alone, copied before the in-place factorization.
    B, n, r = LU_HUGE
    A = torch.empty(B, n, n, device="cuda", dtype=torch.float64)
    for lo in range(0, B, 512):
        A[lo:lo + 512], _ = random_dominant(min(512, B - lo), n, r,
                                            torch.float64, gen)
    R = torch.randn(B, n, r, generator=gen, device="cuda",
                    dtype=torch.float64)
    tail_A, tail_R = A[-8:].clone(), R[-8:].clone()
    got = lu.lu_solve_multi(A, R)[-8:]
    del A
    want = lu.lu_solve_multi(tail_A, tail_R)
    torch.cuda.synchronize()
    err = rel_diff(got.reshape(8, -1), want.reshape(8, -1))
    emit({"phase": "kernel_check", "kernel": "lu_solve", "B": B, "n_pad": n,
          "r": r, "class": "dominant", "dtype": str(torch.float64),
          "values": B * n * n, "compared": "last 8 systems vs alone",
          "max_rel_diff": err, "tol": LU_RTOL[torch.float64]})
    check(bool(torch.isfinite(got).all()) and
          err <= LU_RTOL[torch.float64],
          f"lu_solve_multi past 2^31 values differs by {err:.3e}")
    del R, got, want, tail_A, tail_R
    torch.cuda.empty_cache()

    timing = {}
    for B, n, r in LU_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            A, R = random_laplacian(B, n, r, dtype, gen)
            t = time_lu(lu, block_lu, A, R)
            lib = library_ms(lambda c: A[:c], lambda c: R[:c], B, n, dtype)
            bound = bound_ms(lu_flops(n, r) * B,
                             (n * n + 2 * n * r) * B * A.element_size(),
                             dtype)
            timing[(B, n, r, dtype)] = {
                "ms": min(t["kernel_ms"]), "plain_ms": min(t["plain_ms"]),
                "max_abs_err": t["max_abs_err"], **lib, **bound}
            emit({"phase": "kernel_time", "kernel": "lu_solve", "B": B,
                  "n_pad": n, "r": r, "dtype": str(dtype), **t, **lib,
                  **bound})
            del A, R
            torch.cuda.empty_cache()
    return worst, timing


def time_lu(lu, block_lu, A, R) -> dict:
    """The blocked-LU kernels against their plain version on ``A``, ``R``:
    device ms in turns (plain, kernel, kernel, plain; the in-place factor's
    fresh copy of A timed alone and taken off), the largest difference,
    the factorization's and the sweeps' device ms by kernel name
    (``kernel_split``) and, in f32, each solve's distance from the f64
    kernel's (``kernel_vs_f64``, ``plain_vs_f64``)."""
    B = A.shape[0]
    W = torch.empty_like(A)
    want = block_lu.blocked_solve_factored(block_lu.blocked_factor(A), R)
    got = lu.lu_solve_multi(W.copy_(A), R)
    out = {"max_abs_err": float((got - want).abs().max())}
    if A.dtype == torch.float32:
        x64 = lu.lu_solve_multi(A.double(), R.double())
        out["kernel_vs_f64"] = rel_diff(got.reshape(B, -1),
                                        x64.reshape(B, -1))
        out["plain_vs_f64"] = rel_diff(want.reshape(B, -1),
                                       x64.reshape(B, -1))
        del x64
    del got, want
    torch.cuda.empty_cache()

    def plain():
        return block_lu.blocked_solve_factored(block_lu.blocked_factor(A), R)

    def kernel():  # the factorization is in place: a fresh copy
        return lu.lu_solve_multi(W.copy_(A), R)

    p1 = cuda_ms(plain, reps=3, warmup=1)
    k1 = cuda_ms(kernel, reps=3, warmup=1)
    copy = cuda_ms(lambda: W.copy_(A), reps=3, warmup=1)
    k2 = cuda_ms(kernel, reps=3, warmup=1)
    p2 = cuda_ms(plain, reps=3, warmup=1)
    factor = kernel_split(lambda: lu.lu_factor(W.copy_(A)))
    F = lu.lu_factor(W.copy_(A))
    solve = kernel_split(lambda: lu.lu_solve_factored(F, R))
    split = {name: {k: {n: v for n, v in sp[k].items()
                        if n.startswith("block_lu")}
                    for k in ("by_kernel_ms", "launches_per_call")}
             for name, sp in (("factor", factor), ("solve", solve))}
    del W, F
    torch.cuda.empty_cache()
    return {"kernel_ms": [k1 - copy, k2 - copy], "copy_ms": copy,
            "plain_ms": [p1, p2], **out,
            **{f"{name}_ms": (sum(split[name]["by_kernel_ms"].values())
                              if sp["device_ms"] is not None else None)
               for name, sp in (("factor", factor), ("solve", solve))},
            "split": split}


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


def randnet_rows(n_nodes: int = RANDNET_NODES, n_edges: int = RANDNET_EDGES,
                 branch: bool = False):
    """A random network of unit resistors between random node pairs
    (``default_rng(0)``), a ground tie on every 50th node, driven by a 1 A
    source: no band for RCM to find.  ``branch`` adds a voltage source and
    a VCCS.  The JAX package's tests build the same graph
    (``_random_graph_rows``) with a tie on every node."""
    rng = np.random.default_rng(0)
    rows = [["v", "A", "1", "n0", "g"]]
    for k in range(n_edges):
        a, b = rng.integers(0, n_nodes, 2)
        if a != b:
            rows.append([f"r{k}", "R", "1", f"n{a}", f"n{b}"])
    rows += [[f"rg{j}", "R", "1", f"n{j}", "g"]
             for j in range(0, n_nodes, RANDNET_TIE_EVERY)]
    if branch:
        rows += [["e1", "E", "2", "n1", "g"],
                 ["d1", "VCCS", "0.5", "n3", "g", "n1", "g"]]
    return rows


def opchain_rows(n_stages: int):
    """A chain of opamp-macromodel voltage followers buffering a
    resistive ladder, as the JAX package's bench builds it
    (``bench_opmodel_chain``): small, non-SPD, condition ~1e8."""
    rows = [["vin", "E", "1", "in0", "g"]]
    prev = "in0"
    for k in range(n_stages):
        out, nxt = f"o{k}", f"in{k + 1}"
        rows += [[f"u{k}", "OPMODEL", "0", out, "g", prev, out],
                 [f"rl{k}", "R", "100", out, "g"],
                 [f"rs{k}", "R", "10", out, nxt],
                 [f"rg{k}", "R", "1000", nxt, "g"]]
        prev = nxt
    return rows


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


def phase_path(label, rows, batch, method, kernels, rate_refines,
               extra_check=None):
    """Drive one main path through ``BatchedSolver(refine="auto")``: count
    the launches of each wrapper in ``kernels`` over exactly that call
    (each must launch; with ``kernels=None`` no kernel of the repo may),
    check the answers (every sample against the tier's raw f64 solve,
    sample 0 against numpy f64 dense, the f64 audit), then time the
    ``rate_refines`` tiers.  Returns the launch count."""
    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist
    from nodal_tpu_torch.ops import block_thomas, lu, pcr, sband

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

    wrappers = (pcr.pcr_solve, sband.sband_solve_multi,
                block_thomas.band_solve_multi, lu.lu_factor,
                lu.lu_solve_factored)
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "last_shape"):
            w.last_shape = None
    xs = solver(params)
    torch.cuda.synchronize()
    if kernels is None:
        launches = 0
        check(all(w.launches == 0 for w in wrappers),
              f"{label}: a kernel of the repo launched on the library path")
    else:
        launches = sum(w.launches for w in kernels)
        check(all(w.launches > 0 for w in kernels),
              f"{label}: the main path never launched a kernel of "
              f"{[w.__name__ for w in kernels]}")
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
          "setup_s": setup_s, "launches": launches,
          "solver": ("the library's pivoted LU (torch.linalg.solve)"
                     if kernels is None else
                     [w.__name__ for w in kernels]),
          "max_residual": max_res,
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
    check(shape is not None and shape[-1] == 3,
          f"branch: the kernel's last launch had shape {shape}, "
          "expected 3 right-hand sides")
    current = BatchResult(xs, circuit.netlist).current("e1")
    check(bool(torch.isfinite(current).all()),
          "branch: non-finite current through e1")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are on: the Schur algebra needs full f32")
    return {"kernel_shape": list(shape),
            "e1_current_sample0": float(current[0])}


# The batch paths' kernels of the repo in a trace, by the prefix of their
# names, for each family of wrappers.
BATCH_KERNEL_PREFIXES = {"pcr": "pcr_", "sband": "sband_",
                         "block_thomas": "block_thomas_",
                         "block_lu": "block_lu_"}


def batch_kernels(ops) -> dict:
    """The kernels each family launched since the counts of its wrappers
    in ``ops`` (the pcr, sband, block_thomas and lu modules) were
    reset.  PCR and the scalar band launch one a counted call.  The block
    Thomas counts host loops, each ``launch_plan``'s launches; the blocked
    LU counts factorizations, ``factor_launches`` each, and solves, 4q − 2
    products each for q panels (``dense_tile.cuh:lu_solve``: two a panel
    forward but the last, two a panel backward), at their last calls'
    shapes, which every call of one path shares."""
    pcr, sband, block_thomas, lu = ops
    bt, solve = block_thomas.band_solve_multi, lu.lu_solve_factored
    out = {"pcr": pcr.pcr_solve.launches,
           "sband": sband.sband_solve_multi.launches,
           "block_thomas": 0, "block_lu": 0}
    if bt.launches:
        B, nb, kb, r = bt.last_shape
        out["block_thomas"] = bt.launches * block_thomas.launch_plan(
            B, nb, kb, min(r, block_thomas.MAX_R), 4).launches
    if lu.lu_factor.launches or solve.launches:
        n = solve.last_shape[1]
        out["block_lu"] = (lu.lu_factor.launches * lu.factor_launches(n)
                           + solve.launches * (4 * (n // lu.BLOCK) - 2))
    return out


def phase_profile(label, rows, batch, ops):
    """Device kernel time of one ``refine="auto"`` call by kind, from a
    ``torch.profiler`` trace of 3 calls (each in its own span) after 2
    warm-up calls, and the device's idle share of the traced window.  A
    trace is read only when it is whole: in each call, the kernels of each
    family of the repo's wrappers, by name, equal what the wrappers
    launched (:func:`batch_kernels`).  A trace that is not whole is
    reported and taken again, up to ``GRID_PROFILE_TRIES`` times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from nodal_tpu_torch import Circuit, Netlist

    circuit = Circuit(Netlist.from_rows(rows))
    solver = circuit.batched_solver(refine="auto", device="cuda")
    params = torch.as_tensor(sweep_params(circuit, batch), device="cuda")
    for _ in range(2):
        solver(params)
    torch.cuda.synchronize()
    calls = 3
    labels = [f"{label}_call_{k}" for k in range(calls)]
    pcr, sband, block_thomas, lu = ops
    wrappers = (pcr.pcr_solve, sband.sband_solve_multi,
                block_thomas.band_solve_multi, lu.lu_factor,
                lu.lu_solve_factored)
    dropped = []
    for _ in range(GRID_PROFILE_TRIES):
        launched = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name in labels:
                for w in wrappers:
                    w.launches = 0
                with record_function(name):
                    solver(params)
                launched[name] = batch_kernels(ops)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        spans, _ = split_trace(events, labels)
        why = None
        for name in labels:
            traced = {f: sum(kernel_name(e.get("name", "")).startswith(pre)
                             for e in spans[name])
                      for f, pre in BATCH_KERNEL_PREFIXES.items()}
            if not spans[name] or traced != launched[name]:
                why = (f"{name} traced {traced} kernels of the repo, the "
                       f"wrappers launched {launched[name]}")
                break
        if why is None:
            break
        dropped.append(why)
        emit({"phase": "profile", "path": label, "trace_not_whole": why})
    check(why is None, f"profile {label}: no whole trace in "
          f"{GRID_PROFILE_TRIES} tries: {dropped}")
    kernels = [e for name in labels for e in spans[name]]
    kinds = {"block_thomas": ("block_thomas",), "sband": ("sband",),
             "pcr": ("pcr",), "block_lu": ("block_lu",),
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
          "calls": calls, "whole": True, "traces_not_whole": len(dropped),
          "repo_kernels_per_call": launched[labels[0]],
          "device_ms_per_call": busy / calls,
          "kernels_per_call": len(kernels) / calls,
          "ms_per_call_by_kind": {k: v / calls for k, v in
                                  sorted(by_kind.items(),
                                         key=lambda kv: -kv[1])},
          "device_idle_share": max(0.0, 1.0 - busy / window)})


def phase_resources(library: Path, only: str = ""):
    """Registers, stack and local (spill) bytes a thread and static shared
    bytes of every kernel in the built library (whose mangled name holds
    ``only``), as ``cuobjdump -res-usage`` reads them.  A diagnostic:
    without the tool it says "not measured"."""
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
        if line.startswith("Function ") and only in line:
            name = line[len("Function "):].rstrip(":")
        elif name and line.startswith("REG:"):
            usage[name] = {k: v for k, v in (kv.split(":", 1) for kv in
                                             line.split() if ":" in kv)
                           if k in ("REG", "STACK", "SHARED", "LOCAL")}
            name = None
    emit({"phase": "resource_usage", "kernels": usage or
          f"not measured (cuobjdump rc {proc.returncode})"})


def event_median_ms(fn, reps: int = 11, inner: int = 10,
                    warmup: int = 3) -> float:
    """Median over ``reps`` CUDA-event readings of the mean device time of
    ``inner`` back-to-back ``fn()`` calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def stencil_cases(st, B, h, w, dtype, gen, weight=1.0):
    """(name, kernel call, plain call) of every stencil check at one shape,
    on inputs drawn from ``gen``."""
    rnd = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                     device="cuda", dtype=dtype)
    x, r = rnd(B, h, w), rnd(B, h, w)
    kw = {"weight": weight, "omega": 0.8}
    cases = [(f"jacobi_sweeps/{k}",
              functools.partial(st.jacobi_sweeps, x, r, sweeps=k, **kw),
              functools.partial(st.jacobi_sweeps_plain, x, r, sweeps=k,
                                **kw)) for k in JACOBI_SWEEPS]
    if h % 2 == 0 and w % 2 == 0:
        zc = rnd(B, h // 2, w // 2)
        for xs, tag in ((None, ""), (x, "/x")):
            cases += [
                ("presmooth_restrict" + tag,
                 functools.partial(st.presmooth_restrict, r, x=xs, **kw),
                 functools.partial(st.presmooth_restrict_plain, r, x=xs,
                                   **kw)),
                ("prolong_postsmooth" + tag,
                 functools.partial(st.prolong_postsmooth, r, zc, x=xs, **kw),
                 functools.partial(st.prolong_postsmooth_plain, r, zc, x=xs,
                                   **kw))]
    nus = (1, 2) if (h, w) in ((64, 64), (1024, 1024)) and B == 1 else (1,)
    cases += [(f"vcycle/nu{nu}",
               functools.partial(st.vcycle, r, nu=nu, **kw),
               functools.partial(st.vcycle_plain, r, nu=nu, **kw))
              for nu in nus]
    return cases


def stencil_bound(name: str, B: int, h: int, w: int, dtype,
                  sweeps: int = TIME_JACOBI_SWEEPS) -> dict:
    """Bytes (inputs read once, output written once) and operations of one
    stencil call: a sweep is 9 flops a cell, a restriction ~6 a fine cell,
    a prolongation 8; the V-cycle's bytes are its input and output.  The
    ``/x`` transfers also read the given x."""
    n, item = B * h * w, torch.finfo(dtype).bits // 8
    values, flops = {
        "jacobi_sweeps": (3 * n, 9 * sweeps * n),
        "presmooth_restrict": (1.25 * n, 15 * n),
        "presmooth_restrict/x": (2.25 * n, 15 * n),
        "prolong_postsmooth": (2.25 * n, 17 * n),
        "prolong_postsmooth/x": (3.25 * n, 17 * n),
        "vcycle": (2 * n, 4 / 3 * 50 * n),
    }[name]
    return bound_ms(flops, values * item, dtype)


def check_stencil_case(name, kernel, plain, shape, weight, dtype,
                       worst) -> None:
    """One stencil kernel call against its plain version: dtype, shape,
    finite values, the difference relative to max|plain| within
    ``STENCIL_RTOL`` (and a mean-zero V-cycle); the worst difference of
    each kernel and dtype is kept in ``worst``."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    check(got.dtype == dtype and got.shape == want.shape,
          f"{name} returned {got.dtype} {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()),
          f"{name} non-finite at {shape} {dtype}")
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max()) / scale
    B, h, w = shape
    emit({"phase": "kernel_check", "kernel": name, "B": B, "h": h, "w": w,
          "weight": weight, "dtype": str(dtype), "max_rel_diff": err,
          "tol": STENCIL_RTOL[dtype]})
    check(err <= STENCIL_RTOL[dtype],
          f"{name} differs from its plain version by {err:.3e} at {shape} "
          f"weight {weight} {dtype}")
    base = name.split("/")[0]
    worst[(base, dtype)] = max(worst.get((base, dtype), 0.0), err)
    if name.startswith("vcycle"):
        mean = float(got.mean(dim=(1, 2)).abs().max()) / scale
        check(mean <= STENCIL_RTOL[dtype],
              f"vcycle output mean {mean:.3e} at {shape}")


def phase_stencil_kernels(st):
    """Each stencil kernel against its plain version on the same CUDA
    tensors at every shape class in f32 and f64 (the transfers also on
    misaligned fields), a batch past 2³¹ values through the Jacobi and
    both transfers (with and without x), then kernel, plain version and
    bound timed."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {}
    shapes = [(s, 1.0) for s in STENCIL_SHAPES] + [((1, 512, 512), 2.0)]
    for dtype in (torch.float32, torch.float64):
        for (B, h, w), weight in shapes:
            for name, kernel, plain in stencil_cases(st, B, h, w, dtype, gen,
                                                     weight):
                check_stencil_case(name, kernel, plain, (B, h, w), weight,
                                   dtype, worst)
            torch.cuda.empty_cache()
        # Fields one value past a 16-byte boundary take the transfers'
        # narrow path whatever their pitch (f64, whose even widths always
        # have a 16-byte pitch, takes it only so).
        B, h, w = MISALIGNED_SHAPE
        r, x = (torch.randn(B * h * w + 1, generator=gen, device="cuda",
                            dtype=dtype)[1:].view(B, h, w) for _ in range(2))
        zc = torch.randn(B, h // 2, w // 2, generator=gen, device="cuda",
                         dtype=dtype)
        check(not st._strip_plan(r, x).wide,
              f"a misaligned {dtype} field took the wide path")
        for xs, tag in ((None, ""), (x, "/x")):
            check_stencil_case(
                "presmooth_restrict" + tag + "/misaligned",
                functools.partial(st.presmooth_restrict, r, x=xs),
                functools.partial(st.presmooth_restrict_plain, r, x=xs),
                (B, h, w), 1.0, dtype, worst)
            check_stencil_case(
                "prolong_postsmooth" + tag + "/misaligned",
                functools.partial(st.prolong_postsmooth, r, zc, x=xs),
                functools.partial(st.prolong_postsmooth_plain, r, zc, x=xs),
                (B, h, w), 1.0, dtype, worst)
        del r, x, zc
    # 64-bit offsets: the last sample of a batch past 2³¹ values against a
    # launch on that sample alone, bit for bit.
    B, h, w = STENCIL_HUGE
    x = torch.randn(B, h, w, generator=gen, device="cuda")
    r = torch.randn(B, h, w, generator=gen, device="cuda")
    x1, r1 = x[-1:].clone(), r[-1:].clone()
    got = st.jacobi_sweeps(x, r, sweeps=4)[-1:].clone()
    same = {"jacobi_sweeps/4": torch.equal(
        got, st.jacobi_sweeps(x1, r1, sweeps=4))}
    del got
    zc = torch.randn(B, h // 2, w // 2, generator=gen, device="cuda")
    z1 = zc[-1:].clone()
    for xs, xs1, tag in ((None, None, ""), (x, x1, "/x")):
        got = st.presmooth_restrict(r, x=xs)[-1:].clone()
        same["presmooth_restrict" + tag] = torch.equal(
            got, st.presmooth_restrict(r1, x=xs1))
        got = st.prolong_postsmooth(r, zc, x=xs)[-1:].clone()
        same["prolong_postsmooth" + tag] = torch.equal(
            got, st.prolong_postsmooth(r1, z1, x=xs1))
        del got
    torch.cuda.synchronize()
    emit({"phase": "kernel_check", "kernel": "stencil", "B": B, "h": h,
          "w": w, "dtype": str(torch.float32), "values": B * h * w,
          "compared": "last sample vs alone", "bit_equal": same})
    check(all(same.values()), f"stencil kernels past 2^31 values differ "
          f"from the sample alone: {same}")
    del x, r, zc, x1, r1, z1
    torch.cuda.empty_cache()

    timing = {}
    for B, h, w in STENCIL_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(B, h, w, generator=gen, device="cuda",
                            dtype=dtype)
            r = torch.randn(B, h, w, generator=gen, device="cuda",
                            dtype=dtype)
            zc = torch.randn(B, h // 2, w // 2, generator=gen, device="cuda",
                             dtype=dtype)
            k = TIME_JACOBI_SWEEPS
            calls = {
                "jacobi_sweeps": (
                    lambda: st.jacobi_sweeps(x, r, sweeps=k),
                    lambda: st.jacobi_sweeps_plain(x, r, sweeps=k)),
                "presmooth_restrict": (
                    lambda: st.presmooth_restrict(r),
                    lambda: st.presmooth_restrict_plain(r)),
                "prolong_postsmooth": (
                    lambda: st.prolong_postsmooth(r, zc),
                    lambda: st.prolong_postsmooth_plain(r, zc)),
                "vcycle": (lambda: st.vcycle(r), lambda: st.vcycle_plain(r)),
            }
            for name, (kernel, plain) in calls.items():
                max_abs = float((kernel() - plain()).abs().max())
                # Alternate plain, kernel, kernel, plain.
                p1 = event_median_ms(plain)
                k1 = event_median_ms(kernel)
                k2 = event_median_ms(kernel)
                p2 = event_median_ms(plain)
                t = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "max_abs_err": max_abs, "library_ms": None,
                     **stencil_bound(name, B, h, w, dtype)}
                timing[(name, (B, h, w), dtype)] = t
                emit({"phase": "kernel_time", "kernel": name, "B": B,
                      "h": h, "w": w, "dtype": str(dtype),
                      "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                      "max_abs_err": max_abs, "library_ms": None,
                      "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]})
            del x, r, zc
            torch.cuda.empty_cache()
    return worst, timing


def phase_cluster_kernels(st):
    """The thread-block cluster kernels: the largest cluster the card
    schedules; rows 10 and 7 by kernel name (``kernel_split``) beside the
    wrapper's event time, ``vcycle`` at the 1024² and 1022² grids' finest
    shapes and ``jacobi_sweeps`` at ``COARSE_SWEEPS`` sweeps on the grid
    paths' coarsest shapes (``CLUSTER_JACOBI_SHAPES``); then the two kernel
    entries: ``vcycle_cluster`` alone at ``CLUSTER_VCYCLE_ENTRY`` and
    ``jacobi_cluster`` alone at 511² f32, each against its plain version
    and its bound."""
    card = torch.cuda.current_device()
    emit({"phase": "cluster", "max_cluster": {
        str(dt): st.max_cluster(card, dt) for dt in (torch.float32,
                                                     torch.float64)}})
    gen = torch.Generator(device="cuda").manual_seed(7)
    rnd = lambda *shape, dtype: torch.randn(  # noqa: E731
        *shape, generator=gen, device="cuda", dtype=dtype)
    for n in CLUSTER_TRACE_SIZES:
        for dtype in (torch.float32, torch.float64):
            r = rnd(1, n, n, dtype=dtype)
            route = st.vcycle_route(n, n, 8, r.element_size(),
                                    st.max_cluster(card, dtype))
            emit({"phase": "kernel_trace", "wrapper": "vcycle", "n": n,
                  "dtype": str(dtype),
                  "entry": list(route.shapes[route.stop]),
                  "cluster": route.plan and route.plan.cluster,
                  "event_ms": event_median_ms(lambda: st.vcycle(r)),
                  **kernel_split(lambda: st.vcycle(r))})
    timing = {}
    for B, h, w, dtype in CLUSTER_JACOBI_SHAPES:
        x, r = rnd(B, h, w, dtype=dtype), rnd(B, h, w, dtype=dtype)
        kernel = functools.partial(st.jacobi_sweeps, x, r,
                                   sweeps=COARSE_SWEEPS)
        plain = functools.partial(st.jacobi_sweeps_plain, x, r,
                                  sweeps=COARSE_SWEEPS)
        timing[("jacobi_cluster", (B, h, w), dtype)] = t = time_cluster(
            kernel, plain, stencil_bound("jacobi_sweeps", B, h, w, dtype,
                                         sweeps=COARSE_SWEEPS))
        emit({"phase": "kernel_trace", "wrapper": "jacobi_sweeps",
              "sweeps": COARSE_SWEEPS, "B": B, "h": h, "w": w,
              "dtype": str(dtype),
              "cluster": st.jacobi_cluster_size(h, w, x.element_size(),
                                                st.max_cluster(card, dtype)),
              **t, **kernel_split(kernel)})
    B, h, w = CLUSTER_VCYCLE_ENTRY
    r = rnd(B, h, w, dtype=torch.float32)
    t = time_cluster(functools.partial(st.vcycle, r),
                     functools.partial(st.vcycle_plain, r),
                     stencil_bound("vcycle", B, h, w, torch.float32))
    timing[("vcycle_cluster", (B, h, w), torch.float32)] = t
    emit({"phase": "kernel_trace", "wrapper": "vcycle", "B": B, "h": h,
          "w": w, "dtype": str(torch.float32), **t,
          **kernel_split(lambda: st.vcycle(r))})
    return timing


def time_cluster(kernel, plain, bound) -> dict:
    """A cluster route's call against its plain version, in turns (plain,
    kernel, kernel, plain), with its bound."""
    max_abs = float((kernel() - plain()).abs().max())
    p1 = event_median_ms(plain)
    k1 = event_median_ms(kernel)
    k2 = event_median_ms(kernel)
    p2 = event_median_ms(plain)
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2),
            "kernel_ms": [k1, k2], "plain_ms_reps": [p1, p2],
            "max_abs_err": max_abs, "library_ms": None, **bound}


def fused_cg_inputs(B, h, w, dtype, gen):
    """p, x, r, Lp [B, h, w] and per-sample α, mean p [B] from ``gen``."""
    rnd = lambda *shape: torch.randn(*shape, generator=gen,  # noqa: E731
                                     device="cuda", dtype=dtype)
    p, x, r, lp = (rnd(B, h, w) for _ in range(4))
    return p, x, r, lp, rnd(B), 0.1 * rnd(B)


def fused_cg_errors(fc, p, x, r, lp, alpha, mean_p, weight=1.0) -> dict:
    """Each output of both kernels against its plain version on the same
    CUDA tensors: fields relative to max|plain|, each part's (S) or tile's
    (U) partial sums relative to its sum of |terms| (the kernels sum in a
    fixed order, the plain versions in torch's)."""
    out = {}
    got_lp, got_part = fc.stencil_partials(p, weight=weight)
    got_u = fc.update_partials(x, r, p, lp, alpha, mean_p)
    torch.cuda.synchronize()
    want_lp, want_part = fc.stencil_partials_plain(p, weight=weight)
    want_u = fc.update_partials_plain(x, r, p, lp, alpha, mean_p)
    tiny = torch.finfo(p.dtype).tiny
    for name, got, want in (("Lp", got_lp, want_lp), ("x", got_u[0],
                                                       want_u[0]),
                            ("r", got_u[1], want_u[1])):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"fused CG {name}: shape {tuple(got.shape)} or non-finite")
        scale = float(want.abs().max()) or 1.0
        out[name] = float((got - want).abs().max()) / scale
    scales = {"sum_p_lp": fc.part_sums((p * want_lp).abs()),
              "sum_p": fc.part_sums(p.abs()), "sum_r2": want_u[2]}
    for name, got, want in (
            ("sum_p_lp", got_part[..., 0], want_part[..., 0]),
            ("sum_p", got_part[..., 1], want_part[..., 1]),
            ("sum_r2", got_u[2], want_u[2])):
        out[name] = float(((got - want).abs()
                           / scales[name].clamp_min(tiny)).max())
    out["max_abs"] = {"stencil_partials": max(
        float((got_lp - want_lp).abs().max()),
        float((got_part - want_part).abs().max())),
        "update_partials": max(float((g - w).abs().max())
                               for g, w in zip(got_u, want_u))}
    return out


def fused_cg_bound(name: str, B: int, h: int, w: int, dtype,
                   parts: int) -> dict:
    """Bytes (inputs read once, outputs written once, the ``parts`` partial
    slots of a sample included) and operations of one fused CG kernel
    call: S forms Lp (6 flops a cell) and two sums (3); U two AXPYs and a
    sum of squares (7)."""
    n, item = B * h * w, torch.finfo(dtype).bits // 8
    values, flops = {
        "stencil_partials": (2 * n + 2 * B * parts, 9 * n),
        "update_partials": (6 * n + 2 * B + B * parts, 7 * n),
    }[name]
    return bound_ms(flops, values * item, dtype)


def phase_fused_cg_kernels(fc):
    """Both fused CG kernels against their plain versions on the same CUDA
    tensors at every stencil shape in f32 and f64, an f32 batch past 2³¹
    values, then kernel, plain version and bound timed."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    shapes = [(s, 1.0) for s in STENCIL_SHAPES] + [((1, 512, 512), 2.0)]
    for dtype in (torch.float32, torch.float64):
        tol = STENCIL_RTOL[dtype]
        for (B, h, w), weight in shapes:
            errs = fused_cg_errors(fc, *fused_cg_inputs(B, h, w, dtype, gen),
                                   weight=weight)
            max_abs = errs.pop("max_abs")
            emit({"phase": "kernel_check", "kernel": "fused_cg", "B": B,
                  "h": h, "w": w, "weight": weight, "dtype": str(dtype),
                  "max_rel_diff": errs, "max_abs_diff": max_abs, "tol": tol})
            for name, err in errs.items():
                check(err <= tol, f"fused CG {name} differs from its plain "
                      f"version by {err:.3e} at {(B, h, w)} {dtype}")
                worst[(name, dtype)] = max(worst.get((name, dtype), 0.0), err)
        torch.cuda.empty_cache()
    # 64-bit offsets: the last sample of a batch past 2³¹ values against a
    # launch on that sample alone, bit for bit (U reads one field as x, r,
    # p and Lp, so the batch fits beside its two outputs).
    B, h, w = STENCIL_HUGE
    p = torch.randn(B, h, w, generator=gen, device="cuda")
    alpha = torch.randn(B, generator=gen, device="cuda")
    mean_p = torch.randn(B, generator=gen, device="cuda")
    tail = p[-1:].clone()
    got = [t[-1:].clone() for t in fc.stencil_partials(p)]
    want = fc.stencil_partials(tail)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    got = [t[-1:].clone() for t in fc.update_partials(p, p, p, p, alpha,
                                                        mean_p)]
    want = fc.update_partials(tail, tail, tail, tail, alpha[-1:].clone(),
                              mean_p[-1:].clone())
    torch.cuda.synchronize()
    same_u = all(torch.equal(a, b) for a, b in zip(got, want))
    emit({"phase": "kernel_check", "kernel": "fused_cg", "B": B, "h": h,
          "w": w, "dtype": str(torch.float32), "values": B * h * w,
          "compared": "last sample vs alone",
          "bit_equal": {"stencil_partials": same, "update_partials": same_u}})
    check(same and same_u, "fused CG kernels past 2^31 values differ from "
          "the sample alone")
    del p, tail, got, want
    torch.cuda.empty_cache()

    timing = {}
    for B, h, w in STENCIL_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            p, x, r, lp, alpha, mean_p = fused_cg_inputs(B, h, w, dtype, gen)
            max_abs = fused_cg_errors(fc, p, x, r, lp, alpha,
                                      mean_p)["max_abs"]
            calls = {
                "stencil_partials": (
                    lambda: fc.stencil_partials(p),
                    lambda: fc.stencil_partials_plain(p)),
                "update_partials": (
                    lambda: fc.update_partials(x, r, p, lp, alpha, mean_p),
                    lambda: fc.update_partials_plain(x, r, p, lp, alpha,
                                                     mean_p)),
            }
            for name, (kernel, plain) in calls.items():
                parts = kernel()[-1].shape[1]
                # Alternate plain, kernel, kernel, plain.
                p1 = event_median_ms(plain)
                k1 = event_median_ms(kernel)
                k2 = event_median_ms(kernel)
                p2 = event_median_ms(plain)
                t = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "max_abs_err": max_abs[name], "library_ms": None,
                     **fused_cg_bound(name, B, h, w, dtype, parts)}
                timing[(name, (B, h, w), dtype)] = t
                emit({"phase": "kernel_time", "kernel": name, "B": B,
                      "h": h, "w": w, "dtype": str(dtype),
                      "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                      "max_abs_err": max_abs[name], "library_ms": None,
                      "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]})
            del p, x, r, lp
            torch.cuda.empty_cache()
    return worst, timing


def fused_launch_counts(fc) -> dict:
    return {w.__name__: w.launches
            for w in (fc.stencil_partials, fc.update_partials)}


def reset_fused_counts(fc) -> None:
    fc.stencil_partials.launches = 0
    fc.update_partials.launches = 0


def fused_grid_run(grid, fc, label, n, rhs, dtype, tol, readout, want,
                   want_its) -> dict:
    """One fused path: ``grid_solve(fused_cg=True)`` on the injection
    fields ``rhs``, its answer ``readout(x)`` against ``want`` from the
    unfused kernel solve, its iterations against ``want_its``, a second
    solve bit for bit, each fused wrapper launched, and one call's latency.
    Returns the fused wrappers' launches over one solve."""
    solve = functools.partial(grid.grid_solve, n, n, rhs, dtype=dtype,
                              tol=tol, fused_cg=True, device="cuda")
    reset_fused_counts(fc)
    x, info = solve()
    torch.cuda.synchronize()
    counts = fused_launch_counts(fc)
    x2, info2 = solve()
    same = torch.equal(x, x2) and all(torch.equal(a, b)
                                      for a, b in zip(info, info2))
    got = readout(x)
    its = torch.as_tensor(info.iterations).reshape(-1).cpu()
    want_its = torch.as_tensor(want_its).reshape(-1).cpu()
    diff = float((torch.as_tensor(got, dtype=torch.float64).cpu()
                  - torch.as_tensor(want, dtype=torch.float64).cpu())
                 .abs().max())
    f64 = dtype == torch.float64
    emit({"phase": "grid_fused", "path": label, "n": n, "dtype": str(dtype),
          "tol": tol, "R": torch.as_tensor(got).reshape(-1).tolist(),
          "iterations": its.tolist(),
          "iterations_unfused": want_its.tolist(),
          "residual": torch.as_tensor(info.residual).reshape(-1).tolist(),
          "R_diff_vs_unfused": diff, "bit_equal_repeat": same,
          "launches_per_solve": counts})
    check(bool(torch.as_tensor(info.converged).all()),
          f"{label} fused: did not converge ({its.tolist()} iterations)")
    check(diff <= (1e-10 if f64 else 1e-6),
          f"{label} fused: R {diff:.3e} from the unfused kernel solve")
    check(int((its - want_its).abs().max()) <= 1,
          f"{label} fused: {its.tolist()} iterations vs "
          f"{want_its.tolist()} unfused")
    check(same, f"{label} fused: two solves differ")
    check(all(v > 0 for v in counts.values()),
          f"{label} fused: a fused kernel never launched: {counts}")
    del x2, info2
    times, ms = host_median_ms(solve)
    emit({"phase": "grid_time", "path": label + "_fused", "ms_reps": times,
          "median_ms": ms, "ms_per_iteration": ms / int(its.max())})
    return counts


def grid_launch_counts(st) -> dict:
    """Each stencil wrapper's launches, and those of the two cluster
    kernels among them."""
    return {**{w.__name__: w.launches for w in
               (st.jacobi_sweeps, st.presmooth_restrict,
                st.prolong_postsmooth, st.vcycle)},
            "vcycle_cluster": st.vcycle.cluster_launches,
            "jacobi_cluster": st.jacobi_sweeps.cluster_launches}


def reset_grid_counts(st) -> None:
    for w in (st.jacobi_sweeps, st.presmooth_restrict,
              st.prolong_postsmooth, st.vcycle):
        w.launches = 0
    st.vcycle.cluster_launches = 0
    st.jacobi_sweeps.cluster_launches = 0


def knight_probes(n: int):
    """bench.py's probes: the centre node and a knight's move away."""
    return (n // 2, n // 2), (n // 2 + 1, n // 2 + 2)


def probe_pairs(n: int) -> np.ndarray:
    """``GRID_PAIRS`` knight's-move probe pairs around the centre of an
    n × n grid, [pairs, 2, 2]."""
    a, _ = knight_probes(n)
    offsets = [(dy, dx) for dy in (-96, -32, 32, 96) for dx in (-96, -32,
                                                                 32, 96)]
    return np.array([[(a[0] + dy, a[1] + dx), (a[0] + dy + 1, a[1] + dx + 2)]
                     for dy, dx in offsets[:GRID_PAIRS]])


def host_median_ms(fn, reps: int = 5):
    """Host-clock times of ``fn()`` ending in a synchronize, after one
    warm-up call, and their median: one call's latency, syncs included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, statistics.median(times)


def phase_grid(grid, st, fc):
    """The grid solves of ``GRID_RUNS`` and the 16-pair batch: launches of
    each stencil wrapper over exactly one solve, answers against the plain
    cycle on the card, f32 against f64, R against the infinite grid, and
    one call's latency; then the fused path on every grid and the 16 pairs
    (:func:`fused_grid_run`).  Returns the stencil and the fused
    wrappers' launches, each summed over its paths."""
    launches = dict.fromkeys(grid_launch_counts(st), 0)
    fused = dict.fromkeys(fused_launch_counts(fc), 0)
    results = {}
    for label, n, dtype, tol in GRID_RUNS:
        a, b = knight_probes(n)
        solve = functools.partial(grid.grid_equivalent_resistance, n, n, a,
                                  b, dtype=dtype, tol=tol, device="cuda")
        reset_grid_counts(st)
        R, info = solve()
        torch.cuda.synchronize()
        counts = grid_launch_counts(st)
        for k, v in counts.items():
            launches[k] += v
        R, its = float(R), int(info.iterations)
        check(bool(info.converged), f"{label}: did not converge "
              f"({its} iterations, residual {float(info.residual):.3e})")
        check(math.isfinite(R), f"{label}: R = {R}")
        R_plain, info_plain = solve(mg_backend="plain")
        R_plain, its_plain = float(R_plain), int(info_plain.iterations)
        f64 = dtype == torch.float64
        diff = abs(R - R_plain)
        emit({"phase": "grid", "path": label, "n": n, "nodes": n * n,
              "dtype": str(dtype), "tol": tol, "probes": [a, b], "R": R,
              "iterations": its, "residual": float(info.residual),
              "launches_per_solve": counts, "R_plain_cycle": R_plain,
              "iterations_plain_cycle": its_plain, "R_diff": diff})
        check(diff <= (1e-12 if f64 else 1e-6),
              f"{label}: R {R!r} vs plain cycle {R_plain!r}")
        check(its == its_plain if f64 else abs(its - its_plain) <= 1,
              f"{label}: {its} iterations vs {its_plain} with the plain "
              "cycle")
        del info_plain
        torch.cuda.empty_cache()
        times, ms = host_median_ms(solve)
        emit({"phase": "grid_time", "path": label, "ms_reps": times,
              "median_ms": ms, "ms_per_iteration": ms / its})
        results[label] = {"R": R, "iterations": its, "ms": ms}
        rhs = torch.zeros(n, n, dtype=dtype, device="cuda")
        rhs[a] += 1.0
        rhs[b] -= 1.0
        counts = fused_grid_run(grid, fc, label, n, rhs, dtype, tol,
                                lambda x: x[a] - x[b], R, its)
        for k, v in counts.items():
            fused[k] += v
        del rhs
        torch.cuda.empty_cache()
    check(abs(results["grid1024_f32"]["R"] - results["grid1024_f64"]["R"])
          <= 1e-5, "grid 1024²: R in f32 and f64 differ by more than 1e-5")
    check(abs(results["grid1024_f64"]["R"] - KNIGHT_R) <= 5e-3,
          f"grid 1024²: R = {results['grid1024_f64']['R']} is not within "
          "5e-3 of 4/pi - 1/2")

    n = 1024
    pairs = probe_pairs(n)
    many = functools.partial(grid.grid_equivalent_resistance_many, n, n,
                             pairs, dtype=torch.float32, tol=1e-6,
                             device="cuda")
    reset_grid_counts(st)
    Rs, res = many()
    torch.cuda.synchronize()
    counts = grid_launch_counts(st)
    for k, v in counts.items():
        launches[k] += v
    singles = [float(grid.grid_equivalent_resistance(
        n, n, tuple(p[0]), tuple(p[1]), dtype=torch.float32, tol=1e-6,
        device="cuda")[0]) for p in pairs]
    worst = max(abs(float(R) - s) for R, s in zip(Rs, singles))
    times, ms = host_median_ms(many)
    emit({"phase": "grid", "path": f"grid1024_f32_many{GRID_PAIRS}",
          "pairs": len(pairs), "R": [float(R) for R in Rs],
          "max_residual": float(res.max()), "launches_per_solve": counts,
          "worst_vs_single": worst, "ms_reps": times, "median_ms": ms})
    check(bool((res <= 1e-6).all()), f"many pairs: residual "
          f"{float(res.max()):.3e}")
    check(worst <= 1e-5, f"many pairs: {worst:.3e} from the single solves")
    check(all(v > 0 for k, v in launches.items()),
          f"a stencil kernel never launched on the grid paths: {launches}")

    rhs, idx, pa, pb = grid._probe_fields(n, n, pairs, torch.float32, "cuda")
    _, info = grid.grid_solve(n, n, rhs, tol=1e-6, device="cuda")
    counts = fused_grid_run(
        grid, fc, f"grid1024_f32_many{GRID_PAIRS}", n, rhs, torch.float32,
        1e-6, lambda x: x.reshape(len(pairs), n * n)[idx, pa]
        - x.reshape(len(pairs), n * n)[idx, pb], Rs, info.iterations)
    for k, v in counts.items():
        fused[k] += v
    return launches, fused


# Kernel names in the trace of each stencil and fused CG wrapper's
# launches (the mean projection's first pass, ``mean_partials``, shares its
# launch with ``subtract_mean``).
GRID_TRACE_NAMES = {
    "jacobi_sweeps": ("jacobi_tiled", "jacobi_block", "jacobi_cluster"),
    "presmooth_restrict": ("presmooth_restrict_strip",),
    "prolong_postsmooth": ("prolong_postsmooth_strip",),
    "vcycle": ("vcycle_block", "subtract_mean", "vcycle_cluster"),
    "vcycle_cluster": ("vcycle_cluster",),
    "jacobi_cluster": ("jacobi_cluster",),
    "stencil_partials": ("stencil_partials_strip",),
    "update_partials": ("update_partials_tiled",),
}


def split_trace(events, labels):
    """The kernel events and host syncs of each ``record_function`` span in
    ``labels``.  A kernel belongs to the span in which the host launched it
    (its launch call shares its ``correlation``), so the device clock's skew
    cannot move it into a neighbouring span."""
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in labels}
    check(len(spans) == len(labels), f"grid profile: spans {sorted(spans)} "
          f"in the trace, expected {labels}")
    kernels = {label: [] for label in labels}
    syncs = dict.fromkeys(labels, 0)
    for e in events:
        if e.get("cat") == "kernel":
            t = launched.get(e.get("args", {}).get("correlation"), e["ts"])
        elif (e.get("cat") == "cpu_op"
              and e.get("name") == "aten::_local_scalar_dense"):
            t = e["ts"]
        else:
            continue
        label = next((k for k, (t0, t1) in spans.items() if t0 <= t <= t1),
                     None)
        if label is None:
            continue
        if e.get("cat") == "kernel":
            kernels[label].append(e)
        else:
            syncs[label] += 1
    return kernels, syncs


def trace_grid_solves(solve, st, fc):
    """One ``torch.profiler`` session of ``GRID_PROFILE_SOLVES`` + 1 calls
    of ``solve`` (a grid solve returning ``(_, SolveInfo)``), each in its
    own ``record_function`` span; the first is a lead-in whose span is not
    read.  Returns the trace's events, the span labels read and each span's
    wrapper launches and CG iterations."""
    from torch.profiler import ProfilerActivity, profile, record_function

    labels = [f"grid_solve_{k}" for k in range(GRID_PROFILE_SOLVES + 1)]
    launches, its = {}, {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label in labels:
            reset_grid_counts(st)
            reset_fused_counts(fc)
            with record_function(label):
                _, info = solve()
                torch.cuda.synchronize()
            launches[label] = {**grid_launch_counts(st),
                               **fused_launch_counts(fc)}
            its[label] = int(info.iterations)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return events, labels[1:], launches, its


def read_grid_trace(events, labels, launches):
    """Each span's kernels summarised, or the reason the trace is not
    whole: a span whose stencil and fused CG kernels by name differ from
    the wrappers' launches in it, or spans that traced different
    kernels."""
    kernels, syncs = split_trace(events, labels)
    kinds = {"stencil_partials": ("stencil_partials_strip",),
             "update_partials": ("update_partials_tiled",),
             "vcycle_cluster": ("vcycle_cluster",),
             "vcycle_block": ("vcycle_block",),
             "presmooth_restrict": ("presmooth_restrict",),
             "prolong_postsmooth": ("prolong_postsmooth",),
             "jacobi": ("jacobi",),
             "mean_projection": ("mean_partials", "subtract_mean"),
             "reductions": ("reduce", "sum", "mean"),
             "padding (matvec)": ("pad", "replication")}
    solves = []
    for label in labels:
        ks = kernels[label]
        if not ks:
            return None, f"no kernel in {label}"
        names = {}
        for e in ks:
            names[e["name"]] = names.get(e["name"], 0) + 1
        traced = {w: sum(v for name, v in names.items()
                         if any(key in name for key in keys))
                  for w, keys in GRID_TRACE_NAMES.items()}
        if traced != launches[label]:
            return None, (f"{label} traced {traced} grid kernels, the "
                          f"wrappers launched {launches[label]}")
        by_kind = {}
        for e in ks:
            name = e["name"].lower()
            kind = next((k for k, keys in kinds.items()
                         if any(key in name for key in keys)), "elementwise")
            by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1e3
        busy = sum(e["dur"] for e in ks) / 1e3
        window = (max(e["ts"] + e["dur"] for e in ks)
                  - min(e["ts"] for e in ks)) / 1e3
        solves.append({"kernels": len(ks), "names": names, "device_ms": busy,
                       "window_ms": window, "by_kind": by_kind,
                       "idle": max(0.0, 1.0 - busy / window),
                       "syncs": syncs[label]})
    for key in ("kernels", "syncs"):
        if len({s[key] for s in solves}) > 1:
            differ = {name: [s["names"].get(name, 0) for s in solves]
                      for name in set().union(*(s["names"] for s in solves))}
            return None, (f"the spans traced {[s[key] for s in solves]} "
                          f"{key}; kernels by name " + str(
                              {k: v for k, v in differ.items()
                               if len(set(v)) > 1}))
    return solves, None


def phase_grid_profile(grid, st, fc, fused: bool):
    """Device kernel time of the 1024² f32 knight's-move solve by kind,
    through the plain CG loop or with ``fused`` through the fused one, from
    a ``torch.profiler`` trace of ``GRID_PROFILE_SOLVES`` solves after a
    lead-in solve: the device's idle share of each solve's window, launches
    and host syncs per CG iteration.  A trace is read only when it is
    whole: in each solve the stencil and fused CG kernels by name equal the
    wrappers' launches, and every solve traced the same kernels and host
    syncs.  A trace that is not whole is reported and taken again, up to
    ``GRID_PROFILE_TRIES`` times."""
    n = 1024
    a, b = knight_probes(n)
    path = "grid1024_f32_fused" if fused else "grid1024_f32"
    if fused:
        rhs = torch.zeros(n, n, device="cuda")
        rhs[a] += 1.0
        rhs[b] -= 1.0
        solve = functools.partial(grid.grid_solve, n, n, rhs, tol=1e-6,
                                  fused_cg=True, device="cuda")
    else:
        solve = functools.partial(grid.grid_equivalent_resistance, n, n, a,
                                  b, tol=1e-6, device="cuda")
    dropped = []
    for _ in range(GRID_PROFILE_TRIES):
        events, labels, launches, its = trace_grid_solves(solve, st, fc)
        check(len(set(its.values())) == 1,
              f"grid profile: iterations {its} differ")
        solves, why = read_grid_trace(events, labels, launches)
        if solves is not None:
            break
        dropped.append(why)
        emit({"phase": "profile", "path": path, "trace_not_whole": why})
    check(solves is not None, f"grid profile: no whole trace in "
          f"{GRID_PROFILE_TRIES} tries: {dropped}")
    its = its[labels[0]]
    first = solves[0]
    emit({"phase": "profile", "path": path, "iterations": its,
          "solves": len(solves), "traces_not_whole": len(dropped),
          "device_ms": [s["device_ms"] for s in solves],
          "window_ms": [s["window_ms"] for s in solves],
          "kernels": first["kernels"],
          "kernels_per_iteration": first["kernels"] / its,
          "launches": launches[labels[0]],
          "host_syncs": first["syncs"],
          "host_syncs_per_iteration": first["syncs"] / its,
          "ms_by_kind": dict(sorted(first["by_kind"].items(),
                                    key=lambda kv: -kv[1])),
          "device_idle_share": [s["idle"] for s in solves]})


def chain_scale(stamps, params: np.ndarray, x: np.ndarray,
                lam: np.ndarray) -> np.ndarray:
    """S_k per sample [B, P]: Σ_e |∂v_e/∂p_k| times ‖λ‖∞·‖x‖∞ over the G
    entries and ‖λ‖∞ over the RHS entries, the magnitude of the adjoint's
    chain rule for parameter k (``ADJOINT_BATCH``'s comment)."""
    from nodal_tpu_torch.models.stamps import _INV, _LIN

    def factor(v, e):
        with np.errstate(divide="ignore"):
            inv = 1.0 / np.where(e == _INV, v, 1.0)
        return (np.where(e == _LIN, v, np.where(e == _INV, inv, 1.0)),
                np.where(e == _LIN, 1.0,
                         np.where(e == _INV, -inv * inv, 0.0)))

    out = np.zeros_like(params)
    for k, p in enumerate(params):
        nl, nx = np.abs(lam[k]).max(), np.abs(x[k]).max()
        for coeff, p1, e1, p2, e2, mag in (
                (stamps.g_coeff, stamps.g_p1, stamps.g_e1, stamps.g_p2,
                 stamps.g_e2, nl * nx),
                (stamps.rhs_coeff, stamps.rhs_p1, stamps.rhs_e1,
                 stamps.rhs_p2, stamps.rhs_e2, nl)):
            f1, d1 = factor(p[p1], e1)
            f2, d2 = factor(p[p2], e2)
            np.add.at(out[k], p1, np.abs(coeff * d1 * f2) * mag)
            np.add.at(out[k], p2, np.abs(coeff * f1 * d2) * mag)
    return out


def loss_grad(solver, params_np, w, device):
    """(x, ∂Σ w·x/∂p) through ``solver`` for params on ``device``."""
    p = torch.tensor(params_np, dtype=solver.dtype, device=device,
                     requires_grad=True)
    x = solver(p)
    (w.to(device=device, dtype=x.dtype) * x).sum().backward()
    return x.detach(), p.grad


def phase_adjoint():
    """``backward()`` through each tier's solver on its smoke circuit at
    ``ADJOINT_BATCH``, in f32 ``auto`` (the main path) and raw f64: the
    card's gradient against the same solver's on the CPU and a dense f64
    autograd oracle (``assemble_dense`` + ``torch.linalg.solve``) within
    the bound of ``chain_scale``, the tier's kernel wrappers launched in
    the backward pass (none on ``dense``), and backward time against
    forward time (host clock, median of 5).  Returns each wrapper's
    backward launches summed over the tiers."""
    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist
    from nodal_tpu_torch.ops import block_thomas, lu, pcr, sband
    from nodal_tpu_torch.ops.assemble import assemble_dense
    from nodal_tpu_torch.utils.gridgen import ladder_rows

    sb, bt = (sband.sband_solve_multi,), (block_thomas.band_solve_multi,)
    lus = (lu.lu_factor, lu.lu_solve_factored)
    wrappers = (pcr.pcr_solve, *sb, *bt, *lus)
    tiers = [("ladder", ladder_rows(LADDER_RUNGS), "tridiag",
              (pcr.pcr_solve,)),
             ("mesh", mesh_rows(MESH_NODES), "sband", sb),
             ("branch", mesh_rows(MESH_NODES, branch=True), "schur", sb),
             ("lattice", lattice_rows(20, 10, 10), "band", bt),
             ("widebranch", grid_circuit_rows(64, 64, branch=True), "schur",
              bt),
             ("randnet", randnet_rows(), "block", lus),
             ("randbranch", randnet_rows(branch=True), "schur", lus),
             ("opchain", opchain_rows(OPCHAIN_STAGES), "dense", ())]
    backward_launches = dict.fromkeys((w.__name__ for w in wrappers), 0)
    for label, rows, method, kernels in tiers:
        circuit = Circuit(Netlist.from_rows(rows))
        stamps = circuit.stamps
        params_np = sweep_params(circuit, ADJOINT_BATCH).astype(np.float64)
        w = torch.as_tensor(np.random.default_rng(7).standard_normal(
            (ADJOINT_BATCH, stamps.n)))
        # The f64 oracle and the truth the bound is taken at.
        p64 = torch.tensor(params_np, device="cuda", requires_grad=True)
        G, b = assemble_dense(stamps, p64)
        x_true = torch.linalg.solve(G, b)
        (w.cuda() * x_true).sum().backward()
        g_true = p64.grad.cpu().numpy()
        lam_true = torch.linalg.solve(G.detach().transpose(1, 2), w.cuda())
        scale = chain_scale(stamps, params_np, x_true.detach().cpu().numpy(),
                            lam_true.cpu().numpy())
        del G, b, x_true, lam_true, p64
        for refine, dtype in (("auto", torch.float32),
                              (False, torch.float64)):
            solver = BatchedSolver(circuit, dtype=dtype, refine=refine,
                                   device="cuda")
            check(solver.method == method,
                  f"adjoint {label}: method {solver.method}")
            p = torch.tensor(params_np, dtype=dtype, device="cuda",
                             requires_grad=True)
            loss = (w.cuda().to(torch.float64) * solver(p)).sum()
            torch.cuda.synchronize()
            for wr in wrappers:
                wr.launches = 0
            loss.backward()
            torch.cuda.synchronize()
            launched = {wr.__name__: wr.launches for wr in wrappers}
            for k, v in launched.items():
                backward_launches[k] += v
            g = p.grad.double().cpu().numpy()
            _, g_cpu = loss_grad(BatchedSolver(
                circuit, dtype=dtype, refine=refine, device="cpu"),
                params_np, w, "cpu")
            g_cpu = g_cpu.double().numpy()
            tol = (ADJOINT_F64_TOL if dtype == torch.float64 else
                   2 * CONTRACT_TOL + np.finfo(np.float32).eps) * scale
            err_true = float((np.abs(g - g_true) / tol).max())
            err_cpu = float((np.abs(g - g_cpu) / (2 * tol)).max())

            def backward_once():
                q = torch.tensor(params_np, dtype=dtype, device="cuda",
                                 requires_grad=True)
                out = (w.cuda().to(torch.float64) * solver(q)).sum()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out.backward()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            backward_once()
            bwd = [backward_once() for _ in range(5)]
            _, fwd_ms = host_median_ms(functools.partial(
                solver, torch.as_tensor(params_np, dtype=dtype,
                                        device="cuda")))
            emit({"phase": "adjoint", "path": label, "method": method,
                  "refine": refine, "dtype": str(dtype), "B": ADJOINT_BATCH,
                  "n": stamps.n, "params": len(stamps.params),
                  "err_vs_oracle_over_bound": err_true,
                  "err_vs_cpu_over_bound": err_cpu,
                  "max_rel_vs_oracle": float(np.abs(g - g_true).max()
                                             / np.abs(g_true).max()),
                  "backward_launches": launched,
                  "backward_ms": statistics.median(bwd),
                  "backward_ms_reps": bwd, "forward_ms": fwd_ms})
            check(bool(np.isfinite(g).all()),
                  f"adjoint {label} {refine}: non-finite gradient")
            check(err_true <= 1.0, f"adjoint {label} {refine}: "
                  f"{err_true:.3e} of the bound from the f64 oracle")
            check(err_cpu <= 1.0, f"adjoint {label} {refine}: "
                  f"{err_cpu:.3e} of twice the bound from the CPU gradient")
            check(all(launched[k.__name__] > 0 for k in kernels)
                  if kernels else not any(launched.values()),
                  f"adjoint {label} {refine}: backward launched {launched}")
            del solver, p, loss
            torch.cuda.empty_cache()
    return backward_launches


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
        from nodal_tpu_torch.ops import (band, block_lu, block_thomas,
                                         fused_cg, grid, lu, pcr, sband,
                                         scalar_band, stencil, tridiag)
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

    def clock(after: str) -> None:
        """Seconds since the build started, at the end of a stage."""
        emit({"phase": "clock", "after": after,
              "seconds": time.perf_counter() - t0})

    kernels.load_library()
    emit({"phase": "build", "library": kernels.library_path().name,
          "seconds": time.perf_counter() - t0})
    phase_resources(kernels.library_path())

    worst, timing = phase_kernels(pcr, tridiag)
    sb_worst, sb_timing = phase_sband_kernel(sband, scalar_band)
    bt_worst, bt_timing = phase_band_kernel(block_thomas, band)
    lu_worst, lu_timing = phase_lu_kernel(lu, block_lu)
    emit({"phase": "kernel_check_worst",
          "pcr_solve": {str(k): v for k, v in worst.items()},
          "sband_solve": {str(k): v for k, v in sb_worst.items()},
          "band_solve": {str(k): v for k, v in bt_worst.items()},
          "lu_solve": {str(k): v for k, v in lu_worst.items()}})
    clock("solver kernels")
    launches = phase_path("ladder", ladder_rows(LADDER_RUNGS), BATCH,
                          "tridiag", (pcr.pcr_solve,), ("auto", False))
    sb = (sband.sband_solve_multi,)
    sb_launches = phase_path("mesh", mesh_rows(MESH_NODES), BATCH, "sband",
                             sb, ("auto", False))
    for n_nodes in MIDSIZE_NODES:
        sb_launches += phase_path(f"midsize{n_nodes}", mesh_rows(n_nodes),
                                  MIDSIZE_BATCH, "sband", sb, ("auto",))
    sb_launches += phase_path(
        "branch", mesh_rows(MESH_NODES, branch=True), BATCH, "schur",
        sb, ("auto", False),
        functools.partial(branch_check, kernel=sband.sband_solve_multi))
    bt = (block_thomas.band_solve_multi,)
    bt_launches = phase_path("lattice", lattice_rows(20, 10, 10),
                             GENERAL_BATCH, "band", bt, ("auto", False))
    bt_launches += phase_path("widemesh", grid_circuit_rows(100, 100),
                              MIDSIZE_BATCH, "band", bt, ("auto", False))
    bt_launches += phase_path("widelattice", lattice_rows(12, 14, 14),
                              MIDSIZE_BATCH, "band", bt, ("auto", False))
    bt_launches += phase_path(
        "widebranch", grid_circuit_rows(64, 64, branch=True), GENERAL_BATCH,
        "schur", bt, ("auto", False),
        functools.partial(branch_check, kernel=block_thomas.band_solve_multi))
    lus = (lu.lu_factor, lu.lu_solve_factored)
    lu_launches = phase_path("randnet", randnet_rows(), GENERAL_BATCH,
                             "block", lus, ("auto", False))
    lu_launches += phase_path(
        "randnet4k", randnet_rows(RANDNET4K_NODES, RANDNET4K_EDGES),
        RANDNET4K_BATCH, "block", lus, ("auto", False))
    lu_launches += phase_path(
        "randbranch", randnet_rows(branch=True), GENERAL_BATCH, "schur",
        lus, ("auto", False),
        functools.partial(branch_check, kernel=lu.lu_solve_factored))
    phase_path("opchain", opchain_rows(OPCHAIN_STAGES), BATCH, "dense", None,
               ("auto", False))
    clock("sweep paths")
    phase_band_accuracy("lattice", lattice_rows(20, 10, 10), GENERAL_BATCH)
    phase_band_accuracy("widemesh", grid_circuit_rows(100, 100),
                        MIDSIZE_BATCH)
    ops = (pcr, sband, block_thomas, lu)
    phase_profile("mesh", mesh_rows(MESH_NODES), BATCH, ops)
    phase_profile("midsize5000", mesh_rows(MIDSIZE_NODES[0]), MIDSIZE_BATCH,
                  ops)
    phase_profile("lattice", lattice_rows(20, 10, 10), GENERAL_BATCH, ops)
    phase_profile("randnet", randnet_rows(), GENERAL_BATCH, ops)
    clock("sweep accuracy and profiles")
    st_worst, st_timing = phase_stencil_kernels(stencil)
    emit({"phase": "kernel_check_worst",
          "stencil": {f"{k[0]} {k[1]}": v for k, v in st_worst.items()}})
    st_timing.update(phase_cluster_kernels(stencil))
    clock("stencil kernels")
    fc_worst, fc_timing = phase_fused_cg_kernels(fused_cg)
    emit({"phase": "kernel_check_worst",
          "fused_cg": {f"{k[0]} {k[1]}": v for k, v in fc_worst.items()}})
    clock("fused CG kernels")
    st_launches, fc_launches = phase_grid(grid, stencil, fused_cg)
    clock("grid paths")
    phase_grid_profile(grid, stencil, fused_cg, fused=False)
    phase_grid_profile(grid, stencil, fused_cg, fused=True)
    clock("grid profiles")
    bwd_launches = phase_adjoint()
    emit({"phase": "adjoint_launches", "backward": bwd_launches})
    clock("adjoint")

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
        kernel_entry("lu_solve", "nodal_tpu_torch/csrc/block_lu.cu",
                     "nodal_tpu/ops/pallas_block_lu.py:345 and "
                     "nodal_tpu/ops/pallas_block_lu.py:408", lu_launches,
                     lu_timing[(GENERAL_BATCH, 1024, 1, torch.float32)]),
        *(kernel_entry(name, "nodal_tpu_torch/csrc/stencil.cu",
                       f"nodal_tpu/ops/pallas_stencil.py:{line}",
                       st_launches[name],
                       st_timing[(name, (1, 1024, 1024), torch.float32)])
          for name, line in (("jacobi_sweeps", 137),
                             ("presmooth_restrict", 211),
                             ("prolong_postsmooth", 286),
                             ("vcycle", 380))),
        kernel_entry("vcycle_cluster", "nodal_tpu_torch/csrc/stencil.cu",
                     "nodal_tpu/ops/pallas_stencil.py:380",
                     st_launches["vcycle_cluster"],
                     st_timing[("vcycle_cluster", CLUSTER_VCYCLE_ENTRY,
                                torch.float32)]),
        kernel_entry("jacobi_cluster", "nodal_tpu_torch/csrc/stencil.cu",
                     "nodal_tpu/ops/pallas_stencil.py:137",
                     st_launches["jacobi_cluster"],
                     st_timing[("jacobi_cluster", (1, 511, 511),
                                torch.float32)]),
        *(kernel_entry(name, "nodal_tpu_torch/csrc/cg.cu",
                       f"nodal_tpu/ops/pallas_cg.py:{line}",
                       fc_launches[name],
                       fc_timing[(name, (1, 1024, 1024), torch.float32)])
          for name, line in (("stencil_partials", 47),
                             ("update_partials", 94))),
    ]})
    check("jax" not in sys.modules, "jax was imported")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
