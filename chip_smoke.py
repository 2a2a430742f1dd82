"""Smoke test of nodal_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nodal_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card (the block Thomas's kept
elimination and its substitution against a fresh solve, bit for bit, and
the substitution timed beside its byte bound), then drives each main path
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
Then the adjoint: ``backward()`` through each tier's solver on the card
against the same solver's gradient on the CPU and a dense f64 autograd
oracle, with the tier's kernel launched in the backward pass.  Last, the
user-facing analysis:

* ``Circuit.solve()`` on the card (BASELINE configs 1–3 and the other
  example netlists, f64 and f32) against the port on the CPU and a numpy
  f64 dense solve, ``examples/unconnected_*.csv``, and the band route's
  single solves (the 100×100 mesh and the 20×10×10 lattice: one
  block-Thomas host loop a solve at B = 1) against scipy's sparse LU, with
  each solve's latency on the card and on the CPU and the band solves'
  device time by kernel name;
* both command lines (``solver_cli``, ``equiv_cli``) on the card against
  ``--device cpu``;
* ``monte_carlo``: BASELINE config 4 (10,000 samples of the 256-node
  ladder, every resistor at 5 %, the PCR kernel) against ``_mc_run`` on
  the CPU with the same draws, and the mesh and branch sweeps at 4096
  samples (scalar-band kernel), each bit for bit by seed, with its f64
  audit and solves/s;
* ``sensitivities`` on the ladder, mesh, branch and 1.6.1 circuits against
  the CPU and central differences, the tier's kernel launched by the
  adjoint.

Then the sparse slice: ``equivalent_resistance_many`` with 64 probe pairs
on the 100×100 mesh and the 20×10×10 lattice (the block-Thomas kernel at
(1, nb, 128, 64), a shape the kernel check holds) and on the 1000-node
random network (the dense route), each against the CPU's skyline LDLᵀ;
the 1000×1000 grid netlist (1M nodes) through the native parser and
``equivalent_resistance_stamps`` (AMG-CG on the card) against the
matrix-free grid solve; a 40,000-node random network through
``Circuit(sparse=True)`` (Jacobi-CG) and AMG-CG against a dense f64 LU on
the card, each repeated to see whether two solves agree bit for bit; and
``equiv_cli -s --native on`` on the grid's CSV and ``solver_cli -s`` on the
card against ``--device cpu``.  The skyline and the native parser are
built with ``g++`` from ``nodal_tpu_torch/cpp``; a phase fails if either
does not build.  Then the general sparse backend (ideal-source reduction
and bordered elimination, f64 AMG-CG and the Schur LU on the card): the
JAX package's bench circuits at their default sizes (40k- and 100k-node
meshes with E, VCCS and CCCS sources, a 40k mesh with ~8.4k E's, 2500
opamp followers, a 40k mesh with 8192 VCCS border rows) through
``Circuit(sparse=True).solve()`` cold and warm, each audited in f64,
repeated bit for bit and (but the 100k mesh) held against the CPU's
route, with no host skyline and no repo kernel on the card; the adjoint
``sensitivities`` of the 40k mesh against the CPU; and ``solver_cli -s``
on every example with branch rows, the card against ``--device cpu``.

Last, the weighted grids and lattices (``phase_weighted``): the three
kernels of ``csrc/weighted_stencil.cu`` against their plain versions at
the grids' and lattices' shapes (1024², 64² at B 1024, 256² at B 64,
1000², odd and tiny grids, 128³, 12×16×16 at B 1024, an odd lattice, the
solves' coarsest levels, fields with zero-conductance edges) in f32 and
f64, then timed; the knight's-move R of the 1024² grid with a random metal
layer (f32 and f64), of the 1000² grid (125² coarsest level, one launch a
sweep), of 64² fabrics at B = 1024 and 256² at B = 64, of the 128³ and
12×16×16 (B = 1024) lattices through the user's entry points, each with
its iterations, launches and host ms, three batched samples against
single solves; the g = 1 grid against ``grid_equivalent_resistance``, the
card against the CPU route at 256² and 16×32×32 in f64, dR/dgx at 1024²
against central differences, and a profile of the 1024² f32 solve.

Then the multi-device slice (``phase_parallel``) on a one-rank NCCL job
(``multihost.initialize`` over TCP on this host, ``global_mesh()``): the
ladder, mesh and branch sweeps at B = 16384 and the lattice and random
network at B = 1024 through ``make_sharded_batch_solver``, each block
against the unsharded tier on the same rows (bits) with the tier's
kernel launched, both timed; ``refine=True`` on the mesh; ``backward()``
through the sharded ladder and mesh; the 1024² grid's knight's-move
probes (f32, f64) through ``make_sharded_grid_solver`` (``grid_solve``'s
bits) and ``make_halo_grid_solver`` (its NCCL all-reduces and
all-gathers, no more CG iterations than ``grid_solve``, R within 5e-3 of
0.7732), the plain halo CG at 64²; then ``dryrun_multichip(1)``.

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

import contextlib
import functools
import json
import logging
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
# (n, B): the last is the ladder of BASELINE config 4's Monte Carlo, 10,000
# samples of 256 nodes.
KERNEL_SHAPES = [(n, b) for n in (1, 2, 3, 1000, 1024, 2048, 4097)
                 for b in (1, 7, BATCH)] + [(20000, 8), (256, 10_000)]

MESH_ROWS = 25              # the JAX package bench's meshes are 25 rows tall
MESH_NODES = 1000
MIDSIZE_NODES = (5000, 10000)
MIDSIZE_BATCH = 256         # bench.py --midsize-batch default
MC_SUB_SAMPLES = 4096       # bench.py --mc-sub-samples default
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
# (W1 + n_rhs <= 32) and its shared-memory variant; then a band without
# couplings (w = 0); the last four are the mesh's (n_rhs 1) and the branch
# circuit's (n_rhs 3) shapes in phase_monte_carlo (MC_SUB_SAMPLES) and
# phase_sensitivities (B = 1).
SBAND_SHAPES = [
    (1, 1, 1, 1), (7, 1, 56, 3), (256, 8, 8, 1), (7, 8, 1, 126),
    (256, 999, 26, 1), (256, 999, 26, 3), (7, 999, 56, 71),
    (1, 999, 8, 119), (BATCH, 999, 26, 1), (BATCH, 1000, 26, 3),
    (256, 5000, 26, 1), (7, 5000, 8, 3), (1, 5000, 1, 1),
    (256, 5000, 56, 3), (7, 16384, 26, 3), (1, 16384, 56, 71),
    (7, 16384, 1, 126), (7, 999, 30, 1), (7, 999, 31, 1), (7, 999, 3, 28),
    (7, 999, 0, 3), (MC_SUB_SAMPLES, 1000, 26, 1),
    (MC_SUB_SAMPLES, 1000, 26, 3), (1, 1000, 26, 1), (1, 1000, 26, 3),
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
# than the grid (the lattice shape walks the batch in four waves); then
# phase_circuit's single solves of the 100×100 mesh and the 20×10×10
# lattice, and phase_equiv_many's 64 probe pairs of the same two (k = 64
# is above APPLY_R = 4: the five-launch path).
BAND_SHAPES = [
    (1, 1, 128, 1), (7, 2, 128, 3), (GENERAL_BATCH, 16, 128, 1),
    (MIDSIZE_BATCH, 79, 128, 1), (GENERAL_BATCH, 32, 128, 3),
    (7, 16, 128, 128), (2, 300, 128, 1), (MIDSIZE_BATCH, 10, 256, 1),
    (7, 4, 256, 3), (1, 2, 256, 128), (7, 3, 384, 1), (1, 8, 384, 128),
    (3, 4, 128, 130), (1, 79, 128, 1), (1, 16, 128, 1),
    (1, 79, 128, 64), (1, 16, 128, 64),
]
BAND_TIME_SHAPES = [(GENERAL_BATCH, 16, 128, 1), (MIDSIZE_BATCH, 79, 128, 1),
                    (MIDSIZE_BATCH, 10, 256, 1)]
# (B, nb, 128, r <= APPLY_R): the kept elimination and its substitution
# at the lattice's and the 100×100 mesh's shapes, one and two block rows,
# every r, one system.
BAND_SUBST_SHAPES = [
    (GENERAL_BATCH, 16, 128, 1), (MIDSIZE_BATCH, 79, 128, 1),
    (5, 1, 128, 1), (7, 2, 128, 4), (3, 16, 128, 3), (1, 79, 128, 2),
]

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

# The single solve (BASELINE configs 1–3): these example netlists through
# Circuit.solve() on the card, in f64 within CIRCUIT_F64_RTOL of max|x| of
# the port on the CPU and of a numpy f64 dense solve (two pivoted LUs,
# cuSOLVER and LAPACK, on systems of condition up to ~1e12 for the OPMODEL
# circuits: ~1e-16·κ at worst, under 1e-10 as the JAX package's goldens
# have it); in f32 each answer's residual under Circuit's own f32 gate.
CIRCUIT_EXAMPLES = ("netlist.csv", "1.6.1.csv", "opmodel_amplifier.csv",
                    "opmodel_voltage_buffer.csv", "divider.csv",
                    "buffer.csv")
CIRCUIT_F64_RTOL = 1e-10
# The band route's single solves against scipy's sparse LU (both f64 direct
# solves of systems with κ up to ~1e5): 1e-9 of max|x|.
BAND_SOLVE_RTOL = 1e-9
# The CLIs on the card and on the CPU: the same lines, values within this
# much of the largest printed value.
CLI_RTOL = 1e-12
# BASELINE config 4: a Monte Carlo of 10,000 samples of the 256-node ladder,
# every resistor at 5 %, f32 refine="auto", seeds 1–3 after a warm-up with
# seed 0 (bench.py:bench_monte_carlo); the mesh and branch circuits at
# 4096 samples (bench.py --mc-sub-samples).  The card's mean and std are
# held to _mc_run on the CPU with the same draws within MC_CPU_TOL of
# max|mean|: both inside the 1e-6 contract of the f64 answer.
MC_RUNGS = 256
MC_SAMPLES = 10_000
MC_SEEDS = (1, 2, 3)
MC_CPU_TOL = 1e-6
# Sensitivities: the card against the CPU within SENS_CPU_TOL of the
# largest |entry| (two f64 solves and adjoints), and against central
# differences of the card's own raw f64 solve (step SENS_FD_STEP relative)
# on its three largest entries within SENS_FD_TOL of the largest |entry|
# (truncation ~h² ≈ 1e-10; the solve's own error over h, ~1e-13·κ/h,
# up to ~1e-8 on the mesh).
SENS_CPU_TOL = 1e-9
SENS_FD_STEP = 1e-5
SENS_FD_TOL = 1e-6
# equivalent_resistance_many: 64 probe pairs of each netlist's own nodes
# (default_rng(0)); every resistance on the card within EQUIV_RTOL of the
# CPU's skyline LDLᵀ (both f64 direct solves: ~κ·ε) and of single
# equivalent_resistance calls on the first EQUIV_SINGLE pairs.
EQUIV_PAIRS = 64
EQUIV_SINGLE = 4
EQUIV_RTOL = 1e-9
# The resistive sparse backend at its users' scale: the 1000×1000 grid
# netlist (1M nodes, ~2M resistors) through the native parser and
# equivalent_resistance_stamps (AMG-CG at its tol 1e-9), R within
# SPARSE_GRID_RTOL of the matrix-free grid solve at tol 1e-10 (the check
# of tests/test_amg.py at 50²); and a 40,000-node random network, Jacobi-
# and AMG-CG at tol 1e-10 within RANDNET40K_RTOL of max|x| of a pivoted
# dense f64 LU of the same system on the card.
SPARSE_GRID = 1000
SPARSE_GRID_RTOL = 1e-6
RANDNET40K_NODES, RANDNET40K_EDGES = 40000, 160000
RANDNET40K_RTOL = 1e-8
# A CLI line that ends in a CG solve on the card and on the CPU: both stop
# at ||r|| <= 1e-9·||b||, with sums rounded in other orders, so their R
# may differ by up to the solve's tolerance.  So does -s on a circuit with
# branch rows: the card's A11 solves are CG, the CPU's the skyline LDLᵀ,
# each refined to a relative residual of 1e-10, so their x may differ by
# up to the system's condition number times that.
CLI_CG_RTOL = 1e-9
# The general sparse backend (Circuit(sparse=True) on circuits with branch
# rows): the JAX package's bench stages at their default sizes, nothing
# cut (bench.py:358-578).  Each solve's f64 COO residual at most
# GENERAL_AUDIT_TOL (the solves target 1e-10), x within the given share
# of max|x| of the port's own device="cpu" route (the κ ≈ 1e12 opamp
# chain 1e-6, the bound of tests/test_sparse_schur.py:166-168), None
# where the audit stands alone; sensitivities of GENERAL_SENS_CONFIG on
# the card within GENERAL_SENS_RTOL of the largest |entry| on the CPU.
GENERAL_AUDIT_TOL = 1e-9
GENERAL_CONFIGS = (("sparse40k", 1e-8), ("sparse100k", None),
                   ("ebig", 1e-8), ("opmodel", 1e-6),
                   ("vccs_border", 1e-8))
GENERAL_SENS_CONFIG = "sparse40k"
GENERAL_SENS_RTOL = 1e-7
#: The examples with branch rows, whose -s runs the bordered elimination.
BRANCH_EXAMPLES = ("1.6.1.csv", "all_components.csv", "buffer.csv",
                   "opamp_amplifier.csv", "opmodel_amplifier.csv",
                   "opmodel_voltage_buffer.csv", "test_1.csv",
                   "unconnected_0.csv", "unconnected_1.csv")

# The weighted grids and lattices (phase_weighted).  Kernel-check shapes
# [B, d, h, w] (a grid is d = 1): the 1024² metal layer, fabrics of
# 64² (B 1024) and 256² (B 64), the 1000² grid (125² coarsest), odd and
# tiny grids; the 128³ lattice, the 12×16×16 bench lattice at B 1024, an
# odd lattice.  The coarsest levels of the solves go through the block
# kernel too.
WEIGHTED_SHAPES = [(1, 1, 1024, 1024), (1024, 1, 64, 64), (64, 1, 256, 256),
                   (1, 1, 1000, 1000), (3, 1, 17, 33), (2, 1, 8, 8),
                   (1, 128, 128, 128), (1024, 12, 16, 16), (2, 5, 7, 9)]
WEIGHTED_BLOCK_SHAPES = [(1024, 1, 8, 8), (64, 1, 8, 8), (1, 8, 8, 8),
                         (1024, 6, 8, 8)]
# Fields with about a fifth of their edges at zero conductance and isolated
# nodes (deg = 0, x = r = 0 there: ω / max(deg, tiny) · 0 must stay 0).
WEIGHTED_ZERO_SHAPES = [(2, 1, 64, 64), (2, 4, 16, 16)]
WEIGHTED_SWEEPS = (1, 2, 96)
# A sweep and a residual equal their plain versions bit for bit (no FMA
# contraction); only the restriction's block sums and the mean
# projections are summed in another order.
WEIGHTED_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
WEIGHTED_G = (0.5, 2.0)     # conductances ~ U(0.5, 2.0)
# The side of BASELINE config 5's grid: the weighted metal layer of the
# wgrid1024 runs, the g = 1 identity, the gradient and the profile.
WEIGHTED_LAYER_N = 1024
WEIGHTED_TIME_SHAPE = (1, 1, 1024, 1024)
WEIGHTED_BLOCK_TIME_SHAPE = (1024, 1, 8, 8)   # fabric64's coarsest level
# Solves: (label, dims, batch, dtype, tol).  Probes: the knight's move of
# bench.py:595 about the centre of the single grid or lattice, corner to
# corner on the batched fabrics and lattices.  fabric256 runs at tol 1e-5:
# f32 CG stalls near 1e-6 on a 256² fabric corner to corner, in the JAX
# package as in the port (2 of 3 and 1 of 3 samples at 300 iterations on
# the CPU).
WEIGHTED_RUNS = [
    ("wgrid1024_f32", (1024, 1024), 1, torch.float32, 1e-6),
    ("wgrid1024_f64", (1024, 1024), 1, torch.float64, 1e-10),
    ("wgrid1000_f32", (1000, 1000), 1, torch.float32, 1e-6),
    ("fabric64", (64, 64), 1024, torch.float32, 1e-6),
    ("fabric256", (256, 256), 64, torch.float32, 1e-5),
    ("lattice128", (128, 128, 128), 1, torch.float32, 1e-6),
    ("benchlattice", (12, 16, 16), 1024, torch.float32, 1e-6),
]
WEIGHTED_SINGLES = ("fabric64", "benchlattice")  # 3 samples each vs singles
WEIGHTED_BATCH_RTOL = 1e-4
WEIGHTED_IDENTITY_RTOL = 1e-8   # g = 1 against the uniform grid, f64
WEIGHTED_CPU_RTOL = 1e-8        # the card against the CPU route, f64
WEIGHTED_CPU_DIMS = ((256, 256), (16, 32, 32))
WEIGHTED_FD_EDGES = ((512, 512), (513, 513), (512, 511))   # gx edges
WEIGHTED_FD_STEP = 1e-4
WEIGHTED_FD_RTOL = 1e-5

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


def phase_band_subst(block_thomas, band):
    """The kept elimination (``band_factor``) and the substitution-only
    launch (``band_substitute``, kernel ``block_thomas_subst``) on the
    card: the first answer and each substitution for new right-hand sides
    against the plain solver (``band_thomas_solve``) within
    ``BAND_RTOL``, and against ``band_solve_multi`` bit for bit, the held
    factors left as they were, one launch a substitution; then, at the
    lattice's shape, the substitution's device time beside its bound
    (bytes: L_t, S_t⁻¹ and C_t read once, 3nb − 2 blocks a system), the
    full solve's and the plain substitution's (``band_thomas_substitute``),
    in turns.  Returns the timing of the f32 lattice shape, for the
    summary's ``kernels`` line."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    subst = block_thomas.band_substitute
    scratch_max = block_thomas.SCRATCH_BYTES_MAX
    # The lattice's shape keeps 4.4 GB in f64, past the default cap.
    block_thomas.SCRATCH_BYTES_MAX = 16 << 30
    try:
        for dtype in (torch.float32, torch.float64):
            for B, nb, kb, r in BAND_SUBST_SHAPES:
                W, R = random_block_band(B, nb, kb, r, dtype, gen)
                R2 = torch.randn(R.shape, generator=gen, device="cuda",
                                 dtype=dtype)
                X, f = block_thomas.band_factor(W, R)
                check(f is not None, f"band_factor kept nothing at "
                      f"{(B, nb, kb, r)} {dtype}")
                F0 = f.F.clone()
                before = subst.launches
                got = subst(f, R2)
                launches = subst.launches - before
                want = block_thomas.band_solve_multi(W, R)
                want2 = block_thomas.band_solve_multi(W, R2)
                torch.cuda.synchronize()
                same = {"factor": torch.equal(X, want),
                        "subst": torch.equal(got, want2),
                        "held": torch.equal(f.F, F0)}
                del want, want2, F0
                err = {"factor": rel_diff(
                           X.reshape(B, -1),
                           band.band_thomas_solve(W, R).reshape(B, -1)),
                       "subst": rel_diff(
                           got.reshape(B, -1),
                           band.band_thomas_solve(W, R2).reshape(B, -1))}
                emit({"phase": "kernel_check", "kernel": "band_subst",
                      "B": B, "nb": nb, "kb": kb, "r": r,
                      "dtype": str(dtype), "bit_for_bit": same,
                      "max_rel_diff": err, "tol": BAND_RTOL[dtype],
                      "launches": launches})
                check(all(same.values()), f"band_factor / band_substitute "
                      f"at {(B, nb, kb, r)} {dtype}: {same}")
                check(max(err.values()) <= BAND_RTOL[dtype],
                      f"band_factor / band_substitute differ from the "
                      f"plain solver by {err} at {(B, nb, kb, r)} {dtype}")
                check(launches == 1, f"band_substitute made {launches} "
                      f"launches at {(B, nb, kb, r)} {dtype}")
                del W, R, R2, X, f, got
                torch.cuda.empty_cache()
        timing = {}
        for dtype in (torch.float32, torch.float64):
            B, nb, kb, r = BAND_SUBST_SHAPES[0]
            W, R = random_block_band(B, nb, kb, r, dtype, gen)
            _, f = block_thomas.band_factor(W, R)
            _, plain_f = band.band_thomas_factor(W, R)
            max_abs = float((subst(f, R) - band.band_thomas_substitute(
                plain_f, R)).abs().max())
            solve = functools.partial(block_thomas.band_solve_multi, W, R)
            kernel = functools.partial(subst, f, R)
            plain = functools.partial(band.band_thomas_substitute, plain_f,
                                      R)
            before = subst.launches
            kernel()
            launches = subst.launches - before
            times = [cuda_ms(fn) for fn in (solve, kernel, kernel, solve)]
            plain_ms = [cuda_ms(plain, reps=2, warmup=1) for _ in range(2)]
            item = W.element_size()
            bound = bound_ms(B * (3 * nb - 2) * 2 * kb * kb * r,
                             (B * (3 * nb - 2) * kb * kb
                              + 2 * B * nb * kb * r) * item, dtype)
            emit({"phase": "kernel_time", "kernel": "band_subst", "B": B,
                  "nb": nb, "kb": kb, "r": r, "dtype": str(dtype),
                  "subst_ms": times[1:3], "solve_ms": [times[0], times[3]],
                  "plain_ms": plain_ms, "max_abs_err": max_abs,
                  "launches": launches, **bound})
            # No library call substitutes on a kept block elimination.
            timing[dtype] = {"ms": min(times[1:3]), "plain_ms": min(plain_ms),
                             "max_abs_err": max_abs, "library_ms": None,
                             **bound}
            del W, R, f, plain_f
            torch.cuda.empty_cache()
    finally:
        block_thomas.SCRATCH_BYTES_MAX = scratch_max
    return timing[torch.float32]


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
    ``rate_refines`` tiers.  Returns the launches of each wrapper in
    ``kernels`` over that call, by name."""
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
                block_thomas.band_solve_multi, block_thomas.band_substitute,
                lu.lu_factor, lu.lu_solve_factored)
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "last_shape"):
            w.last_shape = None
    xs = solver(params)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in kernels or ()}
    if kernels is None:
        check(all(w.launches == 0 for w in wrappers),
              f"{label}: a kernel of the repo launched on the library path")
    else:
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
    Thomas counts every kernel it launches (``kernels``); the blocked
    LU counts factorizations, ``factor_launches`` each, and solves, 4q − 2
    products each for q panels (``dense_tile.cuh:lu_solve``: two a panel
    forward but the last, two a panel backward), at their last calls'
    shapes, which every call of one path shares."""
    pcr, sband, block_thomas, lu = ops
    bt, solve = block_thomas.band_solve_multi, lu.lu_solve_factored
    out = {"pcr": pcr.pcr_solve.launches,
           "sband": sband.sband_solve_multi.launches,
           "block_thomas": 0, "block_lu": 0}
    out["block_thomas"] = bt.kernels
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
                block_thomas.band_solve_multi.kernels = 0
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


def repo_wrappers():
    """The counted wrappers of the batch and single-solve paths, by name."""
    from nodal_tpu_torch.ops import block_thomas, lu, pcr, sband

    return {w.__name__: w for w in (
        pcr.pcr_solve, sband.sband_solve_multi,
        block_thomas.band_solve_multi, lu.lu_factor, lu.lu_solve_factored)}


def counted(fn):
    """``(fn(), launches)``: every wrapper's count set to 0 just before the
    call and read just after it (the call synchronizes first)."""
    wrappers = repo_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items()}


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def sband_shape_checked(label: str) -> None:
    """The scalar-band kernel's last launch was at a shape of
    ``SBAND_SHAPES``, which phase_sband_kernel holds to the plain version
    in both dtypes."""
    from nodal_tpu_torch.ops.sband import sband_solve_multi

    B, n, W1, n_rhs = sband_solve_multi.last_shape
    check((B, n, W1 - 1, n_rhs) in SBAND_SHAPES,
          f"{label}: sband_solve_multi launched at {(B, n, W1 - 1, n_rhs)}, "
          "a shape no kernel check holds")


def numpy_system(stamps):
    """The MNA system ``(G, b)`` of the netlist's own values in numpy f64,
    straight from ``stamp_values_np`` (no torch)."""
    from nodal_tpu_torch.models.stamps import stamp_values_np

    g, r = stamp_values_np(stamps, stamps.params.astype(np.float64))
    G = np.zeros((stamps.n, stamps.n))
    np.add.at(G, (stamps.g_rows, stamps.g_cols), g)
    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, r)
    return G, b


def max_rel(x: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def cli_output(main, argv) -> str:
    """What one CLI call prints on its standard output."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def same_cli_lines(card: str, cpu: str, rtol: float = CLI_RTOL) -> float:
    """Fails unless the two outputs have the same lines but for the
    values, which must agree within ``rtol`` of the largest printed
    value; returns the worst difference over that scale."""
    cl, pl = card.splitlines(), cpu.splitlines()
    check(len(cl) == len(pl) and len(cl) > 0,
          f"CLI outputs differ in length: {card!r} / {cpu!r}")
    split = [(c.rsplit("= ", 1), p.rsplit("= ", 1)) for c, p in zip(cl, pl)]
    vals = [abs(float(p[1])) for c, p in split if len(p) == 2]
    scale = max(vals, default=1.0) or 1.0
    worst = 0.0
    for c, p in split:
        check(c[0] == p[0], f"CLI lines differ: {c[0]!r} / {p[0]!r}")
        if len(p) == 2:
            worst = max(worst, abs(float(c[1]) - float(p[1])) / scale)
    check(worst <= rtol, f"CLI values differ by {worst:.3e} of the "
          f"largest: {card!r} / {cpu!r}")
    return worst


@contextlib.contextmanager
def circuit_warnings_off():
    """Circuit.solve's accuracy warning off, for repeats of a solve whose
    first call has logged it."""
    log = logging.getLogger("nodal_tpu_torch.circuit")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield
    finally:
        log.setLevel(level)


def phase_circuit() -> dict:
    """The single solve: BASELINE configs 1–3 and the error cases through
    ``Circuit.solve()`` on the card, the band route's single solves (one
    ``band_solve_multi`` host loop a solve at B = 1) against scipy's sparse
    LU, each solve's host latency on the card and on the CPU, and both
    CLIs on the card against ``--device cpu``.  Returns the launches of
    the band route's solves."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from nodal_tpu_torch import Circuit, Netlist, UnconnectedCircuitError
    from nodal_tpu_torch import equiv_cli, solver_cli
    from nodal_tpu_torch.circuit import _RESIDUAL_TOL
    from nodal_tpu_torch.models.stamps import stamp_values_np
    from nodal_tpu_torch.ops import block_thomas
    from nodal_tpu_torch.ops.band import band_plan

    examples = ROOT / "examples"
    for name in CIRCUIT_EXAMPLES:
        path = str(examples / name)
        ref = np.linalg.solve(*numpy_system(Circuit(Netlist(path)).stamps))
        for dtype in (torch.float64, torch.float32):
            card = Circuit(Netlist(path), dtype=dtype)
            (sol, launched) = counted(card.solve)
            cpu = Circuit(Netlist(path), dtype=dtype, device="cpu").solve()
            err_ref, err_cpu = max_rel(sol.result, ref), max_rel(
                sol.result, cpu.result)
            with circuit_warnings_off():
                _, card_ms = host_median_ms(card.solve)
                _, cpu_ms = host_median_ms(Circuit(
                    Netlist(path), dtype=dtype, device="cpu").solve)
            emit({"phase": "circuit", "netlist": name, "dtype": str(dtype),
                  "n": card.stamps.n, "method": sol.stats["method"],
                  "backend": sol.stats["backend"],
                  "residual": sol.stats["residual"],
                  "rel_err_vs_numpy_f64": err_ref,
                  "rel_err_vs_cpu": err_cpu, "launches": launched,
                  "solve_ms_card": card_ms, "solve_ms_cpu": cpu_ms})
            check(sol.stats["backend"] == "cuda",
                  f"{name}: solved on {sol.stats['backend']}")
            check(not any(launched.values()),
                  f"{name}: a kernel of the repo launched on the dense "
                  f"route: {launched}")
            if dtype == torch.float64:
                check(err_ref <= CIRCUIT_F64_RTOL and
                      err_cpu <= CIRCUIT_F64_RTOL,
                      f"{name} f64: {err_ref:.3e} from numpy, {err_cpu:.3e} "
                      "from the CPU")
            else:
                check(sol.stats["residual"] <= _RESIDUAL_TOL[dtype],
                      f"{name} f32: residual {sol.stats['residual']:.3e}")
    sol = Circuit(Netlist(str(examples / "unconnected_0.csv"))).solve()
    check(abs(sol.potential("3") - 12.0 / 13.0) <= 1e-12,
          f"unconnected_0: e(3) = {sol.potential('3')}")
    try:
        Circuit(Netlist(str(examples / "unconnected_1.csv"))).solve()
        fail("unconnected_1 solved")
    except UnconnectedCircuitError:
        pass
    emit({"phase": "circuit_errors", "unconnected_0_e3": sol.potential("3"),
          "unconnected_1": "UnconnectedCircuitError"})

    bt = block_thomas.band_solve_multi
    launches = 0
    for label, rows in (("widemesh", grid_circuit_rows(100, 100)),
                        ("lattice", lattice_rows(20, 10, 10))):
        circuit = Circuit(Netlist.from_rows(rows))
        stamps, plan = circuit.stamps, band_plan(circuit.stamps)
        g, r = stamp_values_np(stamps, stamps.params.astype(np.float64))
        A = sp.coo_matrix((g, (stamps.g_rows, stamps.g_cols)),
                          shape=(stamps.n, stamps.n)).tocsc()
        b = np.zeros(stamps.n)
        np.add.at(b, stamps.rhs_rows, r)
        ref = spla.spsolve(A, b)
        bt.last_shape = None
        (sol, launched) = counted(circuit.solve)
        err = max_rel(sol.result, ref)
        solves = 1 + 5  # host_median_ms: a warm-up and 5 timed solves
        (timing, timed) = counted(lambda: host_median_ms(circuit.solve))
        cpu = Circuit(Netlist.from_rows(rows), device="cpu")
        _, cpu_ms = host_median_ms(cpu.solve)
        split = kernel_split(circuit.solve)
        emit({"phase": "circuit_band", "path": label, "n": stamps.n,
              "nb": plan.nb, "kb": plan.kb, "method": sol.stats["method"],
              "residual": sol.stats["residual"], "rel_err_vs_spsolve": err,
              "launches": launched["band_solve_multi"],
              "last_shape": bt.last_shape, "solve_ms_card": timing[1],
              "solve_ms_card_reps": timing[0], "solve_ms_cpu": cpu_ms,
              "device_ms": split["device_ms"],
              "by_kernel_ms": split["by_kernel_ms"],
              "kernels_per_solve": split["launches_per_call"]})
        check(sol.stats["method"] == "band_thomas",
              f"{label}: method {sol.stats['method']}")
        check(launched["band_solve_multi"] == 1
              and timed["band_solve_multi"] == solves,
              f"{label}: {launched} launches for one solve, {timed} for "
              f"{solves}")
        check(bt.last_shape == (1, plan.nb, plan.kb, 1)
              and bt.last_shape in BAND_SHAPES,
              f"{label}: last shape {bt.last_shape}, a kernel check's: "
              f"{bt.last_shape in BAND_SHAPES}")
        check(err <= BAND_SOLVE_RTOL, f"{label}: {err:.3e} from spsolve")
        launches += launched["band_solve_multi"]

    for main, argv in ((solver_cli.main, [str(examples / "netlist.csv")]),
                       (solver_cli.main, [str(examples / "1.6.1.csv"),
                                          "--sensitivity", "e(2)"]),
                       (solver_cli.main,
                        [str(examples / "opmodel_amplifier.csv")]),
                       (equiv_cli.main, [str(examples / "resistive_1.csv")])):
        card = cli_output(main, argv)
        cpu = cli_output(main, [*argv, "--device", "cpu"])
        worst = same_cli_lines(card, cpu)
        emit({"phase": "cli", "argv": argv, "lines": len(card.splitlines()),
              "worst_rel_diff": worst})
        if argv[0].endswith("netlist.csv"):
            check(card == "Ground node: 1\ne(2) \t= -1.0\ne(3) \t= -2.0\n",
                  f"netlist.csv printed {card!r}")
        if argv[0].endswith("resistive_1.csv"):
            check(card == "R = 2.0\n", f"resistive_1.csv printed {card!r}")
    return {"band_solve_multi": launches}


def mc_tolerances(circuit) -> dict:
    """Every resistor at ``SWEEP_SIGMA``, as bench.py's Monte Carlo."""
    return {name: SWEEP_SIGMA
            for name, comp in circuit.netlist.components.items()
            if comp.type == "R"}


def phase_monte_carlo() -> dict:
    """BASELINE config 4 and the mesh and branch sweeps through
    ``monte_carlo``: the tier's kernel launched in each timed call, the
    f64 audit under the contract, the same seed bit for bit, the exact
    audit against the fused one, and (config 4) the card's statistics
    against ``_mc_run`` on the CPU with the same draws.  Returns the
    launches of the timed calls."""
    from nodal_tpu_torch import Circuit, Netlist
    from nodal_tpu_torch.batch import _mc_run, monte_carlo
    from nodal_tpu_torch.utils.gridgen import ladder_rows

    total = {}
    for label, rows, n, method, kernel in (
            ("ladder256", ladder_rows(MC_RUNGS), MC_SAMPLES, "tridiag",
             "pcr_solve"),
            ("mesh", mesh_rows(MESH_NODES), MC_SUB_SAMPLES, "sband",
             "sband_solve_multi"),
            ("branch", mesh_rows(MESH_NODES, branch=True), MC_SUB_SAMPLES,
             "schur", "sband_solve_multi")):
        circuit = Circuit(Netlist.from_rows(rows))
        tols = mc_tolerances(circuit)
        monte_carlo(circuit, tols, n, seed=0)  # warm-up
        solver = circuit.batched_solver()
        check(solver.method == method,
              f"monte_carlo {label}: method {solver.method}")
        runs = []
        for seed in MC_SEEDS:
            t0 = time.perf_counter()
            out, launched = counted(
                lambda s=seed: monte_carlo(circuit, tols, n, seed=s))
            runs.append({"seed": seed, "s": time.perf_counter() - t0,
                         "max_residual": out["max_residual"],
                         "launches": launched})
            check(launched[kernel] > 0, f"monte_carlo {label} seed {seed}: "
                  f"{kernel} never launched ({launched})")
            if kernel == "sband_solve_multi":
                sband_shape_checked(f"monte_carlo {label}")
            check(out["max_residual"] <= CONTRACT_TOL,
                  f"monte_carlo {label} seed {seed}: max residual "
                  f"{out['max_residual']:.3e}")
            check(bool(torch.isfinite(out["mean"]).all()
                       and torch.isfinite(out["std"]).all()),
                  f"monte_carlo {label}: non-finite statistics")
            add_launches(total, launched)
        again = monte_carlo(circuit, tols, n, seed=MC_SEEDS[0])
        first = monte_carlo(circuit, tols, n, seed=MC_SEEDS[0], audit="exact")
        check(torch.equal(again["mean"], first["mean"])
              and torch.equal(again["std"], first["std"]),
              f"monte_carlo {label}: the same seed gave other statistics")
        audit_diff = abs(first["max_residual"] - again["max_residual"])
        check(audit_diff <= 1e-12, f"monte_carlo {label}: exact audit "
              f"{first['max_residual']:.3e}, fused {again['max_residual']:.3e}")
        info = {}
        if label == "ladder256":
            # The same draws as monte_carlo's, from the same generator.
            stamps, dev = circuit.stamps, torch.device("cuda")
            gen = torch.Generator(device=dev).manual_seed(MC_SEEDS[0])
            noise = torch.randn(n, len(tols), generator=gen,
                                dtype=torch.float32, device=dev)
            cpu = Circuit(Netlist.from_rows(rows), device="cpu")
            slots = torch.tensor([stamps.param_slot[m] for m in tols])
            sigmas = torch.tensor(list(tols.values()), dtype=torch.float32)
            base = torch.as_tensor(stamps.params, dtype=torch.float32)
            mean, std, _, _, audit = _mc_run(
                cpu.batched_solver(), cpu.stamps, base, slots, sigmas,
                noise.cpu(), False, True)
            scale = float(mean.abs().max())
            info = {
                "mean_vs_cpu": float((again["mean"].cpu() - mean).abs().max())
                / scale,
                "std_vs_cpu": float((again["std"].cpu() - std).abs().max())
                / scale,
                "cpu_max_residual": float(audit[0]),
                "e_n0_mean": float(again["mean"][circuit.netlist.nodenum[
                    "n0"]]),
                "e_n0_std": float(again["std"][circuit.netlist.nodenum[
                    "n0"]])}
            check(info["mean_vs_cpu"] <= MC_CPU_TOL
                  and info["std_vs_cpu"] <= MC_CPU_TOL,
                  f"monte_carlo {label}: card against CPU {info}")
        best = min(r["s"] for r in runs)
        emit({"phase": "monte_carlo", "path": label, "method": method,
              "n": circuit.stamps.n, "samples": n, "tolerances": len(tols),
              "runs": runs, "best_s": best, "solves_per_s": n / best,
              "exact_audit": first["max_residual"],
              "fused_audit": again["max_residual"], **info})
    return total


def phase_sensitivities() -> dict:
    """``sensitivities`` on the card for the ladder, mesh, branch and
    1.6.1 circuits: against the port on the CPU, against central
    differences of the card's own raw f64 solve on the three largest
    entries, the tier's kernel launched by the adjoint (none on
    ``dense``), and the ms of a call.  Returns the launches of one call
    on each circuit."""
    from nodal_tpu_torch import Circuit, Netlist
    from nodal_tpu_torch.batch import sensitivities
    from nodal_tpu_torch.utils.gridgen import ladder_rows

    total = {}
    cases = [("ladder", ladder_rows(LADDER_RUNGS), "tridiag",
              {"potential": "n0"}, "pcr_solve"),
             ("mesh", mesh_rows(MESH_NODES), "sband", {"potential": "1"},
              "sband_solve_multi"),
             ("branch", mesh_rows(MESH_NODES, branch=True), "schur",
              {"current": "e1"}, "sband_solve_multi"),
             ("161", [r.split(",") for r in (
                 "r1,R,2,1,4", "r2,R,2,1,g", "r3,R,0.5,1,2",
                 "e1,E,8,4,g", "a1,A,4,1,2", "d1,CCCS,2,2,g,1,g,r2")],
              "dense", {"current": "e1"}, None)]
    for label, rows, method, target, kernel in cases:
        circuit = Circuit(Netlist.from_rows(rows))
        solver = circuit.batched_solver(dtype=torch.float64)
        check(solver.method == method, f"sensitivities {label}: method "
              f"{solver.method}")
        sens, launched = counted(lambda: sensitivities(circuit, **target))
        if kernel == "sband_solve_multi":
            sband_shape_checked(f"sensitivities {label}")
        p = torch.tensor(circuit.stamps.params, device="cuda")[None]
        _, forward = counted(lambda: solver(p))
        backward = {k: launched[k] - forward[k] for k in launched}
        cpu = sensitivities(Circuit(Netlist.from_rows(rows), device="cpu"),
                            **target)
        names = list(sens)
        g = np.array([sens[k] for k in names])
        scale = float(np.abs(g).max())
        err_cpu = float(np.abs(g - np.array([cpu[k] for k in names])).max()
                        ) / scale
        netlist = circuit.netlist
        idx = (netlist.nodenum[target["potential"]] if "potential" in target
               else netlist.nums["kcl"] + netlist.anomnum[target["current"]])
        raw = circuit.batched_solver(dtype=torch.float64, refine=False)
        fd = {}
        for k in np.argsort(-np.abs(g))[:3]:
            slot = circuit.stamps.param_slot[names[k]]
            h = SENS_FD_STEP * max(abs(circuit.stamps.params[slot]), 1.0)
            q = np.tile(circuit.stamps.params, (2, 1))
            q[0, slot] += h
            q[1, slot] -= h
            x = raw(q)[:, idx].cpu().numpy()
            fd[names[k]] = (float(g[k]), float((x[0] - x[1]) / (2 * h)))
        err_fd = max(abs(a - b) for a, b in fd.values()) / scale
        times, ms = host_median_ms(lambda: sensitivities(circuit, **target))
        emit({"phase": "sensitivities", "path": label, "method": method,
              "n": circuit.stamps.n, "params": len(names), "target": target,
              "rel_err_vs_cpu": err_cpu, "rel_err_vs_central_diff": err_fd,
              "central_diff": fd, "launches": launched,
              "backward_launches": backward, "ms": ms, "ms_reps": times})
        check(err_cpu <= SENS_CPU_TOL, f"sensitivities {label}: "
              f"{err_cpu:.3e} from the CPU")
        check(err_fd <= SENS_FD_TOL, f"sensitivities {label}: {err_fd:.3e} "
              "from central differences")
        check(backward[kernel] > 0 if kernel else not any(launched.values()),
              f"sensitivities {label}: launches {launched}, backward "
              f"{backward}")
        add_launches(total, launched)
    return total


def resistors_only(rows):
    """The resistor rows of a netlist: equivalent resistance takes
    resistors only (``check_resistive``)."""
    return [r for r in rows if r[1] == "R"]


def equiv_pairs(netlist, k: int = EQUIV_PAIRS):
    """k probe pairs of distinct nodes of the netlist (ground among them),
    drawn with ``numpy.random.default_rng(0)``."""
    nodes = sorted(netlist.nodenum) + [netlist.ground]
    rng = np.random.default_rng(0)
    return [tuple(nodes[i] for i in rng.choice(len(nodes), 2,
                                               replace=False))
            for _ in range(k)]


def rel_each(x: np.ndarray, ref: np.ndarray) -> float:
    """The largest elementwise relative difference."""
    return float(np.max(np.abs(x - ref) / np.abs(ref)))


def phase_equiv_many() -> dict:
    """``equivalent_resistance_many`` with 64 probe pairs on the card: the
    100×100 mesh and the 20×10×10 lattice through the band route (one
    ``band_solve_multi`` host loop at (1, nb, 128, 64), a shape the kernel
    check holds), the 1000-node random network through the dense route (no
    kernel of the repo), each against the CPU's skyline LDLᵀ and single
    ``equivalent_resistance`` calls, with host ms a call on the card and
    on the CPU.  Returns the launches of one call on each."""
    from nodal_tpu_torch import Netlist
    from nodal_tpu_torch.equiv import (equivalent_resistance,
                                       equivalent_resistance_many)
    from nodal_tpu_torch.models.stamps import compile_stamps
    from nodal_tpu_torch.ops import block_thomas, skyline
    from nodal_tpu_torch.ops.band import band_plan

    check(skyline.available(), "the skyline LDLᵀ library did not build")
    bt = block_thomas.band_solve_multi
    launches = 0
    for label, rows, route in (
            ("widemesh", grid_circuit_rows(100, 100), "band"),
            ("lattice", lattice_rows(20, 10, 10), "band"),
            ("randnet", randnet_rows(), "dense")):
        netlist = Netlist.from_rows(resistors_only(rows))
        pairs = equiv_pairs(netlist)
        plan = band_plan(compile_stamps(netlist))
        bt.last_shape = None
        card, launched = counted(
            lambda: equivalent_resistance_many(netlist, pairs))
        shape = bt.last_shape
        cpu = equivalent_resistance_many(netlist, pairs, device="cpu")
        single = np.array([equivalent_resistance(netlist, a, b)
                           for a, b in pairs[:EQUIV_SINGLE]])
        err_cpu = rel_each(card, cpu)
        err_single = rel_each(card[:EQUIV_SINGLE], single)
        card_reps, card_ms = host_median_ms(
            lambda: equivalent_resistance_many(netlist, pairs))
        cpu_reps, cpu_ms = host_median_ms(
            lambda: equivalent_resistance_many(netlist, pairs,
                                               device="cpu"))
        split = kernel_split(
            lambda: equivalent_resistance_many(netlist, pairs))
        emit({"phase": "equiv_many", "path": label, "route": route,
              "n": len(netlist.nodenum), "pairs": len(pairs),
              "band": None if plan is None else [plan.nb, plan.kb],
              "last_shape": shape, "launches": launched,
              "rel_err_vs_cpu_skyline": err_cpu,
              "rel_err_vs_single": err_single, "ms_card": card_ms,
              "ms_card_reps": card_reps, "ms_cpu": cpu_ms,
              "ms_cpu_reps": cpu_reps, "device_ms": split["device_ms"],
              "by_kernel_ms": split["by_kernel_ms"],
              "kernels_per_call": split["launches_per_call"],
              "R_first": float(card[0])})
        check(np.isfinite(card).all() and card.shape == (len(pairs),),
              f"equiv_many {label}: {card}")
        check(err_cpu <= EQUIV_RTOL and err_single <= EQUIV_RTOL,
              f"equiv_many {label}: {err_cpu:.3e} from the CPU, "
              f"{err_single:.3e} from single solves")
        if route == "band":
            want = (1, plan.nb, plan.kb, len(pairs))
            check(launched["band_solve_multi"] == 1 and shape == want
                  and shape in BAND_SHAPES,
                  f"equiv_many {label}: {launched}, last shape {shape}, "
                  f"want {want} of BAND_SHAPES")
        else:
            check(plan is None and not any(launched.values()),
                  f"equiv_many {label}: plan {plan}, launches {launched}")
        launches += launched["band_solve_multi"]
    return {"band_solve_multi": launches}


@contextlib.contextmanager
def sparse_log():
    """Records what the sparse solves inside the block spend: the AMG
    set-up's host seconds (``build_hierarchy``) and each Krylov loop's
    ms on the host clock between two synchronizes, with its iterations."""
    from nodal_tpu_torch.ops import sparse

    log = {"setup_s": [], "krylov": []}
    real = sparse.build_hierarchy, sparse.cg, sparse.bicgstab

    def hierarchy(*args, **kw):
        t0 = time.perf_counter()
        out = real[0](*args, **kw)
        log["setup_s"].append(time.perf_counter() - t0)
        return out

    def timed(solver):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = solver(*args, **kw)
            torch.cuda.synchronize()
            log["krylov"].append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "iterations": int(info.iterations[0])})
            return x, info
        return run

    sparse.build_hierarchy = hierarchy
    sparse.cg, sparse.bicgstab = timed(real[1]), timed(real[2])
    try:
        yield log
    finally:
        sparse.build_hierarchy, sparse.cg, sparse.bicgstab = real


def trace_summary(fn) -> dict:
    """One ``fn()`` call under ``torch.profiler``: its kernels, their
    device ms, the host's synchronizes, and the five kernels that take
    the most time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    by_name = {}
    kernels = syncs = 0
    for e in events:
        if e.get("cat") == "kernel":
            kernels += 1
            name = kernel_name(e.get("name", ""))
            by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
        elif e.get("cat") == "cuda_runtime" and "Synchronize" in e.get(
                "name", ""):
            syncs += 1
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    return {"kernels": kernels, "host_syncs": syncs,
            "device_ms": sum(by_name.values()), "top_kernels_ms": top}


def phase_sparse() -> None:
    """The resistive sparse backend at its users' scale, on the card:

    * ``grid1000_sparse``: the 1000×1000 grid netlist (1M nodes) parsed by
      the native parser, then ``equivalent_resistance_stamps`` (AMG-CG),
      R against the matrix-free grid solve;
    * ``randnet40k``: a 40,000-node random network, ``Circuit(sparse=True)
      .solve()`` (Jacobi-CG) and ``solve_sparse_system(preconditioner=
      "amg")``, each against a pivoted dense f64 LU on the card, and each
      repeated to see whether two solves agree bit for bit;
    * both CLIs' ``-s`` (``equiv_cli --native on`` on the grid's CSV) on
      the card against ``--device cpu``.

    Fails when the skyline or the native parser does not build: nothing
    here may take the Python path quietly."""
    from nodal_tpu_torch import Circuit, Netlist, equiv_cli, solver_cli
    from nodal_tpu_torch.equiv import equivalent_resistance_stamps
    from nodal_tpu_torch.models.stamps import compile_stamps
    from nodal_tpu_torch.netlist import is_connected
    from nodal_tpu_torch.ops import skyline
    from nodal_tpu_torch.ops.assemble import assemble_dense
    from nodal_tpu_torch.ops.grid import grid_equivalent_resistance
    from nodal_tpu_torch.ops.sparse import solve_sparse_system
    from nodal_tpu_torch.utils import native
    from nodal_tpu_torch.utils.gridgen import grid_csv

    check(skyline.available(), "the skyline LDLᵀ library did not build")
    try:
        native._load()
    except native.NativeUnavailable as e:
        fail(f"the native parser did not build: {e}")

    n = SPARSE_GRID
    a, b = knight_probes(n)
    t0 = time.perf_counter()
    text = grid_csv(n, n, a, b)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stamps, symbols = native.parse_stamps(text)
    parse_s = time.perf_counter() - t0
    ia, ib = symbols.node_index("1"), symbols.node_index("g")
    torch.cuda.reset_peak_memory_stats()
    with sparse_log() as log:
        t0 = time.perf_counter()
        R = equivalent_resistance_stamps(stamps, ia, ib)
        call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    R_grid, ginfo = grid_equivalent_resistance(n, n, a, b,
                                               dtype=torch.float64, tol=1e-10)
    err = abs(R - float(R_grid)) / abs(float(R_grid))
    trace = trace_summary(lambda: equivalent_resistance_stamps(stamps, ia,
                                                               ib))
    emit({"phase": "sparse", "path": "grid1000_sparse", "n": stamps.n,
          "nnz_raw": stamps.nnz, "R": R, "R_grid": float(R_grid),
          "grid_iterations": int(ginfo.iterations), "rel_err_vs_grid": err,
          "csv_gen_s": gen_s, "parse_s": parse_s, "call_s": call_s,
          "amg_setup_s": log["setup_s"], "cg": log["krylov"],
          "peak_device_bytes": peak, "trace": trace})
    check(len(log["setup_s"]) == 1 and len(log["krylov"]) == 1,
          f"grid1000_sparse took another route: {log}")
    check(err <= SPARSE_GRID_RTOL, f"grid1000_sparse: R {R} is {err:.3e} "
          f"from the grid's {float(R_grid)}")

    rows = randnet_rows(RANDNET40K_NODES, RANDNET40K_EDGES)
    netlist = Netlist.from_rows(rows)
    check(is_connected(netlist), "randnet40k is not connected")
    stamps = compile_stamps(netlist)
    params = torch.tensor(stamps.params, device="cuda")[None]
    G, bvec = assemble_dense(stamps, params)
    t0 = time.perf_counter()
    ref = torch.linalg.solve(G, bvec)[0].cpu().numpy()
    dense_ms = (time.perf_counter() - t0) * 1e3
    del G
    torch.cuda.empty_cache()
    routes = {}
    for route in ("jacobi", "amg"):
        if route == "jacobi":
            circuit = Circuit(netlist, sparse=True)

            def solve():
                sol = circuit.solve()
                return sol.result, sol.stats["method"]
        else:
            def solve():
                x, info = solve_sparse_system(stamps, stamps.params,
                                              preconditioner="amg")
                return x.cpu().numpy(), info.preconditioner
        with sparse_log() as log:
            t0 = time.perf_counter()
            x, how = solve()
            first_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            x2, _ = solve()
            second_ms = (time.perf_counter() - t0) * 1e3
        err = max_rel(x, ref)
        routes[route] = {"how": how, "rel_err_vs_dense_lu": err,
                         "bit_for_bit": bool(np.array_equal(x, x2)),
                         "first_ms": first_ms, "second_ms": second_ms,
                         "amg_setup_s": log["setup_s"], "cg": log["krylov"]}
        check(err <= RANDNET40K_RTOL, f"randnet40k {route}: {err:.3e} from "
              "the dense f64 LU")
        check(len(log["krylov"]) == 2, f"randnet40k {route}: {log}")
    emit({"phase": "sparse", "path": "randnet40k", "n": stamps.n,
          "nnz_raw": stamps.nnz, "dense_lu_ms": dense_ms, **routes})
    check(routes["jacobi"]["how"] == "krylov"
          and routes["amg"]["how"] == "amg",
          f"randnet40k routes: {routes}")

    examples = ROOT / "examples"
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "grid1000.csv"
        path.write_text(text)
        for main, argv, rtol in (
                (equiv_cli.main, [str(path), "-s", "--native", "on"],
                 CLI_CG_RTOL),
                (solver_cli.main, [str(examples / "resistive_1.csv"), "-s"],
                 CLI_RTOL)):
            t0 = time.perf_counter()
            card = cli_output(main, argv)
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = cli_output(main, [*argv, "--device", "cpu"])
            cpu_s = time.perf_counter() - t0
            worst = same_cli_lines(card, cpu, rtol)
            emit({"phase": "cli", "argv": [Path(argv[0]).name, *argv[1:]],
                  "lines": len(card.splitlines()), "worst_rel_diff": worst,
                  "card_s": card_s, "cpu_s": cpu_s,
                  "first_line": card.splitlines()[0]})


def general_sparse_rows(n_nodes: int, h: int = 100):
    """``bench.py:bench_general_sparse``'s circuit: an h-row resistor mesh
    with 32 E, 16 VCCS and a CCCS, grounded only through the sources."""
    from nodal_tpu_torch.utils.gridgen import grid_rows

    w = max(n_nodes // h, 8)
    rows = list(grid_rows(h, w))
    e_cols = list(range(1, w, max(w // 32, 1)))[:32]
    d_cols = list(range(2, w, max(w // 16, 1)))[:16]
    for k, col in enumerate(e_cols):
        rows.append([f"e{k}", "E", str(1.0 + 0.1 * k), f"n0_{col}", "g"])
    for k, col in enumerate(d_cols):
        rows.append([f"d{k}", "VCCS", "0.3", f"n{h // 2}_{col}", "g",
                     f"n0_{e_cols[k % len(e_cols)]}", "g"])
    rows.append(["rdrv", "R", "2", f"n{h - 1}_5", f"n{h - 1}_6"])
    rows.append(["f1", "CCCS", "1.5", f"n{h // 3}_4", "g",
                 f"n{h - 1}_5", f"n{h - 1}_6", "rdrv"])
    return rows


def large_border_rows(n_nodes: int = 40000, h: int = 100):
    """``bench.py:bench_large_border``'s circuit: an h-row mesh with an E
    to ground on every top node and E's between rows 2–41 (~8.4k ideal
    sources at 40k nodes)."""
    from nodal_tpu_torch.utils.gridgen import grid_rows

    w = max(n_nodes // h, 4)
    rows = list(grid_rows(h, w))
    for col in range(w):
        rows.append([f"eg{col}", "E", str(1.0 + 0.001 * col),
                     f"n0_{col}", "g"])
    for r in range(2, min(42, h - 1), 2):
        for col in range(w):
            rows.append([f"e{r}_{col}", "E", str(0.01 * r),
                         f"n{r}_{col}", f"n{r + 1}_{col}"])
    return rows


def big_border_vccs_rows(n_nodes: int = 40000, m: int = 8192,
                         h: int = 100):
    """``bench.py:bench_big_border_vccs``'s circuit: an h-row mesh grounded
    at one corner, a current source, and m VCCS border rows."""
    from nodal_tpu_torch.utils.gridgen import grid_rows

    w = max(n_nodes // h, 8)
    rows = list(grid_rows(h, w))
    rows.append(["rg", "R", "1", "n0_0", "g"])
    rows.append(["src", "A", "1", f"n{h // 2}_{w // 2}", "g"])
    for k in range(m):
        i, j = k % (h - 1), (k * 7) % (w - 1)
        ci, cj = (k * 3) % h, (k * 11) % w
        rows.append([f"d{k}", "VCCS", "0.01", f"n{i}_{j}", "g",
                     f"n{ci}_{cj}", "g"])
    return rows


def general_rows(label: str):
    """The rows of one of GENERAL_CONFIGS, at bench.py's default size."""
    return {"sparse40k": lambda: general_sparse_rows(40000),
            "sparse100k": lambda: general_sparse_rows(100000),
            "ebig": lambda: large_border_rows(40000),
            "opmodel": lambda: opchain_rows(2500),
            "vccs_border": lambda: big_border_vccs_rows(40000, 8192),
            }[label]()


def coo_audit(stamps, x: np.ndarray) -> float:
    """The f64 COO residual ``max|b − G x| / max(max|b|, 1)`` of the
    netlist's own values, straight from the stamp entries."""
    from nodal_tpu_torch.models.stamps import stamp_values_np

    g, r = stamp_values_np(stamps, stamps.params.astype(np.float64))
    b = np.zeros(stamps.n)
    np.add.at(b, stamps.rhs_rows, r)
    y = np.zeros(stamps.n)
    np.add.at(y, stamps.g_rows, g * x[stamps.g_cols])
    return float(np.max(np.abs(b - y)) / max(np.max(np.abs(b)), 1.0))


@contextlib.contextmanager
def general_log():
    """Records what the bordered elimination spends inside the block, each
    span between two synchronizes: the ideal-source reduction plan, the
    AMG set-up (host), each factorization (YB's A11 solves, S and its
    LU; its iterations), the Schur LU alone, and the calls of the host
    skyline."""
    from nodal_tpu_torch.ops import amg, reduce_e, skyline, sparse_schur

    log = {"reduce_s": [], "amg_setup_s": [], "factor": [],
           "schur_lu_s": [], "skyline_calls": 0}
    real = (reduce_e.build_e_reduction, amg.build_hierarchy,
            sparse_schur._factorization, sparse_schur._schur_lu,
            skyline.factor, skyline.solve)

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if key == "factor":
                log[key].append({"s": dt, "iterations": out[1],
                                 "m": int(out[0].YB.shape[0])
                                 if out[0] is not None else None})
            else:
                log[key].append(dt)
            return out
        return run

    def host(fn):
        def run(*args, **kw):
            log["skyline_calls"] += 1
            return fn(*args, **kw)
        return run

    reduce_e.build_e_reduction = timed(real[0], "reduce_s")
    amg.build_hierarchy = timed(real[1], "amg_setup_s")
    sparse_schur._factorization = timed(real[2], "factor")
    sparse_schur._schur_lu = timed(real[3], "schur_lu_s")
    skyline.factor, skyline.solve = host(real[4]), host(real[5])
    try:
        yield log
    finally:
        (reduce_e.build_e_reduction, amg.build_hierarchy,
         sparse_schur._factorization, sparse_schur._schur_lu,
         skyline.factor, skyline.solve) = real


def cli_run(main, argv):
    """``(stdout, exit code)`` of one CLI call."""
    try:
        return cli_output(main, argv), 0
    except SystemExit as e:
        return "", e.code


def phase_general_sparse() -> None:
    """The general sparse backend at its users' scale, on the card: the
    five GENERAL_CONFIGS through ``Circuit(sparse=True).solve()`` (ideal-
    source reduction, bordered elimination with f64 AMG-CG on the card and
    the Schur LU on the card), each cold and warm, with its method,
    iterations, host seconds and peak device memory; its f64 COO audit;
    a fresh circuit's cold solve bit for bit; x against the port's own
    ``device="cpu"`` route (not on ``sparse100k``); no host skyline and no
    kernel of the repo on the card.  Then ``sensitivities`` of
    GENERAL_SENS_CONFIG on the card against the CPU, and ``solver_cli -s``
    on each example with branch rows, the card against ``--device cpu``."""
    from nodal_tpu_torch import Circuit, Netlist, solver_cli
    from nodal_tpu_torch.batch import sensitivities
    from nodal_tpu_torch.ops import sparse_schur

    check(sparse_schur._BORDER_CAP_NATIVE >= 8192,
          "the card's border cap no longer serves vccs_border")
    sens_circuits = None
    for label, cpu_rtol in GENERAL_CONFIGS:
        netlist = Netlist.from_rows(general_rows(label))
        circuit = Circuit(netlist, sparse=True)
        torch.cuda.reset_peak_memory_stats()
        with general_log() as log:
            sol, launched = counted(circuit.solve)
            t0 = time.perf_counter()
            warm = circuit.solve()
            warm_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        fresh = Circuit(netlist, sparse=True).solve()
        audit = coo_audit(circuit.stamps, sol.result)
        out = {"phase": "general_sparse", "path": label,
               "n": circuit.stamps.n, "nnz_raw": circuit.stamps.nnz,
               "method": sol.stats["method"],
               "iterations": sol.stats["iterations"],
               "warm_iterations": warm.stats["iterations"],
               "cold_s": sol.stats["solve_s"], "warm_s": warm_s,
               "audit": audit, "residual": sol.stats["residual"],
               "bit_for_bit": bool(np.array_equal(sol.result, fresh.result)
                                   and np.array_equal(sol.result,
                                                      warm.result)),
               "peak_device_bytes": peak, "launches": launched,
               "reduce_s": log["reduce_s"],
               "amg_setup_s": log["amg_setup_s"],
               "factor": log["factor"], "schur_lu_s": log["schur_lu_s"],
               "skyline_calls": log["skyline_calls"]}
        out["trace_warm"] = trace_summary(circuit.solve)
        if cpu_rtol is None:
            out["vs_cpu"] = "not run: the f64 COO audit stands alone"
        else:
            cpu = Circuit(netlist, sparse=True, device="cpu")
            t0 = time.perf_counter()
            cpu_sol = cpu.solve()
            out.update(cpu_s=time.perf_counter() - t0,
                       cpu_method=cpu_sol.stats["method"],
                       rel_err_vs_cpu=max_rel(sol.result, cpu_sol.result))
            if label == GENERAL_SENS_CONFIG:
                sens_circuits = (circuit, cpu)
        emit(out)
        check(sol.stats["method"].endswith("schur-cuda"),
              f"general_sparse {label}: method {sol.stats['method']}")
        check(audit <= GENERAL_AUDIT_TOL,
              f"general_sparse {label}: audit {audit:.3e}")
        check(out["bit_for_bit"], f"general_sparse {label}: a repeat "
              "differs from the first solve")
        check(log["skyline_calls"] == 0 and not any(launched.values()),
              f"general_sparse {label}: the host skyline ran "
              f"{log['skyline_calls']} times; repo kernels {launched}")
        check(cpu_rtol is None or out["rel_err_vs_cpu"] <= cpu_rtol,
              f"general_sparse {label}: {out.get('rel_err_vs_cpu')} from "
              "the CPU route")
        del circuit, sol, warm, fresh
        torch.cuda.empty_cache()

    card, cpu = sens_circuits
    node = sorted(card.netlist.nodenum)[card.stamps.n_kcl // 2]
    t0 = time.perf_counter()
    g_card = sensitivities(card, potential=node)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_cpu = sensitivities(cpu, potential=node)
    cpu_s = time.perf_counter() - t0
    scale = max(abs(v) for v in g_cpu.values())
    worst = max(abs(g_card[k] - g_cpu[k]) for k in g_cpu) / scale
    emit({"phase": "general_sparse", "path": "sensitivities",
          "circuit": GENERAL_SENS_CONFIG, "potential": node,
          "components": len(g_card), "warm_card_s": card_s,
          "warm_cpu_s": cpu_s, "rel_err_vs_cpu": worst})
    check(worst <= GENERAL_SENS_RTOL,
          f"general_sparse sensitivities: {worst:.3e} from the CPU")

    examples = ROOT / "examples"
    for name in BRANCH_EXAMPLES:
        argv = [str(examples / name), "-s"]
        t0 = time.perf_counter()
        card_out, card_code = cli_run(solver_cli.main, argv)
        card_s = time.perf_counter() - t0
        cpu_out, cpu_code = cli_run(solver_cli.main,
                                    [*argv, "--device", "cpu"])
        check(card_code == cpu_code, f"solver_cli -s {name}: exit "
              f"{card_code} on the card, {cpu_code} on the CPU")
        worst = (same_cli_lines(card_out, cpu_out, CLI_CG_RTOL)
                 if card_code == 0 else None)
        emit({"phase": "cli", "argv": [name, "-s"], "exit": card_code,
              "lines": len(card_out.splitlines()), "worst_rel_diff": worst,
              "card_s": card_s})


# ------------------------------------------------- weighted grids, lattices

def weighted_conductances(rng, shape, dtype, zero_edges: bool = False):
    """(gx, gy, gz) on the card for [B, d, h, w] fields, ~U(0.5, 2.0) from
    ``rng``; with ``zero_edges`` about a fifth of them zero and node
    (0, 0, h/2, w/2) of sample 0 isolated."""
    B, d, h, w = shape
    gs = [rng.uniform(*WEIGHTED_G, size=s) for s in
          ((B, d, h, w - 1), (B, d, h - 1, w), (B, d - 1, h, w))]
    if zero_edges:
        for g in gs:
            g[rng.random(g.shape) < 0.2] = 0.0
        i, j = h // 2, w // 2
        gs[0][0, 0, i, j - 1] = gs[0][0, 0, i, j] = 0.0
        gs[1][0, 0, i - 1, j] = gs[1][0, 0, i, j] = 0.0
        if d > 1:
            gs[2][0, 0, i, j] = 0.0
    return tuple(torch.tensor(g, dtype=dtype, device="cuda") for g in gs)


def weighted_field(rng, shape, dtype):
    return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                        device="cuda")


def weighted_cases(ws, shape, dtype, rng, zero_edges: bool = False):
    """(name, kernel call, plain call) of every weighted-stencil check at
    one shape: the residual, the matvec and the restriction; 1, 2 and 96
    sweeps from zero and from x, with and without the fused prolongation;
    the block kernel's coarsest solve where the field fits a block."""
    B, d, h, w = shape
    g = weighted_conductances(rng, shape, dtype, zero_edges)
    x, r = weighted_field(rng, shape, dtype), weighted_field(rng, shape, dtype)
    if zero_edges:  # no injection where a node has no edge
        isolated = ws.degree(g) == 0
        x[isolated] = 0.0
        r[isolated] = 0.0
    shift = weighted_field(rng, (B,), dtype)
    P = functools.partial
    cases = [("weighted_residual", P(ws.weighted_residual, x, g, r),
              P(ws.weighted_residual_plain, x, g, r)),
             ("weighted_residual/matvec",
              P(ws.weighted_residual, x, g, shift=shift),
              P(ws.weighted_residual_plain, x, g, shift=shift))]
    even = h % 2 == 0 and w % 2 == 0 and d % ws.depth_factor(d) == 0
    if even:
        cases.append(("weighted_residual/restrict",
                      P(ws.weighted_residual, x, g, r, restrict=True),
                      P(ws.weighted_residual_plain, x, g, r, restrict=True)))
        zc = weighted_field(rng, (B, d // ws.depth_factor(d), h // 2,
                                  w // 2), dtype)
    for k in WEIGHTED_SWEEPS:
        for x0, tag in ((None, ""), (x, "/x")):
            cases.append((f"weighted_jacobi/{k}{tag}",
                           P(ws.weighted_jacobi, x0, r, g, sweeps=k),
                           P(ws.weighted_jacobi_plain, x0, r, g, sweeps=k)))
            if even and k < 96:
                cases.append((f"weighted_jacobi/{k}{tag}/zc",
                              P(ws.weighted_jacobi, x0, r, g, sweeps=k,
                                zc=zc),
                              P(ws.weighted_jacobi_plain, x0, r, g, sweeps=k,
                                zc=zc)))
    # The coarsest solve presumes a connected level: under its mean
    # projection an isolated node takes ω / tiny times r's mean.
    if (ws.block_fits(d, h, w, torch.finfo(dtype).bits // 8)
            and not zero_edges):
        cases += [(f"weighted_jacobi_block/{k}",
                   P(ws.weighted_jacobi_block, r, g, sweeps=k),
                   P(ws.weighted_jacobi_block_plain, r, g, sweeps=k))
                  for k in WEIGHTED_SWEEPS]
    return cases


def check_weighted_case(name, kernel, plain, shape, dtype, worst) -> float:
    """One weighted kernel call against its plain version: dtype, shape,
    finite values, the largest difference over max|plain| within
    ``WEIGHTED_RTOL``; the worst of each kernel and dtype kept in
    ``worst``."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    check(got.dtype == dtype and got.shape == want.shape,
          f"{name} returned {got.dtype} {tuple(got.shape)} at {shape}")
    check(bool(torch.isfinite(got).all()),
          f"{name} non-finite at {shape} {dtype}")
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max()) / scale
    check(err <= WEIGHTED_RTOL[dtype],
          f"{name} differs from its plain version by {err:.3e} at {shape} "
          f"{dtype}")
    key = (name.split("/")[0], str(dtype))
    worst[key] = max(worst.get(key, 0.0), err)
    return err


def weighted_bound(name: str, shape, dtype, sweeps: int = 1) -> dict:
    """Bytes (x, r and the conductances read once, one field written; the
    block kernel reads no x) and operations of one weighted kernel call: a
    residual is 12 flops a node in a grid and 17 in a lattice, a sweep 18
    and 26."""
    B, d, h, w = shape
    n = B * d * h * w
    g = B * (d * h * (w - 1) + d * (h - 1) * w + (d - 1) * h * w)
    item = torch.finfo(dtype).bits // 8
    lattice = d > 1
    if name == "weighted_residual":
        values, flops = 3 * n + g, (17 if lattice else 12) * n
    elif name == "weighted_jacobi":
        values, flops = 3 * n + g, (26 if lattice else 18) * n
    else:
        values, flops = 2 * n + g, (26 if lattice else 18) * n * sweeps
    return bound_ms(flops, values * item, dtype)


def queued_ms(fn, calls: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call when calls run back to back: CUDA
    events around ``calls`` calls queued behind a spin kernel that holds
    the card until the host has queued them all.  A call shorter than its
    host work (a kernel at 1024²) leaves plain events reading the host's
    launch rate instead (``event_median_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2 GHz: four times the host's queueing time, and at least 10 ms.
    torch.cuda._sleep(int(2e9 * max(4 * calls * host_s, 0.01)))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def time_weighted(ws, rng) -> dict:
    """Kernel, plain version and bound of each weighted kernel, f32 and
    f64: the residual and one sweep from x at 1024², the block kernel's 96
    mean-projected sweeps at fabric64's coarsest level (B 1024, 8²).  The
    device ms of a call back to back (``queued_ms``), and the plain events
    (the host's rate) beside it."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        shape = WEIGHTED_TIME_SHAPE
        g = weighted_conductances(rng, shape, dtype)
        x, r = (weighted_field(rng, shape, dtype) for _ in "xr")
        bshape = WEIGHTED_BLOCK_TIME_SHAPE
        bg = weighted_conductances(rng, bshape, dtype)
        br = weighted_field(rng, bshape, dtype)
        calls = {
            "weighted_residual": (
                shape, 1, lambda: ws.weighted_residual(x, g, r),
                lambda: ws.weighted_residual_plain(x, g, r)),
            "weighted_jacobi": (
                shape, 1, lambda: ws.weighted_jacobi(x, r, g),
                lambda: ws.weighted_jacobi_plain(x, r, g)),
            "weighted_jacobi_block": (
                bshape, COARSE_SWEEPS,
                lambda: ws.weighted_jacobi_block(br, bg,
                                                 sweeps=COARSE_SWEEPS),
                lambda: ws.weighted_jacobi_block_plain(
                    br, bg, sweeps=COARSE_SWEEPS)),
        }
        for name, (shp, sweeps, kernel, plain) in calls.items():
            max_abs = float((kernel() - plain()).abs().max())
            bound = weighted_bound(name, shp, dtype, sweeps)
            t = {"shape": shp, "ms": queued_ms(kernel),
                 "event_ms": event_median_ms(kernel),
                 "plain_ms": queued_ms(plain, calls=3),
                 "max_abs_err": max_abs, "library_ms": None, **bound}
            emit({"phase": "kernel_time", "kernel": name,
                  "dtype": str(dtype), **t})
            out[(name, dtype)] = t
    return out


def phase_weighted_kernels(ws, rng) -> dict:
    """Each weighted kernel against its plain version at every shape of
    ``WEIGHTED_SHAPES`` (the block kernel where a block holds the field),
    the solves' coarsest levels and the zero-edge fields, f32 and f64;
    then each timed.  Returns the timings."""
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for shape in WEIGHTED_SHAPES + WEIGHTED_BLOCK_SHAPES:
            block_only = shape in WEIGHTED_BLOCK_SHAPES
            errs = {}
            for name, kernel, plain in weighted_cases(ws, shape, dtype, rng):
                if block_only and not name.startswith("weighted_jacobi_"):
                    continue
                errs[name] = check_weighted_case(name, kernel, plain, shape,
                                                 dtype, worst)
            emit({"phase": "weighted_kernel_check", "shape": shape,
                  "dtype": str(dtype), "tol": WEIGHTED_RTOL[dtype],
                  "max_rel_diff": errs})
            torch.cuda.empty_cache()
        for shape in WEIGHTED_ZERO_SHAPES:
            errs = {name: check_weighted_case(name, kernel, plain, shape,
                                              dtype, worst)
                    for name, kernel, plain in weighted_cases(
                        ws, shape, dtype, rng, zero_edges=True)}
            emit({"phase": "weighted_kernel_check", "shape": shape,
                  "zero_edges": True, "dtype": str(dtype),
                  "max_rel_diff": errs})
    emit({"phase": "kernel_check_worst",
          "weighted": {f"{k[0]} {k[1]}": v for k, v in worst.items()}})
    return time_weighted(ws, rng)


def weighted_launch_counts(ws) -> dict:
    return {**{f.__name__: f.launches for f in
               (ws.weighted_residual, ws.weighted_jacobi,
                ws.weighted_jacobi_block)},
            **{f"coarse_{k}": v for k, v in ws.coarse_solve.routes.items()}}


def reset_weighted_counts(ws) -> None:
    for f in (ws.weighted_residual, ws.weighted_jacobi,
              ws.weighted_jacobi_block):
        f.launches = 0
    ws.coarse_solve.routes.update(block=0, sweeps=0)


def weighted_probes(dims, batched: bool = False):
    """The knight's move of bench.py:595 about the centre of a single grid
    or lattice; corner to corner on a batch of fabrics or lattices."""
    if batched:
        return (0,) * len(dims), tuple(n - 1 for n in dims)
    a = tuple(n // 2 for n in dims)
    return a, a[:-2] + (a[-2] + 1, a[-1] + 2)


def weighted_solver(gw, gw3, dims, g, tol, probes):
    """The user's entry point for one run: R and its residual."""
    if len(dims) == 2:
        return functools.partial(gw.weighted_equivalent_resistance, *dims,
                                 *g[:2], *probes, tol, device="cuda")
    return functools.partial(gw3.weighted_equivalent_resistance_3d, *dims,
                             *g, *probes, tol, device="cuda")


def weighted_solve_info(gw, gw3, dims, g, tol, probes):
    """x and SolveInfo of the run's probe field through the solve entry."""
    rhs = gw.probe_fields(dims, *probes, g[0].shape[0], g[0].dtype, "cuda")
    if len(dims) == 2:
        return gw.weighted_grid_solve(*g[:2], rhs, tol=tol, device="cuda")
    return gw3.weighted_lattice_solve(*g, rhs, tol=tol, device="cuda")


def run_conductances(rng, dims, B, dtype):
    """A run's conductance fields on the card, [B, ...] per axis (gz
    omitted from a grid's use)."""
    if len(dims) == 2:
        h, w = dims
        shapes = ((B, h, w - 1), (B, h - 1, w))
    else:
        d, h, w = dims
        shapes = ((B, d, h, w - 1), (B, d, h - 1, w), (B, d - 1, h, w))
    return tuple(torch.tensor(rng.uniform(*WEIGHTED_G, size=s), dtype=dtype,
                              device="cuda") for s in shapes)


def phase_weighted_solves(ws, gw, gw3, grid, rng) -> dict:
    """Every run of ``WEIGHTED_RUNS`` through the user's entry point:
    iterations, residual, launches and coarsest routes of one solve, host
    ms (median of 5 after a warm-up), solves/s of the batched runs; three
    batched samples against single solves; the g = 1 identity with the
    uniform grid; the card against the CPU route; dR/dgx against central
    differences.  Returns the wrappers' launches over all of it (counts
    reset just before)."""
    # The metal layer of BASELINE config 5's grid, one field for both
    # dtypes of wgrid1024.
    n = WEIGHTED_LAYER_N
    layer = run_conductances(rng, (n, n), 1, torch.float64)
    reset_weighted_counts(ws)
    results = {}
    for label, dims, B, dtype, tol in WEIGHTED_RUNS:
        if label.startswith("wgrid1024"):
            g = tuple(t.to(dtype) for t in layer)
        else:
            g = run_conductances(rng, dims, B, dtype)
        probes = weighted_probes(dims, B > 1)
        before = weighted_launch_counts(ws)
        x, info = weighted_solve_info(gw, gw3, dims, g, tol, probes)
        torch.cuda.synchronize()
        one = {k: v - before[k] for k, v in weighted_launch_counts(ws).items()}
        its = info.iterations.reshape(-1)
        res = info.residual.reshape(-1)
        check(bool(info.converged.all()) and bool(torch.isfinite(x).all()),
              f"{label}: did not converge (iterations {int(its.max())}, "
              f"residual {float(res.max()):.3e})")
        solve = weighted_solver(gw, gw3, dims, g, tol, probes)
        R, _ = solve()
        times, ms = host_median_ms(solve)
        R = R.reshape(-1)
        check(bool(torch.isfinite(R).all()) and bool((R > 0).all()),
              f"{label}: R {R[:4].tolist()}")
        entry = {"phase": "weighted", "path": label, "dims": dims, "B": B,
                 "dtype": str(dtype), "tol": tol,
                 "probes": probes,
                 "iterations": [int(its.min()), int(its.max())],
                 "residual_max": float(res.max()),
                 "R": float(R[0]) if B == 1 else [float(R.min()),
                                                   float(R.max())],
                 "launches_per_solve": one, "ms_reps": times,
                 "median_ms": ms,
                 "solves_per_s": B / (ms / 1e3)}
        emit(entry)
        results[label] = entry
        if label == "wgrid1000_f32":
            check(one["coarse_sweeps"] > 0 and one["coarse_block"] == 0,
                  f"{label}: the 125² coarsest level took {one}")
        if label in WEIGHTED_SINGLES:
            worst = 0.0
            for i in (0, B // 2, B - 1):
                Ri, _ = weighted_solver(
                    gw, gw3, dims, tuple(t[i] for t in g), tol, probes)()
                worst = max(worst, abs(float(Ri) - float(R[i]))
                            / abs(float(Ri)))
            emit({"phase": "weighted_singles", "path": label,
                  "samples": [0, B // 2, B - 1], "worst_rel": worst,
                  "tol": WEIGHTED_BATCH_RTOL})
            check(worst <= WEIGHTED_BATCH_RTOL,
                  f"{label}: batched samples {worst:.3e} from single solves")
        del x, info, g
        torch.cuda.empty_cache()
    r32 = results["wgrid1024_f32"]["R"]
    r64 = results["wgrid1024_f64"]["R"]
    check(abs(r32 - r64) <= 1e-4 * r64,
          f"wgrid1024: R in f32 {r32!r} and f64 {r64!r} differ")

    # g = 1: the uniform grid of unit resistors, solved by both paths.
    a, b = weighted_probes((n, n))
    ones = (torch.ones(n, n - 1, dtype=torch.float64, device="cuda"),
            torch.ones(n - 1, n, dtype=torch.float64, device="cuda"))
    Rw, _ = gw.weighted_equivalent_resistance(n, n, *ones, a, b, 1e-11,
                                              device="cuda")
    Ru, _ = grid.grid_equivalent_resistance(n, n, a, b, dtype=torch.float64,
                                            tol=1e-11, device="cuda")
    rel = abs(float(Rw) - float(Ru)) / abs(float(Ru))
    emit({"phase": "weighted_identity", "n": n, "R_weighted": float(Rw),
          "R_uniform": float(Ru), "rel": rel,
          "tol": WEIGHTED_IDENTITY_RTOL})
    check(rel <= WEIGHTED_IDENTITY_RTOL,
          f"g = 1: weighted R {float(Rw)!r} vs uniform {float(Ru)!r}")

    # The card against the port's CPU route, f64.
    for dims in WEIGHTED_CPU_DIMS:
        g = run_conductances(rng, dims, 1, torch.float64)
        probes = weighted_probes(dims)
        x, info = weighted_solve_info(gw, gw3, dims, g, 1e-10, probes)
        R = float(weighted_solver(gw, gw3, dims, g, 1e-10, probes)()[0][0])
        gc = tuple(t.cpu() for t in g)
        pa, pb = probes
        rhs = gw.probe_fields(dims, pa, pb, 1, torch.float64, "cpu")
        if len(dims) == 2:
            xc, ic = gw.weighted_grid_solve(*gc[:2], rhs, tol=1e-10,
                                            device="cpu")
            Rc = float(gw.weighted_equivalent_resistance(
                *dims, *gc[:2], pa, pb, 1e-10, device="cpu")[0][0])
        else:
            xc, ic = gw3.weighted_lattice_solve(*gc, rhs, tol=1e-10,
                                                device="cpu")
            Rc = float(gw3.weighted_equivalent_resistance_3d(
                *dims, *gc, pa, pb, 1e-10, device="cpu")[0][0])
        x_rel = float((x.cpu() - xc).abs().max() / xc.abs().max())
        r_rel = abs(R - Rc) / abs(Rc)
        emit({"phase": "weighted_cpu_route", "dims": dims, "R": R,
              "R_cpu": Rc, "R_rel": r_rel, "x_rel": x_rel,
              "iterations": int(info.iterations[0]),
              "iterations_cpu": int(ic.iterations[0]),
              "tol": WEIGHTED_CPU_RTOL})
        check(r_rel <= WEIGHTED_CPU_RTOL and x_rel <= WEIGHTED_CPU_RTOL,
              f"{dims}: the card's R / x {r_rel:.3e} / {x_rel:.3e} from "
              "the CPU route")

    # dR/dgx at 1024² f64 against central differences.
    gx, gy = layer[0][0], layer[1][0]
    gxt = gx.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R, _ = gw.weighted_equivalent_resistance(n, n, gxt, gy, a, b, 1e-12,
                                             device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    R.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads, fds = [], []
    for e in WEIGHTED_FD_EDGES:
        Rs = []
        for sgn in (1, -1):
            ge = gx.clone()
            ge[e] += sgn * WEIGHTED_FD_STEP
            Rs.append(float(gw.weighted_equivalent_resistance(
                n, n, ge, gy, a, b, 1e-12, device="cuda")[0]))
        grads.append(float(gxt.grad[e]))
        fds.append((Rs[0] - Rs[1]) / (2 * WEIGHTED_FD_STEP))
    scale = max(abs(v) for v in grads)
    err = max(abs(p - q) for p, q in zip(grads, fds)) / scale
    emit({"phase": "weighted_gradient", "n": n, "edges": WEIGHTED_FD_EDGES,
          "dR_dgx": grads, "central_differences": fds, "rel": err,
          "tol": WEIGHTED_FD_RTOL, "forward_ms": (t1 - t0) * 1e3,
          "backward_ms": (t2 - t1) * 1e3})
    check(err <= WEIGHTED_FD_RTOL,
          f"dR/dgx {grads} vs central differences {fds}")
    torch.cuda.empty_cache()
    return weighted_launch_counts(ws)


# What each weighted kernel replaces: no Pallas kernel, the XLA fusions
# of these JAX functions.
WEIGHTED_FUSES = (
    ("weighted_residual",
     "no TPU kernel; fuses nodal_tpu/ops/grid_weighted.py:34 "
     "weighted_laplacian_matvec (+ :99-102 restrict), "
     "nodal_tpu/ops/grid_weighted3.py:42"),
    ("weighted_jacobi",
     "no TPU kernel; fuses nodal_tpu/ops/grid_weighted.py:86 jacobi "
     "(+ :104 prolong), nodal_tpu/ops/grid_weighted3.py:103"),
    ("weighted_jacobi_block",
     "no TPU kernel; fuses nodal_tpu/ops/grid_weighted.py:109-111 "
     "coarsest sweeps, nodal_tpu/ops/grid_weighted3.py:131-133"),
)
WEIGHTED_KERNEL_NAMES = {"weighted_residual": ("residual_kernel",
                                               "restrict_kernel"),
                         "weighted_jacobi": ("jacobi_kernel",),
                         "weighted_jacobi_block": ("jacobi_block_kernel",)}


def phase_weighted_profile(ws, gw, rng) -> None:
    """A ``torch.profiler`` trace of the wgrid1024 f32 solve: a lead-in and
    two solves in spans; for each the weighted kernels by name against the
    wrappers' launches (the trace is taken again, up to
    ``GRID_PROFILE_TRIES`` times, until they agree), kernels and host syncs
    a CG iteration, device ms, idle share and the top kernels by name."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = WEIGHTED_LAYER_N
    g = run_conductances(rng, (n, n), 1, torch.float32)
    solve = functools.partial(weighted_solve_info, gw, None, (n, n), g, 1e-6,
                              weighted_probes((n, n)))
    labels = ["wsolve_lead", "wsolve_0", "wsolve_1"]
    for attempt in range(GRID_PROFILE_TRIES):
        launches, its = {}, {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for label in labels:
                reset_weighted_counts(ws)
                with record_function(label):
                    _, info = solve()
                    torch.cuda.synchronize()
                launches[label] = weighted_launch_counts(ws)
                its[label] = int(info.iterations[0])
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        kernels, syncs = split_trace(events, labels[1:])
        solves, whole = [], True
        for label in labels[1:]:
            ks = kernels[label]
            names = {}
            for e in ks:
                k = kernel_name(e["name"])
                names[k] = names.get(k, 0) + 1
            traced = {w: sum(names.get(k, 0) for k in keys)
                      for w, keys in WEIGHTED_KERNEL_NAMES.items()}
            want = {w: launches[label][w] for w in WEIGHTED_KERNEL_NAMES}
            if not ks or traced != want:
                whole = False
                emit({"phase": "weighted_profile", "trace_not_whole": label,
                      "traced": traced, "launched": want})
                break
            busy = sum(e["dur"] for e in ks) / 1e3
            window = (max(e["ts"] + e["dur"] for e in ks)
                      - min(e["ts"] for e in ks)) / 1e3
            by_name = {}
            for e in ks:
                k = kernel_name(e["name"])
                by_name[k] = by_name.get(k, 0.0) + e["dur"] / 1e3
            solves.append({"iterations": its[label], "kernels": len(ks),
                           "kernels_per_iteration": len(ks) / its[label],
                           "host_syncs": syncs[label],
                           "host_syncs_per_iteration":
                               syncs[label] / its[label],
                           "device_ms": busy, "window_ms": window,
                           "idle_share": max(0.0, 1.0 - busy / window),
                           "top_kernels_ms": dict(sorted(
                               by_name.items(), key=lambda kv: -kv[1])[:8]),
                           "launches": launches[label]})
        if whole:
            emit({"phase": "weighted_profile", "path": "wgrid1024_f32",
                  "traces_not_whole": attempt, "solves": solves})
            return
    fail(f"weighted profile: no whole trace in {GRID_PROFILE_TRIES} tries")


def phase_weighted(grid):
    """The weighted grids and lattices on the card: the three kernels
    against their plain versions and timed, the solves of
    ``WEIGHTED_RUNS`` with their checks, then a profile.  Returns the
    wrappers' launches on the solves and the kernels' timings."""
    from nodal_tpu_torch.ops import grid_weighted as gw
    from nodal_tpu_torch.ops import grid_weighted3 as gw3
    from nodal_tpu_torch.ops import weighted_stencil as ws

    rng = np.random.default_rng(0)
    timing = phase_weighted_kernels(ws, rng)
    launches = phase_weighted_solves(ws, gw, gw3, grid, rng)
    emit({"phase": "weighted_launches", **launches})
    check(all(launches[k] > 0 for k in WEIGHTED_KERNEL_NAMES),
          f"a weighted kernel never launched on the solves: {launches}")
    phase_weighted_profile(ws, gw, rng)
    return launches, timing


# The sharded batch paths: the sweep paths' circuits at their
# batches through make_sharded_batch_solver on a one-rank NCCL mesh.
PARALLEL_PATHS = (("ladder", "tridiag", ("pcr_solve",)),
                  ("mesh", "sband", ("sband_solve_multi",)),
                  ("branch", "schur", ("sband_solve_multi",)),
                  ("lattice", "band", ("band_solve_multi",)),
                  ("randnet", "block", ("lu_factor", "lu_solve_factored")))
PARALLEL_GRAD_PATHS = ("ladder", "mesh")
PARALLEL_REFINE_BATCH = GENERAL_BATCH   # the dense core's [B, n, n] in f32
PARALLEL_BITS_TOL = 1e-6    # of max|x|, if a sharded block differs in bits
PARALLEL_GRID_N = 1024      # BASELINE config 5
PARALLEL_GRID_RUNS = ((torch.float32, 1e-6), (torch.float64, 1e-10))
PARALLEL_HALO_RTOL = {torch.float32: 1e-4, torch.float64: 1e-6}
PARALLEL_PLAIN_CG_N = 64    # mg=False only here: 20·n iterations at most
PARALLEL_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                        "batch_isend_irecv")


def parallel_rows(label: str):
    """The rows of a sweep path of ``PARALLEL_PATHS``."""
    from nodal_tpu_torch.utils.gridgen import ladder_rows

    if label == "ladder":
        return ladder_rows(LADDER_RUNGS)
    if label in ("mesh", "branch"):
        return mesh_rows(MESH_NODES, branch=label == "branch")
    if label == "lattice":
        return lattice_rows(20, 10, 10)
    return randnet_rows()


@contextlib.contextmanager
def counted_collectives():
    """Counts of each ``torch.distributed`` collective called inside the
    block (the halo solver and the CG look them up at call time)."""
    import torch.distributed as dist

    counts = dict.fromkeys(PARALLEL_COLLECTIVES, 0)
    saved = {name: getattr(dist, name) for name in PARALLEL_COLLECTIVES}

    def wrap(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in PARALLEL_COLLECTIVES:
        setattr(dist, name, wrap(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def parallel_batch(mesh, label, tier, names, total) -> None:
    """One sharded sweep path at its batch: the wrappers' launches over
    exactly the sharded call (added to ``total``), its block against the
    unsharded tier on the same rows, both timed by CUDA events."""
    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist
    from nodal_tpu_torch.parallel.sharded import make_sharded_batch_solver

    circuit = Circuit(Netlist.from_rows(parallel_rows(label)))
    batch = BATCH if label in ("ladder", "mesh", "branch") else GENERAL_BATCH
    params = torch.as_tensor(sweep_params(circuit, batch), device="cuda")
    sharded = make_sharded_batch_solver(circuit.stamps, mesh)
    check(sharded.tier == tier, f"sharded {label}: tier {sharded.tier}")
    xs, launches = counted(lambda: sharded(params))
    check(all(launches[k] > 0 for k in names),
          f"sharded {label}: a kernel of {names} never launched: {launches}")
    add_launches(total, launches)
    local = BatchedSolver(circuit, dtype=torch.float32, refine=False,
                          method=tier, device="cuda")
    ref = local(params)
    bits = torch.equal(xs, ref)
    diff = float((xs - ref).abs().max() / ref.abs().max())
    times, ms = median_call_ms(sharded, params)
    ref_times, ref_ms = median_call_ms(local, params)
    emit({"phase": "parallel_batch", "path": label, "tier": tier,
          "B": batch, "n": circuit.stamps.n, "launches": launches,
          "bits_equal_unsharded": bits, "max_rel_diff": diff,
          "ms_reps": times, "median_ms": ms,
          "solves_per_s": batch / (ms / 1e3), "unsharded_ms_reps": ref_times,
          "unsharded_median_ms": ref_ms,
          "unsharded_solves_per_s": batch / (ref_ms / 1e3)})
    check(bits or diff <= PARALLEL_BITS_TOL,
          f"sharded {label}: {diff:.3e} from the unsharded tier")
    if label == "mesh":
        parallel_refine(mesh, circuit, params[:PARALLEL_REFINE_BATCH])
    if label in PARALLEL_GRAD_PATHS:
        w = torch.as_tensor(np.random.default_rng(7).standard_normal(
            (batch, circuit.stamps.n)).astype(np.float32), device="cuda")
        grads = []
        for solve in (sharded, local):
            p = params.clone().requires_grad_()
            x = solve(p)
            _, back = counted(lambda: (w * x).sum().backward())
            grads.append(p.grad)
            if solve is sharded:
                check(all(back[k] > 0 for k in names),
                      f"sharded {label}: no backward launch: {back}")
                add_launches(total, back)
        gdiff = float((grads[0] - grads[1]).abs().max()
                      / grads[1].abs().max())
        emit({"phase": "parallel_gradient", "path": label, "B": batch,
              "backward_launches": back,
              "bits_equal_unsharded": torch.equal(*grads),
              "max_rel_diff": gdiff})
        check(gdiff <= PARALLEL_BITS_TOL,
              f"sharded {label}: gradient {gdiff:.3e} from the unsharded")
    del xs, ref
    torch.cuda.empty_cache()


def parallel_refine(mesh, circuit, params) -> None:
    """``refine=True`` (the dense core, f64 out) on the mesh against the
    sband tier's raw f64 solve."""
    from nodal_tpu_torch import BatchedSolver
    from nodal_tpu_torch.parallel.sharded import make_sharded_batch_solver

    sharded = make_sharded_batch_solver(circuit.stamps, mesh, refine=True)
    xs, launches = counted(lambda: sharded(params))
    x64 = BatchedSolver(circuit, dtype=torch.float64, refine=False,
                        method="sband", device="cuda")(params)
    err = float(rel_errors(xs, x64).max())
    times, ms = median_call_ms(sharded, params)
    emit({"phase": "parallel_refine", "path": "mesh", "tier": sharded.tier,
          "B": len(params), "dtype": str(xs.dtype), "launches": launches,
          "max_rel_err_vs_f64": err, "median_ms": ms,
          "solves_per_s": len(params) / (ms / 1e3)})
    check(sharded.tier == "dense" and xs.dtype == torch.float64,
          f"refine=True: tier {sharded.tier}, {xs.dtype}")
    check(err <= CONTRACT_TOL, f"refine=True: {err:.3e} from f64")
    del xs, x64
    torch.cuda.empty_cache()


def parallel_grids(grid, st, mesh, total) -> None:
    """BASELINE config 5's grid by the sharded and the halo solvers on the
    knight's-move probe fields (B = 2), against ``grid_solve`` on the card;
    the plain halo CG at 64²; each solver's host ms, iterations and
    collectives an iteration.  The stencil wrappers' launches on the
    sharded and halo solves are added to ``total``."""
    from nodal_tpu_torch.parallel.halo import make_halo_grid_solver
    from nodal_tpu_torch.parallel.sharded import make_sharded_grid_solver

    def run(solve):
        reset_grid_counts(st)
        with counted_collectives() as coll:
            out = solve()
            torch.cuda.synchronize()
        counts = grid_launch_counts(st)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, counts, dict(coll)

    for n, runs, mg in ((PARALLEL_GRID_N, PARALLEL_GRID_RUNS, True),
                        (PARALLEL_PLAIN_CG_N, ((torch.float64, 1e-10),),
                         False)):
        pairs = probe_pairs(n)[:2] if mg else np.array(
            [knight_probes(n), ((0, 0), (n - 1, n - 1))])
        for dtype, tol in runs:
            label = f"grid{n}_{'f32' if dtype == torch.float32 else 'f64'}"
            rhs, idx, pa, pb = grid._probe_fields(n, n, pairs, dtype, "cuda")
            kw = {"dtype": dtype, "tol": tol, "mg": mg, "device": "cuda"}
            ref = functools.partial(grid.grid_solve, n, n, rhs, **kw)
            x_ref, info = ref()
            sharded = make_sharded_grid_solver(n, n, mesh, **kw)
            (x_sh, res_sh), sh_counts, sh_coll = run(lambda: sharded(rhs))
            bits = torch.equal(x_sh, x_ref) and torch.equal(
                res_sh, info.residual)
            check(bits, f"sharded {label}: not grid_solve's bits")
            if mg:
                check(all(sh_counts[k] > 0 for k in (
                    "presmooth_restrict", "prolong_postsmooth", "vcycle")),
                    f"sharded {label}: stencil launches {sh_counts}")
            halo = make_halo_grid_solver(n, n, mesh, **kw)
            (x_h, res_h, its_h), h_counts, h_coll = run(lambda: halo(rhs))
            err = float((x_h - x_ref).abs().max() / x_ref.abs().max())
            its, its_ref = int(its_h.max()), int(info.iterations.max())
            flat = x_h.reshape(len(pairs), n * n)
            R = (flat[idx, pa] - flat[idx, pb]).abs().tolist()
            if mg:
                check(h_counts["vcycle"] > 0,
                      f"halo {label}: the gathered level's cycle never ran")
            check(err <= PARALLEL_HALO_RTOL[dtype],
                  f"halo {label}: {err:.3e} of max|x| from grid_solve")
            check(not mg or bool((its_h <= info.iterations).all()),
                  f"halo {label}: {its_h.tolist()} CG iterations, grid_solve"
                  f" {info.iterations.tolist()}")
            check(bool((res_h <= tol).all()), f"halo {label}: residual "
                  f"{float(res_h.max()):.3e}")
            check(not mg or all(abs(r - 0.7732) < 5e-3 for r in R),
                  f"halo {label}: R = {R}")
            t_sh, ms_sh = host_median_ms(lambda: sharded(rhs))
            t_h, ms_h = host_median_ms(lambda: halo(rhs))
            t_ref, ms_ref = host_median_ms(ref)
            emit({"phase": "parallel_grid", "path": label, "mg": mg,
                  "B": len(pairs), "tol": tol, "R": R,
                  "sharded_bits_equal_grid_solve": bits,
                  "sharded_launches": sh_counts,
                  "sharded_collectives": sh_coll,
                  "halo_launches": h_counts, "halo_collectives": h_coll,
                  "halo_collectives_per_iteration": {
                      k: v / its for k, v in h_coll.items()},
                  "halo_iterations": its_h.tolist(),
                  "grid_solve_iterations": info.iterations.tolist(),
                  "halo_max_rel_diff": err,
                  "halo_max_residual": float(res_h.max()),
                  "sharded_ms_reps": t_sh, "sharded_median_ms": ms_sh,
                  "halo_ms_reps": t_h, "halo_median_ms": ms_h,
                  "halo_ms_per_iteration": ms_h / its,
                  "grid_solve_median_ms": ms_ref})
            del rhs, x_ref, x_sh, x_h
            torch.cuda.empty_cache()


def phase_parallel(grid, st):
    """The multi-device slice on a one-rank NCCL job: the sharded sweep
    paths (``PARALLEL_PATHS``) against their unsharded tiers, the
    gradients and ``refine=True``, the sharded and halo grid solvers, then
    ``dryrun_multichip(1)``.  Returns the batch wrappers' and the stencil
    wrappers' launches on the sharded paths."""
    import socket

    import torch.distributed as dist
    from nodal_tpu_torch.parallel import dryrun, multihost

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        mesh = multihost.global_mesh()
        check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1),
              f"{dist.get_backend()} mesh {tuple(mesh.shape)}")
        batch, stencil_total = {}, {}
        for label, tier, names in PARALLEL_PATHS:
            parallel_batch(mesh, label, tier, names, batch)
        parallel_grids(grid, st, mesh, stencil_total)
        summary = dryrun.dryrun_multichip(1, device="cuda")
        emit({"phase": "parallel_dryrun", **summary})
    finally:
        dist.destroy_process_group()
    check("jax" not in sys.modules, "jax was imported")
    emit({"phase": "parallel_launches", "batch": batch,
          "stencil": stencil_total,
          "seconds": time.perf_counter() - t0})
    return batch, stencil_total


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
    subst_timing = phase_band_subst(block_thomas, band)
    lu_worst, lu_timing = phase_lu_kernel(lu, block_lu)
    emit({"phase": "kernel_check_worst",
          "pcr_solve": {str(k): v for k, v in worst.items()},
          "sband_solve": {str(k): v for k, v in sb_worst.items()},
          "band_solve": {str(k): v for k, v in bt_worst.items()},
          "lu_solve": {str(k): v for k, v in lu_worst.items()}})
    clock("solver kernels")
    launches = phase_path("ladder", ladder_rows(LADDER_RUNGS), BATCH,
                          "tridiag", (pcr.pcr_solve,),
                          ("auto", False))["pcr_solve"]
    sb = (sband.sband_solve_multi,)
    sb_launches = phase_path("mesh", mesh_rows(MESH_NODES), BATCH, "sband",
                             sb, ("auto", False))["sband_solve_multi"]
    for n_nodes in MIDSIZE_NODES:
        sb_launches += phase_path(
            f"midsize{n_nodes}", mesh_rows(n_nodes), MIDSIZE_BATCH, "sband",
            sb, ("auto",))["sband_solve_multi"]
    sb_launches += phase_path(
        "branch", mesh_rows(MESH_NODES, branch=True), BATCH, "schur",
        sb, ("auto", False),
        functools.partial(branch_check, kernel=sband.sband_solve_multi)
    )["sband_solve_multi"]
    # The lattice and the 100×100 mesh (kb 128) keep their elimination, so
    # their "auto" calls must substitute; the wide lattice (kb 256) and the
    # schur node band eliminate for every solve.
    bt = (block_thomas.band_solve_multi,)
    kept = bt + (block_thomas.band_substitute,)
    bt_launches = subst_launches = 0
    for label, rows, batch, kernels_of in (
            ("lattice", lattice_rows(20, 10, 10), GENERAL_BATCH, kept),
            ("widemesh", grid_circuit_rows(100, 100), MIDSIZE_BATCH, kept),
            ("widelattice", lattice_rows(12, 14, 14), MIDSIZE_BATCH, bt)):
        got = phase_path(label, rows, batch, "band", kernels_of,
                         ("auto", False))
        bt_launches += got["band_solve_multi"]
        subst_launches += got.get("band_substitute", 0)
    bt_launches += phase_path(
        "widebranch", grid_circuit_rows(64, 64, branch=True), GENERAL_BATCH,
        "schur", bt, ("auto", False),
        functools.partial(branch_check, kernel=block_thomas.band_solve_multi)
    )["band_solve_multi"]
    lus = (lu.lu_factor, lu.lu_solve_factored)
    lu_launches = 0
    for label, rows, batch, method, extra in (
            ("randnet", randnet_rows(), GENERAL_BATCH, "block", None),
            ("randnet4k", randnet_rows(RANDNET4K_NODES, RANDNET4K_EDGES),
             RANDNET4K_BATCH, "block", None),
            ("randbranch", randnet_rows(branch=True), GENERAL_BATCH, "schur",
             functools.partial(branch_check, kernel=lu.lu_solve_factored))):
        lu_launches += sum(phase_path(label, rows, batch, method, lus,
                                      ("auto", False), extra).values())
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
    bt_launches += phase_circuit()["band_solve_multi"]
    clock("circuit")
    bt_launches += phase_equiv_many()["band_solve_multi"]
    clock("equiv many")
    phase_sparse()
    clock("sparse")
    phase_general_sparse()
    clock("general sparse")
    mc_launches = phase_monte_carlo()
    clock("monte carlo")
    sens_launches = phase_sensitivities()
    clock("sensitivities")
    emit({"phase": "analysis_launches", "monte_carlo": mc_launches,
          "sensitivities": sens_launches})
    w_launches, w_timing = phase_weighted(grid)
    clock("weighted")
    p_batch, p_stencil = phase_parallel(grid, stencil)
    clock("parallel")
    launches += p_batch.get("pcr_solve", 0)
    sb_launches += p_batch.get("sband_solve_multi", 0)
    bt_launches += p_batch.get("band_solve_multi", 0)
    lu_launches += (p_batch.get("lu_factor", 0)
                    + p_batch.get("lu_solve_factored", 0))
    for k, v in p_stencil.items():
        st_launches[k] += v
    for counts in (mc_launches, sens_launches):
        launches += counts.get("pcr_solve", 0)
        sb_launches += counts.get("sband_solve_multi", 0)
        bt_launches += counts.get("band_solve_multi", 0)
        lu_launches += (counts.get("lu_factor", 0)
                        + counts.get("lu_solve_factored", 0))

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
        kernel_entry("block_thomas_subst",
                     "nodal_tpu_torch/csrc/block_thomas.cu",
                     "none (no TPU kernel substitutes on a kept "
                     "elimination)", subst_launches, subst_timing),
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
        *(kernel_entry(name, "nodal_tpu_torch/csrc/weighted_stencil.cu",
                       fuses, w_launches[name],
                       w_timing[(name, torch.float32)])
          for name, fuses in WEIGHTED_FUSES),
    ]})
    check("jax" not in sys.modules, "jax was imported")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
