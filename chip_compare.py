"""Two checkouts' kernels, in turns on one GPU.

    python3 chip_compare.py [--mma] ROOT [ROOT ...]
    python3 chip_compare.py --sband ROOT [ROOT ...]
    python3 chip_compare.py --grid ROOT [ROOT ...]

Each ROOT is a directory that holds a ``nodal_tpu_torch`` package: this
checkout (``.``) or another commit unpacked beside it, for instance

    git archive HEAD~1 | tar -x -C _checkout      # _checkout/ is git-ignored
    python3 chip_compare.py _checkout . . _checkout

Each ROOT runs in a process of its own, in the order given, and builds its
own kernels.  It measures, with this checkout's ``chip_smoke.py`` helpers,
by default the blocked-LU and block-Thomas kernels:

* the blocked LU at ``chip_smoke.LU_TIME_SHAPES`` and the block Thomas at
  ``chip_smoke.BAND_TIME_SHAPES``, f32 and f64: kernel against plain
  device ms (``time_lu``, ``time_band``), the factorization's and the
  sweeps' device ms by kernel name, and on the Laplacian class in f32 each
  solve's distance from the f64 kernel's (``kernel_vs_f64``);
* the block Thomas's raw f32 error on the ``lattice`` and ``widemesh`` bands
  (``phase_band_accuracy``);
* ``BatchedSolver(refine="auto")`` solves/s (CUDA events, median of 5) of
  the paths that run these kernels, with the kernels' launches in a call.

With ``--sband``, the scalar-band kernel instead: its registers, stack and
spills (``cuobjdump``); its difference from the plain solver at every
``chip_smoke.SBAND_SHAPES`` shape, f32 and f64, reported beside
``SBAND_RTOL`` and not asserted (a ROOT may be a variant whose answers are
wrong on purpose); its device ms against the plain solver's and its bound
at ``chip_smoke.SBAND_TIME_SHAPES`` (``time_sband``), with the launch
configuration and the SM clock; and, where every check passed, the
``auto`` solves/s of the mesh, midsize and branch paths (``SBAND_PATHS``).

With ``--grid``, the multigrid V-cycle and the grid solve instead: the
transfer kernels (``presmooth_restrict``, ``prolong_postsmooth``, each
with and without a given x) by kernel name from a trace (``kernel_split``)
at ``TRANSFER_SHAPES``, f32 and f64, beside their bounds
(``chip_smoke.stencil_bound``); the ``vcycle`` wrapper's event time and
its device time by kernel name at the 1024², 1022² and 1000² finest
shapes, f32 and f64; ``jacobi_sweeps`` at 96 sweeps on the coarsest shapes
(``chip_smoke.CLUSTER_JACOBI_SHAPES``); kernels and device ms a solve (by
trace) and the host-clock latency (``host_median_ms``) of the
``GRID_COMPARE_RUNS`` grids and the 16 probe pairs; and, where the ROOT
has cluster kernels, the cycle at 1024² f32 and its grid solve with
clusters of at most 8 against at most 16.

Prints the card's name and power limit, then one JSON line a measurement
tagged with its ROOT; with ``--mma`` first the FP64 ``mma.sync`` shapes'
rates.  Imports no JAX.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

# (label, rows from chip_smoke's builders, batch, wrappers to count).
AUTO_PATHS = [
    ("randnet", lambda cs: cs.randnet_rows(), "GENERAL_BATCH", "lu"),
    ("randnet4k", lambda cs: cs.randnet_rows(cs.RANDNET4K_NODES,
                                             cs.RANDNET4K_EDGES),
     "RANDNET4K_BATCH", "lu"),
    ("randbranch", lambda cs: cs.randnet_rows(branch=True), "GENERAL_BATCH",
     "lu"),
    ("lattice", lambda cs: cs.lattice_rows(20, 10, 10), "GENERAL_BATCH",
     "band"),
    ("widemesh", lambda cs: cs.grid_circuit_rows(100, 100), "MIDSIZE_BATCH",
     "band"),
    ("widelattice", lambda cs: cs.lattice_rows(12, 14, 14), "MIDSIZE_BATCH",
     "band"),
    ("widebranch", lambda cs: cs.grid_circuit_rows(64, 64, branch=True),
     "GENERAL_BATCH", "band"),
]

# The scalar-band kernel's main paths, as ``AUTO_PATHS``.
SBAND_PATHS = [
    ("mesh", lambda cs: cs.mesh_rows(cs.MESH_NODES), "BATCH", "sband"),
    *((f"midsize{n}", lambda cs, n=n: cs.mesh_rows(n), "MIDSIZE_BATCH",
       "sband") for n in (5000, 10000)),
    ("branch", lambda cs: cs.mesh_rows(cs.MESH_NODES, branch=True), "BATCH",
     "sband"),
]

# The grid solves --grid times, by their chip_smoke.GRID_RUNS labels.
GRID_COMPARE_RUNS = ("grid1024_f32", "grid1024_f64", "grid4096_f32",
                     "grid1000_f64", "grid1022_f32")
# (B, h, w) the transfer kernels are traced at: the 1024² grid's finest
# level, the 16-pair batch's and the 4096² grid's.
TRANSFER_SHAPES = [(1, 1024, 1024), (16, 1024, 1024), (1, 4096, 4096)]

MMA_SRC = r"""
#include <cuda_runtime.h>
namespace {
template <int S>
__global__ void rate_kernel(double* sink, int iters) {
  double a[8], b[4], d[4][4] = {};
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (S == 0)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
                     : "+d"(d[u][0]), "+d"(d[u][1]) : "d"(a[u]), "d"(b[u]));
      if (S == 1)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+d"(d[u][0]), "+d"(d[u][1]), "+d"(d[u][2]),
                       "+d"(d[u][3])
                     : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]),
                       "d"(b[0]), "d"(b[1]));
    }
  }
  double s = 0;
  for (int u = 0; u < 4; ++u) for (int i = 0; i < 4; ++i) s += d[u][i];
  if (s == 12345.0) sink[0] = s;
}
}  // namespace
extern "C" int mma_rate(int shape, double* sink, int blocks, int iters) {
  if (shape == 0) rate_kernel<0><<<blocks, 256>>>(sink, iters);
  if (shape == 1) rate_kernel<1><<<blocks, 256>>>(sink, iters);
  return (int)cudaGetLastError();
}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smoke_helpers():
    """This checkout's chip_smoke.py, loaded under a name of its own so
    that another ROOT's copy is never picked up."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mma_rates() -> None:
    """TFLOP/s of the FP64 tensor cores by mma.sync shape: 1056 blocks of
    8 warps, each issuing 4 independent chains of 4096 products."""
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "mma.cu", Path(tmp) / "libmma.so"
        src.write_text(MMA_SRC)
        proc = subprocess.run(
            ["/usr/local/cuda/bin/nvcc", "-gencode",
             "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-o", str(lib_path), str(src)],
            capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"chip_compare: nvcc failed: {proc.stderr[-2000:]}")
        lib = ctypes.CDLL(str(lib_path))
        lib.mma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int]
        sink = torch.zeros(1, dtype=torch.float64, device="cuda")
        blocks, iters = 132 * 8, 4096
        for shape, (name, mnk) in enumerate((("m8n8k4", 256),
                                             ("m16n8k8", 1024))):
            lib.mma_rate(shape, sink.data_ptr(), blocks, 16)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.mma_rate(shape, sink.data_ptr(), blocks, iters)
            end.record()
            end.synchronize()
            flops = blocks * 8 * iters * 4 * 2 * mnk
            emit({"phase": "mma_f64", "shape": name, "launch_err": err,
                  "tflops": flops / start.elapsed_time(end) / 1e9})


def load_root(root: Path):
    """This checkout's chip_smoke helpers and ROOT's package, with its
    kernels built; returns (helpers, tag)."""
    sys.path.insert(0, str(root))
    cs = smoke_helpers()
    import nodal_tpu_torch
    from nodal_tpu_torch.utils import kernels

    pkg = Path(nodal_tpu_torch.__file__).resolve().parent
    if pkg.parent != root.resolve():
        sys.exit(f"chip_compare: nodal_tpu_torch came from {pkg}")
    tag = {"root": str(root)}
    t0 = time.perf_counter()
    kernels.load_library()
    emit({**tag, "phase": "build", "seconds": time.perf_counter() - t0})
    return cs, tag


def auto_rates(cs, tag, paths, wrappers) -> None:
    """``BatchedSolver(refine="auto")`` solves/s of each path, with the
    launches of its kind's wrappers in one call."""
    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist

    for label, rows, batch, kind in paths:
        B = getattr(cs, batch)
        circuit = Circuit(Netlist.from_rows(rows(cs)))
        solver = BatchedSolver(circuit, dtype=torch.float32, refine="auto",
                               device="cuda")
        params = torch.as_tensor(cs.sweep_params(circuit, B), device="cuda")
        for w in wrappers[kind]:
            w.launches = 0
        solver(params)
        torch.cuda.synchronize()
        launches = sum(w.launches for w in wrappers[kind])
        times, ms = cs.median_call_ms(solver, params)
        emit({**tag, "phase": "auto_rate", "path": label, "B": B,
              "method": solver.method, "launches": launches,
              "ms_reps": times, "median_ms": ms,
              "solves_per_s": B / (ms / 1e3)})
        del solver, params
        torch.cuda.empty_cache()


def busy_sm_clock_mhz(fn, calls: int = 40) -> float:
    """The SM clock (MHz) that ``nvidia-smi`` reads while ``calls`` queued
    ``fn()`` calls keep the card busy."""
    for _ in range(calls):
        fn()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    return float(smi.stdout.split()[0])


def measure_sband(root: Path) -> None:
    cs, tag = load_root(root)
    from nodal_tpu_torch.ops import sband, scalar_band
    from nodal_tpu_torch.utils import kernels

    cs.emit = lambda obj: emit({**tag, **obj})
    cs.phase_resources(kernels.library_path(), only="sband")
    gen = torch.Generator(device="cuda").manual_seed(1)
    right = True
    for dtype in (torch.float32, torch.float64):
        for shape in cs.SBAND_SHAPES:
            err = cs.check_sband(sband, scalar_band, shape, dtype, gen)
            right &= err <= cs.SBAND_RTOL[dtype]
            emit({**tag, "phase": "kernel_check", "kernel": "sband_solve",
                  "shape": shape, "dtype": str(dtype), "max_rel_diff": err,
                  "tol": cs.SBAND_RTOL[dtype],
                  "within_tol": err <= cs.SBAND_RTOL[dtype]})
    for B, n, w, n_rhs in cs.SBAND_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            U, R = cs.random_sband(B, n, w, n_rhs, dtype, gen)
            t = cs.time_sband(sband, scalar_band, U, R)
            cfg = sband.launch_config(B, n, w + 1, n_rhs, U.element_size())
            mhz = busy_sm_clock_mhz(lambda: sband.sband_solve_multi(U, R))
            us = min(t["kernel_ms"]) * 1e3 / n
            emit({**tag, "phase": "kernel_time", "kernel": "sband_solve",
                  "B": B, "n": n, "w": w, "n_rhs": n_rhs,
                  "dtype": str(dtype), **t, "us_a_row": us, "sm_mhz": mhz,
                  "clocks_a_row": us * mhz, "launch": repr(cfg)})
            del U, R
            torch.cuda.empty_cache()
    if right:  # a variant with wrong answers can make a path's algebra fail
        auto_rates(cs, tag, SBAND_PATHS,
                   {"sband": (sband.sband_solve_multi,)})


def grid_solve_times(cs, tag, label, solve) -> None:
    """Kernels a solve by trace and one call's host-clock latency."""
    split = cs.kernel_split(solve, calls=2)
    times, ms = cs.host_median_ms(solve)
    emit({**tag, "phase": "grid_time", "path": label,
          "kernels_per_solve": sum(split["launches_per_call"].values()),
          "device_ms": split["device_ms"], "ms_reps": times,
          "median_ms": ms})


def max_cluster(st, dtype) -> int:
    """The ROOT's ``max_cluster`` on the current card: per card and dtype,
    or, in a checkout from before the per-card cache, per dtype."""
    try:
        return st.max_cluster(torch.cuda.current_device(), dtype)
    except TypeError:
        return st.max_cluster(dtype)


def measure_transfers(cs, tag, st, gen) -> None:
    """Both transfer kernels, with and without x, by kernel name."""
    for B, h, w in TRANSFER_SHAPES:
        for dtype in (torch.float32, torch.float64):
            rnd = lambda *shape: torch.randn(  # noqa: E731
                *shape, generator=gen, device="cuda", dtype=dtype)
            r, x, zc = rnd(B, h, w), rnd(B, h, w), rnd(B, h // 2, w // 2)
            calls = {
                "presmooth_restrict": lambda: st.presmooth_restrict(r),
                "presmooth_restrict/x":
                    lambda: st.presmooth_restrict(r, x=x),
                "prolong_postsmooth": lambda: st.prolong_postsmooth(r, zc),
                "prolong_postsmooth/x":
                    lambda: st.prolong_postsmooth(r, zc, x=x)}
            for name, call in calls.items():
                emit({**tag, "phase": "transfer", "kernel": name, "B": B,
                      "h": h, "w": w, "dtype": str(dtype),
                      **cs.kernel_split(call),
                      **cs.stencil_bound(name, B, h, w, dtype)})
            del r, x, zc
            torch.cuda.empty_cache()


def measure_grid(root: Path) -> None:
    cs, tag = load_root(root)
    from nodal_tpu_torch.ops import grid, stencil as st

    gen = torch.Generator(device="cuda").manual_seed(2)
    measure_transfers(cs, tag, st, gen)
    for n in (1024, 1022, 1000):
        for dtype in (torch.float32, torch.float64):
            r = torch.randn(1, n, n, generator=gen, device="cuda",
                            dtype=dtype)
            emit({**tag, "phase": "vcycle", "n": n, "dtype": str(dtype),
                  "event_ms": cs.event_median_ms(lambda: st.vcycle(r)),
                  **cs.kernel_split(lambda: st.vcycle(r))})
    for B, h, w, dtype in cs.CLUSTER_JACOBI_SHAPES:
        x = torch.randn(B, h, w, generator=gen, device="cuda", dtype=dtype)
        r = torch.randn_like(x)
        call = lambda: st.jacobi_sweeps(x, r,  # noqa: E731
                                        sweeps=cs.COARSE_SWEEPS)
        emit({**tag, "phase": "jacobi_sweeps", "sweeps": cs.COARSE_SWEEPS,
              "B": B, "h": h, "w": w, "dtype": str(dtype),
              "event_ms": cs.event_median_ms(call),
              **cs.kernel_split(call)})
    for label, n, dtype, tol in cs.GRID_RUNS:
        if label not in GRID_COMPARE_RUNS:
            continue
        a, b = cs.knight_probes(n)
        grid_solve_times(cs, tag, label, lambda: grid.
                         grid_equivalent_resistance(n, n, a, b, dtype=dtype,
                                                    tol=tol, device="cuda"))
    pairs = cs.probe_pairs(1024)
    grid_solve_times(cs, tag, f"grid1024_f32_many{len(pairs)}",
                     lambda: grid.grid_equivalent_resistance_many(
                         1024, 1024, pairs, dtype=torch.float32, tol=1e-6,
                         device="cuda"))
    if not hasattr(st, "max_cluster"):
        return
    queried = st.max_cluster
    r = torch.randn(1, 1024, 1024, generator=gen, device="cuda")
    a, b = cs.knight_probes(1024)
    for mc in (16, 8):
        st.max_cluster = lambda *args, mc=mc: min(mc, queried(*args))
        route = st.vcycle_route(1024, 1024, 8, 4, max_cluster(st, r.dtype))
        emit({**tag, "phase": "vcycle_max_cluster", "max_cluster": mc,
              "entry": list(route.shapes[route.stop]),
              "cluster": route.plan and route.plan.cluster,
              "event_ms": cs.event_median_ms(lambda: st.vcycle(r)),
              **cs.kernel_split(lambda: st.vcycle(r))})
        grid_solve_times(cs, {**tag, "max_cluster": mc},
                         "grid1024_f32", lambda: grid.
                         grid_equivalent_resistance(1024, 1024, a, b,
                                                    tol=1e-6, device="cuda"))
    st.max_cluster = queried


def measure(root: Path) -> None:
    cs, tag = load_root(root)
    from nodal_tpu_torch.ops import band, block_lu, block_thomas, lu

    gen = torch.Generator(device="cuda").manual_seed(3)
    for B, n, r in cs.LU_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            A, R = cs.random_laplacian(B, n, r, dtype, gen)
            t = cs.time_lu(lu, block_lu, A, R)
            bound = cs.bound_ms(cs.lu_flops(n, r) * B,
                                (n * n + 2 * n * r) * B * A.element_size(),
                                dtype)
            emit({**tag, "phase": "kernel_time", "kernel": "lu_solve",
                  "B": B, "n_pad": n, "r": r, "dtype": str(dtype), **t,
                  **bound})
            del A, R
            torch.cuda.empty_cache()
    for B, nb, kb, r in cs.BAND_TIME_SHAPES:
        for dtype in (torch.float32, torch.float64):
            W, R = cs.random_block_band(B, nb, kb, r, dtype, gen)
            t = cs.time_band(block_thomas, band, W, R)
            bound = cs.bound_ms(cs.block_thomas_flops(nb, kb, r) * B,
                                nb * kb * (3 * kb + 2 * r) * B
                                * W.element_size(), dtype)
            emit({**tag, "phase": "kernel_time", "kernel": "band_solve",
                  "B": B, "nb": nb, "kb": kb, "r": r, "dtype": str(dtype),
                  **t, **bound})
            del W, R
            torch.cuda.empty_cache()
    cs.phase_band_accuracy("lattice", cs.lattice_rows(20, 10, 10),
                           cs.GENERAL_BATCH)
    cs.phase_band_accuracy("widemesh", cs.grid_circuit_rows(100, 100),
                           cs.MIDSIZE_BATCH)

    auto_rates(cs, tag, AUTO_PATHS,
               {"lu": (lu.lu_factor, lu.lu_solve_factored),
                "band": (block_thomas.band_solve_multi,)})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_compare: CUDA is not available")
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        {"sband": measure_sband, "grid": measure_grid}.get(
            args[1], measure)(Path(args[2]))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    emit(smi.stdout.strip())
    mode = "kernels"
    if args[:1] == ["--mma"]:
        mma_rates()
        args = args[1:]
    elif args[:1] in (["--sband"], ["--grid"]):
        mode, args = args[0][2:], args[1:]
    if not args:
        sys.exit("chip_compare: name at least one ROOT")
    for root in args:
        if not (Path(root) / "nodal_tpu_torch").is_dir():
            sys.exit(f"chip_compare: {root} holds no nodal_tpu_torch")
    for root in args:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--measure", mode, root])
        if proc.returncode:
            sys.exit(f"chip_compare: {root} failed ({proc.returncode})")
    emit(smi.stdout.strip())


if __name__ == "__main__":
    main()
