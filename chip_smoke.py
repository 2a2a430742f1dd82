"""Smoke test of nodal_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nodal_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card, then drives the main path
once — the 1000-node ladder through ``BatchedSolver(refine="auto")`` on a
batch of 16384 parameter vectors — and checks its answers against the f64
audit and a numpy f64 dense solve.  Every phase asserts; any failure exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is unavailable or when the
``nodal_tpu_torch`` package is not beside this script.  Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
        timing[dtype] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                         "max_abs_err": max_abs}
        emit({"phase": "kernel_time", "kernel": "pcr_solve", "n": LADDER_RUNGS,
              "B": BATCH, "dtype": str(dtype), "kernel_ms": [k1, k2],
              "plain_ms": [p1, p2], "max_abs_err": max_abs})
        del bands, got, want
    return worst, timing


def ladder_params(circuit):
    """The sweep batch, made as the JAX package's bench makes it."""
    rng = np.random.default_rng(0)
    base = circuit.stamps.params.astype(np.float32)
    return (base * (1.0 + SWEEP_SIGMA * rng.standard_normal(
        (BATCH, len(base))))).astype(np.float32)


def phase_main_path(pcr):
    from nodal_tpu_torch import BatchedSolver, Circuit, Netlist
    from nodal_tpu_torch.ops.assemble import assemble_dense
    from nodal_tpu_torch.utils.gridgen import ladder_rows

    t0 = time.perf_counter()
    circuit = Circuit(Netlist.from_rows(ladder_rows(LADDER_RUNGS)))
    solver = BatchedSolver(circuit, dtype=torch.float32, refine="auto",
                           device="cuda")
    params_np = ladder_params(circuit)
    params = torch.as_tensor(params_np, device="cuda")
    setup_s = time.perf_counter() - t0
    check(solver.method == "tridiag", f"method is {solver.method}")

    pcr.pcr_solve.launches = 0
    xs = solver(params)
    torch.cuda.synchronize()
    launches = pcr.pcr_solve.launches
    check(launches > 0, "the main path never launched the PCR kernel")
    check(xs.device.type == "cuda" and xs.dtype == torch.float64,
          f"output is {xs.dtype} on {xs.device}")
    check(xs.shape == (BATCH, circuit.stamps.n), f"shape {tuple(xs.shape)}")
    check(bool(torch.isfinite(xs).all()), "non-finite node voltages")

    res = solver.residuals(params, xs)
    check(res.device.type == "cuda" and res.dtype == torch.float64,
          "the audit left the card or f64")
    max_res = float(res.max())
    check(max_res <= CONTRACT_TOL, f"full-batch residual {max_res:.3e}")

    G, b = assemble_dense(circuit.stamps,
                          torch.as_tensor(params_np[:1], dtype=torch.float64))
    ref = np.linalg.solve(G[0].numpy(), b[0].numpy())
    x0 = xs[0].cpu().numpy()
    err0 = float(np.abs(x0 - ref).max() / np.abs(ref).max())
    check(err0 <= CONTRACT_TOL, f"sample 0 is {err0:.3e} from f64 dense")

    rates = {}
    for refine in ("auto", False):
        s = circuit.batched_solver(dtype=torch.float32, refine=refine,
                                   device="cuda")
        s(params)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            s(params)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        rates[str(refine)] = BATCH / (ms / 1e3)
        emit({"phase": "main_path_time", "refine": refine, "B": BATCH,
              "n": circuit.stamps.n, "ms_reps": times, "median_ms": ms,
              "solves_per_s": rates[str(refine)]})

    emit({"phase": "main_path", "circuit": f"ladder_rows({LADDER_RUNGS})",
          "n": circuit.stamps.n, "nnz": circuit.stamps.nnz, "B": BATCH,
          "method": solver.method, "setup_s": setup_s,
          "pcr_launches": launches, "max_residual": max_res,
          "sample0_rel_err_vs_f64": err0,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, str(ROOT))
    try:
        import nodal_tpu_torch
        from nodal_tpu_torch.ops import pcr, tridiag
        from nodal_tpu_torch.utils import kernels
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
    emit(smi.stdout.strip().splitlines()[0])
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    kernels.load_library()
    emit({"phase": "build", "library": kernels.library_path().name,
          "seconds": time.perf_counter() - t0})

    worst, timing = phase_kernels(pcr, tridiag)
    launches = phase_main_path(pcr)

    t32 = timing[torch.float32]
    emit({"kernels": [{
        "name": "pcr_solve", "route": "cuda",
        "source": "nodal_tpu_torch/csrc/pcr.cu",
        "replaces": "nodal_tpu/ops/pallas_tridiag.py:74",
        "launches": launches, "max_abs_err": t32["max_abs_err"],
        "ms": t32["ms"], "plain_ms": t32["plain_ms"]}]})
    check("jax" not in sys.modules, "jax was imported")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
