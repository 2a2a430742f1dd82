"""Ablation of the tile core on one NVIDIA GPU.

    python3 chip_ablate.py

Builds variants of ``nodal_tpu_torch/csrc/dense_tile.cuh``, each the
header with one part cut out or one setting changed (``VARIANTS``), into
libraries of their own under the git-ignored ``_ablate/`` (all ``nvcc``
processes at once; the base build with ``-Xptxas -v``, its SASS beside
it), then times each variant's inverse at B = 1024 and 256 and its wide
tile product at the LU's and the block Thomas's shapes, f32 and f64, by
CUDA events.  A cut variant's answers are wrong; its time says what the
part costs.  Prints the card's name, power limit and clock, then one JSON
line a measurement.  Imports no JAX.
"""
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "_ablate"
OUT.mkdir(parents=True, exist_ok=True)
NVCC = "/usr/local/cuda/bin/nvcc"
HDR = (ROOT / "nodal_tpu_torch/csrc/dense_tile.cuh").read_text()

HARNESS = r'''
#include "dense_tile.cuh"
namespace { DENSE_TILE_KERNELS(ablate) }
using dense_tile::Mat;
template <typename T> int inv(T* D, int B, int n, void* st) {
  auto k = ablate_kernels<T>();
  if (int e = dense_tile::prepare(k)) return e;
  return dense_tile::invert(k, Mat<T>{D, (size_t)n * n, n}, B, (cudaStream_t)st);
}
template <typename T> int gemm(T* C, T* A, T* Bm, int B, int M, int N, int K, int cin, void* st) {
  auto k = ablate_kernels<T>();
  if (int e = dense_tile::prepare(k)) return e;
  Mat<T> Cm{C, (size_t)M * N, N};
  Mat<T> none{nullptr, 0, 0};
  return dense_tile::gemm(k, Cm, cin ? Cm : none, Mat<T>{A, (size_t)M * K, K}, Mat<T>{Bm, (size_t)K * N, N}, M, N, K, T(-1), B, (cudaStream_t)st);
}
extern "C" int inv_f32(float* D, int B, int n, void* st) { return inv(D, B, n, st); }
extern "C" int inv_f64(double* D, int B, int n, void* st) { return inv(D, B, n, st); }
extern "C" int gemm_f32(float* C, float* A, float* Bm, int B, int M, int N, int K, int cin, void* st) { return gemm(C, A, Bm, B, M, N, K, cin, st); }
extern "C" int gemm_f64(double* C, double* A, double* Bm, int B, int M, int N, int K, int cin, void* st) { return gemm(C, A, Bm, B, M, N, K, cin, st); }
'''

F32MB = "  static constexpr int kMinBlocks = 2;\n  static constexpr int kChunk = 8;"
F64ST = "  static constexpr int kChunk = 16;\n  static constexpr int kStages = 3;"
INVGRID = "      dim3(static_cast<unsigned>(B < kMaxGridY ? B : kMaxGridY)),\n      dim3(Inv<T>::kThreads)"
F32K = "      for (int kk = 0; kk < C::kChunk; ++kk) {\n        const float4 a0 ="
F64K = "      for (int k4 = 0; k4 < C::kChunk; k4 += 4) {"
EPI32 = "      if (i >= g.M) continue;\n#pragma unroll\n      for (int h = 0; h < 2; ++h) {"
EPI64 = "        if (i >= g.M) continue;\n#pragma unroll\n        for (int v = 0; v < 4; ++v) {"
VARIANTS = {
    "base": [],
    # the inverse: one resident block an SM walking the batch
    "inv_persistent": [(INVGRID, INVGRID.replace(
        "B < kMaxGridY ? B : kMaxGridY",
        "B < 132 * Inv<T>::kMinBlocks ? B : 132 * Inv<T>::kMinBlocks"))],
    # f32 tiles: one block an SM (registers without spills)
    "gemm_f32_one_block": [(F32MB, F32MB.replace("kMinBlocks = 2", "kMinBlocks = 1"))],
    # f64 tiles: a fourth stage in the ring
    "gemm_f64_four_stages": [(F64ST, F64ST.replace("kStages = 3", "kStages = 4"))],
    "gemm_nocompute": [(F32K, F32K.replace("kk < C::kChunk", "kk < 0")),
                       (F64K, F64K.replace("k4 < C::kChunk", "k4 < 0"))],
    "gemm_noepi": [(EPI32, EPI32.replace("i >= g.M", "i >= g.M || g.alpha != 12345.f")),
                   (EPI64, EPI64.replace("i >= g.M", "i >= g.M || g.alpha != 12345.0"))],
}


def build(name, patches):
    d = OUT / name
    d.mkdir(exist_ok=True)
    src = HDR
    for old, new in patches:
        assert src.count(old) == 1, (name, old)
        src = src.replace(old, new)
    (d / "dense_tile.cuh").write_text(src)
    (d / "h.cu").write_text(HARNESS)
    cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-I", str(d), "-o", str(d / "lib.so"),
           str(d / "h.cu")]
    if name == "base":
        cmd[1:1] = ["-Xptxas", "-v"]
    p = subprocess.run(cmd, capture_output=True, text=True)
    (d / "build.txt").write_text(p.stdout + p.stderr)
    return name, p.returncode


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        for name, rc in ex.map(lambda kv: build(*kv), VARIANTS.items()):
            print(json.dumps({"build": name, "rc": rc}), flush=True)
    base = OUT / "base" / "lib.so"
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(base)],
                          capture_output=True, text=True)
    (OUT / "base_sass.txt").write_text(sass.stdout)
    P = ctypes.c_void_p
    I = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name in VARIANTS:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in ("inv_f32", "inv_f64"):
            getattr(lib, fn).argtypes = [P, I, I, P]
        for fn in ("gemm_f32", "gemm_f64"):
            getattr(lib, fn).argtypes = [P, P, P, I, I, I, I, I, P]
        st = torch.cuda.current_stream().cuda_stream
        for dt, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
            for B in (1024, 256):
                D = torch.randn(B, 128, 128, generator=g, device="cuda", dtype=dt) * 0.1
                D += torch.eye(128, device="cuda", dtype=dt) * 20
                D0 = D.clone()
                f = getattr(lib, f"inv_{sfx}")
                err = f(D.data_ptr(), B, 128, st)
                torch.cuda.synchronize()
                chk = float((D0[:4] @ D[:4] - torch.eye(128, device="cuda", dtype=dt)).abs().max())
                t = ms(lambda: f(D.data_ptr(), B, 128, st))
                results.append({"variant": name, "kernel": "inv", "dtype": sfx, "B": B,
                                "err": err, "resid": chk, "ms": t})
                print(json.dumps(results[-1]), flush=True)
            for (B, M, N, K) in ((1024, 896, 896, 128), (1024, 768, 768, 256), (1024, 128, 128, 128), (64, 3968, 3968, 128), (256, 128, 128, 128)):
                A = torch.randn(B, M, K, generator=g, device="cuda", dtype=dt)
                Bm = torch.randn(B, K, N, generator=g, device="cuda", dtype=dt)
                C = torch.randn(B, M, N, generator=g, device="cuda", dtype=dt)
                f = getattr(lib, f"gemm_{sfx}")
                for cin in (1, 0):
                    C1 = C.clone()
                    err = f(C1.data_ptr(), A.data_ptr(), Bm.data_ptr(), B, M, N, K, cin, st)
                    torch.cuda.synchronize()
                    want = C[:2] - A[:2] @ Bm[:2] if cin else -(A[:2] @ Bm[:2])
                    chk = float((C1[:2] - want).abs().max())
                    t = ms(lambda: f(C1.data_ptr(), A.data_ptr(), Bm.data_ptr(), B, M, N, K, cin, st))
                    results.append({"variant": name, "kernel": "gemm", "dtype": sfx, "B": B, "M": M,
                                    "N": N, "K": K, "cin": cin, "err": err, "diff": chk, "ms": t,
                                    "tflops": 2 * B * M * N * K / t / 1e9})
                    print(json.dumps(results[-1]), flush=True)
                del A, Bm, C, C1
                torch.cuda.empty_cache()
    (OUT / "results.json").write_text(json.dumps(results))


def smoke_phases():
    """chip_smoke.py's LU and band checks and timings on the package."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nodal_tpu_torch.ops import band, block_lu, block_thomas, lu
    from nodal_tpu_torch.utils import kernels
    kernels.load_library()
    cs.phase_resources(kernels.library_path())
    for name, fn in (("lu", lambda: cs.phase_lu_kernel(lu, block_lu)),
                     ("band", lambda: cs.phase_band_kernel(block_thomas, band))):
        try:
            fn()
        except SystemExit as e:
            print(json.dumps({"phase_failed": name, "code": str(e.code)}), flush=True)


main()
