// Batched no-pivot blocked dense LU with many right-hand sides, for sm_90a.
//
// Replaces the Pallas TPU kernels of nodal_tpu/ops/pallas_block_lu.py:
//   * pallas_lu_solve (one right-hand side) and
//   * pallas_lu_solve_multi (up to 128 right-hand sides),
// which keep 8 systems of at most 1024 unknowns whole in VMEM, invert each
// 128×128 diagonal block by Newton-Schulz iterations (the TPU's matrix unit
// does products and nothing else) and carry the right-hand sides as
// 128-lane matrices.  None of that carries over: here the host drives one
// factorization step a 128-column panel, each launch covers the whole
// batch, every diagonal block is inverted directly, and any n that is a
// multiple of 128, any batch and any number of right-hand sides are served.
//
// What it computes (the plain version is
// nodal_tpu_torch/ops/block_lu.py:blocked_factor + blocked_solve_factored):
// for B systems G [n, n] and right-hand sides R [n, r], X = G⁻¹R by
// right-looking LU in panels of k = 128, without pivoting, which is stable
// on the diagonally dominant and SPD matrices the callers give.  For each
// panel t (D the diagonal block, A21 the column below it, U the row right
// of it, all Schur-updated by the earlier panels):
//   factor:   Dinv = D⁻¹;  P = Dinv·U;  A22 −= A21·P
//             (panels in pairs, their updates of the rest delayed into
//             one product of depth 256: dense_tile.cuh:lu_factor)
//   forward:  y_{>t} −= A21·(Dinv·y_t)                  (L = A21·Dinv)
//   backward: x_t = Dinv·(y_t − U·x_{>t})
// The factor is packed in place of G: Dinv on the diagonal blocks, A21
// below them, U right of them.  Storing A21 rather than L = A21·Dinv makes
// the factorization's in-place products out-of-place ones (P goes to a
// scratch), at the price of one [k, r] product a panel in the forward sweep.
//
// Kernels (dense_tile.cuh, shared with block_thomas.cu):
//   * block_lu_inv: one block a system inverts the 128×128 diagonal block
//     by Gauss-Jordan in 32-column panels, the block in registers.
//   * block_lu_gemm: the wide tile product (P, the trailing update, and
//     the sweeps when r > 4): f32 on the CUDA cores with 8×8 register
//     tiles, f64 on the FP64 tensor cores, K chunks brought in by cp.async.
//   * block_lu_gemv: the narrow product (the sweeps when r <= 4).
//
// Bound on the H100: at least 2/3·n³ + 2·n²·r flops a system, against
// 67 TFLOP/s in both dtypes (f32 on the CUDA cores, f64 on the FP64 tensor
// cores); G read once, R read and X written once, far fewer bytes.  So the
// work is bound by operations: 11.0 ms at B = 1024, n = 1024, where this
// design takes 2.7× that in f32 and 4.3× in f64 (PERF.md §6).  The
// trailing update is ~80 % of the operations and of the time: its
// tiles run at 27 TFLOP/s (f32: 4-byte transposing copies of A, register
// spills at two blocks an SM) and 22 (f64: the C tile's trip through
// device memory at one block an SM).  Panels go in pairs so that the rest
// of the matrix makes that trip once a pair; the inverses take 5 % (f32)
// and 29 % (f64) of the factorization, latency-bound at one block a
// system.

#include <cuda_runtime.h>

#include <cstddef>

#include "dense_tile.cuh"

namespace {

using dense_tile::kBlock;  // panel width (ops/lu.py:BLOCK)
using dense_tile::Mat;

DENSE_TILE_KERNELS(block_lu)

// G [B, n, n] is factored in place; P holds B·factor_scratch(n) values.
template <typename T>
int factor(T* G, T* P, int B, int n, void* stream) {
  if (B <= 0 || n <= 0 || n % kBlock != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto k = block_lu_kernels<T>();
  if (int err = dense_tile::prepare(k)) return err;
  return dense_tile::lu_factor(k, G, static_cast<size_t>(n) * n, P, B, n,
                               static_cast<cudaStream_t>(stream));
}

// F [B, n, n] packed by factor(); X [B, n, r] holds R on entry and the
// solution on return; Z holds B·kBlock·r values.
template <typename T>
int solve(const T* F, T* X, T* Z, int B, int n, int r, void* stream) {
  if (B <= 0 || n <= 0 || n % kBlock != 0 || r <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto k = block_lu_kernels<T>();
  if (int err = dense_tile::prepare(k)) return err;
  return dense_tile::lu_solve(k, F, static_cast<size_t>(n) * n,
                              Mat<T>{X, static_cast<size_t>(n) * r, r}, Z, B,
                              n, r, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Each returns the first non-zero error of its launches (0 on success).
// G [B, n, n] is factored in place with the scratch P of
// B·factor_scratch(n) values (ops/lu.py:factor_scratch); X [B, n, r] holds
// R on entry and G⁻¹R on return, with the scratch Z of B·128·r values.
int block_lu_factor_f32(float* G, float* P, int B, int n, void* stream) {
  return factor<float>(G, P, B, n, stream);
}

int block_lu_factor_f64(double* G, double* P, int B, int n, void* stream) {
  return factor<double>(G, P, B, n, stream);
}

int block_lu_solve_f32(const float* F, float* X, float* Z, int B, int n,
                       int r, void* stream) {
  return solve<float>(F, X, Z, B, n, r, stream);
}

int block_lu_solve_f64(const double* F, double* X, double* Z, int B, int n,
                       int r, void* stream) {
  return solve<double>(F, X, Z, B, n, r, stream);
}

}  // extern "C"
