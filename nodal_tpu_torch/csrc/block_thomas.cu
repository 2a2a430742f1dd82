// Batched no-pivot block-Thomas solve with many right-hand sides, for sm_90a.
//
// Replaces the Pallas TPU kernels of nodal_tpu/ops/pallas_band.py:
//   * pallas_band_solve / pallas_band_solve_multi, the solve whose whole
//     band sits in VMEM (kb = 128, n <= 2048), and
//   * _band_solve_stream behind pallas_band_solve_stream /
//     pallas_band_solve_multi_stream, the same recursion pipelined over
//     block rows, which exists only because VMEM stops at 2048 rows.
// Both inverted each Schur block by Newton-Schulz iterations because the
// TPU's matrix unit does products and nothing else.  This card has no such
// limit: each Schur block is factored directly, and one design serves every
// shape a plan admits (kb in {128, 256, 384}, any number of block rows, up
// to 128 right-hand sides a call, any batch).
//
// What it computes (the plain version is
// nodal_tpu_torch/ops/band.py:band_thomas_solve): B systems, each a block
// band W[nb, kb, 3kb] whose block row t is [L_t | D_t | U_t], and
// right-hand sides R[nb·kb, r]:
//   forward:   S_t = D_t − L_t C_{t−1};  [C_t | y_t] = S_t⁻¹ [U_t | R_t − L_t y_{t−1}]
//   backward:  x_{nb−1} = y_{nb−1};      x_t = y_t − C_t x_{t+1}
// without pivoting, which is stable on the diagonally dominant and SPD
// bands the plans give.  Block row 0 reads no C_{−1} or y_{−1} and the last
// reads no x_{nb}: nothing is read that was never written.
//
// Design.  The host walks the block rows and every launch covers the whole
// batch, as the blocked LU does (the kernels are dense_tile.cuh's, under
// the block_thomas_ prefix).  Per block row t:
//   1. S = D_t − L_t C_{t−1} (a wide tile product);
//   2. kb = 128: S⁻¹ in place (block_thomas_inv), which for r <= 4 also
//      forms rhs = R_t − L_t y_{t−1} before and y_t = S⁻¹rhs after the
//      inverse, then C_t = S⁻¹U_t into the row's slot: three launches a
//      block row (five for r > 4, rhs and y_t as products of their own).
//      kb = 256, 384: U_t and rhs go into the slot, S is factored by the
//      blocked LU's 128-panel steps, and the slot is solved in place.
//   3. The backward sweep is one product a block row, into X.
// The scratch (ops/block_thomas.py:launch_plan) is batch-wide: S and rhs
// [B, kb, kb + r], one slot [kb, kb + r, padded to 4] a block row and
// system, and for kb > 128 the LU's P and Z.
//
// Bound on the H100.  Operations: at least ~14/3·n·kb² flops a system at
// one RHS (per block row 2kb³ for L·C, 2/3·kb³ to factor S, 2kb³ for
// S⁻¹U), against 67 TFLOP/s in f32 (CUDA cores) and in f64 (FP64 tensor
// cores); device memory: W and R read once, X written once, far less.  So
// the work is bound by operations, ~2.3 ms at B = 1024, nb = 16, kb = 128,
// where this design takes 4.4× that in f32 and 15× in f64 (PERF.md
// §6).  What stands between: in f32 the tile products, 56 % of the time,
// then the 128×128 inverse, 38 % (dense_tile.cuh: its 128 dependent pivot
// steps, and 2kb³ where an LU does 2/3·kb³); in f64 the inverse, 76 %,
// latency-bound at one block a system (~200 µs a system).  Each launch
// covers the whole batch, so a batch of B puts B tiles on the card at once
// (the design this replaces walked one system a block, ~350 barrier phases
// a block row), and for r <= 4 the inverse's launch forms rhs and y_t
// itself: three launches a block row.

#include <cuda_runtime.h>

#include <cstddef>

#include "dense_tile.cuh"

namespace {

using dense_tile::kBlock;
using dense_tile::Mat;

DENSE_TILE_KERNELS(block_thomas)

// The scratch F, for B systems (ops/block_thomas.py:launch_plan mirrors
// this): S [B][kb][kb], rhs [B][kb][r], slots [B][nb][kb][ls], and for
// kb > 128 the LU's P [B][factor_scratch(kb)] and Z [B][128][kb + r].
inline int slot_ld(int kb, int r) { return kb + (r + 3) / 4 * 4; }

template <typename T>
int launch(const T* W, const T* R, T* X, T* F, int B, int nb, int kb, int r,
           void* stream_) {
  if (B <= 0 || nb <= 0 || kb <= 0 || kb % kBlock != 0 || r <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const auto k = block_thomas_kernels<T>();
  if (int err = dense_tile::prepare(k)) return err;
  const int ls = slot_ld(kb, r);
  const int lw = 3 * kb;
  const size_t w_sys = static_cast<size_t>(nb) * kb * lw;
  const size_t r_sys = static_cast<size_t>(nb) * kb * r;
  const size_t s_sys = static_cast<size_t>(kb) * kb;
  const size_t rhs_sys = static_cast<size_t>(kb) * r;
  const size_t slot_sys = static_cast<size_t>(nb) * kb * ls;
  T* S = F;
  T* rhs = S + s_sys * B;
  T* slots = rhs + rhs_sys * B;
  T* P = slots + slot_sys * B;                           // kb > 128
  T* Z = P + dense_tile::factor_scratch(kb) * B;           // kb > 128
  const Mat<T> none{nullptr, 0, 0};
  const Mat<T> Sm{S, s_sys, kb};
  T* Wm = const_cast<T*>(W);  // Mat is read-only where W and R appear
  T* Rm = const_cast<T*>(R);
  auto slot = [&](int t) {
    return Mat<T>{slots + static_cast<size_t>(t) * kb * ls, slot_sys, ls};
  };
  auto shift = [](Mat<T> m, int cols) {
    return Mat<T>{m.p ? m.p + cols : nullptr, m.stride, m.ld};
  };
  int err;

  for (int t = 0; t < nb; ++t) {
    T* Wt = Wm + static_cast<size_t>(t) * kb * lw;
    const Mat<T> L{Wt, w_sys, lw}, D{Wt + kb, w_sys, lw},
        U{Wt + 2 * kb, w_sys, lw};
    const Mat<T> Rt{Rm + static_cast<size_t>(t) * kb * r, r_sys, r};
    const Mat<T> cur = slot(t);
    const Mat<T> prev = t ? slot(t - 1) : none;
    const int K = t ? kb : 0;  // block row 0 has no carry
    // S = D_t − L_t C_{t−1}
    if ((err = dense_tile::gemm(k, Sm, D, L, prev, kb, kb, K, T(-1), B,
                                stream))) {
      return err;
    }
    if (kb == kBlock && r <= dense_tile::kNarrowCols) {
      // S = S⁻¹ and y_t = S⁻¹(R_t − L_t y_{t−1}) in one launch;
      // C_t = S⁻¹ U_t.
      const dense_tile::InvApply<T> ap{L, shift(prev, kb), Rt,
                                       shift(cur, kb), K, r};
      if ((err = dense_tile::invert(k, Sm, B, stream, ap)) ||
          (err = dense_tile::gemm(k, cur, none, Sm, U, kb, kb, kb, T(1), B,
                                  stream))) {
        return err;
      }
    } else if (kb == kBlock) {
      // rhs = R_t − L_t y_{t−1};  S = S⁻¹;  [C_t | y_t] = S⁻¹ [U_t | rhs]
      const Mat<T> Rh{rhs, rhs_sys, r};
      if ((err = dense_tile::gemm(k, Rh, Rt, L, shift(prev, kb), kb, r, K,
                                  T(-1), B, stream)) ||
          (err = dense_tile::invert(k, Sm, B, stream)) ||
          (err = dense_tile::gemm(k, cur, none, Sm, U, kb, kb, kb, T(1), B,
                                  stream)) ||
          (err = dense_tile::gemm(k, shift(cur, kb), none, Sm, Rh, kb, r, kb,
                                  T(1), B, stream))) {
        return err;
      }
    } else {
      // slot = [U_t | R_t − L_t y_{t−1}], then slot = S⁻¹ slot by the LU.
      if ((err = dense_tile::gemm(k, shift(cur, kb), Rt, L, shift(prev, kb),
                                  kb, r, K, T(-1), B, stream)) ||
          (err = dense_tile::gemm(k, cur, U, none, none, kb, kb, 0, T(1), B,
                                  stream)) ||
          (err = dense_tile::lu_factor(k, S, s_sys, P, B, kb, stream)) ||
          (err = dense_tile::lu_solve(k, S, s_sys, cur, Z, B, kb, kb + r,
                                      stream))) {
        return err;
      }
    }
  }

  // x_{nb−1} = y_{nb−1};  x_t = y_t − C_t x_{t+1}
  auto xrows = [&](int t) {
    return Mat<T>{X + static_cast<size_t>(t) * kb * r, r_sys, r};
  };
  if ((err = dense_tile::gemm(k, xrows(nb - 1), shift(slot(nb - 1), kb),
                              none, none, kb, r, 0, T(1), B, stream))) {
    return err;
  }
  for (int t = nb - 2; t >= 0; --t) {
    if ((err = dense_tile::gemm(k, xrows(t), shift(slot(t), kb), slot(t),
                                xrows(t + 1), kb, r, kb, T(-1), B,
                                stream))) {
      return err;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns the first non-zero error of the launches (0 on success).  W is
// [B, nb, kb, 3kb], R and X are [B, nb·kb, r]; F is the scratch of
// ops/block_thomas.py:launch_plan for B systems.
int block_thomas_f32(const float* W, const float* R, float* X, float* F,
                     int B, int nb, int kb, int r, void* stream) {
  return launch<float>(W, R, X, F, B, nb, kb, r, stream);
}

int block_thomas_f64(const double* W, const double* R, double* X, double* F,
                     int B, int nb, int kb, int r, void* stream) {
  return launch<double>(W, R, X, F, B, nb, kb, r, stream);
}

}  // extern "C"
