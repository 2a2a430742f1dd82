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
// itself: three launches a block row.  A band solved again for other
// right-hand sides is eliminated once by the same launches, keeping every
// S_t⁻¹ (block_thomas_factor_*), and then only substituted
// (block_thomas_subst, below).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "dense_tile.cuh"

namespace {

using dense_tile::kBlock;
using dense_tile::Mat;

DENSE_TILE_KERNELS(block_thomas)

// The scratch F, for B systems (ops/block_thomas.py:launch_plan mirrors
// this): S [B][kb][kb], rhs [B][kb][r], slots [B][nb][kb][ls], and for
// kb > 128 the LU's P [B][factor_scratch(kb)] and Z [B][128][kb + r].
// With `held` (kb = 128 only; ops/block_thomas.py:held_elems) S has a
// block row of its own, S [B][nb][kb][kb], so that F keeps every S_t⁻¹
// and [C_t | y_t] for block_thomas_subst; the launches are the same.
inline int slot_ld(int kb, int r) { return kb + (r + 3) / 4 * 4; }

template <typename T>
int launch(const T* W, const T* R, T* X, T* F, int B, int nb, int kb, int r,
           bool held, void* stream_) {
  if (B <= 0 || nb <= 0 || kb <= 0 || kb % kBlock != 0 || r <= 0 ||
      (held && kb != kBlock)) {
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
  const size_t s_rows = held ? static_cast<size_t>(nb) : 1;
  T* S = F;
  T* rhs = S + s_sys * s_rows * B;
  T* slots = rhs + rhs_sys * B;
  T* P = slots + slot_sys * B;                           // kb > 128
  T* Z = P + dense_tile::factor_scratch(kb) * B;           // kb > 128
  const Mat<T> none{nullptr, 0, 0};
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
    const Mat<T> Sm{held ? S + static_cast<size_t>(t) * s_sys : S,
                    s_sys * s_rows, kb};
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

// ---- substitution on held factors ----------------------------------------
//
// block_thomas_subst corresponds to no TPU kernel: the Pallas solves
// eliminate the band for every right-hand side, and so did this port until
// the band tier's operator kept its first elimination (launch with `held`).
// It was added for the contract layer's defect passes, which solve the band
// they eliminated again for one new right-hand side.  Given the held S_t⁻¹
// and C_t (kb = 128) and a new R (r <= 4):
//   forward:   rhs = R_t − L_t y_{t−1};  y_t = S_t⁻¹ rhs
//   backward:  x_{nb−1} = y_{nb−1};      x_t = y_t − C_t x_{t+1}
// Bound on the H100: bytes.  It reads L_t, S_t⁻¹ and C_t once each, 3nb − 2
// blocks of 128×128 a system (46 at nb = 16: 3.0 GB at B 1024 in f32, 0.90
// ms at 3.35 TB/s), against ~2 flops a value read.
//
// Design: one launch, a block a system, walking the 3nb − 2 blocks in the
// order the recursion reads them (S_0⁻¹, L_1, S_1⁻¹, ..., L_{nb−1},
// S_{nb−1}⁻¹, C_{nb−2}, ..., C_0) as 64-KB tiles (a block in f32, half of
// one in f64) through a ring of three shared-memory stages filled by
// 16-byte cp.async: the next two tiles load while the block computes on
// this one, since no tile depends on y.  y_{t−1} / x_{t+1}, rhs and the
// new values stay in shared memory; y_t goes to X, where the backward sweep
// overwrites it by x_t.  Each sum is the one the eliminating launches form
// for the same value, in the same order (the f32 and f64 InvApply and
// narrow_rows of dense_tile.cuh), so that a substitution gives the bits of
// a fresh solve on the same band: fixed orders, no atomics.

constexpr int kSubstThreads = 256;
constexpr int kSubstStages = 3;

template <typename T>
struct SubstTile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kRows = 65536 / (kBlock * static_cast<int>(sizeof(T)));
  static constexpr int kLd = kBlock + kVec;  // padded: conflict-free rows
  static constexpr int kElems = kRows * kLd;
  static constexpr int kPerBlock = kBlock / kRows;  // tiles a 128×128 block
  static constexpr int kCopies = kRows * kBlock / kVec / kSubstThreads;
  static constexpr int kVecs = 3 * dense_tile::kNarrowCols * kBlock;
  static constexpr int kSmemBytes =
      (kSubstStages * kElems + kVecs) * static_cast<int>(sizeof(T));
};

__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double mul_add(double a, double b, double c) {
  return fma(a, b, c);
}

// The kVec values at p (16-byte aligned shared memory) as one load.
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  dense_tile::load4(p, *reinterpret_cast<float(*)[4]>(v));
}

__device__ __forceinline__ void load_vec(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}

template <typename T>
struct SubstArgs {
  const T* W;      // [B][nb][kb][3kb]: L_t
  const T* Sinv;   // [B][nb][kb][kb]: S_t⁻¹
  const T* slots;  // [B][nb][kb][ls]: C_t in the first kb columns
  const T* R;      // [B][nb·kb][r]
  T* X;            // [B][nb·kb][r]
  int nb, r, ls;
};

// Row 0 of block m of the walk for system s, and its row length.
template <typename T>
__device__ __forceinline__ const T* walk_block(const SubstArgs<T>& a, int s,
                                               int m, int& ld) {
  const size_t sys = static_cast<size_t>(s) * a.nb;
  if (m < 2 * a.nb - 1) {
    const size_t t = (m + 1) / 2;
    if (m & 1) {
      ld = 3 * kBlock;
      return a.W + (sys + t) * kBlock * 3 * kBlock;
    }
    ld = kBlock;
    return a.Sinv + (sys + t) * kBlock * kBlock;
  }
  const size_t t = a.nb - 2 - (m - (2 * a.nb - 1));
  ld = a.ls;
  return a.slots + (sys + t) * kBlock * a.ls;
}

template <typename T>
__device__ __forceinline__ void load_walk_tile(const SubstArgs<T>& a, int s,
                                               int i, T* stage) {
  using C = SubstTile<T>;
  constexpr int kRowCopies = kBlock / C::kVec;
  int ld;
  const T* src = walk_block(a, s, i / C::kPerBlock, ld) +
                 static_cast<size_t>(i % C::kPerBlock) * C::kRows * ld;
#pragma unroll
  for (int k = 0; k < C::kCopies; ++k) {
    const int q = threadIdx.x + k * kSubstThreads;
    const int row = q / kRowCopies, col = (q % kRowCopies) * C::kVec;
    dense_tile::cp_async<16>(stage + row * C::kLd + col,
                             src + static_cast<size_t>(row) * ld + col, true);
  }
}

// rhs[c][i0 + i] = R_t − L_t·y for the tile's rows; y[c][·] = y_{t−1}.
// f32: apply_rhs's sums, four chains of stride 4 a row (a lane each),
// added as (a0 + a1) + (a2 + a3).  f64: invert_block_f64's, a half warp a
// row, eight consecutive columns a lane.
template <typename T>
__device__ __forceinline__ void subst_rhs(const T* tile, int i0,
                                          const T* Rt, int r, const T* y,
                                          T* rhs) {
  using C = SubstTile<T>;
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
    constexpr int kRowsPerThread = C::kRows * 4 / kSubstThreads;
    const int q = tid & 3;
    for (int c = 0; c < r; ++c) {
      const float* yc = y + c * kBlock + q;
      float rt[kRowsPerThread], acc[kRowsPerThread];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int i = (tid >> 2) + k * (kSubstThreads / 4);
        rt[k] = q == 0 ? Rt[static_cast<size_t>(i0 + i) * r + c] : 0.f;
        acc[k] = 0.f;
      }
#pragma unroll 8
      for (int j = 0; j < kBlock; j += 4) {
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const int i = (tid >> 2) + k * (kSubstThreads / 4);
          acc[k] = fmaf(tile[i * C::kLd + q + j], yc[j], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int i = (tid >> 2) + k * (kSubstThreads / 4);
        const float pair = acc[k] + __shfl_down_sync(0xffffffffu, acc[k], 1);
        const float sum = pair + __shfl_down_sync(0xffffffffu, pair, 2);
        if (q == 0) rhs[c * kBlock + i0 + i] = rt[k] - sum;
      }
    }
  } else {
    const int tc = tid & 15, c0 = 8 * tc, rg = (tid >> 4) * 4;
    for (int c = 0; c < r; ++c) {
      double yv[8];
      dense_tile::load4(y + c * kBlock + c0,
                        *reinterpret_cast<double(*)[4]>(yv));
      dense_tile::load4(y + c * kBlock + c0 + 4,
                        *reinterpret_cast<double(*)[4]>(yv + 4));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        double l[8];
        dense_tile::load4(tile + (rg + u) * C::kLd + c0,
                          *reinterpret_cast<double(*)[4]>(l));
        dense_tile::load4(tile + (rg + u) * C::kLd + c0 + 4,
                          *reinterpret_cast<double(*)[4]>(l + 4));
        double part = 0.0;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) part = fma(l[cc], yv[cc], part);
        part = dense_tile::half_warp_sum(part);
        if (tc == 0) {
          rhs[c * kBlock + i0 + rg + u] =
              Rt[static_cast<size_t>(i0 + rg + u) * r + c] - part;
        }
      }
    }
  }
}

// y_t = S_t⁻¹·rhs for the tile's rows, into y and X_t: a half warp a row,
// as the inverse's launch forms y_t from its registers (f32: columns
// 4tc .. + 3 and 64 + 4tc .. + 3 a lane; f64: 8tc .. + 7).
template <typename T>
__device__ __forceinline__ void subst_y(const T* tile, int i0, const T* rhs,
                                        int r, T* y, T* Xt) {
  using C = SubstTile<T>;
  const int tid = threadIdx.x, tc = tid & 15;
  for (int c = 0; c < r; ++c) {
    if constexpr (sizeof(T) == 4) {
      float rv[8];
      dense_tile::load4(rhs + c * kBlock + 4 * tc,
                        *reinterpret_cast<float(*)[4]>(rv));
      dense_tile::load4(rhs + c * kBlock + 64 + 4 * tc,
                        *reinterpret_cast<float(*)[4]>(rv + 4));
      constexpr int kRowsPerThread = C::kRows * 16 / kSubstThreads;
      float part[kRowsPerThread];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const float* row = tile + ((tid >> 4) + 16 * k) * C::kLd + 4 * tc;
        float a[8];
        dense_tile::load4(row, *reinterpret_cast<float(*)[4]>(a));
        dense_tile::load4(row + 64, *reinterpret_cast<float(*)[4]>(a + 4));
        part[k] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part[k] = fmaf(a[e], rv[e], part[k]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
        }
      }
      // Every lane of the half warp holds each row's sum: lane k stores
      // row k.
      float mine = part[0];
#pragma unroll
      for (int k = 1; k < kRowsPerThread; ++k) mine = tc == k ? part[k] : mine;
      if (tc < kRowsPerThread) {
        const int i = i0 + (tid >> 4) + 16 * tc;
        y[c * kBlock + i] = mine;
        Xt[static_cast<size_t>(i) * r + c] = mine;
      }
    } else {
      const int c0 = 8 * tc, rg = (tid >> 4) * 4;
      double rv[8];
      dense_tile::load4(rhs + c * kBlock + c0,
                        *reinterpret_cast<double(*)[4]>(rv));
      dense_tile::load4(rhs + c * kBlock + c0 + 4,
                        *reinterpret_cast<double(*)[4]>(rv + 4));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        double a[8];
        dense_tile::load4(tile + (rg + u) * C::kLd + c0,
                          *reinterpret_cast<double(*)[4]>(a));
        dense_tile::load4(tile + (rg + u) * C::kLd + c0 + 4,
                          *reinterpret_cast<double(*)[4]>(a + 4));
        double part = 0.0;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) part = fma(a[cc], rv[cc], part);
        part = dense_tile::half_warp_sum(part);
        if (tc == 0) {
          y[c * kBlock + i0 + rg + u] = part;
          Xt[static_cast<size_t>(i0 + rg + u) * r + c] = part;
        }
      }
    }
  }
}

// x_t = y_t − C_t·x_{t+1} for the tile's rows (y_t read from X_t, x_{t+1}
// in xn), into xo and X_t: narrow_rows's sums, a warp a row (its rows
// interleaved), each lane's columns 16 bytes at a time along the row, then
// a butterfly over the warp.
template <typename T>
__device__ __forceinline__ void subst_x(const T* tile, int i0, const T* xn,
                                        int r, T* xo, T* Xt) {
  using C = SubstTile<T>;
  constexpr int V = C::kVec;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = 0; c < r; ++c) {
    T b[4];
#pragma unroll
    for (int h = 0; h < 4 / V; ++h) {
      load_vec(xn + c * kBlock + (32 * h + lane) * V, b + h * V);
    }
    // Lane k takes row warp + 8k's y_t and stores its x_t.
    constexpr int kRowsPerWarp = C::kRows / (kSubstThreads / 32);
    T* out = Xt + static_cast<size_t>(i0 + warp + 8 * lane) * r + c;
    const T yv = lane < kRowsPerWarp ? *out : T(0);
    T acc[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      T a[4];
#pragma unroll
      for (int h = 0; h < 4 / V; ++h) {
        load_vec(tile + (warp + 8 * k) * C::kLd + (32 * h + lane) * V,
                 a + h * V);
      }
      acc[k] = T(0);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k] = mul_add(a[e], b[e], acc[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
    }
    T mine = acc[0];
#pragma unroll
    for (int k = 1; k < kRowsPerWarp; ++k) mine = lane == k ? acc[k] : mine;
    if (lane < kRowsPerWarp) {
      const T x = yv - mine;
      xo[c * kBlock + i0 + warp + 8 * lane] = x;
      *out = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSubstThreads, 1)
    block_thomas_subst(SubstArgs<T> a) {
  using C = SubstTile<T>;
  extern __shared__ __align__(16) unsigned char subst_smem[];
  T* ring = reinterpret_cast<T*>(subst_smem);
  T* vecs = ring + kSubstStages * C::kElems;
  T* v[2] = {vecs, vecs + dense_tile::kNarrowCols * kBlock};  // y / x
  T* rhs = vecs + 2 * dense_tile::kNarrowCols * kBlock;
  const int s = blockIdx.x, nb = a.nb, r = a.r;
  const size_t sys = static_cast<size_t>(s) * nb * kBlock * r;
  const T* R = a.R + sys;
  T* X = a.X + sys;
  const int n = (3 * nb - 2) * C::kPerBlock;

  for (int e = threadIdx.x; e < kBlock * r; e += kSubstThreads) {
    rhs[(e % r) * kBlock + e / r] = R[e];  // rhs = R_0
  }
#pragma unroll
  for (int p = 0; p < kSubstStages - 1; ++p) {
    if (p < n) load_walk_tile(a, s, p, ring + p * C::kElems);
    dense_tile::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    dense_tile::cp_async_wait<kSubstStages - 2>();
    __syncthreads();  // tile i is in; every thread is past tile i − 1
    const int next = i + kSubstStages - 1;
    if (next < n) {
      load_walk_tile(a, s, next, ring + (next % kSubstStages) * C::kElems);
    }
    dense_tile::cp_async_commit();
    const T* tile = ring + (i % kSubstStages) * C::kElems;
    const int m = i / C::kPerBlock;
    const int i0 = (i % C::kPerBlock) * C::kRows;
    if (m < 2 * nb - 1) {
      const int t = (m + 1) / 2;
      const size_t rows = static_cast<size_t>(t) * kBlock * r;
      if (m & 1) {
        subst_rhs(tile, i0, R + rows, r, v[(t - 1) & 1], rhs);
      } else {
        subst_y(tile, i0, rhs, r, v[t & 1], X + rows);
      }
    } else {
      const int t = nb - 2 - (m - (2 * nb - 1));
      subst_x(tile, i0, v[(t + 1) & 1], r, v[t & 1],
              X + static_cast<size_t>(t) * kBlock * r);
    }
  }
}

template <typename T>
int substitute(const T* W, const T* Sinv, const T* slots, const T* R, T* X,
               int B, int nb, int kb, int r, int ls, void* stream) {
  if (B <= 0 || nb <= 0 || kb != kBlock || r <= 0 ||
      r > dense_tile::kNarrowCols || ls < kb + r || ls % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const T* p : {W, Sinv, slots}) {  // the 16-byte copies' sources
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  const void* fn = reinterpret_cast<const void*>(block_thomas_subst<T>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SubstTile<T>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  SubstArgs<T> a{W, Sinv, slots, R, X, nb, r, ls};
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(B)),
                         dim3(kSubstThreads), args, SubstTile<T>::kSmemBytes,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the first non-zero error of the launches (0 on success).  W is
// [B, nb, kb, 3kb], R and X are [B, nb·kb, r]; F is the scratch of
// ops/block_thomas.py:launch_plan for B systems.
int block_thomas_f32(const float* W, const float* R, float* X, float* F,
                     int B, int nb, int kb, int r, void* stream) {
  return launch<float>(W, R, X, F, B, nb, kb, r, false, stream);
}

int block_thomas_f64(const double* W, const double* R, double* X, double* F,
                     int B, int nb, int kb, int r, void* stream) {
  return launch<double>(W, R, X, F, B, nb, kb, r, false, stream);
}

// The same solve (kb = 128), its launches in the same order, keeping
// every S_t⁻¹ and [C_t | y_t] in F, the held layout of
// ops/block_thomas.py:held_elems for B systems.
int block_thomas_factor_f32(const float* W, const float* R, float* X,
                            float* F, int B, int nb, int kb, int r,
                            void* stream) {
  return launch<float>(W, R, X, F, B, nb, kb, r, true, stream);
}

int block_thomas_factor_f64(const double* W, const double* R, double* X,
                            double* F, int B, int nb, int kb, int r,
                            void* stream) {
  return launch<double>(W, R, X, F, B, nb, kb, r, true, stream);
}

// X = W⁻¹R for r <= 4 right-hand sides by one block_thomas_subst launch on
// the S_t⁻¹ (Sinv) and slots (rows ls apart) that block_thomas_factor_*
// kept for the same W.
int block_thomas_subst_f32(const float* W, const float* Sinv,
                           const float* slots, const float* R, float* X,
                           int B, int nb, int kb, int r, int ls,
                           void* stream) {
  return substitute<float>(W, Sinv, slots, R, X, B, nb, kb, r, ls, stream);
}

int block_thomas_subst_f64(const double* W, const double* Sinv,
                           const double* slots, const double* R, double* X,
                           int B, int nb, int kb, int r, int ls,
                           void* stream) {
  return substitute<double>(W, Sinv, slots, R, X, B, nb, kb, r, ls, stream);
}

}  // extern "C"
