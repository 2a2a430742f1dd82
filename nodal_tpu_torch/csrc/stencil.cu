// Multigrid stencil kernels of the matrix-free grid solve, for sm_90a.
//
// Replace the Pallas TPU kernels of nodal_tpu/ops/pallas_stencil.py:
//   * jacobi_tiled / jacobi_block   <- fused_jacobi (:137)
//   * presmooth_restrict_tiled      <- fused_presmooth_restrict (:211)
//   * prolong_postsmooth_tiled      <- fused_prolong_postsmooth (:286)
//   * vcycle_block (+ mean_partials / subtract_mean for a coarsest level
//     that no block holds)          <- fused_vcycle (:380)
// Semantics follow the plain versions in nodal_tpu_torch/ops/stencil.py:
// fields are [B, h, w], the Laplacian is the edge-replicate 5-point stencil
// L_w x = w (4x - up - down - left - right), a weighted-Jacobi sweep is
// x <- x + c (r - L_w x) with c = omega / (4w), and the transfers are the
// cell-centred bilinear ones (1-D weights 3/4, 1/4; edge-replicated
// prolongation, restriction = its transpose with the edge folds).
//
// Design.  The tiled kernels cut a field into 2-D output tiles; a block
// loads its tile plus a halo into shared memory.  Outside the field the
// halo is the field's mirror image (x[-1] = x[0], repeated with period 2h
// for halos wider than the field), which is exactly the edge-replicate
// boundary: the stencil commutes with the reflections, so mirrored ghosts
// stay consistent through any number of sweeps and the tiles are exact,
// not approximate.
//   * Jacobi: K <= 8 sweeps a launch on a (32 + 2K) x (64 + 2K) window
//     (overlapped trapezoids: sweep s updates cells at distance >= s from
//     the window edge, so the 32 x 64 centre is exact after K sweeps); the
//     wrapper loops launches for more sweeps.  Fields whose x, its
//     ping-pong copy and r fit one block's shared memory run all sweeps in
//     one single-block launch per sample (jacobi_block).
//   * Restriction: a 16 x 16 coarse tile needs fine rows 2I-1 .. 2I+2 of
//     the residual, and the residual one more cell of x: a 36 x 36 window.
//     With the mirrored halo the restriction's edge folds are the ordinary
//     quarter weights on ghost cells.  Direct four-tap sums on each axis,
//     no matrix products.
//   * Prolongation + post-smooth: a 32 x 32 fine tile forms x = c r (or the
//     given pre-smoothed x) + P zc on its 34 x 34 window, then writes one
//     sweep of it; zc is read through the cache.
//   * V-cycle: one block per sample holds the whole hierarchy below an
//     entry level in shared memory (x of every level, r of every level
//     below the entry, one scratch field of the entry size; the entry r is
//     read from device memory) and runs the V(nu, nu) cycle, the 96-sweep
//     coarsest solve with both mean projections and the entry's mean
//     projection as block reductions (a fixed tree: a solve repeats bit for
//     bit).  A coarsest level too large for a block goes through the
//     Jacobi kernels and mean_partials + subtract_mean, a two-pass
//     reduction with no atomics.
// Bound on the H100: bytes.  Every kernel does a few flops a value (a sweep
// is 8); at 3.35 TB/s a 1024^2 f32 field read or written costs 1.25 us,
// against 67 TFLOP/s for the arithmetic.  The tiled kernels read each input
// once (plus halo re-reads, 1.9x for an 8-sweep Jacobi window, which the
// cache absorbs in part) and write each output once.  The single-block
// V-cycle is latency-bound: one SM, ~10 barriers a sweep.
// All offsets into a batch are size_t: [130, 4096, 4096] is past 2^31
// values.  Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "grid_common.cuh"

namespace {

using nodal_grid::block_sum;
using nodal_grid::ceil_div;
using nodal_grid::lap_point;
using nodal_grid::mirror;

constexpr int kThreads = 256;      // tiled kernels
constexpr int kBlockThreads = 512; // single-block kernels (<= 512: see pcr.cu)
constexpr int kTileH = 32;         // Jacobi output tile
constexpr int kTileW = 64;
constexpr int kMaxHalo = 8;        // sweeps per tiled Jacobi launch
constexpr int kCoarseTile = 16;    // restriction: coarse outputs a block side
constexpr int kFineTile = 32;      // prolongation: fine outputs a block side
constexpr int kMaxLevels = 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;   // 227 KB a block on the H100
constexpr int kMeanChunk = 4096;   // values a block sums in mean_partials

// One weighted-Jacobi update.
template <typename T>
__device__ __forceinline__ T sweep_point(T v, T rr, T up, T dn, T lf, T rt,
                                         T weight, T c) {
  return v + c * (rr - lap_point(v, up, dn, lf, rt, weight));
}

// Fine cell (i, j) of the bilinear prolongation of the coarse field zc
// [hc, wc] (rows first, then columns, as the plain version).
template <typename T>
__device__ __forceinline__ T prolong_at(const T* zc, int i, int j, int hc,
                                        int wc) {
  const int ic = i >> 1, jc = j >> 1;
  const int ia = (i & 1) ? min(ic + 1, hc - 1) : max(ic - 1, 0);
  const int ja = (j & 1) ? min(jc + 1, wc - 1) : max(jc - 1, 0);
  const size_t r0 = static_cast<size_t>(ic) * wc;
  const size_t r1 = static_cast<size_t>(ia) * wc;
  const T a = T(0.75) * zc[r0 + jc] + T(0.25) * zc[r1 + jc];
  const T b = T(0.75) * zc[r0 + ja] + T(0.25) * zc[r1 + ja];
  return T(0.75) * a + T(0.25) * b;
}

// Restriction weights over fine offsets -1, 0, 1, 2 of a 2x2 block.
template <typename T>
__device__ __forceinline__ T restrict4(T f0, T f1, T f2, T f3) {
  return T(0.75) * (f1 + f2) + T(0.25) * (f0 + f3);
}

// ---------------------------------------------------------------- Jacobi

template <typename T>
__global__ void __launch_bounds__(kThreads)
    jacobi_tiled(const T* __restrict__ x, const T* __restrict__ r,
                 T* __restrict__ out, int h, int w, int K, T weight, T c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WH = kTileH + 2 * K, WW = kTileW + 2 * K, WN = WH * WW;
  T* A = reinterpret_cast<T*>(smem_raw);
  T* Bf = A + WN;
  T* R = Bf + WN;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int i0 = blockIdx.y * kTileH - K, j0 = blockIdx.x * kTileW - K;
  for (int t = threadIdx.x; t < WN; t += blockDim.x) {
    const int a = t / WW, b = t - a * WW;
    const size_t g = base + static_cast<size_t>(mirror(i0 + a, h)) * w +
                     mirror(j0 + b, w);
    A[t] = x[g];
    R[t] = r[g];
  }
  __syncthreads();
  for (int s = 1; s <= K; ++s) {
    const int ih = WH - 2 * s, iw = WW - 2 * s;
    for (int t = threadIdx.x; t < ih * iw; t += blockDim.x) {
      const int a = s + t / iw, b = s + t % iw;
      const int q = a * WW + b;
      Bf[q] = sweep_point(A[q], R[q], A[q - WW], A[q + WW], A[q - 1],
                          A[q + 1], weight, c);
    }
    __syncthreads();
    T* tmp = A;
    A = Bf;
    Bf = tmp;
  }
  for (int t = threadIdx.x; t < kTileH * kTileW; t += blockDim.x) {
    const int a = t / kTileW, b = t - a * kTileW;
    const int gi = blockIdx.y * kTileH + a, gj = blockIdx.x * kTileW + b;
    if (gi < h && gj < w) {
      out[base + static_cast<size_t>(gi) * w + gj] = A[(a + K) * WW + b + K];
    }
  }
}

// Whole-field helpers for one block, on fields in shared or device memory
// (generic pointers), edge-replicate boundary by clamping.

template <typename T>
__device__ __forceinline__ T lap_at(const T* x, int t, int i, int j, int h,
                                    int w, T weight) {
  const T v = x[t];
  const T up = i > 0 ? x[t - w] : v;
  const T dn = i < h - 1 ? x[t + w] : v;
  const T lf = j > 0 ? x[t - 1] : v;
  const T rt = j < w - 1 ? x[t + 1] : v;
  return lap_point(v, up, dn, lf, rt, weight);
}

template <typename T>
__device__ void field_fill_zero(T* x, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) x[t] = T(0);
  __syncthreads();
}

// n sweeps on x (in place) against r, ping-ponging through tmp.
template <typename T>
__device__ void field_sweeps(T* x, const T* r, T* tmp, int h, int w, int n,
                             T weight, T c) {
  T* src = x;
  T* dst = tmp;
  const int N = h * w;
  for (int s = 0; s < n; ++s) {
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
      const int i = t / w, j = t - i * w;
      dst[t] = src[t] + c * (r[t] - lap_at(src, t, i, j, h, w, weight));
    }
    __syncthreads();
    T* s2 = src;
    src = dst;
    dst = s2;
  }
  if (src != x) {
    for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] = src[t];
    __syncthreads();
  }
}

template <typename T>
__device__ void field_subtract_mean(T* x, int n, T* red) {
  T s = T(0);
  for (int t = threadIdx.x; t < n; t += blockDim.x) s += x[t];
  const T mean = block_sum(s, red) / T(n);
  for (int t = threadIdx.x; t < n; t += blockDim.x) x[t] -= mean;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    jacobi_block(const T* __restrict__ x, const T* __restrict__ r,
                 T* __restrict__ out, int h, int w, int sweeps, T weight,
                 T c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = h * w;
  T* X = reinterpret_cast<T*>(smem_raw);
  T* Y = X + N;
  T* R = Y + N;
  const size_t base = static_cast<size_t>(blockIdx.x) * N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    X[t] = x[base + t];
    R[t] = r[base + t];
  }
  __syncthreads();
  field_sweeps(X, R, Y, h, w, sweeps, weight, c);
  for (int t = threadIdx.x; t < N; t += blockDim.x) out[base + t] = X[t];
}

// ------------------------------------------------- restriction, prolongation

template <typename T, bool kHasX>
__global__ void __launch_bounds__(kThreads)
    presmooth_restrict_tiled(const T* __restrict__ r,
                             const T* __restrict__ x, T* __restrict__ rc,
                             int h, int w, T weight, T c) {
  constexpr int RW = 2 * kCoarseTile + 4;  // fine 2*I0-2 .. 2*I0+2*tile+1
  constexpr int SW = 2 * kCoarseTile + 2;  // fine 2*I0-1 .. 2*I0+2*tile
  __shared__ T R[RW * RW];
  __shared__ T X[kHasX ? RW * RW : 1];
  __shared__ T S[SW * SW];
  const int hc = h / 2, wc = w / 2;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const size_t basec = static_cast<size_t>(blockIdx.z) * hc * wc;
  const int I0 = blockIdx.y * kCoarseTile, J0 = blockIdx.x * kCoarseTile;
  const int fi0 = 2 * I0 - 2, fj0 = 2 * J0 - 2;
  for (int t = threadIdx.x; t < RW * RW; t += blockDim.x) {
    const int a = t / RW, b = t - a * RW;
    const size_t g = base + static_cast<size_t>(mirror(fi0 + a, h)) * w +
                     mirror(fj0 + b, w);
    R[t] = r[g];
    if (kHasX) X[t] = x[g];
  }
  __syncthreads();
  // Residual r - L x on the window, x = c r unless given (one sweep from 0).
  for (int t = threadIdx.x; t < SW * SW; t += blockDim.x) {
    const int a = t / SW + 1, b = t % SW + 1;
    const int q = a * RW + b;
    T v, up, dn, lf, rt;
    if (kHasX) {
      v = X[q]; up = X[q - RW]; dn = X[q + RW]; lf = X[q - 1]; rt = X[q + 1];
    } else {
      v = c * R[q]; up = c * R[q - RW]; dn = c * R[q + RW];
      lf = c * R[q - 1]; rt = c * R[q + 1];
    }
    S[t] = R[q] - lap_point(v, up, dn, lf, rt, weight);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kCoarseTile * kCoarseTile;
       t += blockDim.x) {
    const int i = t / kCoarseTile, j = t - i * kCoarseTile;
    const int I = I0 + i, J = J0 + j;
    if (I >= hc || J >= wc) continue;
    T col[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const T* s = S + (2 * i + p) * SW + 2 * j;
      col[p] = restrict4(s[0], s[1], s[2], s[3]);
    }
    rc[basec + static_cast<size_t>(I) * wc + J] =
        restrict4(col[0], col[1], col[2], col[3]);
  }
}

template <typename T, bool kHasX>
__global__ void __launch_bounds__(kThreads)
    prolong_postsmooth_tiled(const T* __restrict__ r,
                             const T* __restrict__ zc,
                             const T* __restrict__ x, T* __restrict__ out,
                             int h, int w, T weight, T c) {
  constexpr int XW = kFineTile + 2;
  __shared__ T X[XW * XW];
  __shared__ T Rs[XW * XW];
  const int hc = h / 2, wc = w / 2;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const T* z = zc + static_cast<size_t>(blockIdx.z) * hc * wc;
  const int i0 = blockIdx.y * kFineTile - 1, j0 = blockIdx.x * kFineTile - 1;
  for (int t = threadIdx.x; t < XW * XW; t += blockDim.x) {
    const int a = t / XW, b = t - a * XW;
    const int fi = mirror(i0 + a, h), fj = mirror(j0 + b, w);
    const size_t g = base + static_cast<size_t>(fi) * w + fj;
    const T rv = r[g];
    Rs[t] = rv;
    X[t] = (kHasX ? x[g] : c * rv) + prolong_at(z, fi, fj, hc, wc);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kFineTile * kFineTile; t += blockDim.x) {
    const int a = t / kFineTile + 1, b = t % kFineTile + 1;
    const int gi = i0 + a, gj = j0 + b;
    if (gi >= h || gj >= w) continue;
    const int q = a * XW + b;
    out[base + static_cast<size_t>(gi) * w + gj] =
        sweep_point(X[q], Rs[q], X[q - XW], X[q + XW], X[q - 1], X[q + 1],
                    weight, c);
  }
}

// ---------------------------------------------------------------- V-cycle

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Shared-memory values vcycle_block needs for levels lv (entry = level 0).
size_t vcycle_smem_values(const Levels& lv) {
  size_t v = static_cast<size_t>(lv.h[0]) * lv.w[0];  // scratch
  for (int l = 0; l < lv.n; ++l) {
    const size_t n = static_cast<size_t>(lv.h[l]) * lv.w[l];
    v += l == 0 ? n : 2 * n;  // x of every level, r below the entry
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    vcycle_block(const T* __restrict__ r_in, T* __restrict__ out, Levels lv,
                 int nu, int coarse_sweeps, T weight, T c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kBlockThreads];
  const int L = lv.n - 1;
  const int N0 = lv.h[0] * lv.w[0];
  T* tmp = reinterpret_cast<T*>(smem_raw);
  T* xs[kMaxLevels];
  T* rs[kMaxLevels] = {};
  T* p = tmp + N0;
  for (int l = 0; l <= L; ++l) {
    const int n = lv.h[l] * lv.w[l];
    xs[l] = p;
    p += n;
    if (l > 0) {
      rs[l] = p;
      p += n;
    }
  }
  const size_t base = static_cast<size_t>(blockIdx.x) * N0;
  const T* r0 = r_in + base;

  // Descent: nu sweeps from zero, residual, restriction.
  for (int l = 0; l < L; ++l) {
    const int h = lv.h[l], w = lv.w[l], n = h * w;
    const T* r = l == 0 ? r0 : rs[l];
    field_fill_zero(xs[l], n);
    field_sweeps(xs[l], r, tmp, h, w, nu, weight, c);
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int i = t / w, j = t - i * w;
      tmp[t] = r[t] - lap_at(xs[l], t, i, j, h, w, weight);
    }
    __syncthreads();
    const int hc = h / 2, wc = w / 2;
    for (int t = threadIdx.x; t < hc * wc; t += blockDim.x) {
      const int I = t / wc, J = t - I * wc;
      const int ri[4] = {max(2 * I - 1, 0), 2 * I, 2 * I + 1,
                         min(2 * I + 2, h - 1)};
      const int cj[4] = {max(2 * J - 1, 0), 2 * J, 2 * J + 1,
                         min(2 * J + 2, w - 1)};
      T col[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T* s = tmp + ri[q] * w;
        col[q] = restrict4(s[cj[0]], s[cj[1]], s[cj[2]], s[cj[3]]);
      }
      rs[l + 1][t] = restrict4(col[0], col[1], col[2], col[3]);
    }
    __syncthreads();
  }

  // Coarsest: mean-projected right-hand side, rolled sweeps from zero,
  // mean-projected solution.
  {
    const int h = lv.h[L], w = lv.w[L], n = h * w;
    T* r = rs[L];
    T* sweep_tmp = tmp;
    if (L == 0) {
      // The entry level is the coarsest: its r stays in device memory, so
      // the projected r goes to tmp and the sweeps ping-pong through the
      // extra field the launcher reserves after x.
      T s = T(0);
      for (int t = threadIdx.x; t < n; t += blockDim.x) s += r0[t];
      const T mean = block_sum(s, red) / T(n);
      for (int t = threadIdx.x; t < n; t += blockDim.x) tmp[t] = r0[t] - mean;
      __syncthreads();
      r = tmp;
      sweep_tmp = xs[0] + n;
    } else {
      field_subtract_mean(r, n, red);
    }
    field_fill_zero(xs[L], n);
    field_sweeps(xs[L], r, sweep_tmp, h, w, coarse_sweeps, weight, c);
    field_subtract_mean(xs[L], n, red);
  }

  // Ascent: prolongated correction, nu sweeps.
  for (int l = L - 1; l >= 0; --l) {
    const int h = lv.h[l], w = lv.w[l], n = h * w;
    const int hc = lv.h[l + 1], wc = lv.w[l + 1];
    const T* r = l == 0 ? r0 : rs[l];
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int i = t / w, j = t - i * w;
      xs[l][t] += prolong_at(xs[l + 1], i, j, hc, wc);
    }
    __syncthreads();
    field_sweeps(xs[l], r, tmp, h, w, nu, weight, c);
  }

  field_subtract_mean(xs[0], N0, red);
  for (int t = threadIdx.x; t < N0; t += blockDim.x) out[base + t] = xs[0][t];
}

// Two-pass deterministic mean projection of [B, n] fields: per-chunk
// partial sums, then every block of the second pass sums the partials in
// the same order and subtracts the mean.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mean_partials(const T* __restrict__ x, T* __restrict__ part, size_t n,
                  int nchunk) {
  __shared__ T red[kThreads];
  const T* xb = x + blockIdx.y * n;
  const size_t lo = static_cast<size_t>(blockIdx.x) * kMeanChunk;
  const size_t hi = lo + kMeanChunk < n ? lo + kMeanChunk : n;
  T s = T(0);
  for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x) s += xb[i];
  const T total = block_sum(s, red);
  if (threadIdx.x == 0) part[blockIdx.y * nchunk + blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    subtract_mean(const T* __restrict__ x, const T* __restrict__ part,
                  T* __restrict__ out, size_t n, int nchunk) {
  __shared__ T red[kThreads];
  T s = T(0);
  for (int k = threadIdx.x; k < nchunk; k += blockDim.x) {
    s += part[blockIdx.y * nchunk + k];
  }
  const T mean = block_sum(s, red) / T(n);
  const size_t base = blockIdx.y * n;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    out[base + i] = x[base + i] - mean;
  }
}

// ---------------------------------------------------------------- launchers

template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return 0;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T>
int launch_jacobi(const T* x, const T* r, T* out, int B, int h, int w,
                  int sweeps, int single, double weight, double c,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (single) {
    const size_t bytes = 3 * static_cast<size_t>(h) * w * sizeof(T);
    const int err = opt_in(jacobi_block<T>, bytes);
    if (err) return err;
    jacobi_block<T><<<B, kBlockThreads, bytes, s>>>(x, r, out, h, w, sweeps,
                                                    T(weight), T(c));
  } else {
    if (sweeps < 1 || sweeps > kMaxHalo) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t bytes = 3 * static_cast<size_t>(kTileH + 2 * sweeps) *
                         (kTileW + 2 * sweeps) * sizeof(T);
    const int err = opt_in(jacobi_tiled<T>, bytes);
    if (err) return err;
    const dim3 grid(ceil_div(w, kTileW), ceil_div(h, kTileH), B);
    jacobi_tiled<T><<<grid, kThreads, bytes, s>>>(x, r, out, h, w, sweeps,
                                                  T(weight), T(c));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_presmooth_restrict(const T* r, const T* x, T* rc, int B, int h,
                              int w, double weight, double c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ceil_div(w / 2, kCoarseTile), ceil_div(h / 2, kCoarseTile),
                  B);
  if (x == nullptr) {
    presmooth_restrict_tiled<T, false><<<grid, kThreads, 0, s>>>(
        r, nullptr, rc, h, w, T(weight), T(c));
  } else {
    presmooth_restrict_tiled<T, true><<<grid, kThreads, 0, s>>>(
        r, x, rc, h, w, T(weight), T(c));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_prolong_postsmooth(const T* r, const T* zc, const T* x, T* out,
                              int B, int h, int w, double weight, double c,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ceil_div(w, kFineTile), ceil_div(h, kFineTile), B);
  if (x == nullptr) {
    prolong_postsmooth_tiled<T, false><<<grid, kThreads, 0, s>>>(
        r, zc, nullptr, out, h, w, T(weight), T(c));
  } else {
    prolong_postsmooth_tiled<T, true><<<grid, kThreads, 0, s>>>(
        r, zc, x, out, h, w, T(weight), T(c));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vcycle(const T* r, T* out, int B, int n_levels, const int* hs,
                  const int* ws, int nu, int coarse_sweeps, double weight,
                  double c, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
  }
  for (int l = n_levels; l < kMaxLevels; ++l) lv.h[l] = lv.w[l] = 0;
  size_t values = vcycle_smem_values(lv);
  if (n_levels == 1) values += static_cast<size_t>(hs[0]) * ws[0];
  const size_t bytes = values * sizeof(T);
  if (bytes + kBlockThreads * sizeof(T) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = opt_in(vcycle_block<T>, bytes);
  if (err) return err;
  vcycle_block<T><<<B, kBlockThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      r, out, lv, nu, coarse_sweeps, T(weight), T(c));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_subtract_mean(const T* x, T* out, T* part, int B, long long n,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nn = static_cast<size_t>(n);
  const int nchunk = static_cast<int>((nn + kMeanChunk - 1) / kMeanChunk);
  mean_partials<T><<<dim3(nchunk, B), kThreads, 0, s>>>(x, part, nn, nchunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int per_chunk = kMeanChunk / kThreads;
  const int blocks = nchunk < 4096 / per_chunk ? nchunk * per_chunk : 4096;
  subtract_mean<T><<<dim3(blocks, B), kThreads, 0, s>>>(x, part, out, nn,
                                                        nchunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Jacobi: single != 0 runs every sweep in one block per sample (x, its
// copy and r in shared memory); otherwise 1 <= sweeps <= 8 in 2-D tiles.
int stencil_jacobi_f32(const float* x, const float* r, float* out, int B,
                       int h, int w, int sweeps, int single, double weight,
                       double c, void* stream) {
  return launch_jacobi<float>(x, r, out, B, h, w, sweeps, single, weight, c,
                              stream);
}
int stencil_jacobi_f64(const double* x, const double* r, double* out, int B,
                       int h, int w, int sweeps, int single, double weight,
                       double c, void* stream) {
  return launch_jacobi<double>(x, r, out, B, h, w, sweeps, single, weight, c,
                               stream);
}

// x == NULL: the pre-smoothed field is c·r (one sweep from zero).
int stencil_presmooth_restrict_f32(const float* r, const float* x, float* rc,
                                   int B, int h, int w, double weight,
                                   double c, void* stream) {
  return launch_presmooth_restrict<float>(r, x, rc, B, h, w, weight, c,
                                          stream);
}
int stencil_presmooth_restrict_f64(const double* r, const double* x,
                                   double* rc, int B, int h, int w,
                                   double weight, double c, void* stream) {
  return launch_presmooth_restrict<double>(r, x, rc, B, h, w, weight, c,
                                           stream);
}

int stencil_prolong_postsmooth_f32(const float* r, const float* zc,
                                   const float* x, float* out, int B, int h,
                                   int w, double weight, double c,
                                   void* stream) {
  return launch_prolong_postsmooth<float>(r, zc, x, out, B, h, w, weight, c,
                                          stream);
}
int stencil_prolong_postsmooth_f64(const double* r, const double* zc,
                                   const double* x, double* out, int B,
                                   int h, int w, double weight, double c,
                                   void* stream) {
  return launch_prolong_postsmooth<double>(r, zc, x, out, B, h, w, weight, c,
                                           stream);
}

// hs, ws: host arrays of the n_levels level shapes, entry level first.
int stencil_vcycle_f32(const float* r, float* out, int B, int n_levels,
                       const int* hs, const int* ws, int nu,
                       int coarse_sweeps, double weight, double c,
                       void* stream) {
  return launch_vcycle<float>(r, out, B, n_levels, hs, ws, nu, coarse_sweeps,
                              weight, c, stream);
}
int stencil_vcycle_f64(const double* r, double* out, int B, int n_levels,
                       const int* hs, const int* ws, int nu,
                       int coarse_sweeps, double weight, double c,
                       void* stream) {
  return launch_vcycle<double>(r, out, B, n_levels, hs, ws, nu,
                               coarse_sweeps, weight, c, stream);
}

// part holds B·ceil(n / 4096) values.
int stencil_subtract_mean_f32(const float* x, float* out, float* part, int B,
                              long long n, void* stream) {
  return launch_subtract_mean<float>(x, out, part, B, n, stream);
}
int stencil_subtract_mean_f64(const double* x, double* out, double* part,
                              int B, long long n, void* stream) {
  return launch_subtract_mean<double>(x, out, part, B, n, stream);
}

}  // extern "C"
