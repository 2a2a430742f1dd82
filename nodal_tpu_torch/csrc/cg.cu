// Fused CG kernels of the grid solve, for sm_90a.
//
// Replace the Pallas TPU kernels of nodal_tpu/ops/pallas_cg.py:
//   * stencil_partials_tiled <- stencil_partials (:47): Lp = L_w p and the
//     partial sums of p·Lp and of p;
//   * update_partials_tiled  <- update_partials (:94): x' = x + a p,
//     r' = r - a (Lp + mean_p) and the partial sum of r'².
// Semantics follow the plain versions in nodal_tpu_torch/ops/fused_cg.py:
// fields are [B, h, w], L_w is the edge-replicate 5-point stencil
// (grid_common.cuh), a and mean_p are [B] per-sample values in device
// memory, so a CG step reads no host value.
//
// Design.  Both kernels cut a field into the same 32 x 64 tiles, one
// 256-thread block a (tile, sample): grid (ceil(w/64), ceil(h/32), B).  Each
// block writes one partial sum a quantity for its (sample, tile), at
// tile = blockIdx.y * gridDim.x + blockIdx.x, summed with a fixed stride per
// thread and then a fixed tree (block_sum); the wrapper sums the partials
// over the tile axis in a fixed order.  No atomics: a solve repeats bit for
// bit.  The Pallas kernels tiled 256 full-width rows with an 8-row halo, a
// Mosaic layout constraint that does not carry over.
//   * S loads its tile plus a one-cell halo into shared memory, through the
//     mirror index (the edge-replicate boundary), and writes Lp.
//   * U is elementwise; neighbouring threads touch neighbouring columns.
// Bound on the H100: bytes.  S reads p and writes Lp (2 values a cell), U
// reads x, r, p, Lp and writes x, r (6 values a cell), against a few flops a
// cell: at 3.35 TB/s a 1024^2 f32 field costs ~2.5 us in S and ~7.5 us in U.
// S re-reads ~10 % of p for its halos.  Offsets into a batch are size_t.  Each
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>

#include "grid_common.cuh"

namespace {

using nodal_grid::block_sum;
using nodal_grid::ceil_div;
using nodal_grid::lap_point;
using nodal_grid::mirror;

constexpr int kThreads = 256;  // a power of two (block_sum)
constexpr int kTileH = 32;
constexpr int kTileW = 64;

// This block's (sample, tile) slot among B * gridDim.x * gridDim.y.
__device__ __forceinline__ size_t tile_slot() {
  return static_cast<size_t>(blockIdx.z) * gridDim.x * gridDim.y +
         blockIdx.y * gridDim.x + blockIdx.x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stencil_partials_tiled(const T* __restrict__ p, T* __restrict__ lp,
                           T* __restrict__ part, int h, int w, T weight) {
  constexpr int WH = kTileH + 2, WW = kTileW + 2;
  __shared__ T P[WH * WW];
  __shared__ T red[kThreads];
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  for (int t = threadIdx.x; t < WH * WW; t += blockDim.x) {
    const int a = t / WW, b = t - a * WW;
    P[t] = p[base + static_cast<size_t>(mirror(i0 - 1 + a, h)) * w +
             mirror(j0 - 1 + b, w)];
  }
  __syncthreads();
  T s_plp = T(0), s_p = T(0);
  for (int t = threadIdx.x; t < kTileH * kTileW; t += blockDim.x) {
    const int a = t / kTileW, b = t - a * kTileW;
    const int gi = i0 + a, gj = j0 + b;
    if (gi >= h || gj >= w) continue;
    const int q = (a + 1) * WW + b + 1;
    const T v = P[q];
    const T l = lap_point(v, P[q - WW], P[q + WW], P[q - 1], P[q + 1],
                          weight);
    lp[base + static_cast<size_t>(gi) * w + gj] = l;
    s_plp += v * l;
    s_p += v;
  }
  const T total_plp = block_sum(s_plp, red);
  const T total_p = block_sum(s_p, red);
  if (threadIdx.x == 0) {
    const size_t slot = tile_slot();
    part[2 * slot] = total_plp;
    part[2 * slot + 1] = total_p;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    update_partials_tiled(const T* __restrict__ x, const T* __restrict__ r,
                          const T* __restrict__ p, const T* __restrict__ lp,
                          const T* __restrict__ alpha,
                          const T* __restrict__ mean_p, T* __restrict__ xo,
                          T* __restrict__ ro, T* __restrict__ part, int h,
                          int w) {
  __shared__ T red[kThreads];
  const T a = alpha[blockIdx.z], mp = mean_p[blockIdx.z];
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  T s = T(0);
  for (int t = threadIdx.x; t < kTileH * kTileW; t += blockDim.x) {
    const int gi = i0 + t / kTileW, gj = j0 + t % kTileW;
    if (gi >= h || gj >= w) continue;
    const size_t g = base + static_cast<size_t>(gi) * w + gj;
    xo[g] = x[g] + a * p[g];
    const T rn = r[g] - a * (lp[g] + mp);
    ro[g] = rn;
    s += rn * rn;
  }
  const T total = block_sum(s, red);
  if (threadIdx.x == 0) part[tile_slot()] = total;
}

dim3 tile_grid(int B, int h, int w) {
  return dim3(ceil_div(w, kTileW), ceil_div(h, kTileH), B);
}

template <typename T>
int launch_stencil_partials(const T* p, T* lp, T* part, int B, int h, int w,
                            double weight, void* stream) {
  stencil_partials_tiled<T><<<tile_grid(B, h, w), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, lp, part, h, w, T(weight));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_update_partials(const T* x, const T* r, const T* p, const T* lp,
                           const T* alpha, const T* mean_p, T* xo, T* ro,
                           T* part, int B, int h, int w, void* stream) {
  update_partials_tiled<T><<<tile_grid(B, h, w), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, r, p, lp, alpha, mean_p, xo, ro, part, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// part holds B · ceil(h/32) · ceil(w/64) pairs (Σ p·Lp, Σ p).
int cg_stencil_partials_f32(const float* p, float* lp, float* part, int B,
                            int h, int w, double weight, void* stream) {
  return launch_stencil_partials<float>(p, lp, part, B, h, w, weight, stream);
}
int cg_stencil_partials_f64(const double* p, double* lp, double* part, int B,
                            int h, int w, double weight, void* stream) {
  return launch_stencil_partials<double>(p, lp, part, B, h, w, weight,
                                         stream);
}

// alpha, mean_p: [B]; part holds B · ceil(h/32) · ceil(w/64) values Σ r'².
int cg_update_partials_f32(const float* x, const float* r, const float* p,
                           const float* lp, const float* alpha,
                           const float* mean_p, float* xo, float* ro,
                           float* part, int B, int h, int w, void* stream) {
  return launch_update_partials<float>(x, r, p, lp, alpha, mean_p, xo, ro,
                                       part, B, h, w, stream);
}
int cg_update_partials_f64(const double* x, const double* r, const double* p,
                           const double* lp, const double* alpha,
                           const double* mean_p, double* xo, double* ro,
                           double* part, int B, int h, int w, void* stream) {
  return launch_update_partials<double>(x, r, p, lp, alpha, mean_p, xo, ro,
                                        part, B, h, w, stream);
}

}  // extern "C"
