// Fused CG kernels of the grid solve, for sm_90a.
//
// Replace the Pallas TPU kernels of nodal_tpu/ops/pallas_cg.py:
//   * stencil_partials_strip <- stencil_partials (:47): Lp = L_w p and the
//     partial sums of p·Lp and of p;
//   * update_partials_tiled  <- update_partials (:94): x' = x + a p,
//     r' = r - a (Lp + mean_p) and the partial sum of r'².
// Semantics follow the plain versions in nodal_tpu_torch/ops/fused_cg.py:
// fields are [B, h, w], L_w is the edge-replicate 5-point stencil
// (grid_common.cuh), a and mean_p are [B] per-sample values in device
// memory, so a CG step reads no host value.
//
// Bound on the H100: bytes.  S reads p and writes Lp (2 values a cell), U
// reads x, r, p, Lp and writes x, r (6 values a cell), against a few flops a
// cell: at 3.35 TB/s a 1024^2 f32 field costs ~2.5 us in S and ~7.5 us in U.
// Every partial sum is taken in a fixed order and written to a slot of its
// own, and the wrapper sums the slots in a fixed order: no atomics, a solve
// repeats bit for bit.  The Pallas kernels tiled 256 full-width rows with an
// 8-row halo, a Mosaic layout constraint that does not carry over.
//   * S is a row-streaming strip kernel, as the transfers of stencil.cu.  A
//     block of kStripThreads threads owns a strip of kStripThreads · V
//     columns (V = 16 / sizeof(T): one 16-byte access a thread) and walks
//     down a segment of rows.  The rows arrive by cp.async in a ring of
//     kRowRing rows, each with V halo columns a side, 16 bytes a copy where
//     the row pitch and the base pointer allow it, else one value a copy; so
//     each value of p is read from device memory about once (two halo rows a
//     segment come again, mostly from L2), and the loads run rows ahead of
//     the arithmetic.  A thread keeps the rows above and at the current one
//     in registers, reads the row below as one 16-byte value and its two
//     side neighbours, stores V values of Lp at once, and keeps its two sums
//     in registers over the segment; the block sums them by warp shuffles,
//     then over its warps in order, into one pair a (sample, segment,
//     strip).  The edge-replicate boundary is a select: columns -1 and w
//     read their mirror, rows -1 and h are staged from rows 0 and h - 1.
//     The segments depend on the field's shape and the card alone (the
//     wrapper's plan), never on B: a sample's partials are the same alone
//     or in a batch.
//   * U cuts a field into 32 x 64 tiles, one 256-thread block a (tile,
//     sample): grid (ceil(w/64), ceil(h/32), B), one partial a tile, summed
//     with a fixed stride per thread and then a fixed tree (block_sum).
//     Neighbouring threads touch neighbouring columns.
// Offsets into a batch are size_t.  Each launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "grid_common.cuh"

namespace {

using nodal_grid::block_sum;
using nodal_grid::ceil_div;
using nodal_grid::copy_async;
using nodal_grid::copy_commit;
using nodal_grid::copy_wait;
using nodal_grid::lap_point;
using nodal_grid::load16;
using nodal_grid::reflect;
using nodal_grid::store16;
using nodal_grid::Vec16;
using nodal_grid::warp_sum;

constexpr int kThreads = 256;  // U: a power of two (block_sum)
constexpr int kTileH = 32;     // U's tiles
constexpr int kTileW = 64;
constexpr int kStripThreads = 128;  // S: threads a strip block
constexpr int kRowRing = 8;         // S: ring slots, one row each

// This block's (sample, tile) slot among B * gridDim.x * gridDim.y.
__device__ __forceinline__ size_t tile_slot() {
  return static_cast<size_t>(blockIdx.z) * gridDim.x * gridDim.y +
         blockIdx.y * gridDim.x + blockIdx.x;
}

// S's ring row: the strip's columns and kHalo each side (16-byte units).
template <typename T>
struct StripRow {
  static constexpr int V = Vec16<T>::kN;  // columns a thread
  static constexpr int kCols = kStripThreads * V;
  static constexpr int kHalo = V;
  static constexpr int kWidth = kCols + 2 * kHalo;
};

// Row q (reflected once) of a field into a ring row (columns c0 - kHalo
// ...): the 16-byte chunks (kWide: w·sizeof(T) a multiple of 16, so a chunk
// is all in or all out) or the values inside [0, w).
template <typename T, bool kWide>
__device__ __forceinline__ void stage_strip_row(T* dst, const T* field,
                                                int q, int h, int w,
                                                int c0) {
  using S = StripRow<T>;
  const T* src = field + static_cast<size_t>(reflect(q, h)) * w;
  constexpr int kV = kWide ? S::V : 1;
  for (int t = threadIdx.x; t < S::kWidth / kV; t += kStripThreads) {
    const int col = c0 - S::kHalo + t * kV;
    if (col >= 0 && col < w) {
      copy_async<kV * sizeof(T)>(dst + t * kV, src + col);
    }
  }
}

// S on one (strip, segment, sample) block: grid (strips, segments, B).
// Local row u of the segment r0 .. r0 + nr - 1 is field row r0 - 1 + u;
// slot u % kRowRing holds it; rows u - 1, u, u + 1 give Lp's row u - 1.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kStripThreads)
    stencil_partials_strip(const T* __restrict__ p, T* __restrict__ lp,
                           T* __restrict__ part, int h, int w, int seg,
                           T weight) {
  using S = StripRow<T>;
  constexpr int V = S::V, D = kRowRing, kWarps = kStripThreads / 32;
  __shared__ __align__(16) T ring[D * S::kWidth];
  __shared__ T red[2 * kWarps];
  const int j = threadIdx.x;
  const int c0 = blockIdx.x * S::kCols, gc = c0 + j * V;
  const int r0 = blockIdx.y * seg, nr = min(seg, h - r0), rows = nr + 2;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const T* pb = p + base;
  T* lb = lp + base;

  for (int u = 0; u < D; ++u) {
    if (u < rows) {
      stage_strip_row<T, kWide>(ring + u * S::kWidth, pb, r0 - 1 + u, h, w,
                                c0);
    }
    copy_commit();
  }
  copy_wait<D - 2>();  // rows 0 and 1 have landed
  __syncthreads();
  const int col = S::kHalo + j * V;  // this thread's first ring column
  T up[V], mid[V];
  load16(ring + col, up);
  load16(ring + S::kWidth + col, mid);
  T s_plp = T(0), s_p = T(0);
  for (int t = 0; t < nr; ++t) {
    copy_wait<D - 3>();  // row t + 2 has landed
    __syncthreads();     // and no thread reads row t's slot any more
    if (t + D < rows) {
      stage_strip_row<T, kWide>(ring + (t % D) * S::kWidth, pb, r0 - 1 + t + D,
                                h, w, c0);
    }
    copy_commit();
    const T* mrow = ring + ((t + 1) % D) * S::kWidth + col;
    T dn[V], out[V];
    load16(ring + ((t + 2) % D) * S::kWidth + col, dn);
    const T lf = gc > 0 ? mrow[-1] : mid[0];
    const T rt = mrow[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T left = k > 0 ? mid[k - 1] : lf;
      const T right =
          gc + k + 1 < w ? (k + 1 < V ? mid[k + 1] : rt) : mid[k];
      out[k] = lap_point(mid[k], up[k], dn[k], left, right, weight);
      const bool in = gc + k < w;
      s_plp += in ? mid[k] * out[k] : T(0);
      s_p += in ? mid[k] : T(0);
    }
    T* dst = lb + static_cast<size_t>(r0 + t) * w + gc;
    if constexpr (kWide) {
      if (gc < w) store16(dst, out);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (gc + k < w) dst[k] = out[k];
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      up[k] = mid[k];
      mid[k] = dn[k];
    }
  }
  s_plp = warp_sum(s_plp);
  s_p = warp_sum(s_p);
  if (j % 32 == 0) {
    red[2 * (j / 32)] = s_plp;
    red[2 * (j / 32) + 1] = s_p;
  }
  __syncthreads();
  if (j == 0) {
    T a = T(0), b = T(0);
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      a += red[2 * q];
      b += red[2 * q + 1];
    }
    const size_t slot =
        (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
            gridDim.x +
        blockIdx.x;
    part[2 * slot] = a;
    part[2 * slot + 1] = b;
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
                            int seg, int wide, double weight, void* stream) {
  if (B < 1 || h < 1 || w < 1 || seg < 1 || ceil_div(h, seg) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (wide && ((static_cast<size_t>(w) * sizeof(T)) % 16 ||
               reinterpret_cast<uintptr_t>(p) % 16 ||
               reinterpret_cast<uintptr_t>(lp) % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(ceil_div(w, StripRow<T>::kCols), ceil_div(h, seg), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    stencil_partials_strip<T, true><<<grid, kStripThreads, 0, s>>>(
        p, lp, part, h, w, seg, T(weight));
  } else {
    stencil_partials_strip<T, false><<<grid, kStripThreads, 0, s>>>(
        p, lp, part, h, w, seg, T(weight));
  }
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

// part holds B · ceil(h/seg) · ceil(w/(128·16/sizeof(T))) pairs (Σ p·Lp,
// Σ p), by sample, segment, strip; wide: 16-byte copies and stores (w ·
// sizeof(T) a multiple of 16, p and lp aligned).
int cg_stencil_partials_f32(const float* p, float* lp, float* part, int B,
                            int h, int w, int seg, int wide, double weight,
                            void* stream) {
  return launch_stencil_partials<float>(p, lp, part, B, h, w, seg, wide,
                                        weight, stream);
}
int cg_stencil_partials_f64(const double* p, double* lp, double* part, int B,
                            int h, int w, int seg, int wide, double weight,
                            void* stream) {
  return launch_stencil_partials<double>(p, lp, part, B, h, w, seg, wide,
                                         weight, stream);
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
