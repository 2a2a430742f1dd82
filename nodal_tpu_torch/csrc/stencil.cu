// Multigrid stencil kernels of the matrix-free grid solve, for sm_90a.
//
// Replace the Pallas TPU kernels of nodal_tpu/ops/pallas_stencil.py:
//   * jacobi_tiled / jacobi_block / jacobi_cluster
//                                   <- fused_jacobi (:137)
//   * presmooth_restrict_strip      <- fused_presmooth_restrict (:211)
//   * prolong_postsmooth_strip      <- fused_prolong_postsmooth (:286)
//   * vcycle_cluster / vcycle_block (+ jacobi_cluster for a coarsest level
//     alone, mean_partials / subtract_mean for one no cluster holds)
//                                   <- fused_vcycle (:380)
// Semantics follow the plain versions in nodal_tpu_torch/ops/stencil.py:
// fields are [B, h, w], the Laplacian is the edge-replicate 5-point stencil
// L_w x = w (4x - up - down - left - right), a weighted-Jacobi sweep is
// x <- x + c (r - L_w x) with c = omega / (4w), and the transfers are the
// cell-centred bilinear ones (1-D weights 3/4, 1/4; edge-replicated
// prolongation, restriction = its transpose with the edge folds).
//
// Design.  The tiled Jacobi kernels cut a field into 2-D output tiles; a
// block loads its tile plus a halo into shared memory.  Outside the field
// the halo is the field's mirror image (x[-1] = x[0], repeated with period
// 2h for halos wider than the field), which is exactly the edge-replicate
// boundary: the stencil commutes with the reflections, so mirrored ghosts
// stay consistent through any number of sweeps and the tiles are exact,
// not approximate.
//   * Jacobi: K <= 8 sweeps a launch on a (32 + 2K) x (64 + 2K) window
//     (overlapped trapezoids: sweep s updates cells at distance >= s from
//     the window edge, so the 32 x 64 centre is exact after K sweeps); the
//     wrapper loops launches for more sweeps.  Fields whose x, its
//     ping-pong copy and r fit one block's shared memory run all sweeps in
//     one single-block launch per sample (jacobi_block).
//   * Restriction and prolongation + post-smooth: row-streaming strip
//     kernels (see "restriction, prolongation" below).  Their bound is
//     bytes: presmooth_restrict reads r once and writes rc once, 1.25 n
//     values for an n-value field (2.25 n with a given x), a few flops a
//     value; prolong_postsmooth reads r and zc and writes out, 2.25 n
//     (3.25 n with x).  So a block owns a column strip and a segment of
//     rows and walks down them, its rows staged by 16-byte cp.async into
//     a shared-memory ring several rows ahead: each fine value comes from
//     device memory about once (the tiles re-read 1.27x and 1.13x, one
//     scalar load at a time), and the loads overlap the arithmetic.  A
//     thread forms two fine columns, holding the rows above and at the
//     current one in registers: the restriction's residual rows and their
//     horizontal four-tap sums, the prolongation's coarse neighbours (each
//     loaded once a row, not four clamped loads a cell).  Ghost columns
//     are written by the blocks at the field's edges alone; rows past the
//     edge are copied from their mirror rows.  The TPU kernels formed the
//     transfers as matrix products because Mosaic rejects strided slices;
//     here they are direct four-tap sums, with no matrix products.
//   * V-cycle: one block per sample holds the whole hierarchy below an
//     entry level in shared memory (x of every level, r of every level
//     below the entry, one scratch field of the entry size; the entry r is
//     read from device memory) and runs the V(nu, nu) cycle, the 96-sweep
//     coarsest solve with both mean projections and the entry's mean
//     projection as block reductions (a fixed tree: a solve repeats bit for
//     bit).  A coarsest level too large for a block goes through the
//     Jacobi kernels and mean_partials + subtract_mean, a two-pass
//     reduction with no atomics.
//   * Clusters: the TPU kernel's premise, one fast memory holding the
//     hierarchy, returns on Hopper across a thread-block cluster: up to 16
//     CTAs on neighbouring SMs, 16 x 227 KB, read each other's shared
//     memory.  vcycle_cluster holds the hierarchy below a larger entry
//     level (256^2 instead of 128^2 in f32, 64^2 in f64) in row strips,
//     one cluster a sample (see "thread-block clusters" below); a level
//     with larger strips runs faster in the transfer and tiled kernels,
//     which the Python plan keeps above the entry.  jacobi_cluster runs all
//     sweeps of a field past one block in one launch, and with its mean
//     projections a coarsest level that no block holds.
// Bound on the H100: bytes.  Every kernel does a few flops a value (a sweep
// is 8); at 3.35 TB/s a 1024^2 f32 field read or written costs 1.25 us,
// against 67 TFLOP/s for the arithmetic.  The tiled Jacobi reads each input
// once (plus halo re-reads, 1.9x for an 8-sweep window, which the cache
// absorbs in part) and writes each output once.  The single-block
// V-cycle is latency-bound: one SM, ~10 barriers a sweep.  The cluster
// kernels are latency-bound too, by one cluster barrier a sweep and the
// small levels in rank 0, but spread a level's sweeps over C SMs.
// All offsets into a batch are size_t: [130, 4096, 4096] is past 2^31
// values.  Each launcher returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "grid_common.cuh"

namespace {

namespace cg = cooperative_groups;

using nodal_grid::block_sum;
using nodal_grid::ceil_div;
using nodal_grid::lap_point;
using nodal_grid::mirror;

constexpr int kThreads = 256;      // tiled kernels
constexpr int kBlockThreads = 512; // single-block, cluster kernels (see pcr.cu)
constexpr int kTileH = 32;         // Jacobi output tile
constexpr int kTileW = 64;
constexpr int kMaxHalo = 8;        // sweeps per tiled Jacobi launch
constexpr int kMaxLevels = 32;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;   // 227 KB a block on the H100
constexpr int kMeanChunk = 4096;   // values a block sums in mean_partials
constexpr int kMaxCluster = 16;    // CTAs a cluster (past 8: non-portable)
constexpr int kRank0Rows = 4;      // thinner strips: the level goes to rank 0
constexpr int kSlots = 2;          // a cluster sum's alternating slots
constexpr int kWarpCoarse = 256;   // coarsest values (w <= 32): one warp

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
//
// Row-streaming strip kernels.  A block of kStripCols threads owns
// kStripCols coarse columns, thread j coarse column J = J0 + j (fine
// columns 2J, 2J + 1), and a segment of coarse rows, down which it walks
// two fine rows ("a group") at a time.  The groups arrive in a ring of
// kRingGroups slots in shared memory by cp.async: group g + kRingGroups - 1
// is copied while group g is computed, into the slot group g - 1 left, so
// each fine value is read from device memory about once (the two or four
// overlapping rows of two segments come from L2) and the loads overlap the
// arithmetic.  A ring row holds the strip's fine columns and kHalo more on
// each side; the copies move kV values at a time (16 bytes where the row
// pitch and the base pointers allow it, else one value), and columns
// outside the field are never copied: the blocks at the field's edges
// write those the stencil reads (the mirror columns -1, -2 <- 0, 1 and
// w, w + 1 <- w - 1, w - 2) one group ahead, after the group has landed.
// Rows outside the field are copied from their mirror rows.  Each thread
// keeps the rows it needs in registers and reads only the newest group.

constexpr int kStripCols = 128;  // coarse columns (threads) a strip block
constexpr int kRingGroups = 4;   // ring slots, two fine rows each

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// The fine ring row of a launch whose copies move kV values: the strip's
// 2 kStripCols fine columns and kHalo (>= 2, a multiple of kV) each side.
template <int kV>
struct RowWindow {
  static constexpr int kHalo = kV > 2 ? kV : 2;
  static constexpr int kWidth = 2 * kStripCols + 2 * kHalo;
};
// A coarse ring row: the strip's coarse columns and one each side.
constexpr int kCoarseWidth = kStripCols + 2;

template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's latest groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row q of an n-row field, q in [-2, n + 1], reflected once: -1 -> 0,
// -2 -> 1, n -> n - 1, n + 1 -> n - 2 (n >= 2, or n >= 1 for q in
// [-1, n]).  Only a segment at the field's top or bottom takes a branch.
__device__ __forceinline__ int reflect(int q, int n) {
  return q < 0 ? -1 - q : (q >= n ? 2 * n - 1 - q : q);
}

// Fine row q of a field into a ring row (columns c0 - kHalo ...): the
// chunks of kV values inside [0, w) (w % kV == 0, so a chunk is all in or
// all out).
template <typename T, int kV>
__device__ __forceinline__ void stage_row(T* dst, const T* field, int q,
                                          int h, int w, int c0) {
  constexpr int H = RowWindow<kV>::kHalo, W = RowWindow<kV>::kWidth;
  const T* src = field + static_cast<size_t>(reflect(q, h)) * w;
  for (int t = threadIdx.x; t < W / kV; t += blockDim.x) {
    const int col = c0 - H + t * kV;
    if (col >= 0 && col < w) {
      copy_async<kV * sizeof(T)>(dst + t * kV, src + col);
    }
  }
}

// Coarse row Q of zc [hc, wc] into a coarse ring row (columns J0 - 1 ...),
// one value a copy.
template <typename T>
__device__ __forceinline__ void stage_coarse_row(T* dst, const T* zc, int Q,
                                                 int hc, int wc, int J0) {
  const T* src = zc + static_cast<size_t>(reflect(Q, hc)) * wc;
  for (int t = threadIdx.x; t < kCoarseWidth; t += blockDim.x) {
    const int col = J0 - 1 + t;
    if (col >= 0 && col < wc) copy_async<sizeof(T)>(dst + t, src + col);
  }
}

// The mirror columns of a landed fine ring row at the field's edges.
template <int H, typename T>
__device__ __forceinline__ void mirror_columns(T* row, int c0, int w) {
  if (c0 == 0) {
    row[H - 1] = row[H];
    row[H - 2] = row[H + 1];
  }
  if (c0 + 2 * kStripCols >= w) {
    const int e = w - c0 + H;  // column w
    row[e] = row[e - 1];
    row[e + 1] = row[e - 2];
  }
}

template <typename T>
__device__ __forceinline__ void mirror_coarse(T* row, int J0, int wc) {
  if (J0 == 0) row[0] = row[1];
  if (J0 + kStripCols >= wc) row[wc - J0 + 1] = row[wc - J0];
}

// A thread's six fine values 2J - 2 .. 2J + 3 of a ring row (row points at
// column 2J - 2, an even offset: aligned pair loads).
template <typename T>
__device__ __forceinline__ void read6(const T* row, T (&v)[6]) {
  using V2 = typename Vec2<T>::type;
  const V2* q = reinterpret_cast<const V2*>(row);
  const V2 a = q[0], b = q[1], c = q[2];
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
  v[4] = c.x;
  v[5] = c.y;
}

// One fine row for the restriction: x at 2J - 2 .. 2J + 3 (c r unless x is
// given) and r at 2J - 1 .. 2J + 2.
template <typename T, int H, bool kHasX>
__device__ __forceinline__ void read_fine(const T* rrow, const T* xrow,
                                          int j, T c, T (&x6)[6],
                                          T (&r4)[4]) {
  T r6[6];
  read6(rrow + 2 * j + H - 2, r6);
  if constexpr (kHasX) {
    read6(xrow + 2 * j + H - 2, x6);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) x6[k] = c * r6[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) r4[k] = r6[k + 1];
}

// The horizontal restriction of one fine row of the residual r - L x:
// restrict4 over fine columns 2J - 1 .. 2J + 2, from x of the row at
// 2J - 2 .. 2J + 3 (xm), of the rows above and below at 2J - 1 .. 2J + 2.
template <typename T>
__device__ __forceinline__ T residual_row(const T (&xu)[4], const T (&xm)[6],
                                          const T (&xd)[4], const T (&rr)[4],
                                          T weight) {
  T s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = rr[k] - lap_point(xm[k + 1], xu[k], xd[k], xm[k], xm[k + 2],
                             weight);
  }
  return restrict4(s[0], s[1], s[2], s[3]);
}

template <typename T>
__device__ __forceinline__ void centre4(const T (&v)[6], T (&out)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = v[k + 1];
}

// Group g's two fine rows, first + 2g and first + 2g + 1, of r (and x)
// into their ring slot (rows 2 (g % kRingGroups) .. + 1 of each ring).
template <typename T, int kV, bool kHasX>
__device__ __forceinline__ void stage_fine_group(T* Rr, T* Xr, const T* r,
                                                 const T* x, int g,
                                                 int first, int h, int w,
                                                 int c0) {
  constexpr int W = RowWindow<kV>::kWidth;
  for (int e = 0; e < 2; ++e) {
    const int row = (2 * (g % kRingGroups) + e) * W, q = first + 2 * g + e;
    stage_row<T, kV>(Rr + row, r, q, h, w, c0);
    if constexpr (kHasX) stage_row<T, kV>(Xr + row, x, q, h, w, c0);
  }
}

// The mirror columns of group g's landed fine rows: thread t < 2 those of
// r's row t, 2 <= t < 4 those of x's row t - 2.
template <typename T, int kV, bool kHasX>
__device__ __forceinline__ void mirror_fine_group(T* Rr, T* Xr, int g,
                                                  int c0, int w) {
  constexpr int W = RowWindow<kV>::kWidth;
  const int t = threadIdx.x;
  if (t < (kHasX ? 4 : 2)) {
    const int row = (2 * (g % kRingGroups) + (t & 1)) * W;
    mirror_columns<RowWindow<kV>::kHalo>((t < 2 ? Rr : Xr) + row, c0, w);
  }
}

// rc = restrict(r - L x), x = c r unless given.  Local fine row u of a
// segment of coarse rows I0 .. I0 + nI - 1 is row 2 I0 - 2 + u; group g
// holds rows 2g, 2g + 1; residual rows 1 .. 2 nI + 2 feed the segment's
// coarse rows (row I0 + m from residual rows 2m + 1 .. 2m + 4).
template <typename T, int kV, bool kHasX>
__global__ void __launch_bounds__(kStripCols)
    presmooth_restrict_strip(const T* __restrict__ r,
                             const T* __restrict__ x, T* __restrict__ rc,
                             int h, int w, int seg, T weight, T c) {
  constexpr int H = RowWindow<kV>::kHalo, W = RowWindow<kV>::kWidth;
  constexpr int D = kRingGroups;
  __shared__ __align__(16) T Rr[2 * D * W];
  __shared__ __align__(16) T Xr[(kHasX ? 2 * D : 1) * W];
  const int hc = h / 2, wc = w / 2, j = threadIdx.x;
  const int J0 = blockIdx.x * kStripCols, J = J0 + j, c0 = 2 * J0;
  const int I0 = blockIdx.y * seg, nI = min(seg, hc - I0);
  const int groups = nI + 2, first = 2 * I0 - 2;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const T* rb = r + base;
  const T* xb = kHasX ? x + base : nullptr;
  T* out = rc + static_cast<size_t>(blockIdx.z) * hc * wc;
  const bool edge = blockIdx.x == 0 || blockIdx.x == gridDim.x - 1;

  for (int g = 0; g < D - 1; ++g) {
    if (g < groups) {
      stage_fine_group<T, kV, kHasX>(Rr, Xr, rb, xb, g, first, h, w, c0);
    }
    copy_commit();
  }
  copy_wait<D - 2>();  // group 0 has landed
  __syncthreads();
  if (edge) mirror_fine_group<T, kV, kHasX>(Rr, Xr, 0, c0, w);
  // Entering group g: x of rows 2g - 2 (at 2J - 1 .. 2J + 2) and 2g - 1,
  // r of row 2g - 1, the horizontal restrictions of rows 2g - 3, 2g - 2.
  T xu[4] = {}, xm[6] = {}, rm[4] = {}, h0 = T(0), h1 = T(0);
  for (int g = 0; g < groups; ++g) {
    copy_wait<D - 3>();  // group g + 1 has landed
    __syncthreads();
    if (edge && g + 1 < groups) {
      mirror_fine_group<T, kV, kHasX>(Rr, Xr, g + 1, c0, w);
    }
    if (g + D - 1 < groups) {  // into the slot group g - 1 left
      stage_fine_group<T, kV, kHasX>(Rr, Xr, rb, xb, g + D - 1, first, h, w,
                                     c0);
    }
    copy_commit();
    const int s = 2 * (g % D) * W;
    T xa[6], ra[4], xq[6], rq[4];
    read_fine<T, H, kHasX>(Rr + s, Xr + (kHasX ? s : 0), j, c, xa, ra);
    read_fine<T, H, kHasX>(Rr + s + W, Xr + (kHasX ? s + W : 0), j, c, xq,
                           rq);
    T xa4[4], xq4[4];
    centre4(xa, xa4);
    centre4(xq, xq4);
    if (g > 0) {
      T xm4[4];
      centre4(xm, xm4);
      const T ha = residual_row(xu, xm, xa4, rm, weight);  // row 2g - 1
      const T hb = residual_row(xm4, xa, xq4, ra, weight);  // row 2g
      if (g > 1 && J < wc) {
        out[static_cast<size_t>(I0 + g - 2) * wc + J] =
            restrict4(h0, h1, ha, hb);
      }
      h0 = ha;
      h1 = hb;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xu[k] = xa4[k];
      rm[k] = rq[k];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) xm[k] = xq[k];
  }
}

// x = c r (or the given x) + P zc at fine columns 2J - 1 .. 2J + 2 of one
// fine row, from the coarse rows near (weight 3/4) and far (1/4) at
// J - 1, J, J + 1 (rows first, then columns, as prolong_at); r at 2J,
// 2J + 1 kept for the sweep.
template <typename T, int H, bool kHasX>
__device__ __forceinline__ void form_x(const T* rrow, const T* xrow, int j,
                                       const T (&zn)[3], const T (&zf)[3],
                                       T c, T (&X)[4], T (&r2)[2]) {
  T a[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k] = T(0.75) * zn[k] + T(0.25) * zf[k];
  const T p[4] = {T(0.75) * a[0] + T(0.25) * a[1],
                  T(0.75) * a[1] + T(0.25) * a[0],
                  T(0.75) * a[1] + T(0.25) * a[2],
                  T(0.75) * a[2] + T(0.25) * a[1]};
  T r6[6];
  read6(rrow + 2 * j + H - 2, r6);
  if constexpr (kHasX) {
    T x6[6];
    read6(xrow + 2 * j + H - 2, x6);
#pragma unroll
    for (int k = 0; k < 4; ++k) X[k] = x6[k + 1] + p[k];
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) X[k] = c * r6[k + 1] + p[k];
  }
  r2[0] = r6[2];
  r2[1] = r6[3];
}

// One sweep at fine columns 2J, 2J + 1 of a row of X (2J - 1 .. 2J + 2),
// with the rows above and below at 2J, 2J + 1, stored as a pair.
template <typename T>
__device__ __forceinline__ void sweep_pair(T* dst, const T (&up)[2],
                                           const T (&X)[4], const T (&dn)[2],
                                           const T (&rr)[2], T weight, T c) {
  typename Vec2<T>::type v;
  v.x = sweep_point(X[1], rr[0], up[0], dn[0], X[0], X[2], weight, c);
  v.y = sweep_point(X[2], rr[1], up[1], dn[1], X[1], X[3], weight, c);
  *reinterpret_cast<typename Vec2<T>::type*>(dst) = v;
}

template <typename T>
__device__ __forceinline__ void read3(const T* row, T (&v)[3]) {
  v[0] = row[0];
  v[1] = row[1];
  v[2] = row[2];
}

// out = one sweep of x = c r (or the given x) + P zc.  Local fine row u of
// a segment of coarse rows I0 .. I0 + nI - 1 is row 2 I0 - 1 + u, local
// coarse row v is I0 - 1 + v; group g holds fine rows 2g, 2g + 1 and
// coarse row g + 1 (coarse row 0 has a slot of its own, D); x of rows
// 2g - 2 .. 2g + 1 gives out at rows 2g - 1 and 2g.
template <typename T, int kV, bool kHasX>
__global__ void __launch_bounds__(kStripCols)
    prolong_postsmooth_strip(const T* __restrict__ r,
                             const T* __restrict__ zc,
                             const T* __restrict__ x, T* __restrict__ out,
                             int h, int w, int seg, T weight, T c) {
  constexpr int H = RowWindow<kV>::kHalo, W = RowWindow<kV>::kWidth;
  constexpr int D = kRingGroups, CW = kCoarseWidth;
  constexpr int kFineRows = kHasX ? 4 : 2;  // fine ring rows a group
  __shared__ __align__(16) T Rr[2 * D * W];
  __shared__ __align__(16) T Xr[(kHasX ? 2 * D : 1) * W];
  __shared__ __align__(16) T Zr[(D + 1) * CW];
  const int hc = h / 2, wc = w / 2, j = threadIdx.x;
  const int J0 = blockIdx.x * kStripCols, J = J0 + j, c0 = 2 * J0;
  const int I0 = blockIdx.y * seg, nI = min(seg, hc - I0);
  const int groups = nI + 1, first = 2 * I0 - 1;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const T* rb = r + base;
  const T* xb = kHasX ? x + base : nullptr;
  const T* zb = zc + static_cast<size_t>(blockIdx.z) * hc * wc;
  T* ob = out + base;
  const bool edge = blockIdx.x == 0 || blockIdx.x == gridDim.x - 1;

  for (int g = 0; g < D - 1; ++g) {
    if (g < groups) {
      stage_fine_group<T, kV, kHasX>(Rr, Xr, rb, xb, g, first, h, w, c0);
      stage_coarse_row(Zr + (g % D) * CW, zb, I0 + g, hc, wc, J0);
      if (g == 0) stage_coarse_row(Zr + D * CW, zb, I0 - 1, hc, wc, J0);
    }
    copy_commit();
  }
  copy_wait<D - 2>();  // group 0 and coarse row 0 have landed
  __syncthreads();
  if (edge) {
    mirror_fine_group<T, kV, kHasX>(Rr, Xr, 0, c0, w);
    if (j == kFineRows) mirror_coarse(Zr, J0, wc);
    if (j == kFineRows + 1) mirror_coarse(Zr + D * CW, J0, wc);
  }
  // Entering group g: coarse row g, x of rows 2g - 2 (at 2J, 2J + 1) and
  // 2g - 1 (at 2J - 1 .. 2J + 2), r of row 2g - 1 (at 2J, 2J + 1).
  T zo[3] = {}, xu[2] = {}, xm[4] = {}, rm[2] = {};
  for (int g = 0; g < groups; ++g) {
    copy_wait<D - 3>();  // group g + 1 has landed
    __syncthreads();
    if (edge && g + 1 < groups) {
      mirror_fine_group<T, kV, kHasX>(Rr, Xr, g + 1, c0, w);
      if (j == kFineRows) mirror_coarse(Zr + ((g + 1) % D) * CW, J0, wc);
    }
    const int gn = g + D - 1;  // into the slot group g - 1 left
    if (gn < groups) {
      stage_fine_group<T, kV, kHasX>(Rr, Xr, rb, xb, gn, first, h, w, c0);
      stage_coarse_row(Zr + (gn % D) * CW, zb, I0 + gn, hc, wc, J0);
    }
    copy_commit();
    const int s = 2 * (g % D) * W;
    if (g == 0) read3(Zr + D * CW + j, zo);
    T zn[3];
    read3(Zr + (g % D) * CW + j, zn);
    // Fine row 2g is odd in the field (coarse row g near, g + 1 far),
    // 2g + 1 even (g + 1 near, g far).
    T Xa[4], ra[2], Xq[4], rq[2];
    form_x<T, H, kHasX>(Rr + s, Xr + (kHasX ? s : 0), j, zo, zn, c, Xa, ra);
    form_x<T, H, kHasX>(Rr + s + W, Xr + (kHasX ? s + W : 0), j, zn, zo, c,
                        Xq, rq);
    const T xa2[2] = {Xa[1], Xa[2]};
    if (g > 0 && J < wc) {
      T* dst = ob + static_cast<size_t>(first + 2 * g - 1) * w + 2 * J;
      const T xm2[2] = {xm[1], xm[2]};
      const T xq2[2] = {Xq[1], Xq[2]};
      sweep_pair(dst, xu, xm, xa2, rm, weight, c);      // row 2g - 1
      sweep_pair(dst + w, xm2, Xa, xq2, ra, weight, c);  // row 2g
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      xu[k] = xa2[k];
      rm[k] = rq[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) xm[k] = Xq[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) zo[k] = zn[k];
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

// Sum over a warp of each lane's s by a fixed xor tree: every lane gets the
// same value (addition commutes), bit for bit from run to run.
template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// A coarsest level of n = h w <= kWarpCoarse values, w <= 32, solved by
// warp 0 alone in registers: lane l holds cells l, l + 32, ... (K a lane)
// and reads its neighbours by shuffles, so a sweep takes no barrier and
// no memory.  rz = r minus its mean, sweeps from zero, x = the result
// minus its mean (both written back).  Ends with the block barrier.
template <typename T, int K>
__device__ void warp_coarse_regs(const T* r, T* x, int h, int w, int sweeps,
                                 T weight, T c) {
  const int n = h * w, lane = threadIdx.x;
  const unsigned all = 0xffffffffu;
  if (lane < 32) {
    T rz[K], v[K];
    int i[K], j[K];
    T s = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = lane + 32 * k;
      i[k] = t / w;
      j[k] = t - i[k] * w;
      rz[k] = t < n ? r[t] : T(0);
      s += rz[k];
    }
    const T mr = warp_sum(s) / T(n);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      rz[k] -= mr;
      v[k] = sweeps > 0 ? c * rz[k] : T(0);  // the first sweep from zero
    }
    const int up_lane = (lane - w) & 31, dn_lane = (lane + w) & 31;
    for (int it = 1; it < sweeps; ++it) {
      T nv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // Cell t - w lies in this register (lane >= w) or the one before;
        // t + w in this one (lane + w < 32) or the next; t -+ 1 likewise.
        const T up_a = __shfl_sync(all, v[k], up_lane);
        const T up_b = __shfl_sync(all, v[k > 0 ? k - 1 : 0], up_lane);
        const T dn_a = __shfl_sync(all, v[k], dn_lane);
        const T dn_b = __shfl_sync(all, v[k < K - 1 ? k + 1 : k], dn_lane);
        const T lf_a = __shfl_sync(all, v[k], (lane - 1) & 31);
        const T lf_b = __shfl_sync(all, v[k > 0 ? k - 1 : 0], 31);
        const T rt_a = __shfl_sync(all, v[k], (lane + 1) & 31);
        const T rt_b = __shfl_sync(all, v[k < K - 1 ? k + 1 : k], 0);
        const T vk = v[k];
        const T up = i[k] > 0 ? (lane >= w ? up_a : up_b) : vk;
        const T dn = i[k] < h - 1 ? (lane + w < 32 ? dn_a : dn_b) : vk;
        const T lf = j[k] > 0 ? (lane > 0 ? lf_a : lf_b) : vk;
        const T rt = j[k] < w - 1 ? (lane < 31 ? rt_a : rt_b) : vk;
        nv[k] = vk + c * (rz[k] - lap_point(vk, up, dn, lf, rt, weight));
      }
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = nv[k];
    }
    s = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) s += lane + 32 * k < n ? v[k] : T(0);
    const T mx = warp_sum(s) / T(n);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + 32 * k < n) x[lane + 32 * k] = v[k] - mx;
    }
  }
  __syncthreads();
}

// The coarsest solve by one warp, in registers, for the register count
// its size needs (x gets the mean-projected solution).
template <typename T>
__device__ void warp_coarse_solve(const T* r, T* x, int h, int w, int sweeps,
                                  T weight, T c) {
  switch ((h * w + 31) / 32) {
    case 1: warp_coarse_regs<T, 1>(r, x, h, w, sweeps, weight, c); break;
    case 2: warp_coarse_regs<T, 2>(r, x, h, w, sweeps, weight, c); break;
    case 3: warp_coarse_regs<T, 3>(r, x, h, w, sweeps, weight, c); break;
    case 4: warp_coarse_regs<T, 4>(r, x, h, w, sweeps, weight, c); break;
    case 5: warp_coarse_regs<T, 5>(r, x, h, w, sweeps, weight, c); break;
    case 6: warp_coarse_regs<T, 6>(r, x, h, w, sweeps, weight, c); break;
    case 7: warp_coarse_regs<T, 7>(r, x, h, w, sweeps, weight, c); break;
    default: warp_coarse_regs<T, 8>(r, x, h, w, sweeps, weight, c); break;
  }
}

// The V(nu, nu) cycle of one block on levels top .. L = lv.n - 1 of whole
// fields, against rtop at level top: x of each level in xs[l] (level top's
// left there, not mean-projected), r of the levels below top in rs[l], tmp
// one field of level top's size.  The coarsest level's r is projected in
// place; with top == L, the coarsest alone, rtop is projected into tmp and
// the sweeps ping-pong through extra instead, unless extra is null, which
// says rtop lies in this block's shared memory and is projected in place.
template <typename T>
__device__ void block_vcycle(const T* rtop, T* const* xs, T* const* rs,
                             T* tmp, T* extra, const Levels& lv, int top,
                             int nu, int coarse_sweeps, T weight, T c,
                             T* red) {
  const int L = lv.n - 1;

  // Descent: nu sweeps from zero, residual, restriction.
  for (int l = top; l < L; ++l) {
    const int h = lv.h[l], w = lv.w[l], n = h * w;
    const T* r = l == top ? rtop : rs[l];
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
    T* r = L > top ? rs[L] : const_cast<T*>(rtop);
    T* sweep_tmp = tmp;
    const bool from_device = L == top && extra != nullptr;
    const bool one_warp = n <= kWarpCoarse && w <= 32;
    if (one_warp) {
      warp_coarse_solve(from_device ? rtop : r, xs[L], h, w, coarse_sweeps,
                        weight, c);
    } else if (from_device) {
      T s = T(0);
      for (int t = threadIdx.x; t < n; t += blockDim.x) s += rtop[t];
      const T mean = block_sum(s, red) / T(n);
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        tmp[t] = rtop[t] - mean;
      }
      __syncthreads();
      r = tmp;
      sweep_tmp = extra;
    } else {
      field_subtract_mean(r, n, red);
    }
    if (!one_warp) {
      field_fill_zero(xs[L], n);
      field_sweeps(xs[L], r, sweep_tmp, h, w, coarse_sweeps, weight, c);
      field_subtract_mean(xs[L], n, red);
    }
  }

  // Ascent: prolongated correction, nu sweeps.
  for (int l = L - 1; l >= top; --l) {
    const int h = lv.h[l], w = lv.w[l], n = h * w;
    const int hc = lv.h[l + 1], wc = lv.w[l + 1];
    const T* r = l == top ? rtop : rs[l];
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int i = t / w, j = t - i * w;
      xs[l][t] += prolong_at(xs[l + 1], i, j, hc, wc);
    }
    __syncthreads();
    field_sweeps(xs[l], r, tmp, h, w, nu, weight, c);
  }
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
  // A one-level cycle's sweeps ping-pong through the field after x, which
  // the launcher reserves.
  const size_t base = static_cast<size_t>(blockIdx.x) * N0;
  block_vcycle(r_in + base, xs, rs, tmp, xs[0] + N0, lv, 0, nu,
               coarse_sweeps, weight, c, red);
  field_subtract_mean(xs[0], N0, red);
  for (int t = threadIdx.x; t < N0; t += blockDim.x) out[base + t] = xs[0][t];
}

// ---------------------------------------------------- thread-block clusters
//
// A cluster of C CTAs (C a power of two, up to 16 on neighbouring SMs) holds
// one sample.  Each level down to the last one whose strips keep kRank0Rows
// rows is cut into C row strips: those of that last level (rank k owns rows
// k h / C .. (k + 1) h / C) doubled level by level, so a coarse strip is the
// restriction of its fine strip and every fine strip starts on an even row.
// Every CTA lays its shared memory out alike, so a neighbour's field is the
// same offset mapped into its CTA (cluster.map_shared_rank).  A sweep reads
// the rows above and below its strip straight from the neighbours' shared
// memory, with ping-pong buffers and one cluster barrier a sweep, split so
// that the interior rows are swept while it settles.  The barrier's release
// compiles to a GPU-scope fence (MEMBAR.ALL.GPU): with the barrier itself,
// about a third of a 511^2 sweep on the H100.  The sweeps walk down columns
// with the rows above and at a cell in registers; at 16 CTAs they are bound
// by instruction issue.  The levels below the cut live whole in rank 0,
// which runs them as vcycle_block does (the coarsest in one warp's
// registers) while the other ranks wait at the barrier; the
// restriction into them writes rank 0's shared memory, the prolongation out
// of them reads it.  A mean over the cluster is each rank's fixed-tree block
// sum in a slot, read by every rank in rank order after a barrier: the same
// value on every rank, bit for bit from solve to solve, no atomics.

// This CTA's rows [lo, hi) of a level cut in strips, the rows of the strip
// above it, and the cut: the boundaries of the last cut level (hl rows)
// shifted left by `shift`.
struct Strip {
  int lo, hi, w, prev_rows, rank, C;
  __device__ int rows() const { return hi - lo; }
};

__device__ __forceinline__ Strip strip_of(int hl, int shift, int w, int rank,
                                          int C) {
  Strip s;
  s.lo = (rank * hl / C) << shift;
  s.hi = ((rank + 1) * hl / C) << shift;
  s.prev_rows = rank > 0 ? s.lo - (((rank - 1) * hl / C) << shift) : 0;
  s.w = w;
  s.rank = rank;
  s.C = C;
  return s;
}

// The rows just above and below a strip of buf: the neighbours' edge rows
// through distributed shared memory, or the strip's own edge row at the
// field's edge (the edge-replicate boundary).
template <typename T>
__device__ __forceinline__ const T* halo_up(cg::cluster_group& cl,
                                            const Strip& s, T* buf) {
  return s.rank > 0 ? cl.map_shared_rank(buf, s.rank - 1) +
                          (s.prev_rows - 1) * s.w
                    : buf;
}

template <typename T>
__device__ __forceinline__ const T* halo_down(cg::cluster_group& cl,
                                              const Strip& s, T* buf) {
  return s.rank < s.C - 1 ? cl.map_shared_rank(buf, s.rank + 1)
                          : buf + (s.rows() - 1) * s.w;
}

// L_w x at the strip's cell (i, j), local row i of n.
template <typename T>
__device__ __forceinline__ T strip_lap(const T* x, const T* up_row,
                                       const T* dn_row, int i, int j, int n,
                                       int w, T weight) {
  const T* row = x + i * w;
  const T v = row[j];
  const T up = i > 0 ? row[j - w] : up_row[j];
  const T dn = i < n - 1 ? row[j + w] : dn_row[j];
  const T lf = j > 0 ? row[j - 1] : v;
  const T rt = j < w - 1 ? row[j + 1] : v;
  return lap_point(v, up, dn, lf, rt, weight);
}

// The cluster barrier split in its two halves: arrive (release) when this
// thread's writes that others read are done, wait (acquire) when it needs
// theirs.  cl.sync() is the two back to back.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// This thread's cells of a field w wide, with no division a cell: rows
// i0, i0 + di, ... and columns j0, j0 + dj, ... (no rows when i0 is past
// the field).
struct Cells {
  int i0, di, j0, dj;
};

__device__ __forceinline__ Cells cells_of(int w) {
  const int nt = blockDim.x, tid = threadIdx.x;
  if (w >= nt) return {0, 1, tid, nt};
  const int per = nt / w, i = tid / w;
  return {i < per ? i : 1 << 30, per, tid - i * w, w};
}

// One sweep of rows i0 .. i1 - 1 of a w-wide field whose rows i0 - 1 and
// i1 lie in src too, walking down columns: thread (g, j) takes column j
// (and j + blockDim.x, ... when the field is wider) of row group g, and
// keeps the rows above and at the cell in registers.
template <typename T>
__device__ void walk_sweep(const T* src, T* dst, const T* r, int i0, int i1,
                           int w, T weight, T c) {
  const int m = i1 - i0, nt = blockDim.x;
  int groups = 1, g = 0, j0 = threadIdx.x, dj = nt;
  if (w < nt) {
    groups = min(nt / w, m);
    g = threadIdx.x / w;
    j0 = threadIdx.x - g * w;
    dj = w;
  }
  if (g >= groups) return;
  const int a = i0 + g * m / groups, b = i0 + (g + 1) * m / groups;
  for (int j = j0; j < w; j += dj) {
    T up = src[(a - 1) * w + j];
    T v = src[a * w + j];
    for (int i = a; i < b; ++i) {
      const int q = i * w + j;
      const T dn = src[q + w];
      const T lf = j > 0 ? src[q - 1] : v;
      const T rt = j < w - 1 ? src[q + 1] : v;
      dst[q] = v + c * (r[q] - lap_point(v, up, dn, lf, rt, weight));
      up = v;
      v = dn;
    }
  }
}

// One sweep of a strip, src -> dst, ending at the cluster barrier: its edge
// rows first (they alone read the neighbours' rows), the arrival, then the
// interior while the barrier settles, the block barrier for the interior's
// writes, and the wait.  A neighbour reads only dst's edge rows.
template <typename T>
__device__ void strip_sweep(const Strip& s, const T* up, const T* dn, T* src,
                            T* dst, const T* r, T weight, T c) {
  const int n = s.rows(), w = s.w, edge = (n > 1 ? 2 : 1) * w;
  for (int t = threadIdx.x; t < edge; t += blockDim.x) {
    const int i = t < w ? 0 : n - 1, j = t < w ? t : t - w;
    const int q = i * w + j;
    dst[q] = src[q] + c * (r[q] - strip_lap(src, up, dn, i, j, n, w,
                                            weight));
  }
  cluster_arrive();
  if (n > 2) walk_sweep(src, dst, r, 1, n - 1, w, weight, c);
  __syncthreads();
  cluster_wait();
}

// k sweeps of a strip against r from the start value in b[k % 2] (visible
// to the cluster) into b[0]: sweep j reads b[(k - j + 1) % 2] and writes
// b[(k - j) % 2].
template <typename T>
__device__ void strip_sweeps(cg::cluster_group& cl, const Strip& s, T* b0,
                             T* b1, const T* r, int k, T weight, T c) {
  const T* up[2] = {halo_up(cl, s, b0), halo_up(cl, s, b1)};
  const T* dn[2] = {halo_down(cl, s, b0), halo_down(cl, s, b1)};
  for (int j = 1; j <= k; ++j) {
    const int from = (k - j + 1) % 2;
    strip_sweep(s, up[from], dn[from], from ? b1 : b0, from ? b0 : b1, r,
                weight, c);
  }
}

// k sweeps from zero into b[0]: the first is c r and reads no halo.
template <typename T>
__device__ void strip_sweeps_from_zero(cg::cluster_group& cl, const Strip& s,
                                       T* b0, T* b1, const T* r, int k,
                                       T weight, T c) {
  const int N = s.rows() * s.w;
  T* first = k % 2 ? b0 : b1;  // b[(k - 1) % 2]
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    if (k == 0) {
      b0[t] = T(0);
    } else {
      first[t] = c * r[t];
    }
  }
  cl.sync();
  if (k > 0) strip_sweeps(cl, s, b0, b1, r, k - 1, weight, c);
}

// out = r - L_w x on the strip.
template <typename T>
__device__ void strip_residual(cg::cluster_group& cl, const Strip& s, T* x,
                               const T* r, T* out, T weight) {
  const int n = s.rows(), w = s.w;
  const T* up = halo_up(cl, s, x);
  const T* dn = halo_down(cl, s, x);
  const Cells cc = cells_of(w);
  for (int i = cc.i0; i < n; i += cc.di) {
    for (int j = cc.j0; j < w; j += cc.dj) {
      out[i * w + j] = r[i * w + j] - strip_lap(x, up, dn, i, j, n, w,
                                                weight);
    }
  }
  cl.sync();
}

// The restriction of the strip's residual res (an h-row level) onto coarse
// rows lo/2 .. hi/2: fine rows 2I - 1 and 2I + 2 past the strip are the
// neighbours' edge rows.  Coarse row I lands in row I - out_row0 of out
// (this CTA's coarse strip, or rank 0's whole field).
template <typename T>
__device__ void strip_restrict(cg::cluster_group& cl, const Strip& s, int h,
                               T* res, T* out, int out_row0) {
  const int w = s.w, wc = w / 2, I0 = s.lo / 2, nI = s.rows() / 2;
  const T* up = halo_up(cl, s, res);
  const T* dn = halo_down(cl, s, res);
  const Cells cc = cells_of(wc);
  for (int I = I0 + cc.i0; I < I0 + nI; I += cc.di) {
    for (int J = cc.j0; J < wc; J += cc.dj) {
      const int ri[4] = {max(2 * I - 1, 0), 2 * I, 2 * I + 1,
                         min(2 * I + 2, h - 1)};
      const int cj[4] = {max(2 * J - 1, 0), 2 * J, 2 * J + 1,
                         min(2 * J + 2, w - 1)};
      T col[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T* row = ri[q] < s.lo    ? up
                       : ri[q] >= s.hi ? dn
                                       : res + (ri[q] - s.lo) * w;
        col[q] = restrict4(row[cj[0]], row[cj[1]], row[cj[2]], row[cj[3]]);
    }
    out[static_cast<size_t>(I - out_row0) * wc + J] =
        restrict4(col[0], col[1], col[2], col[3]);
    }
  }
  cl.sync();
}

// dst = src + P z on the strip, z the coarse x (hc x wc): cut in the same
// strips (its rows past this strip's from the neighbours) or, with whole,
// rank 0's whole field.
template <typename T>
__device__ void strip_prolong_add(cg::cluster_group& cl, const Strip& s,
                                  const T* src, T* dst, T* z, bool whole,
                                  int hc, int wc) {
  const int w = s.w, I0 = s.lo / 2, I1 = s.hi / 2;
  const T* z_own = whole ? cl.map_shared_rank(z, 0) : z;
  const T* z_prev = !whole && s.rank > 0
                        ? cl.map_shared_rank(z, s.rank - 1) +
                              (s.prev_rows / 2 - 1) * wc
                        : z_own;
  const T* z_next = !whole && s.rank < s.C - 1
                        ? cl.map_shared_rank(z, s.rank + 1)
                        : z_own;
  const int own0 = whole ? 0 : I0;
  const Cells cc = cells_of(w);
  for (int li = cc.i0; li < s.rows(); li += cc.di) {
    for (int j = cc.j0; j < w; j += cc.dj) {
      const int i = s.lo + li, t = li * w + j;
      const int ic = i >> 1, jc = j >> 1;
      const int ia = (i & 1) ? min(ic + 1, hc - 1) : max(ic - 1, 0);
      const int ja = (j & 1) ? min(jc + 1, wc - 1) : max(jc - 1, 0);
      const T* z0 = z_own + static_cast<size_t>(ic - own0) * wc;
      const T* z1 = whole || (ia >= I0 && ia < I1)
                        ? z_own + static_cast<size_t>(ia - own0) * wc
                    : ia < I0 ? z_prev
                              : z_next;
      const T a = T(0.75) * z0[jc] + T(0.25) * z1[jc];
      const T b = T(0.75) * z0[ja] + T(0.25) * z1[ja];
      dst[t] = src[t] + (T(0.75) * a + T(0.25) * b);
    }
  }
  cl.sync();
}

// The sum over the cluster of each rank's s, in rank order; `turn` picks
// the slot, alternating so that a slot is written again only after the
// next sum's barrier.
template <typename T>
__device__ T cluster_sum(cg::cluster_group& cl, T s, T* red, T* slots,
                         int& turn) {
  const T part = block_sum(s, red);
  T* slot = slots + turn;
  turn ^= 1;
  if (threadIdx.x == 0) *slot = part;
  cl.sync();
  T total = T(0);
  for (unsigned k = 0; k < cl.num_blocks(); ++k) {
    total += *cl.map_shared_rank(slot, k);
  }
  return total;
}

// x -= mean of the cut field (n values in all) on this CTA's N values.
template <typename T>
__device__ void strip_subtract_mean(cg::cluster_group& cl, T* x, int N,
                                    int n, T* red, T* slots, int& turn) {
  T s = T(0);
  for (int t = threadIdx.x; t < N; t += blockDim.x) s += x[t];
  const T mean = cluster_sum(cl, s, red, slots, turn) / T(n);
  for (int t = threadIdx.x; t < N; t += blockDim.x) x[t] -= mean;
  __syncthreads();
}

// The tail of a cluster V-cycle: its levels, the cut and the shared-memory
// layout (offsets in values; tmp at 0).
struct ClusterLevels {
  Levels lv;                // entry first
  int d;                    // levels 0 .. d - 1 cut in strips
  int C;                    // CTAs a sample
  int xoff[kMaxLevels];     // x of each level
  int roff[kMaxLevels];     // r of each level, -1 for the entry's (device)
};

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    vcycle_cluster(const T* __restrict__ r_in, T* __restrict__ out,
                   ClusterLevels p, int nu, int coarse_sweeps, T weight,
                   T c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kBlockThreads];
  __shared__ T slots[kSlots];
  cg::cluster_group cl = cg::this_cluster();
  const Levels& lv = p.lv;
  const int rank = static_cast<int>(cl.block_rank());
  const int L = lv.n - 1, D = p.d - 1, hl = lv.h[D];
  T* tmp = reinterpret_cast<T*>(smem_raw);
  T* xs[kMaxLevels];
  T* rs[kMaxLevels];
  for (int l = 0; l <= L; ++l) {
    xs[l] = tmp + p.xoff[l];
    rs[l] = p.roff[l] < 0 ? nullptr : tmp + p.roff[l];
  }
  const Strip s0 = strip_of(hl, D, lv.w[0], rank, p.C);
  const size_t base = static_cast<size_t>(blockIdx.y) * lv.h[0] * lv.w[0] +
                      static_cast<size_t>(s0.lo) * lv.w[0];
  const T* r0 = r_in + base;
  int turn = 0;

  // Descent over the cut levels: nu sweeps from zero, residual,
  // restriction (into rank 0's shared memory below the cut).
  const int last = min(D, L - 1);
  for (int l = 0; l <= last; ++l) {
    const Strip s = strip_of(hl, D - l, lv.w[l], rank, p.C);
    const T* r = l == 0 ? r0 : rs[l];
    strip_sweeps_from_zero(cl, s, xs[l], tmp, r, nu, weight, c);
    strip_residual(cl, s, xs[l], r, tmp, weight);
    if (l < D) {
      strip_restrict(cl, s, lv.h[l], tmp, rs[l + 1], s.lo / 2);
    } else {
      strip_restrict(cl, s, lv.h[l], tmp, cl.map_shared_rank(rs[l + 1], 0),
                     0);
    }
  }

  if (L > D) {
    // The levels below the cut, in rank 0 alone.
    if (rank == 0) {
      block_vcycle(rs[D + 1], xs, rs, tmp, static_cast<T*>(nullptr), lv,
                   D + 1, nu, coarse_sweeps, weight, c, red);
    }
    cl.sync();
  } else {
    // A cut coarsest level: its mean-projected sweeps over the cluster.
    const Strip s = strip_of(hl, 0, lv.w[L], rank, p.C);
    const int N = s.rows() * s.w, n = lv.h[L] * lv.w[L];
    strip_subtract_mean(cl, rs[L], N, n, red, slots, turn);
    strip_sweeps_from_zero(cl, s, xs[L], tmp, rs[L], coarse_sweeps, weight,
                           c);
    strip_subtract_mean(cl, xs[L], N, n, red, slots, turn);
    cl.sync();
  }

  // Ascent: the prolongated correction, nu sweeps.
  for (int l = last; l >= 0; --l) {
    const Strip s = strip_of(hl, D - l, lv.w[l], rank, p.C);
    const T* r = l == 0 ? r0 : rs[l];
    strip_prolong_add(cl, s, xs[l], nu % 2 ? tmp : xs[l], xs[l + 1], l >= D,
                      lv.h[l + 1], lv.w[l + 1]);
    strip_sweeps(cl, s, xs[l], tmp, r, nu, weight, c);
  }

  // The entry's mean projection.
  const int N0 = s0.rows() * s0.w;
  strip_subtract_mean(cl, xs[0], N0, lv.h[0] * lv.w[0], red, slots, turn);
  for (int t = threadIdx.x; t < N0; t += blockDim.x) out[base + t] = xs[0][t];
  cl.sync();  // no CTA leaves while a neighbour may read its shared memory
}

// sweeps Jacobi sweeps of [h, w] fields cut in C row strips, x, its
// ping-pong copy and r in each CTA's shared memory.  With project, x is
// not read: the sweeps start from zero against r minus its mean, and the
// result has its mean subtracted (a coarsest level's solve).
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    jacobi_cluster(const T* __restrict__ x, const T* __restrict__ r,
                   T* __restrict__ out, int h, int w, int sweeps, int project,
                   T weight, T c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kBlockThreads];
  __shared__ T slots[kSlots];
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const Strip s = strip_of(h, 0, w, static_cast<int>(cl.block_rank()), C);
  const int stride = (h + C - 1) / C * w, N = s.rows() * w;
  T* X = reinterpret_cast<T*>(smem_raw);
  T* Y = X + stride;
  T* R = Y + stride;
  const size_t base = static_cast<size_t>(blockIdx.y) * h * w +
                      static_cast<size_t>(s.lo) * w;
  int turn = 0;
  if (project) {
    for (int t = threadIdx.x; t < N; t += blockDim.x) R[t] = r[base + t];
    __syncthreads();
    strip_subtract_mean(cl, R, N, h * w, red, slots, turn);
    strip_sweeps_from_zero(cl, s, X, Y, R, sweeps, weight, c);
    strip_subtract_mean(cl, X, N, h * w, red, slots, turn);
  } else {
    T* start = sweeps % 2 ? Y : X;
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
      start[t] = x[base + t];
      R[t] = r[base + t];
    }
    cl.sync();
    strip_sweeps(cl, s, X, Y, R, sweeps, weight, c);
  }
  for (int t = threadIdx.x; t < N; t += blockDim.x) out[base + t] = X[t];
  cl.sync();  // no CTA leaves while a neighbour may read its shared memory
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

// Whether a strip launch can take: even h, w >= 2; a segment count the
// grid carries; on the wide path (16-byte copies) w and every fine
// field's base pointer 16-byte aligned.
template <typename T>
bool strip_ok(int B, int h, int w, int seg, int wide,
              std::initializer_list<const T*> fine) {
  if (B < 1 || h < 2 || w < 2 || h % 2 || w % 2 || seg < 1 ||
      ceil_div(h / 2, seg) > 65535) {
    return false;
  }
  if (!wide) return true;
  if ((static_cast<size_t>(w) * sizeof(T)) % 16) return false;
  for (const T* p : fine) {
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return true;
}

dim3 strip_grid(int B, int h, int w, int seg) {
  return dim3(ceil_div(w / 2, kStripCols), ceil_div(h / 2, seg), B);
}

template <typename T, int kV>
void presmooth_restrict_v(const T* r, const T* x, T* rc, int B, int h,
                          int w, int seg, T weight, T c, cudaStream_t s) {
  const dim3 grid = strip_grid(B, h, w, seg);
  if (x == nullptr) {
    presmooth_restrict_strip<T, kV, false><<<grid, kStripCols, 0, s>>>(
        r, nullptr, rc, h, w, seg, weight, c);
  } else {
    presmooth_restrict_strip<T, kV, true><<<grid, kStripCols, 0, s>>>(
        r, x, rc, h, w, seg, weight, c);
  }
}

template <typename T>
int launch_presmooth_restrict(const T* r, const T* x, T* rc, int B, int h,
                              int w, int seg, int wide, double weight,
                              double c, void* stream) {
  if (!strip_ok<T>(B, h, w, seg, wide, {r, x})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    presmooth_restrict_v<T, 16 / sizeof(T)>(r, x, rc, B, h, w, seg,
                                            T(weight), T(c), s);
  } else {
    presmooth_restrict_v<T, 1>(r, x, rc, B, h, w, seg, T(weight), T(c), s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kV>
void prolong_postsmooth_v(const T* r, const T* zc, const T* x, T* out,
                          int B, int h, int w, int seg, T weight, T c,
                          cudaStream_t s) {
  const dim3 grid = strip_grid(B, h, w, seg);
  if (x == nullptr) {
    prolong_postsmooth_strip<T, kV, false><<<grid, kStripCols, 0, s>>>(
        r, zc, nullptr, out, h, w, seg, weight, c);
  } else {
    prolong_postsmooth_strip<T, kV, true><<<grid, kStripCols, 0, s>>>(
        r, zc, x, out, h, w, seg, weight, c);
  }
}

// out is stored in pairs: its base pointer must be aligned to two values.
template <typename T>
int launch_prolong_postsmooth(const T* r, const T* zc, const T* x, T* out,
                              int B, int h, int w, int seg, int wide,
                              double weight, double c, void* stream) {
  if (!strip_ok<T>(B, h, w, seg, wide, {r, x}) ||
      reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    prolong_postsmooth_v<T, 16 / sizeof(T)>(r, zc, x, out, B, h, w, seg,
                                            T(weight), T(c), s);
  } else {
    prolong_postsmooth_v<T, 1>(r, zc, x, out, B, h, w, seg, T(weight),
                               T(c), s);
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

// Shared memory a CTA of `kernel` may take beside its static values (the
// reduction's and the slots, as the compiler lays them out), or 0.
template <typename K>
size_t dynamic_max(K kernel) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return 0;
  return kMaxSmem - fa.sharedSizeBytes;
}

template <typename K>
cudaLaunchConfig_t cluster_config(K kernel, int C, int B, size_t bytes,
                                  cudaStream_t s, cudaLaunchAttribute* attr,
                                  int* err) {
  *err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
  if (!*err && C > 8) {
    *err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(kBlockThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool cluster_size_ok(int C) {
  return C >= 2 && C <= kMaxCluster && (C & (C - 1)) == 0;
}

template <typename T>
int launch_vcycle_cluster(const T* r, T* out, int B, int n_levels,
                          const int* hs, const int* ws, int C, int d, int nu,
                          int coarse_sweeps, double weight, double c,
                          void* stream) {
  if (n_levels < 2 || n_levels > kMaxLevels || !cluster_size_ok(C) ||
      d < 1 || d > n_levels || hs[d - 1] / C < kRank0Rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ClusterLevels p = {};
  p.lv.n = n_levels;
  p.d = d;
  p.C = C;
  for (int l = 0; l < n_levels; ++l) {
    p.lv.h[l] = hs[l];
    p.lv.w[l] = ws[l];
  }
  // Strips of the cut levels sized by the largest, then rank 0's fields.
  const size_t rows = (hs[d - 1] + C - 1) / C;
  size_t strip[kMaxLevels];
  for (int l = 0; l < d; ++l) strip[l] = (rows << (d - 1 - l)) * ws[l];
  const size_t whole_top = d < n_levels ? static_cast<size_t>(hs[d]) * ws[d]
                                        : 0;
  size_t off = strip[0] > whole_top ? strip[0] : whole_top;  // tmp
  for (int l = 0; l < n_levels; ++l) {
    const size_t n = l < d ? strip[l] : static_cast<size_t>(hs[l]) * ws[l];
    p.xoff[l] = static_cast<int>(off);
    off += n;
    p.roff[l] = l == 0 ? -1 : static_cast<int>(off);
    if (l > 0) off += n;
  }
  const size_t bytes = off * sizeof(T);
  if (bytes > dynamic_max(vcycle_cluster<T>)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  int err = 0;
  const cudaLaunchConfig_t cfg =
      cluster_config(vcycle_cluster<T>, C, B, bytes,
                     static_cast<cudaStream_t>(stream), &attr, &err);
  if (err) return err;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, vcycle_cluster<T>, r, out,
                                            p, nu, coarse_sweeps, T(weight),
                                            T(c)));
  return err ? err : static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_jacobi_cluster(const T* x, const T* r, T* out, int B, int h,
                          int w, int sweeps, int C, int project,
                          double weight, double c, void* stream) {
  if (!cluster_size_ok(C) || h < C || sweeps < 0 ||
      (x == nullptr && !project)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes =
      3 * static_cast<size_t>((h + C - 1) / C) * w * sizeof(T);
  if (bytes > dynamic_max(jacobi_cluster<T>)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchAttribute attr;
  int err = 0;
  const cudaLaunchConfig_t cfg =
      cluster_config(jacobi_cluster<T>, C, B, bytes,
                     static_cast<cudaStream_t>(stream), &attr, &err);
  if (err) return err;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, jacobi_cluster<T>, x, r,
                                            out, h, w, sweeps, project,
                                            T(weight), T(c)));
  return err ? err : static_cast<int>(cudaGetLastError());
}

// Whether the card schedules at least one cluster of C CTAs of `kernel` at
// the full shared memory a CTA.
template <typename K>
int schedules(K kernel, int C, bool* ok) {
  cudaLaunchAttribute attr;
  int err = 0;
  const cudaLaunchConfig_t cfg = cluster_config(
      kernel, C, 1, dynamic_max(kernel), nullptr, &attr, &err);
  int clusters = 0;
  if (!err) {
    err = static_cast<int>(
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg));
  }
  *ok = !err && clusters >= 1;
  return err;
}

// The largest cluster, 16 or 8, that the current card schedules for both
// cluster kernels, or 0.  A refused size is not an error unless 8 is
// refused too.
template <typename T>
int max_cluster_here(int* out) {
  *out = 0;
  for (int C = kMaxCluster; C >= 8; C /= 2) {
    bool ok_v = false, ok_j = false;
    int err = schedules(vcycle_cluster<T>, C, &ok_v);
    if (!err) err = schedules(jacobi_cluster<T>, C, &ok_j);
    if (ok_v && ok_j) {
      *out = C;
      return 0;
    }
    cudaGetLastError();  // clear a refusal before the next size
    if (C == 8 && err) return err;
  }
  return 0;
}

// max_cluster_here on card `device`, the current card restored after.
template <typename T>
int max_cluster(int device, int* out) {
  *out = 0;
  int prev = 0;
  int err = static_cast<int>(cudaGetDevice(&prev));
  if (!err) err = static_cast<int>(cudaSetDevice(device));
  if (err) return err;
  err = max_cluster_here<T>(out);
  const int restored = static_cast<int>(cudaSetDevice(prev));
  return err ? err : restored;
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

// The strip kernels: segments of seg coarse rows; wide != 0 takes 16-byte
// copies (w and the fine fields' base pointers 16-byte aligned), else one
// value a copy.  x == NULL: the pre-smoothed field is c·r (one sweep from
// zero).
int stencil_presmooth_restrict_f32(const float* r, const float* x, float* rc,
                                   int B, int h, int w, int seg, int wide,
                                   double weight, double c, void* stream) {
  return launch_presmooth_restrict<float>(r, x, rc, B, h, w, seg, wide,
                                          weight, c, stream);
}
int stencil_presmooth_restrict_f64(const double* r, const double* x,
                                   double* rc, int B, int h, int w, int seg,
                                   int wide, double weight, double c,
                                   void* stream) {
  return launch_presmooth_restrict<double>(r, x, rc, B, h, w, seg, wide,
                                           weight, c, stream);
}

int stencil_prolong_postsmooth_f32(const float* r, const float* zc,
                                   const float* x, float* out, int B, int h,
                                   int w, int seg, int wide, double weight,
                                   double c, void* stream) {
  return launch_prolong_postsmooth<float>(r, zc, x, out, B, h, w, seg, wide,
                                          weight, c, stream);
}
int stencil_prolong_postsmooth_f64(const double* r, const double* zc,
                                   const double* x, double* out, int B,
                                   int h, int w, int seg, int wide,
                                   double weight, double c, void* stream) {
  return launch_prolong_postsmooth<double>(r, zc, x, out, B, h, w, seg, wide,
                                           weight, c, stream);
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

// The cluster V-cycle on the n_levels >= 2 levels hs x ws (entry first,
// entry r in device memory), clusters of C CTAs, the first d levels cut in
// row strips and the rest whole in rank 0.
int stencil_vcycle_cluster_f32(const float* r, float* out, int B,
                               int n_levels, const int* hs, const int* ws,
                               int C, int d, int nu, int coarse_sweeps,
                               double weight, double c, void* stream) {
  return launch_vcycle_cluster<float>(r, out, B, n_levels, hs, ws, C, d, nu,
                                      coarse_sweeps, weight, c, stream);
}
int stencil_vcycle_cluster_f64(const double* r, double* out, int B,
                               int n_levels, const int* hs, const int* ws,
                               int C, int d, int nu, int coarse_sweeps,
                               double weight, double c, void* stream) {
  return launch_vcycle_cluster<double>(r, out, B, n_levels, hs, ws, C, d, nu,
                                       coarse_sweeps, weight, c, stream);
}

// Every sweep in one launch of clusters of C CTAs; project != 0 (x may be
// NULL) solves a coarsest level: sweeps from zero against r minus its
// mean, the result minus its mean.
int stencil_jacobi_cluster_f32(const float* x, const float* r, float* out,
                               int B, int h, int w, int sweeps, int C,
                               int project, double weight, double c,
                               void* stream) {
  return launch_jacobi_cluster<float>(x, r, out, B, h, w, sweeps, C, project,
                                      weight, c, stream);
}
int stencil_jacobi_cluster_f64(const double* x, const double* r,
                               double* out, int B, int h, int w, int sweeps,
                               int C, int project, double weight, double c,
                               void* stream) {
  return launch_jacobi_cluster<double>(x, r, out, B, h, w, sweeps, C,
                                       project, weight, c, stream);
}

// *out = the largest cluster (16 or 8) card `device` schedules for the
// cluster kernels at the full shared memory a CTA, or 0.
int stencil_max_cluster_f32(int device, int* out) {
  return max_cluster<float>(device, out);
}
int stencil_max_cluster_f64(int device, int* out) {
  return max_cluster<double>(device, out);
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
