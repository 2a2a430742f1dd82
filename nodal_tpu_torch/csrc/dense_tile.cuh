// Batched dense tile products and diagonal-block inverses for sm_90a: the
// core that the blocked LU (block_lu.cu) and the block Thomas
// (block_thomas.cu) share.
//
// Every product computes out = cin + alpha·(A·Bm) for M×N outputs, K deep,
// in each of B systems.  The products of an output are summed apart, from
// zero, and cin is added last: summed onto cin (O(1) entries against small
// products) each step would round at cin's scale, which cost ~20× the plain
// version's f32 error on the grounded Laplacians, where the Schur
// complements cancel heavily.  cin.p may be null (zero) or equal out.p
// (each element is read and then written by the same thread); A and Bm
// must not overlap out.  K = 0 is a copy of cin.
//
//   * wide (N > 4): 128×128 output tiles, K in chunks staged in shared
//     memory by cp.async through a ring of stages, so that the next chunks'
//     L2/HBM loads overlap this chunk's arithmetic.
//       - f32: full f32 FMAs on the CUDA cores (no TF32: the contract
//         layer's pass count rests on the raw f32 error).  256 threads, an
//         8×8 accumulator patch each (two 4×4 quadrants, 64 rows and 64
//         columns apart); A is stored k-major (transposed by 4-byte copies)
//         so that each thread reads its A and B fragments as 16-byte
//         vectors.
//       - f64: the FP64 tensor cores (DMMA, mma.sync m16n8k4).  512 threads,
//         16 warps of 32×32 outputs, A row-major and B k-major in shared
//         memory, padded so that the fragment loads are conflict-free.
//   * narrow (N <= 4, the sweeps and the contract layer's right-hand
//     sides): a matrix-vector product bound by reading A.  A warp takes 4
//     rows, its lanes stride along them with 16-byte loads, and the sums
//     meet in a warp reduction; no tile in which most columns are padding.
//
// Each source instantiates the kernels under its own name prefix
// (DENSE_TILE_KERNELS below), so that profiles keep them apart.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace dense_tile {

constexpr int kBlock = 128;  // LU panel = diagonal block = output tile
constexpr int kMaxGridY = 65535;

template <typename T>
struct Mat {
  T* p;           // element (0, 0) of system 0
  size_t stride;  // elements between systems
  int ld;         // elements between rows
  __device__ __host__ __forceinline__ T* at(int s, int i, int j) const {
    return p + static_cast<size_t>(s) * stride +
           static_cast<size_t>(i) * ld + j;
  }
};

template <typename T>
struct GemmArgs {
  Mat<T> out, cin, A, Bm;
  int M, N, K;
  T alpha;
  int B;
};

// ---- cp.async ------------------------------------------------------------

// Copies `bytes` (4, 8 or 16) from global to shared memory, or zeros when
// !pred (src is then not read, but must be a valid address).
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? bytes : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(bytes), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- wide tiles, f32 on the CUDA cores -----------------------------------

struct WideF32 {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;
  static constexpr int kChunk = 8;
  static constexpr int kStages = 4;
  static constexpr int kLdA = kBlock + 4;  // k-major A rows, padded
  static constexpr int kStageA = kChunk * kLdA;
  static constexpr int kStageB = kChunk * kBlock;
  static constexpr int kSmemBytes =
      kStages * (kStageA + kStageB) * static_cast<int>(sizeof(float));
};

// Four consecutive outputs of one row, of which n_left exist.
__device__ __forceinline__ void store_row4(float* out, const float* cin,
                                           float alpha, float4 v,
                                           int n_left) {
  if (n_left >= 4 && aligned16(out) && (!cin || aligned16(cin))) {
    float4 c = cin ? *reinterpret_cast<const float4*>(cin)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    c.x += alpha * v.x;
    c.y += alpha * v.y;
    c.z += alpha * v.z;
    c.w += alpha * v.w;
    *reinterpret_cast<float4*>(out) = c;
    return;
  }
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n_left) out[j] = (cin ? cin[j] : 0.f) + alpha * w[j];
  }
}

// Stage st of the ring receives K chunk kc of A (transposed, k-major) and
// Bm for the tile at (i0, j0) of system s; zeros past M, N and K.
__device__ __forceinline__ void load_chunk_f32(const GemmArgs<float>& g,
                                               int s, int i0, int j0, int kc,
                                               float* As, float* Bs, int st) {
  using C = WideF32;
  const int k0 = kc * C::kChunk;
  float* as = As + st * C::kStageA;
  float* bs = Bs + st * C::kStageB;
#pragma unroll
  for (int q = 0; q < kBlock * C::kChunk / C::kThreads; ++q) {
    const int e = threadIdx.x + q * C::kThreads;
    const int row = e / C::kChunk, kk = e % C::kChunk;
    const int i = i0 + row, k = k0 + kk;
    const bool ok = i < g.M && k < g.K;
    cp_async<4>(as + kk * C::kLdA + row, ok ? g.A.at(s, i, k) : g.A.p, ok);
  }
#pragma unroll
  for (int q = 0; q < kBlock * C::kChunk / C::kThreads; ++q) {
    const int e = threadIdx.x + q * C::kThreads;
    const int kk = e / kBlock, col = e % kBlock;
    const int j = j0 + col, k = k0 + kk;
    const bool ok = j < g.N && k < g.K;
    cp_async<4>(bs + kk * kBlock + col, ok ? g.Bm.at(s, k, j) : g.Bm.p, ok);
  }
}

__device__ __forceinline__ void wide_tile(const GemmArgs<float>& g,
                                          unsigned char* smem) {
  using C = WideF32;
  float* As = reinterpret_cast<float*>(smem);  // [stage][k][m]
  float* Bs = As + C::kStages * C::kStageA;    // [stage][k][n]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int tiles_n = (g.N + kBlock - 1) / kBlock;
  const int i0 = (blockIdx.x / tiles_n) * kBlock;
  const int j0 = (blockIdx.x % tiles_n) * kBlock;
  const int nk = (g.K + C::kChunk - 1) / C::kChunk;

  for (int s = blockIdx.y; s < g.B; s += gridDim.y) {
    float acc[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < C::kStages - 1; ++st) {
      if (st < nk) load_chunk_f32(g, s, i0, j0, st, As, Bs, st);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<C::kStages - 2>();
      __syncthreads();  // chunk kc landed; chunk kc − 1's readers are done
      if (kc + C::kStages - 1 < nk) {
        load_chunk_f32(g, s, i0, j0, kc + C::kStages - 1, As, Bs,
                       (kc + C::kStages - 1) % C::kStages);
      }
      cp_async_commit();
      const float* as = As + (kc % C::kStages) * C::kStageA;
      const float* bs = Bs + (kc % C::kStages) * C::kStageB;
#pragma unroll
      for (int kk = 0; kk < C::kChunk; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(as + kk * C::kLdA + ty * 4);
        const float4 a1 =
            *reinterpret_cast<const float4*>(as + kk * C::kLdA + 64 + ty * 4);
        const float4 b0 =
            *reinterpret_cast<const float4*>(bs + kk * kBlock + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bs + kk * kBlock + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next system

#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + (u < 4 ? ty * 4 + u : 64 + ty * 4 + u - 4);
      if (i >= g.M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + h * 64 + tx * 4;
        if (j >= g.N) continue;
        store_row4(g.out.at(s, i, j), g.cin.p ? g.cin.at(s, i, j) : nullptr,
                   g.alpha,
                   make_float4(acc[u][h * 4], acc[u][h * 4 + 1],
                               acc[u][h * 4 + 2], acc[u][h * 4 + 3]),
                   g.N - j);
      }
    }
  }
}

// ---- wide tiles, f64 on the FP64 tensor cores ----------------------------

struct WideF64 {
  static constexpr int kThreads = 512;
  static constexpr int kMinBlocks = 1;
  static constexpr int kChunk = 16;
  static constexpr int kStages = 3;
  static constexpr int kLdA = kChunk + 4;   // row-major A, padded
  static constexpr int kLdB = kBlock + 8;   // k-major B, padded
  static constexpr int kStageA = kBlock * kLdA;
  static constexpr int kStageB = kChunk * kLdB;
  static constexpr int kSmemBytes =
      kStages * (kStageA + kStageB) * static_cast<int>(sizeof(double));
};

// d += a·b on one 16×8×4 step.  Lane (g = lane / 4, t = lane % 4) holds
//   a[i] = A[g + 8·i][t]                (i < 2),
//   b    = B[t][g],
//   d[i] = D[g + 8·(i / 2)][2t + i % 2] (i < 4).
// The m16n8k* shapes run the FP64 tensor cores at their full rate (k4 as k8
// and k16, with the fewest fragment registers); m8n8k4 reaches half of it
// on the H100 (chip_compare.py --mma).
__device__ __forceinline__ void dmma1684(double (&d)[4], const double (&a)[2],
                                         double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// Stage st of the ring receives K chunk kc of A (row-major) and Bm for the
// tile at (i0, j0) of system s; zeros past M, N and K.
__device__ __forceinline__ void load_chunk_f64(const GemmArgs<double>& g,
                                               int s, int i0, int j0, int kc,
                                               double* As, double* Bs,
                                               int st) {
  using C = WideF64;
  const int k0 = kc * C::kChunk;
  double* as = As + st * C::kStageA;
  double* bs = Bs + st * C::kStageB;
#pragma unroll
  for (int q = 0; q < kBlock * C::kChunk / C::kThreads; ++q) {
    const int e = threadIdx.x + q * C::kThreads;
    const int row = e / C::kChunk, kk = e % C::kChunk;
    const int i = i0 + row, k = k0 + kk;
    const bool ok = i < g.M && k < g.K;
    cp_async<8>(as + row * C::kLdA + kk, ok ? g.A.at(s, i, k) : g.A.p, ok);
  }
#pragma unroll
  for (int q = 0; q < kBlock * C::kChunk / C::kThreads; ++q) {
    const int e = threadIdx.x + q * C::kThreads;
    const int kk = e / kBlock, col = e % kBlock;
    const int j = j0 + col, k = k0 + kk;
    const bool ok = j < g.N && k < g.K;
    cp_async<8>(bs + kk * C::kLdB + col, ok ? g.Bm.at(s, k, j) : g.Bm.p, ok);
  }
}

__device__ __forceinline__ void wide_tile(const GemmArgs<double>& g,
                                          unsigned char* smem) {
  using C = WideF64;
  double* As = reinterpret_cast<double*>(smem);  // [stage][m][k]
  double* Bs = As + C::kStages * C::kStageA;     // [stage][k][n]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int lg = lane >> 2, lt = lane & 3;
  const int tiles_n = (g.N + kBlock - 1) / kBlock;
  const int i0 = (blockIdx.x / tiles_n) * kBlock;
  const int j0 = (blockIdx.x % tiles_n) * kBlock;
  const int nk = (g.K + C::kChunk - 1) / C::kChunk;

  for (int s = blockIdx.y; s < g.B; s += gridDim.y) {
    double acc[2][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][v][e] = 0.0;
      }
    }
#pragma unroll
    for (int st = 0; st < C::kStages - 1; ++st) {
      if (st < nk) load_chunk_f64(g, s, i0, j0, st, As, Bs, st);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<C::kStages - 2>();
      __syncthreads();
      if (kc + C::kStages - 1 < nk) {
        load_chunk_f64(g, s, i0, j0, kc + C::kStages - 1, As, Bs,
                       (kc + C::kStages - 1) % C::kStages);
      }
      cp_async_commit();
      const double* as = As + (kc % C::kStages) * C::kStageA;
      const double* bs = Bs + (kc % C::kStages) * C::kStageB;
#pragma unroll
      for (int k4 = 0; k4 < C::kChunk; k4 += 4) {
        double a[2][2], b[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            a[u][i] = as[(wm + u * 16 + lg + 8 * i) * C::kLdA + k4 + lt];
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          b[v] = bs[(k4 + lt) * C::kLdB + wn + v * 8 + lg];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) dmma1684(acc[u][v], a[u], b[v]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wm + u * 16 + lg + 8 * h;
        if (i >= g.M) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = j0 + wn + v * 8 + 2 * lt;
          if (j >= g.N) continue;
          double* o = g.out.at(s, i, j);
          const double* c = g.cin.p ? g.cin.at(s, i, j) : nullptr;
          const double d0 = acc[u][v][2 * h], d1 = acc[u][v][2 * h + 1];
          if (j + 1 < g.N && aligned16(o) && (!c || aligned16(c))) {
            // Two neighbours a lane, four lanes a row: 64-byte segments.
            double2 w = c ? *reinterpret_cast<const double2*>(c)
                          : make_double2(0.0, 0.0);
            w.x += g.alpha * d0;
            w.y += g.alpha * d1;
            *reinterpret_cast<double2*>(o) = w;
          } else {
            o[0] = (c ? c[0] : 0.0) + g.alpha * d0;
            if (j + 1 < g.N) o[1] = (c ? c[1] : 0.0) + g.alpha * d1;
          }
        }
      }
    }
  }
}

template <typename T>
struct Wide;
template <>
struct Wide<float> : WideF32 {};
template <>
struct Wide<double> : WideF64 {};

// ---- narrow products (N <= 4) --------------------------------------------

constexpr int kNarrowThreads = 256;
constexpr int kNarrowRows = 4;  // rows a warp
constexpr int kNarrowCols = 4;  // the most columns

template <typename T, bool kVec>
__device__ __forceinline__ void narrow_rows(const GemmArgs<T>& g) {
  constexpr int V = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (kNarrowThreads / 32) + warp) * kNarrowRows;
  if (r0 >= g.M) return;  // a whole warp: no barrier follows
  for (int s = blockIdx.y; s < g.B; s += gridDim.y) {
    T acc[kNarrowRows][kNarrowCols];
#pragma unroll
    for (int r = 0; r < kNarrowRows; ++r) {
#pragma unroll
      for (int c = 0; c < kNarrowCols; ++c) acc[r][c] = T(0);
    }
    for (int k = lane * V; k < g.K; k += 32 * V) {
      T b[V][kNarrowCols];
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int c = 0; c < kNarrowCols; ++c) {
          b[v][c] = (c < g.N && k + v < g.K) ? *g.Bm.at(s, k + v, c) : T(0);
        }
      }
#pragma unroll
      for (int r = 0; r < kNarrowRows; ++r) {
        if (r0 + r >= g.M) break;
        const T* a_row = g.A.at(s, r0 + r, k);
        T a[V];
        if constexpr (kVec) {
          if constexpr (sizeof(T) == 4) {
            const float4 q = *reinterpret_cast<const float4*>(a_row);
            a[0] = q.x;
            a[1] = q.y;
            a[2] = q.z;
            a[3] = q.w;
          } else {
            const double2 q = *reinterpret_cast<const double2*>(a_row);
            a[0] = q.x;
            a[1] = q.y;
          }
        } else {
          a[0] = *a_row;
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int c = 0; c < kNarrowCols; ++c) acc[r][c] += a[v] * b[v][c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kNarrowRows; ++r) {
#pragma unroll
      for (int c = 0; c < kNarrowCols; ++c) {
        if (c >= g.N) break;  // the same in every lane
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kNarrowRows; ++r) {
#pragma unroll
      for (int c = 0; c < kNarrowCols; ++c) {
        if (lane == r * kNarrowCols + c && r0 + r < g.M && c < g.N) {
          *g.out.at(s, r0 + r, c) =
              (g.cin.p ? *g.cin.at(s, r0 + r, c) : T(0)) + g.alpha * acc[r][c];
        }
      }
    }
  }
}

// ---- 128×128 diagonal-block inverse --------------------------------------

// Gauss-Jordan without pivoting in four 32-column panels.  The block lives
// in registers: thread (tr, tc) = (tid / 16, tid % 16) holds rows
// kRows·tr .. + kRows − 1, columns 8·tc .. + 7.  Per panel P:
//   1. P's columns go to shared memory k-major (colT), P's rows to rowp;
//   2. the 32×32 pivot block M_PP is inverted in place in colT (whose
//      rows P step 4 does not read): in f32 by one warp in registers, lane
//      i holding row i and the pivot row coming by shuffles; in f64 by the
//      whole block, element by element;
//   3. rowp = [Dp | Dp·M_PQ] (Q: the other columns);
//   4. every row i outside P: M_iQ −= M_iP·rowp_Q and M_iP = −M_iP·Dp, a
//      rank-32 update summed apart in 4×4 register patches; P's rows take
//      rowp.
// Five barriers a panel in f32, 38 in f64.  Shared memory: ~83 KB in f64
// (no copy of the whole block), ~41 KB in f32.
template <typename T>
struct Inv;
template <>
struct Inv<float> {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;
  static constexpr int kRows = 8;
};
template <>
struct Inv<double> {
  static constexpr int kThreads = 512;
  static constexpr int kMinBlocks = 1;
  static constexpr int kRows = 4;
};

constexpr int kPanel = 32;
constexpr int kLdCol = kBlock + 4;

// Shared values of the inverse: colT, rowp, a stash that takes warp 0's
// patch (f32) or the two Gauss-Jordan buffers (f64), and InvApply's rhs.
constexpr int kInvStash = 2 * kPanel * kPanel;

template <typename T>
constexpr int inv_smem_bytes() {
  return (kPanel * kLdCol + kPanel * kBlock + kInvStash + kBlock * 4) *
         static_cast<int>(sizeof(T));
}

// Four consecutive values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// The 32×32 block stored column by column at blk (a_ij at blk[j·ld + i])
// = its inverse, by one warp: in-place Gauss-Jordan without pivoting, each
// step  p = 1/a_kk;  a_kj = a_kj·p;  a_ik = −a_ik·p;  a_ij −= (a_ik·p)·a_kj.
// Lane i holds row i; a lane's row is a column of consecutive addresses, so
// the loads and stores are free of bank conflicts.
template <typename T>
__device__ __forceinline__ void warp_gauss_jordan(T* blk, int ld, int lane) {
  T x[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) x[j] = blk[j * ld + lane];
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    const T p = T(1) / __shfl_sync(0xffffffffu, x[k], k);
    const T f = x[k] * p;
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      const T pkj = __shfl_sync(0xffffffffu, x[j], k);
      if (j == k) {
        x[j] = lane == k ? p : -f;
      } else {
        x[j] = lane == k ? pkj * p : x[j] - f * pkj;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j) blk[j * ld + lane] = x[j];
}

// The same by the whole block, element by element, the block copied into
// buf (two 32×32 buffers, column by column): each step reads one buffer
// and writes the other, one barrier a step.  In f64 this beats the warp's
// version, whose 32 pivot-row values a lane do not fit its registers
// beside the patch (PERF.md §6).
template <typename T>
__device__ __forceinline__ void block_gauss_jordan(T* blk, int ld, T* buf) {
  constexpr int kThreads = Inv<T>::kThreads;
  constexpr int kSq = kPanel * kPanel;
  const int tid = threadIdx.x;
  T* cur = buf;
  T* nxt = buf + kSq;
  for (int e = tid; e < kSq; e += kThreads) {
    cur[e] = blk[(e / kPanel) * ld + e % kPanel];
  }
  __syncthreads();
  for (int k = 0; k < kPanel; ++k) {
    const T p = T(1) / cur[k * kPanel + k];
    for (int e = tid; e < kSq; e += kThreads) {
      const int i = e % kPanel, j = e / kPanel;  // a_ij at cur[j·32 + i]
      const T aik = cur[k * kPanel + i];
      const T akj = cur[j * kPanel + k];
      T v;
      if (i == k) {
        v = j == k ? p : akj * p;
      } else if (j == k) {
        v = -aik * p;
      } else {
        v = cur[e] - (aik * p) * akj;
      }
      nxt[e] = v;
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int e = tid; e < kSq; e += kThreads) {
    blk[(e / kPanel) * ld + e % kPanel] = cur[e];
  }
}

// The optional work of a block-Thomas inverse launch, r <= 4 right-hand
// sides: before the inverse rhs = R − L·y (K = 0: rhs = R), after it
// out = D⁻¹·rhs; all blocks are 128 rows.  It spares the block row two
// narrow launches.
template <typename T>
struct InvApply {
  Mat<T> L, y, R, out;
  int K, r;
};

// Sum of v over the 16 lanes of a half warp (the threads of one row patch).
template <typename T>
__device__ __forceinline__ T half_warp_sum(T v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// D (the 128×128 block at D.at(s, 0, 0)) = D⁻¹; with kApply also the
// InvApply work, its rhs kept in shared memory across the inverse.
template <typename T, bool kApply>
__device__ __forceinline__ void invert_block(Mat<T> D, int B,
                                             unsigned char* smem,
                                             InvApply<T> ap) {
  constexpr int kThreads = Inv<T>::kThreads, kRows = Inv<T>::kRows;
  T* colT = reinterpret_cast<T*>(smem);  // [kPanel][kLdCol]: M[i][p0 + k]
  T* rowp = colT + kPanel * kLdCol;      // [kPanel][kBlock]: M[p0 + k][c]
  T* stash = rowp + kPanel * kBlock;     // warp 0's patch during step 2
  T* rhs = stash + kInvStash;            // [kBlock][4], kApply only
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid >> 4) * kRows, c0 = (tid & 15) * 8;

  for (int s = blockIdx.x; s < B; s += gridDim.x) {
    if constexpr (kApply) {
      // rhs = R − L·y, each row's products summed over its 16 threads.
      for (int c = 0; c < ap.r; ++c) {
        T yv[8];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          yv[cc] = ap.K ? *ap.y.at(s, c0 + cc, c) : T(0);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          T part = T(0);
          if (ap.K) {
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) {
              part += *ap.L.at(s, r0 + r, c0 + cc) * yv[cc];
            }
          }
          part = half_warp_sum(part);
          if ((tid & 15) == 0) {
            rhs[(r0 + r) * 4 + c] = *ap.R.at(s, r0 + r, c) - part;
          }
        }
      }
    }
    T a[kRows][8];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) a[r][c] = *D.at(s, r0 + r, c0 + c);
    }
    for (int p0 = 0; p0 < kBlock; p0 += kPanel) {
      const bool my_rows = r0 >= p0 && r0 < p0 + kPanel;
      const bool my_cols = c0 >= p0 && c0 < p0 + kPanel;
      // 1. Panel columns and rows to shared memory.
      if (my_cols) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            colT[(c0 - p0 + c) * kLdCol + r0 + r] = a[r][c];
          }
        }
      }
      if (my_rows) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            rowp[(r0 - p0 + r) * kBlock + c0 + c] = a[r][c];
          }
        }
      }
      __syncthreads();
      // 2. Dp = M_PP⁻¹ over M_PP in colT: in f32 by warp 0, which parks
      //    its patch in shared memory meanwhile so that the patch and the
      //    pivot rows need not fit its registers together; in f64 by the
      //    whole block.
      if constexpr (sizeof(T) == 8) {
        block_gauss_jordan(colT + p0, kLdCol, stash);
      } else if (tid < 32) {
#pragma unroll
        for (int e = 0; e < kRows * 8; ++e) {
          stash[e * 32 + lane] = a[e / 8][e % 8];
        }
        warp_gauss_jordan(colT + p0, kLdCol, lane);
#pragma unroll
        for (int e = 0; e < kRows * 8; ++e) {
          a[e / 8][e % 8] = stash[e * 32 + lane];
        }
      }
      __syncthreads();
      // 3. rowp = [Dp | Dp·M_PQ]: kPanel·kBlock outputs, 8 a thread.
      constexpr int kRowsP = kPanel * 16 / kThreads;  // rowp rows a thread
      T nr[kRowsP][8];
#pragma unroll
      for (int q = 0; q < kRowsP; ++q) {
        const int k = (tid >> 4) + q * (kThreads / 16);
#pragma unroll
        for (int c = 0; c < 8; ++c) nr[q][c] = T(0);
        if (my_cols) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            nr[q][c] = colT[(c0 - p0 + c) * kLdCol + p0 + k];
          }
        } else {
#pragma unroll 8
          for (int j = 0; j < kPanel; ++j) {
            const T d = colT[j * kLdCol + p0 + k];
            T b0[4], b1[4];
            load4(rowp + j * kBlock + c0, b0);
            load4(rowp + j * kBlock + c0 + 4, b1);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              nr[q][c] += d * b0[c];
              nr[q][c + 4] += d * b1[c];
            }
          }
        }
      }
      __syncthreads();  // every read of the old rowp is done
#pragma unroll
      for (int q = 0; q < kRowsP; ++q) {
        const int k = (tid >> 4) + q * (kThreads / 16);
#pragma unroll
        for (int c = 0; c < 8; ++c) rowp[k * kBlock + c0 + c] = nr[q][c];
      }
      __syncthreads();
      // 4. The rank-32 update of the other rows; P's rows take rowp.
      if (my_rows) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            a[r][c] = rowp[(r0 - p0 + r) * kBlock + c0 + c];
          }
        }
      } else {
#pragma unroll
        for (int rb = 0; rb < kRows; rb += 4) {
#pragma unroll
          for (int cb = 0; cb < 8; cb += 4) {
            T acc[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
            }
#pragma unroll 4
            for (int k = 0; k < kPanel; ++k) {
              T av[4], bv[4];
              load4(colT + k * kLdCol + r0 + rb, av);
              load4(rowp + k * kBlock + c0 + cb, bv);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[u][v] += av[u] * bv[v];
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int v = 0; v < 4; ++v) {
                a[rb + u][cb + v] =
                    (my_cols ? T(0) : a[rb + u][cb + v]) - acc[u][v];
              }
            }
          }
        }
      }
      __syncthreads();  // colT and rowp are free for the next panel
    }
    if constexpr (kApply) {
      // out = D⁻¹·rhs (rhs written before the panels' barriers).
      for (int c = 0; c < ap.r; ++c) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          T part = T(0);
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) {
            part += a[r][cc] * rhs[(c0 + cc) * 4 + c];
          }
          part = half_warp_sum(part);
          if ((tid & 15) == 0) *ap.out.at(s, r0 + r, c) = part;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) *D.at(s, r0 + r, c0 + c) = a[r][c];
    }
    if constexpr (kApply) __syncthreads();  // rhs serves the next system
  }
}

// ---- host side -----------------------------------------------------------

// The kernels of one source (DENSE_TILE_KERNELS), for one dtype.
template <typename T>
struct Kernels {
  void (*wide)(GemmArgs<T>);
  void (*narrow_vec)(GemmArgs<T>);
  void (*narrow)(GemmArgs<T>);
  void (*inv)(Mat<T>, int, InvApply<T>);
  void (*inv_apply)(Mat<T>, int, InvApply<T>);
};

template <typename T>
int prepare(const Kernels<T>& k) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(k.wide),
      cudaFuncAttributeMaxDynamicSharedMemorySize, Wide<T>::kSmemBytes);
  const void* invs[] = {reinterpret_cast<const void*>(k.inv),
                        reinterpret_cast<const void*>(k.inv_apply)};
  for (const void* inv : invs) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(inv,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 inv_smem_bytes<T>());
    }
  }
  return static_cast<int>(err);
}

template <typename T>
bool narrow_vec_ok(const Mat<T>& A, int K) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  return (reinterpret_cast<uintptr_t>(A.p) & 15) == 0 && A.ld % V == 0 &&
         A.stride % V == 0 && K % V == 0;
}

// out = cin + alpha·(A·Bm); see the header note.  Returns the launch's
// cudaGetLastError().
template <typename T>
int gemm(const Kernels<T>& k, Mat<T> out, Mat<T> cin, Mat<T> A, Mat<T> Bm,
         int M, int N, int K, T alpha, int B, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || B <= 0) return 0;
  GemmArgs<T> g{out, cin, A, Bm, M, N, K, alpha, B};
  void* args[] = {&g};
  const unsigned gy = static_cast<unsigned>(B < kMaxGridY ? B : kMaxGridY);
  cudaError_t err;
  if (N <= kNarrowCols) {
    const int rows = (kNarrowThreads / 32) * kNarrowRows;
    const dim3 grid((M + rows - 1) / rows, gy);
    err = cudaLaunchKernel(
        reinterpret_cast<const void*>(narrow_vec_ok(A, K) ? k.narrow_vec
                                                          : k.narrow),
        grid, dim3(kNarrowThreads), args, 0, stream);
  } else {
    const dim3 grid(((M + kBlock - 1) / kBlock) * ((N + kBlock - 1) / kBlock),
                    gy);
    err = cudaLaunchKernel(reinterpret_cast<const void*>(k.wide), grid,
                           dim3(Wide<T>::kThreads), args, Wide<T>::kSmemBytes,
                           stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// D (128×128 at D.at(s, 0, 0) for each of B systems) = D⁻¹; with ap.r > 0
// also the InvApply work (ap.r <= 4).
template <typename T>
int invert(const Kernels<T>& k, Mat<T> D, int B, cudaStream_t stream,
           InvApply<T> ap = {}) {
  if (ap.r > kNarrowCols) return static_cast<int>(cudaErrorInvalidValue);
  int nb = B;
  void* args[] = {&D, &nb, &ap};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(ap.r > 0 ? k.inv_apply : k.inv),
      dim3(static_cast<unsigned>(B < kMaxGridY ? B : kMaxGridY)),
      dim3(Inv<T>::kThreads), args, inv_smem_bytes<T>(), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Scratch values a system that lu_factor needs for n (ops/lu.py mirrors
// it): P of a lone panel, 128 × (n − 128), or of a pair of panels,
// 128 × 128 and 256 × (n − 256).
inline size_t factor_scratch(int n) {
  return n <= 2 * kBlock
             ? static_cast<size_t>(kBlock) * (n - kBlock)
             : static_cast<size_t>(kBlock) * kBlock +
                   static_cast<size_t>(2 * kBlock) * (n - 2 * kBlock);
}

// No-pivot right-looking LU of G [B][n][n] (n a multiple of 128, systems
// g_stride apart, rows n apart), packed in place: Dinv on the diagonal
// blocks, A21 below them, U right of them; P holds B·factor_scratch(n)
// values.  Per panel t:  Dinv = D⁻¹;  P = Dinv·U;  A22 −= A21·P.  Panels
// go in pairs (t, t + 1), whose updates of the rest R (past both) are
// delayed into one product of depth 256, so that R moves through device
// memory once a pair:
//   Dinv_t;  [P_a | P_b] = Dinv_t·U_t  (P_a: t + 1's columns);
//   column and row of t + 1 −= A21_t·P_a, A21_t·P_b (its first 128 rows);
//   Dinv_{t+1};  P_c = Dinv_{t+1}·U_{t+1};
//   R −= [A21_t | A21_{t+1}]·[P_b ; P_c].
// The packed factor is the one panel by panel gives, rounded apart.
template <typename T>
int lu_factor(const Kernels<T>& k, T* G, size_t g_stride, T* P, int B, int n,
              cudaStream_t stream) {
  const size_t p_stride = factor_scratch(n);
  auto at = [&](int i, int j) {
    return Mat<T>{G + static_cast<size_t>(i) * n + j, g_stride, n};
  };
  int err;
  for (int d = 0; d < n;) {
    const int e = d + kBlock;
    if ((err = invert(k, at(d, d), B, stream))) return err;
    if (e == n) break;
    if (e + kBlock == n) {  // a lone last panel: P = Dinv·U;  A22 −= A21·P
      const Mat<T> Pm{P, p_stride, kBlock};
      if ((err = gemm(k, Pm, Mat<T>{nullptr, 0, 0}, at(d, d), at(d, e),
                      kBlock, kBlock, kBlock, T(1), B, stream)) ||
          (err = gemm(k, at(e, e), at(e, e), at(e, d), Pm, kBlock, kBlock,
                      kBlock, T(-1), B, stream))) {
        return err;
      }
      d = e;
      continue;
    }
    const int f = e + kBlock, m = n - f;
    const Mat<T> none{nullptr, 0, 0};
    const Mat<T> Pa{P, p_stride, kBlock};
    const Mat<T> Q{P + kBlock * kBlock, p_stride, m};  // [P_b ; P_c]
    const Mat<T> Qc{Q.p + static_cast<size_t>(kBlock) * m, p_stride, m};
    if ((err = gemm(k, Pa, none, at(d, d), at(d, e), kBlock, kBlock, kBlock,
                    T(1), B, stream)) ||
        (err = gemm(k, Q, none, at(d, d), at(d, f), kBlock, m, kBlock, T(1),
                    B, stream)) ||
        (err = gemm(k, at(e, e), at(e, e), at(e, d), Pa, n - e, kBlock,
                    kBlock, T(-1), B, stream)) ||
        (err = gemm(k, at(e, f), at(e, f), at(e, d), Q, kBlock, m, kBlock,
                    T(-1), B, stream)) ||
        (err = invert(k, at(e, e), B, stream)) ||
        (err = gemm(k, Qc, none, at(e, e), at(e, f), kBlock, m, kBlock, T(1),
                    B, stream)) ||
        (err = gemm(k, at(f, f), at(f, f), at(f, d), Q, m, m, 2 * kBlock,
                    T(-1), B, stream))) {
      return err;
    }
    d = f;
  }
  return 0;
}

// X (n × r at X.at(s, 0, 0)) = G⁻¹X with the packed factor F of lu_factor
// (systems f_stride apart, rows n apart); Z holds B·128·r values.
//   forward:  z = Dinv_t·y_t;  y_{>t} −= A21_t·z
//   backward: z = y_t − U_t·x_{>t};  x_t = Dinv_t·z
template <typename T>
int lu_solve(const Kernels<T>& k, const T* F, size_t f_stride, Mat<T> X,
             T* Z, int B, int n, int r, cudaStream_t stream) {
  T* Fm = const_cast<T*>(F);  // Mat is read-only where F appears
  const Mat<T> Zm{Z, static_cast<size_t>(kBlock) * r, r};
  const Mat<T> none{nullptr, 0, 0};
  auto rows = [&](int d) {
    return Mat<T>{X.p + static_cast<size_t>(d) * X.ld, X.stride, X.ld};
  };
  int err;
  for (int d = 0; d + kBlock < n; d += kBlock) {
    const int m = n - d - kBlock;
    T* diag = Fm + static_cast<size_t>(d) * n + d;
    const Mat<T> Dm{diag, f_stride, n};
    const Mat<T> A21{diag + static_cast<size_t>(kBlock) * n, f_stride, n};
    if ((err = gemm(k, Zm, none, Dm, rows(d), kBlock, r, kBlock, T(1), B,
                    stream))) {
      return err;
    }
    if ((err = gemm(k, rows(d + kBlock), rows(d + kBlock), A21, Zm, m, r,
                    kBlock, T(-1), B, stream))) {
      return err;
    }
  }
  for (int d = n - kBlock; d >= 0; d -= kBlock) {
    const int m = n - d - kBlock;
    T* diag = Fm + static_cast<size_t>(d) * n + d;
    const Mat<T> Dm{diag, f_stride, n};
    const Mat<T> U{diag + kBlock, f_stride, n};
    if ((err = gemm(k, Zm, rows(d), U, rows(d + kBlock), kBlock, r, m, T(-1),
                    B, stream))) {
      return err;
    }
    if ((err = gemm(k, rows(d), none, Dm, Zm, kBlock, r, kBlock, T(1), B,
                    stream))) {
      return err;
    }
  }
  return 0;
}

}  // namespace dense_tile

// The kernels under a source's own name prefix: prefix##_gemm (wide),
// prefix##_gemv (narrow) and prefix##_inv, and prefix##_kernels<T>() that
// hands them to the host routines above.
#define DENSE_TILE_KERNELS(prefix)                                           \
  template <typename T>                                                      \
  __global__ void __launch_bounds__(dense_tile::Wide<T>::kThreads,           \
                                    dense_tile::Wide<T>::kMinBlocks)         \
      prefix##_gemm(dense_tile::GemmArgs<T> g) {                             \
    extern __shared__ __align__(16) unsigned char dense_tile_smem[];         \
    dense_tile::wide_tile(g, dense_tile_smem);                               \
  }                                                                          \
  template <typename T, bool kVec>                                           \
  __global__ void __launch_bounds__(dense_tile::kNarrowThreads)              \
      prefix##_gemv(dense_tile::GemmArgs<T> g) {                             \
    dense_tile::narrow_rows<T, kVec>(g);                                     \
  }                                                                          \
  template <typename T, bool kApply>                                         \
  __global__ void __launch_bounds__(dense_tile::Inv<T>::kThreads,            \
                                    dense_tile::Inv<T>::kMinBlocks)          \
      prefix##_inv(dense_tile::Mat<T> D, int B,                              \
                   dense_tile::InvApply<T> ap) {                             \
    extern __shared__ __align__(16) unsigned char dense_tile_smem[];         \
    dense_tile::invert_block<T, kApply>(D, B, dense_tile_smem, ap);          \
  }                                                                          \
  template <typename T>                                                      \
  dense_tile::Kernels<T> prefix##_kernels() {                                \
    return {prefix##_gemm<T>, prefix##_gemv<T, true>,                        \
            prefix##_gemv<T, false>, prefix##_inv<T, false>,                 \
            prefix##_inv<T, true>};                                          \
  }
