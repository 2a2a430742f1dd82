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

// Gauss-Jordan without pivoting in four 32-column panels, the block in
// registers.  Per panel P (Q: the other columns), with Dp = M_PP⁻¹:
//   rowp = [Dp | Dp·M_PQ];  every row i outside P: M_iQ −= M_iP·rowp_Q and
//   M_iP = −M_iP·Dp;  P's rows take rowp,
// the rank-32 products summed apart from zero in register patches and
// subtracted last.  The two dtypes are limited by different things and
// have designs of their own (invert_block_f32, invert_block_f64); both
// inverse kernels of a source (prefix##_inv) run them.

constexpr int kPanel = 32;
constexpr int kLdCol = kBlock + 4;

// Shared values of the f64 inverse: colT, rowp, the two Gauss-Jordan
// buffers and InvApply's rhs.
constexpr int kInvStash = 2 * kPanel * kPanel;

template <typename T>
struct Inv;
template <>
struct Inv<float> {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;
  static constexpr int kGjWarps = 4;  // the warps that invert M_PP
  static constexpr int kLdP = kPanel + 4;  // 32×32 buffers, column by column
  // Offsets (values) of the shared buffers; see invert_block_f32.
  static constexpr int kColT = 0;                          // [2][32][kLdCol]
  static constexpr int kRowp = kColT + 2 * kPanel * kLdCol;  // [32][128]
  static constexpr int kRown = kRowp + kPanel * kBlock;      // [32][128]
  static constexpr int kDp = kRown + kPanel * kBlock;        // [32][kLdP]
  static constexpr int kColx = kDp + kPanel * kLdP;          // [2][32]
  static constexpr int kRhs = kColx + 2 * kPanel;            // [4][128]
  static constexpr int kY = kRhs + 4 * kBlock;               // [4][128]
  static constexpr int kSmemBytes =
      (kY + 4 * kBlock) * static_cast<int>(sizeof(float));
};
template <>
struct Inv<double> {
  static constexpr int kThreads = 512;
  static constexpr int kMinBlocks = 1;
  static constexpr int kRows = 4;
  static constexpr int kSmemBytes =
      (kPanel * kLdCol + kPanel * kBlock + kInvStash + kBlock * 4) *
      static_cast<int>(sizeof(double));
};

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

// Two consecutive values from 8-byte-aligned shared memory.
__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
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

// ---- the f64 inverse -----------------------------------------------------

// Thread (tr, tc) = (tid / 16, tid % 16) holds rows 4·tr .. + 3, columns
// 8·tc .. + 7.  Per panel P:
//   1. P's columns go to shared memory k-major (colT), P's rows to rowp;
//   2. M_PP is inverted in place in colT (whose rows P step 4 does not
//      read) by the whole block, element by element (block_gauss_jordan);
//   3. rowp = [Dp | Dp·M_PQ];
//   4. the rank-32 update in 4×4 register patches; P's rows take rowp.
// 38 barriers a panel: the registers of one warp do not hold the pivot
// rows beside the patch.  Shared memory: ~83 KB (no copy of the block).

// The 32×32 block stored column by column at blk (a_ij at blk[j·ld + i])
// = its inverse, in-place Gauss-Jordan without pivoting, each step
//   p = 1/a_kk;  a_kj = a_kj·p;  a_ik = −a_ik·p;  a_ij −= (a_ik·p)·a_kj,
// by the whole block, the block copied into buf (two 32×32 buffers, column
// by column): each step reads one buffer and writes the other, one barrier
// a step.
__device__ __forceinline__ void block_gauss_jordan(double* blk, int ld,
                                                   double* buf) {
  using T = double;
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

// D (the 128×128 block at D.at(s, 0, 0)) = D⁻¹; with kApply also the
// InvApply work, its rhs kept in shared memory across the inverse.
template <bool kApply>
__device__ __forceinline__ void invert_block_f64(Mat<double> D, int B,
                                                 unsigned char* smem,
                                                 InvApply<double> ap) {
  using T = double;
  constexpr int kThreads = Inv<T>::kThreads, kRows = Inv<T>::kRows;
  T* colT = reinterpret_cast<T*>(smem);  // [kPanel][kLdCol]: M[i][p0 + k]
  T* rowp = colT + kPanel * kLdCol;      // [kPanel][kBlock]: M[p0 + k][c]
  T* stash = rowp + kPanel * kBlock;     // the two Gauss-Jordan buffers
  T* rhs = stash + kInvStash;            // [kBlock][4], kApply only
  const int tid = threadIdx.x;
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
      // 2. Dp = M_PP⁻¹ over M_PP in colT, by the whole block.
      block_gauss_jordan(colT + p0, kLdCol, stash);
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

// ---- the f32 inverse -----------------------------------------------------

// 256 threads, two blocks an SM.  Thread (tr, tc) = (tid / 16, tid % 16)
// holds rows tr + 16·u (u < 8) and columns 4·tc .. + 3 and 64 + 4·tc .. + 3:
// every thread holds two rows of each panel, so all eight warps share each
// panel's update; the block is read from and written to device memory in
// 16-byte vectors, 256 bytes a row and half warp; and every shared row the
// update reads serves a half warp conflict-free.  Per panel P (p0 = 32·q):
//   1. P's columns go to colT, k-major with the rows in thread order
//      (colT[k·kLdCol + 8·(i % 16) + i / 16] = M[i][p0 + k], so that a
//      thread's eight rows are two 16-byte vectors; two buffers, so that
//      panel P + 1 writes one while the update of P still reads the
//      other), P's rows to rowp with I in place of M_PP;
//   2. Dp by the first kGjWarps warps (gauss_jordan_f32); in the first
//      panel the other warps meanwhile form InvApply's rhs (apply_rhs);
//   3. rown = Dp·rowp = [Dp | Dp·M_PQ], 4×4 outputs a thread;
//   4. the rank-32 update of each thread's six rows outside P in 6×4
//      patches, two loads of colT and one of rown for 24 FMAs; its two
//      rows in P take rown.
// A barrier after each of steps 1–3, and one a system; ~74 KB of shared
// memory.  The products are the one-warp design's, in its order, so the
// inverse is the same bit for bit but for the pivots' reciprocals
// (pivot_rcp).  On the H100 at B = 1024: 0.179 ms a launch (24 TFLOP/s,
// 36 % of the CUDA cores' f32 rate), 0.232 ms with InvApply at r = 1; a
// block's time is ~44 % updates, ~31 % pivot inverses (128 dependent
// steps), ~14 % step 3 and ~10 % its loads (PERF.md §6).

// 1/x to within an ulp, with no branch: the hardware's approximation and
// one Newton step.  The IEEE division's slow-path call, which only
// zeros, infinities and subnormals need, would cut the unrolled
// Gauss-Jordan into 32 blocks that the compiler cannot interleave; the
// pivots of the bands and Laplacians served here are none of those.
__device__ __forceinline__ float pivot_rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// Barrier 1 for the first `threads` threads of the block.
__device__ __forceinline__ void bar_sync_1(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The 32×32 block whose row i lane i of the first kWarps warps holds,
// warp w its columns kC·w .. + kC − 1 in x (kC = 32 / kWarps) = its
// inverse, in-place Gauss-Jordan without pivoting, each step
//   p = 1/a_kk;  a_kj = a_kj·p;  a_ik = −a_ik·p;  a_ij −= (a_ik·p)·a_kj.
// The pivot row comes by shuffles; the pivot column, which one warp
// holds, through colx (two 32-value buffers): its owner writes it as soon
// as the step before has updated it, one barrier of the kWarps warps a
// step.  One warp alone would be bound by its dependent chain of 32
// shuffles and selects a step (~250 cycles, PERF.md §6).
template <int kWarps>
__device__ __forceinline__ void gauss_jordan_f32(float (&x)[kPanel / kWarps],
                                                 int w, int lane,
                                                 float* colx) {
  constexpr int kC = kPanel / kWarps;
  if (w == 0) colx[lane] = x[0];
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    bar_sync_1(32 * kWarps);  // column k in colx[k % 2]
    const float* col = colx + (k & 1) * kPanel;
    const float p = pivot_rcp(col[k]);
    const float f = col[lane] * p;
#pragma unroll
    for (int v = 0; v < kC; ++v) {
      const float pkj = __shfl_sync(0xffffffffu, x[v], k);
      const float upd = lane == k ? pkj * p : x[v] - f * pkj;
      x[v] = kC * w + v == k ? (lane == k ? p : -f) : upd;
    }
    if (k + 1 < kPanel && w == (k + 1) / kC) {
      colx[((k + 1) & 1) * kPanel + lane] = x[(k + 1) % kC];
    }
  }
}

// Four values of a row in device memory (one 16-byte access where vec).
__device__ __forceinline__ float4 row4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void set_row4(float* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
}

// Whether every row of m starts on 16 bytes.
__device__ __forceinline__ bool mat_vec4(const Mat<float>& m) {
  return aligned16(m.p) && m.ld % 4 == 0 && m.stride % 4 == 0;
}

// rhs[c][i] = R[i][c] − Σ_j L[i][j]·y[j][c] (c < ap.r) for the rows
// i = t, t + n, ... of system s, y staged in ys[c][j]: thread t reads its
// rows of L in 16-byte vectors (where L allows), ys's values are the same
// for the whole warp.  Four partial sums a row, added last.  (A warp a
// row, with a shuffle reduction, or the same spread over the four panels,
// measured slower: PERF.md §6.)
__device__ __forceinline__ void apply_rhs(const InvApply<float>& ap, int s,
                                          int t, int n, const float* ys,
                                          float* rhs) {
  const bool lvec = mat_vec4(ap.L);
  for (int c = 0; c < ap.r; ++c) {
    for (int i = t; i < kBlock; i += n) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int j = 0; j < ap.K; j += 4) {
        const float4 l = row4(ap.L.at(s, i, j), lvec);
        float yv[4];
        load4(ys + c * kBlock + j, yv);
        acc[0] = fmaf(l.x, yv[0], acc[0]);
        acc[1] = fmaf(l.y, yv[1], acc[1]);
        acc[2] = fmaf(l.z, yv[2], acc[2]);
        acc[3] = fmaf(l.w, yv[3], acc[3]);
      }
      rhs[c * kBlock + i] =
          *ap.R.at(s, i, c) - ((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
}

template <bool kApply>
__device__ __forceinline__ void invert_block_f32(Mat<float> D, int B,
                                                 unsigned char* smem,
                                                 InvApply<float> ap) {
  using C = Inv<float>;
  constexpr int kLdP = C::kLdP, kGjWarps = C::kGjWarps;
  float* sm = reinterpret_cast<float*>(smem);
  float* rowp = sm + C::kRowp;
  float* rown = sm + C::kRown;
  float* dpt = sm + C::kDp;  // Dp column by column: Dp[i][k] at k·kLdP + i
  float* colx = sm + C::kColx;
  float* rhs = sm + C::kRhs;  // [c][128], kApply only
  float* ys = sm + C::kY;     // [c][128], kApply only
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid >> 4, tc = tid & 15;
  // Step 3's outputs: rown rows 4·rg .. + 3, columns 4·cg .. + 3.
  const int rg = tr & 7, cg = tc + ((tid >> 7) << 4);
  const bool vec = mat_vec4(D);

  for (int s = blockIdx.x; s < B; s += gridDim.x) {
    if constexpr (kApply) {  // y to shared memory beside the block's loads
      for (int e = tid; e < ap.K * ap.r; e += 256) {
        ys[e] = *ap.y.at(s, e % kBlock, e / kBlock);
      }
    }
    float a[8][8];  // a[u][4h + v] = M[tr + 16u][64h + 4tc + v]
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 q = row4(D.at(s, tr + 16 * u, 64 * h + 4 * tc), vec);
        a[u][4 * h] = q.x;
        a[u][4 * h + 1] = q.y;
        a[u][4 * h + 2] = q.z;
        a[u][4 * h + 3] = q.w;
      }
    }
#pragma unroll
    for (int q = 0; q < kBlock / kPanel; ++q) {  // P's rows: u = 2q, 2q + 1
      const int p0 = q * kPanel;
      float* colT = sm + C::kColT + (q & 1) * kPanel * kLdCol;
      // The thread's columns in P (if any) are its half hq, from kc on.
      const int hq = q >> 1;
      const int kc = 4 * (tc & 7);
      const bool my_cols = (tc >> 3) == (q & 1);
      // 1. Panel columns and rows to shared memory.
      if (my_cols) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
#pragma unroll
          for (int u = 0; u < 8; u += 4) {
            store4(colT + (kc + v) * kLdCol + 8 * tr + u, a[u][4 * hq + v],
                   a[u + 1][4 * hq + v], a[u + 2][4 * hq + v],
                   a[u + 3][4 * hq + v]);
          }
        }
      }
#pragma unroll
      for (int u = 2 * q; u < 2 * q + 2; ++u) {
        const int i = tr + 16 * (u & 1);  // the row's place in P
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            w[v] = my_cols && h == hq ? (i == kc + v ? 1.f : 0.f)
                                      : a[u][4 * h + v];
          }
          store4(rowp + i * kBlock + 64 * h + 4 * tc, w[0], w[1], w[2], w[3]);
        }
      }
      __syncthreads();
      // 2. Dp = M_PP⁻¹ by the first kGjWarps warps, lane i holding row
      //    p0 + i (at 8·(i % 16) + 2q + i / 16 in colT).
      if (warp < kGjWarps) {
        constexpr int kC = kPanel / kGjWarps;
        const int ip = 8 * (lane & 15) + 2 * q + (lane >> 4);
        float x[kC];
#pragma unroll
        for (int v = 0; v < kC; ++v) x[v] = colT[(kC * warp + v) * kLdCol + ip];
        gauss_jordan_f32<kGjWarps>(x, warp, lane, colx);
#pragma unroll
        for (int v = 0; v < kC; ++v) dpt[(kC * warp + v) * kLdP + lane] = x[v];
      } else if (kApply && q == 0) {
        // Meanwhile the other warps form rhs = R − L·y.
        apply_rhs(ap, s, tid - 32 * kGjWarps, C::kThreads - 32 * kGjWarps,
                  ys, rhs);
      }
      __syncthreads();
      // 3. rown = Dp·rowp.
      {
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
        }
#pragma unroll 8
        for (int k = 0; k < kPanel; ++k) {
          float av[4], bv[4];
          load4(dpt + k * kLdP + 4 * rg, av);
          load4(rowp + k * kBlock + 4 * cg, bv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          store4(rown + (4 * rg + u) * kBlock + 4 * cg, acc[u][0], acc[u][1],
                 acc[u][2], acc[u][3]);
        }
      }
      __syncthreads();
      // 4. The rank-32 update of the thread's six rows outside P (the
      //    rows m[0..5] of its patch); its two rows in P take rown.
      int m[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) m[j] = j < 2 * q ? j : j + 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool zero = my_cols && h == hq;  // M_iP = 0 − M_iP·Dp
        float acc[6][4];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
        }
#pragma unroll 4
        for (int k = 0; k < kPanel; ++k) {
          // colT's values of rows m[0..5]: the four of one half and the
          // pair of the other half outside P.
          const float* ck = colT + k * kLdCol + 8 * tr;
          float av[8], bv[4];
          if (q < 2) {
            load4(ck + 4, *reinterpret_cast<float(*)[4]>(av + 4));
            load2(ck + 2 - 2 * q, av + 2 - 2 * q);
          } else {
            load4(ck, *reinterpret_cast<float(*)[4]>(av));
            load2(ck + 10 - 2 * q, av + 10 - 2 * q);
          }
          load4(rown + k * kBlock + 64 * h + 4 * tc, bv);
#pragma unroll
          for (int j = 0; j < 6; ++j) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              acc[j][v] = fmaf(av[m[j]], bv[v], acc[j][v]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            a[m[j]][4 * h + v] = (zero ? 0.f : a[m[j]][4 * h + v]) - acc[j][v];
          }
        }
      }
#pragma unroll
      for (int u = 2 * q; u < 2 * q + 2; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w[4];
          load4(rown + (tr + 16 * (u & 1)) * kBlock + 64 * h + 4 * tc, w);
#pragma unroll
          for (int v = 0; v < 4; ++v) a[u][4 * h + v] = w[v];
        }
      }
    }
    if constexpr (kApply) {
      // out = D⁻¹·rhs (rhs written before the panels' barriers).
      for (int c = 0; c < ap.r; ++c) {
        float rv[8];
        load4(rhs + c * kBlock + 4 * tc, *reinterpret_cast<float(*)[4]>(rv));
        load4(rhs + c * kBlock + 64 + 4 * tc,
              *reinterpret_cast<float(*)[4]>(rv + 4));
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) part += a[u][e] * rv[e];
          part = half_warp_sum(part);
          if (tc == 0) *ap.out.at(s, tr + 16 * u, c) = part;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        set_row4(D.at(s, tr + 16 * u, 64 * h + 4 * tc),
                 make_float4(a[u][4 * h], a[u][4 * h + 1], a[u][4 * h + 2],
                             a[u][4 * h + 3]),
                 vec);
      }
    }
    __syncthreads();  // the shared buffers serve the next system
  }
}

// D (the 128×128 block at D.at(s, 0, 0)) = D⁻¹; with kApply also the
// InvApply work.
template <typename T, bool kApply>
__device__ __forceinline__ void invert_block(Mat<T> D, int B,
                                             unsigned char* smem,
                                             InvApply<T> ap) {
  if constexpr (sizeof(T) == 4) {
    invert_block_f32<kApply>(D, B, smem, ap);
  } else {
    invert_block_f64<kApply>(D, B, smem, ap);
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
                                 Inv<T>::kSmemBytes);
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
      dim3(Inv<T>::kThreads), args, Inv<T>::kSmemBytes, stream);
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
