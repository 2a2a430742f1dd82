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
// Arithmetic is full f32 or f64 on the CUDA cores (no tensor cores, so no
// TF32).
//
// What it computes (the plain version is
// nodal_tpu_torch/ops/block_lu.py:blocked_factor + blocked_solve_factored):
// for B systems G [n, n] and right-hand sides R [n, r], X = G⁻¹R by
// right-looking LU in panels of k = 128, without pivoting, which is stable
// on the diagonally dominant and SPD matrices the callers give.  For each
// panel t (D the diagonal block, A21 the column below it, U the row right
// of it, all Schur-updated by the earlier panels):
//   factor:   Dinv = D⁻¹;  P = Dinv·U;  A22 −= A21·P
//   forward:  y_{>t} −= A21·(Dinv·y_t)                  (L = A21·Dinv)
//   backward: x_t = Dinv·(y_t − U·x_{>t})
// The factor is packed in place of G: Dinv on the diagonal blocks, A21
// below them, U right of them.  Storing A21 rather than L = A21·Dinv makes
// the factorization's in-place products out-of-place ones (P goes to a
// scratch), at the price of one [k, r] product a panel in the forward sweep.
//
// Kernels:
//   * block_lu_inv: one block a system inverts the 128×128 diagonal block
//     by Gauss-Jordan in dynamic shared memory (64 KB in f32, 128 KB in
//     f64).
//   * block_lu_gemm: out = cin + alpha·(A·Bm) (alpha = ±1), batched
//     with strides, over a grid of (64×64 output tile, system); 256 threads a
//     block with a 4×4 patch of accumulators each, K in chunks of 32
//     staged in shared memory (the pattern of block_thomas.cu); a tile of
//     at most 4 columns (one right-hand side) gives each thread one
//     element instead.  The trailing update A22 −= A21·P, the P products
//     and both sweeps are all this kernel.
//
// Bound on the H100: at least 2/3·n³ + 2·n²·r flops a system, against
// 67 TFLOP/s in both dtypes; G read once, R read and X written once, far
// fewer bytes.  So the work is bound by operations: 10.2 ms at B = 1024,
// n = 1024.  What holds this design above that: the trailing update moves
// its C tile through device memory once a panel (~8n³/(3k) bytes a
// system), every chunk costs two shared-memory loads a thread per 16
// fused multiply-adds, and the sweeps and inversions are many small
// latency-bound launches.  Panels of 128 (not 64) halve the first.  Later
// work: 8×8 register tiles, double-buffered chunk loads, f32-exact tensor
// core products (DMMA in f64), a fused solve.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 128;  // panel width (ops/lu.py:BLOCK)
constexpr int kTile = 64;    // output tile: 16×16 threads × a 4×4 patch
constexpr int kChunk = 32;   // K chunk staged in shared memory
constexpr int kNarrow = kThreads / kTile;  // 4 columns in a narrow tile
constexpr int kMaxGridY = 65535;

template <typename T>
struct Mat {
  T* p;           // element (0, 0) of system 0
  size_t stride;  // elements between systems
  int ld;         // elements between rows
  __device__ __forceinline__ T* at(int s, int i, int j) const {
    return p + static_cast<size_t>(s) * stride +
           static_cast<size_t>(i) * ld + j;
  }
};

template <typename T>
struct GemmShared {
  T a[kTile][kChunk + 1];  // A chunk, padded: no bank conflicts
  T b[kChunk][kTile];      // Bm chunk
};

// out = cin + alpha·(A·Bm) for M×N outputs, K deep, in each of B systems.
// cin.p may be null (zero) or equal out.p (each element is read and then
// written by the same thread); A and Bm must not overlap out.  Grid:
// x = ceil(M/64)·ceil(N/64) tiles, y walks the systems.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_lu_gemm(Mat<T> out, Mat<T> cin, Mat<T> A, Mat<T> Bm, int M,
                  int N, int K, T alpha, int B) {
  __shared__ GemmShared<T> sm;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nu = tid / kNarrow, nv = tid % kNarrow;
  const int tiles_n = (N + kTile - 1) / kTile;
  const int i0 = (blockIdx.x / tiles_n) * kTile;
  const int j0 = (blockIdx.x % tiles_n) * kTile;
  const bool narrow = N - j0 <= kNarrow;  // the same in every thread
  const int nb_cols = narrow ? kNarrow : kTile;

  for (int s = blockIdx.y; s < B; s += gridDim.y) {
    // The products are summed apart from cin and added to it last: summed
    // onto cin (O(1) entries against small products) each step would round
    // at cin's scale, which cost ~20× the plain version's f32 error on the
    // grounded Laplacians, where the Schur complements cancel heavily.
    T acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = T(0);
    }
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      __syncthreads();  // the previous chunk's readers are done
      for (int e = tid; e < kTile * kChunk; e += kThreads) {
        const int ii = e / kChunk, kk = e % kChunk;
        const int i = i0 + ii, k = k0 + kk;
        sm.a[ii][kk] = (i < M && k < K) ? *A.at(s, i, k) : T(0);
      }
      for (int e = tid; e < kChunk * nb_cols; e += kThreads) {
        const int kk = e / nb_cols, jj = e % nb_cols;
        const int j = j0 + jj, k = k0 + kk;
        sm.b[kk][jj] = (j < N && k < K) ? *Bm.at(s, k, j) : T(0);
      }
      __syncthreads();
      if (narrow) {
        // One chunk's partial sum first: the sweeps' K runs to n − 128.
        T part = T(0);
#pragma unroll 8
        for (int k = 0; k < kChunk; ++k) part += sm.a[nu][k] * sm.b[k][nv];
        acc[0][0] += part;
      } else {
#pragma unroll 8
        for (int k = 0; k < kChunk; ++k) {
          T av[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) av[u] = sm.a[ty * 4 + u][k];
#pragma unroll
          for (int v = 0; v < 4; ++v) bv[v] = sm.b[k][tx * 4 + v];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] += av[u] * bv[v];
          }
        }
      }
    }
    if (narrow) {
      const int i = i0 + nu, j = j0 + nv;
      if (i < M && j < N) {
        *out.at(s, i, j) =
            (cin.p ? *cin.at(s, i, j) : T(0)) + alpha * acc[0][0];
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty * 4 + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = j0 + tx * 4 + v;
          if (i < M && j < N) {
            *out.at(s, i, j) =
                (cin.p ? *cin.at(s, i, j) : T(0)) + alpha * acc[u][v];
          }
        }
      }
    }
    __syncthreads();  // sm is reused by the next system
  }
}

// D (the 128×128 block at D.at(s, 0, 0)) = D⁻¹ by in-place Gauss-Jordan
// without pivoting.  Each step copies the pivot row and column aside, so
// every element then updates itself alone: two barriers a step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_lu_inv(Mat<T> D, int B) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  T* a = reinterpret_cast<T*>(s_dyn);  // [kBlock][kBlock]
  T* col = a + kBlock * kBlock;        // pivot column, before the step
  T* row = col + kBlock;               // pivot row, before the step
  const int tid = threadIdx.x;
  for (int s = blockIdx.x; s < B; s += gridDim.x) {
    for (int e = tid; e < kBlock * kBlock; e += kThreads) {
      a[e] = *D.at(s, e / kBlock, e % kBlock);
    }
    for (int k = 0; k < kBlock; ++k) {
      __syncthreads();  // a is up to date; col and row are free
      if (tid < kBlock) {
        col[tid] = a[tid * kBlock + k];
      } else {
        row[tid - kBlock] = a[k * kBlock + tid - kBlock];
      }
      __syncthreads();
      const T p = T(1) / row[k];
      for (int e = tid; e < kBlock * kBlock; e += kThreads) {
        const int i = e / kBlock, j = e % kBlock;
        T v;
        if (i == k) {
          v = j == k ? p : row[j] * p;
        } else if (j == k) {
          v = -col[i] * p;
        } else {
          v = a[e] - (col[i] * p) * row[j];
        }
        a[e] = v;
      }
    }
    __syncthreads();
    for (int e = tid; e < kBlock * kBlock; e += kThreads) {
      *D.at(s, e / kBlock, e % kBlock) = a[e];
    }
    __syncthreads();  // a is reused by the next system
  }
}

constexpr int kInvSmem = (kBlock * kBlock + 2 * kBlock);  // values

template <typename T>
int gemm(Mat<T> out, Mat<T> cin, Mat<T> A, Mat<T> Bm, int M, int N, int K,
         T alpha, int B, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  const long long tiles = static_cast<long long>((M + kTile - 1) / kTile) *
                          ((N + kTile - 1) / kTile);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(B < kMaxGridY ? B : kMaxGridY));
  block_lu_gemm<T><<<grid, kThreads, 0, stream>>>(out, cin, A, Bm, M, N, K,
                                                alpha, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int invert(Mat<T> D, int B, cudaStream_t stream) {
  const int grid = B < kMaxGridY ? B : kMaxGridY;
  block_lu_inv<T><<<grid, kThreads, kInvSmem * sizeof(T), stream>>>(D, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int check_args(int B, int n) {
  if (B <= 0 || n <= 0 || n % kBlock != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaFuncSetAttribute(
      block_lu_inv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kInvSmem * sizeof(T))));
}

// G [B, n, n] is factored in place; P holds B·kBlock·(n − kBlock) values.
template <typename T>
int factor(T* G, T* P, int B, int n, void* stream_) {
  int err = check_args<T>(B, n);
  if (err) return err;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t sys = static_cast<size_t>(n) * n;
  const size_t p_stride = static_cast<size_t>(kBlock) * (n - kBlock);
  const Mat<T> none{nullptr, 0, 0};
  for (int d = 0; d < n; d += kBlock) {
    const int m = n - d - kBlock;  // rows and columns past the panel
    T* diag = G + static_cast<size_t>(d) * n + d;
    const Mat<T> Dm{diag, sys, n};
    if ((err = invert(Dm, B, stream))) return err;
    if (m == 0) break;
    const Mat<T> Pm{P, p_stride, m};
    const Mat<T> U{diag + kBlock, sys, n};
    const Mat<T> A21{diag + static_cast<size_t>(kBlock) * n, sys, n};
    const Mat<T> A22{diag + static_cast<size_t>(kBlock) * n + kBlock, sys,
                     n};
    // P = Dinv·U;  A22 −= A21·P
    if ((err = gemm(Pm, none, Dm, U, kBlock, m, kBlock, T(1), B, stream))) {
      return err;
    }
    if ((err = gemm(A22, A22, A21, Pm, m, m, kBlock, T(-1), B, stream))) {
      return err;
    }
  }
  return 0;
}

// F [B, n, n] packed by factor(); X [B, n, r] holds R on entry and the
// solution on return; Z holds B·kBlock·r values.
template <typename T>
int solve(const T* F, T* X, T* Z, int B, int n, int r, void* stream_) {
  if (B <= 0 || n <= 0 || n % kBlock != 0 || r <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t sys = static_cast<size_t>(n) * n;
  const size_t x_stride = static_cast<size_t>(n) * r;
  T* Fm = const_cast<T*>(F);  // Mat is read-only where F appears
  const Mat<T> Zm{Z, static_cast<size_t>(kBlock) * r, r};
  const Mat<T> none{nullptr, 0, 0};
  int err;
  // Forward: z = Dinv_t·y_t;  y_{>t} −= A21_t·z
  for (int d = 0; d + kBlock < n; d += kBlock) {
    const int m = n - d - kBlock;
    T* diag = Fm + static_cast<size_t>(d) * n + d;
    const Mat<T> Dm{diag, sys, n};
    const Mat<T> A21{diag + static_cast<size_t>(kBlock) * n, sys, n};
    const Mat<T> Yt{X + static_cast<size_t>(d) * r, x_stride, r};
    const Mat<T> Yb{X + static_cast<size_t>(d + kBlock) * r, x_stride, r};
    if ((err = gemm(Zm, none, Dm, Yt, kBlock, r, kBlock, T(1), B, stream))) {
      return err;
    }
    if ((err = gemm(Yb, Yb, A21, Zm, m, r, kBlock, T(-1), B, stream))) {
      return err;
    }
  }
  // Backward: z = y_t − U_t·x_{>t};  x_t = Dinv_t·z
  for (int d = n - kBlock; d >= 0; d -= kBlock) {
    const int m = n - d - kBlock;
    T* diag = Fm + static_cast<size_t>(d) * n + d;
    const Mat<T> Dm{diag, sys, n};
    const Mat<T> U{diag + kBlock, sys, n};
    const Mat<T> Xt{X + static_cast<size_t>(d) * r, x_stride, r};
    const Mat<T> Xb{X + static_cast<size_t>(d + kBlock) * r, x_stride, r};
    if ((err = gemm(Zm, Xt, U, Xb, kBlock, r, m, T(-1), B, stream))) {
      return err;
    }
    if ((err = gemm(Xt, none, Dm, Zm, kBlock, r, kBlock, T(1), B, stream))) {
      return err;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Each returns the first non-zero cudaGetLastError() of its launches (0 on
// success).  G [B, n, n] is factored in place with the scratch P of
// B·128·(n − 128) values; X [B, n, r] holds R on entry and G⁻¹R on return,
// with the scratch Z of B·128·r values.
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
