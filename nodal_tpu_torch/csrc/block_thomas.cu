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
// limit: each block is eliminated directly, in full f32 or f64 on the CUDA
// cores (no tensor cores, so no TF32), and one design serves every shape a
// plan admits (kb in {128, 256, 384}, any number of block rows, up to 128
// right-hand sides a launch, any batch).
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
// Design.  One block of 256 threads solves one system at a time and walks
// the batch with a grid-stride loop.  Each block owns a global scratch
// area: the Schur block S [kb, kb] and one slot [kb, kb + r] per block row,
// which receives [U_t | rhs_t] and, after elimination, [C_t | y_t] for the
// backward sweep.  Per block row:
//   1. S = D_t − L_t C_{t−1} and rhs = R_t − L_t y_{t−1}: tiled products,
//      64×64 output tiles (a 4×4 patch of accumulators a thread) over
//      K chunks of 32 staged in shared memory; a tile of at most 4 columns
//      (one RHS) gives each thread one element instead.
//   2. Gauss-Jordan elimination of [S | U_t | rhs] in panels of 32 columns:
//      the panel's 32×32 diagonal block is inverted in shared memory
//      (in-place Gauss-Jordan, double-buffered, one barrier a step), its
//      32 rows are multiplied by that inverse, and the other rows lose
//      their panel columns times those rows, a rank-32 update of 64×64
//      tiles.  After kb/32 panels the slot holds S⁻¹ [U_t | rhs].
//   3. The backward sweep is one tiled product a block row, into X.
// The slots, and S where it does not fit beside the tiles (kb = 128 in f32
// keeps S in 64 KB of dynamic shared memory, two blocks an SM), are read
// and written once a panel through L2, never kept whole on chip: that is
// what lets the same code take kb = 384 in f64 (1.2 MB of S alone).
//
// Bound on the H100.  Operations: at least ~14/3·n·kb² flops a system at
// one RHS (per block row 2kb³ for L·C, 2/3·kb³ to factor S, 2kb³ for
// S⁻¹U; Gauss-Jordan does ~kb³ more), against 67 TFLOP/s in f32 (CUDA
// cores) and in f64 (FP64 tensor cores); device memory: W and R read once,
// X written once, far less.  So the kernel is bound by operations, ~2.3 ms
// at B = 1024, nb = 16, kb = 128.  What stands between it and that is
// latency: ~350 barrier-separated phases a block row, most waiting on a
// load from L2, with two blocks (16 warps) an SM to hide them.  Later work:
// double-buffered chunk loads, larger register tiles, the slot in shared
// memory, the tensor cores at f32-exact precision (3×TF32 or similar),
// several systems a block at small batch, the true half-bandwidth
// instead of kb.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // ops/block_thomas.py:THREADS
constexpr int kTile = 64;      // output tile: 16×16 threads × a 4×4 patch
constexpr int kPanel = 32;     // K chunk of the products = elimination panel

template <typename T>
struct Shared {
  union {
    T a[kTile][kPanel + 1];             // A chunk, padded: no bank conflicts
    T inv[2][kPanel * kPanel];          // the panel inversion's two buffers
  };
  T b[kPanel][kTile];                   // B chunk
  T dinv[kPanel][kPanel];               // inverse of the panel's diagonal
};

// Logical row i -> stored row, skipping the `len` rows from `skip` on.
struct Rows {
  int skip, len;
  __device__ __forceinline__ int operator()(int i) const {
    return i < skip ? i : i + len;
  }
};
constexpr int kNoSkip = 1 << 30;

// acc[u][v] -= sum_k a[ty·4 + u][k] · b[k][tx·4 + v] over one staged chunk
// (zero-padded past K).
template <typename T>
__device__ __forceinline__ void mma_chunk(T (&acc)[4][4], const Shared<T>& sm,
                                          int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kPanel; ++k) {
    T av[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) av[u] = sm.a[ty * 4 + u][k];
#pragma unroll
    for (int v = 0; v < 4; ++v) bv[v] = sm.b[k][tx * 4 + v];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] -= av[u] * bv[v];
    }
  }
}

// The same for a tile of at most kNarrow columns: thread t owns element
// (t / kNarrow, t % kNarrow), so a column of right-hand sides costs 1/16 of
// a full tile.
constexpr int kNarrow = kThreads / kTile;  // 4

template <typename T>
__device__ __forceinline__ void mma_chunk_narrow(T& acc, const Shared<T>& sm,
                                                 int u, int v) {
#pragma unroll 8
  for (int k = 0; k < kPanel; ++k) acc -= sm.a[u][k] * sm.b[k][v];
}

// out[i][j] = cin[i][j] − Σ_k A[i][k]·Bm[k][j] for i < M, j < N; K = 0 is a
// copy.  Rows of out, cin and A go through `rows`.  out may be cin; A and
// Bm must not overlap out.  Ends on a barrier: the results are visible to
// the whole block.
template <typename T>
__device__ void gemm_sub(T* out, int ldo, const T* cin, int ldc, const T* A,
                         int lda, const T* Bm, int ldb, int M, int N, int K,
                         Rows rows, Shared<T>& sm) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nu = tid / kNarrow, nv = tid % kNarrow;
  for (int i0 = 0; i0 < M; i0 += kTile) {
    for (int j0 = 0; j0 < N; j0 += kTile) {
      const bool narrow = N - j0 <= kNarrow;  // the same in every thread
      T acc[4][4];
      if (narrow) {
        const int i = i0 + nu, j = j0 + nv;
        acc[0][0] = (i < M && j < N)
                        ? cin[static_cast<size_t>(rows(i)) * ldc + j]
                        : T(0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + ty * 4 + u;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = j0 + tx * 4 + v;
            acc[u][v] = (i < M && j < N)
                            ? cin[static_cast<size_t>(rows(i)) * ldc + j]
                            : T(0);
          }
        }
      }
      const int nb_cols = narrow ? kNarrow : kTile;
      for (int k0 = 0; k0 < K; k0 += kPanel) {
        __syncthreads();  // the previous chunk's readers are done
        for (int e = tid; e < kTile * kPanel; e += kThreads) {
          const int ii = e / kPanel, kk = e % kPanel;
          const int i = i0 + ii, k = k0 + kk;
          sm.a[ii][kk] = (i < M && k < K)
                             ? A[static_cast<size_t>(rows(i)) * lda + k]
                             : T(0);
        }
        for (int e = tid; e < kPanel * nb_cols; e += kThreads) {
          const int kk = e / nb_cols, jj = e % nb_cols;
          const int j = j0 + jj, k = k0 + kk;
          sm.b[kk][jj] = (j < N && k < K)
                             ? Bm[static_cast<size_t>(k) * ldb + j]
                             : T(0);
        }
        __syncthreads();
        if (narrow) {
          mma_chunk_narrow(acc[0][0], sm, nu, nv);
        } else {
          mma_chunk(acc, sm, ty, tx);
        }
      }
      if (narrow) {
        const int i = i0 + nu, j = j0 + nv;
        if (i < M && j < N) {
          out[static_cast<size_t>(rows(i)) * ldo + j] = acc[0][0];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + ty * 4 + u;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = j0 + tx * 4 + v;
            if (i < M && j < N) {
              out[static_cast<size_t>(rows(i)) * ldo + j] = acc[u][v];
            }
          }
        }
      }
    }
  }
  __syncthreads();
}

// sm.dinv = inverse of S[p0 : p0+32, p0 : p0+32] (ld kb) by in-place
// Gauss-Jordan without pivoting; each step reads one buffer and writes the
// other, so one barrier a step.
template <typename T>
__device__ void panel_inverse(const T* S, int kb, int p0, Shared<T>& sm) {
  const int tid = threadIdx.x;
  T* cur = sm.inv[0];
  T* nxt = sm.inv[1];
  __syncthreads();  // sm.a (which inv overlays) is free
  for (int e = tid; e < kPanel * kPanel; e += kThreads) {
    cur[e] = S[static_cast<size_t>(p0 + e / kPanel) * kb + p0 + e % kPanel];
  }
  __syncthreads();
  for (int k = 0; k < kPanel; ++k) {
    const T p = T(1) / cur[k * kPanel + k];
    for (int e = tid; e < kPanel * kPanel; e += kThreads) {
      const int i = e / kPanel, j = e % kPanel;
      const T aik = cur[i * kPanel + k];
      const T akj = cur[k * kPanel + j];
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
  for (int e = tid; e < kPanel * kPanel; e += kThreads) {
    sm.dinv[e / kPanel][e % kPanel] = cur[e];
  }
  __syncthreads();
}

// One elimination panel on the columns X [kb, ncols] (ld ldx) of the
// augmented matrix: rows P = [p0, p0+32) become dinv·X[P]; every other row
// i loses S[i, P]·X[P] (the new X[P]).  S[:, P] holds the multipliers and
// is not among the columns X.
template <typename T>
__device__ void gj_apply(T* X, int ldx, int ncols, const T* S, int kb,
                         int p0, Shared<T>& sm) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const Rows rows{p0, kPanel};
  const int M = kb - kPanel;
  constexpr int kPer = kPanel * kTile / kThreads;  // outputs a thread, rows P
  const int jj = tid % kTile;
  const int nu = tid / kNarrow, nv = tid % kNarrow;
  for (int j0 = 0; j0 < ncols; j0 += kTile) {
    const int j = j0 + jj;
    const bool narrow = ncols - j0 <= kNarrow;  // the same in every thread
    __syncthreads();  // sm.b's last readers are done
    for (int e = tid; e < kPanel * kTile; e += kThreads) {
      const int kk = e / kTile, c = j0 + e % kTile;
      sm.b[kk][e % kTile] =
          c < ncols ? X[static_cast<size_t>(p0 + kk) * ldx + c] : T(0);
    }
    __syncthreads();
    T newp[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) newp[q] = T(0);
#pragma unroll 4
    for (int k = 0; k < kPanel; ++k) {
      const T bk = sm.b[k][jj];  // one load serves the thread's kPer rows
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        newp[q] += sm.dinv[tid / kTile + q * (kThreads / kTile)][k] * bk;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int kk = tid / kTile + q * (kThreads / kTile);
      sm.b[kk][jj] = newp[q];
      if (j < ncols) X[static_cast<size_t>(p0 + kk) * ldx + j] = newp[q];
    }
    for (int i0 = 0; i0 < M; i0 += kTile) {
      __syncthreads();  // sm.b holds the new rows P; sm.a is free
      for (int e = tid; e < kTile * kPanel; e += kThreads) {
        const int ii = e / kPanel, kk = e % kPanel, i = i0 + ii;
        sm.a[ii][kk] =
            i < M ? S[static_cast<size_t>(rows(i)) * kb + p0 + kk] : T(0);
      }
      __syncthreads();
      if (narrow) {
        const int i = i0 + nu, c = j0 + nv;
        T acc = (i < M && c < ncols)
                    ? X[static_cast<size_t>(rows(i)) * ldx + c]
                    : T(0);
        mma_chunk_narrow(acc, sm, nu, nv);
        if (i < M && c < ncols) {
          X[static_cast<size_t>(rows(i)) * ldx + c] = acc;
        }
        continue;
      }
      T acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty * 4 + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = j0 + tx * 4 + v;
          acc[u][v] = (i < M && c < ncols)
                          ? X[static_cast<size_t>(rows(i)) * ldx + c]
                          : T(0);
        }
      }
      mma_chunk(acc, sm, ty, tx);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty * 4 + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = j0 + tx * 4 + v;
          if (i < M && c < ncols) {
            X[static_cast<size_t>(rows(i)) * ldx + c] = acc[u][v];
          }
        }
      }
    }
  }
  __syncthreads();
}

// W [B, nb, kb, 3kb], R and X [B, nb·kb, r]; F holds gridDim.x scratch
// areas of kb·kb + nb·kb·(kb + r) values.  With s_shared, the Schur block
// S lives in the block's dynamic shared memory (kb·kb values) instead of
// its scratch area; every helper takes it through a generic pointer.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_thomas_kernel(const T* __restrict__ W, const T* __restrict__ R,
                        T* __restrict__ X, T* __restrict__ F, int B, int nb,
                        int kb, int r, int s_shared) {
  __shared__ Shared<T> sm;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int n_pad = nb * kb;
  const int ls = kb + r;  // slot row length
  const int lw = 3 * kb;  // band row length
  const Rows all{kNoSkip, 0};
  T* area = F + static_cast<size_t>(blockIdx.x) *
                    (static_cast<size_t>(kb) * kb +
                     static_cast<size_t>(n_pad) * ls);
  T* S = s_shared ? reinterpret_cast<T*>(s_dyn) : area;
  T* slots = area + static_cast<size_t>(kb) * kb;

  for (int s = blockIdx.x; s < B; s += gridDim.x) {
    const T* Ws = W + static_cast<size_t>(s) * n_pad * lw;
    const T* Rs = R + static_cast<size_t>(s) * n_pad * r;
    T* Xs = X + static_cast<size_t>(s) * n_pad * r;

    for (int t = 0; t < nb; ++t) {
      const T* Wt = Ws + static_cast<size_t>(t) * kb * lw;
      T* slot = slots + static_cast<size_t>(t) * kb * ls;
      const T* prev = t ? slot - static_cast<size_t>(kb) * ls : nullptr;
      const int K = t ? kb : 0;  // block row 0 has no carry
      // S = D_t − L_t C_{t−1};  slot = [U_t | R_t − L_t y_{t−1}]
      gemm_sub(S, kb, Wt + kb, lw, Wt, lw, prev, ls, kb, kb, K, all, sm);
      gemm_sub(slot, ls, Wt + 2 * kb, lw, static_cast<const T*>(nullptr),
               0, static_cast<const T*>(nullptr), 0, kb, kb, 0, all, sm);
      gemm_sub(slot + kb, ls, Rs + static_cast<size_t>(t) * kb * r, r, Wt,
               lw, prev ? prev + kb : nullptr, ls, kb, r, K, all, sm);
      // slot = S⁻¹ slot, panel by panel.
      for (int p0 = 0; p0 < kb; p0 += kPanel) {
        panel_inverse(S, kb, p0, sm);
        gj_apply(S + p0 + kPanel, kb, kb - p0 - kPanel, S, kb, p0, sm);
        gj_apply(slot, ls, ls, S, kb, p0, sm);
      }
    }

    // x_{nb−1} = y_{nb−1};  x_t = y_t − C_t x_{t+1}
    const T* last = slots + static_cast<size_t>(nb - 1) * kb * ls;
    gemm_sub(Xs + static_cast<size_t>(nb - 1) * kb * r, r, last + kb, ls,
             static_cast<const T*>(nullptr), 0,
             static_cast<const T*>(nullptr), 0, kb, r, 0, all, sm);
    for (int t = nb - 2; t >= 0; --t) {
      const T* slot = slots + static_cast<size_t>(t) * kb * ls;
      T* xt = Xs + static_cast<size_t>(t) * kb * r;
      gemm_sub(xt, r, slot + kb, ls, slot, ls,
               xt + static_cast<size_t>(kb) * r, r, kb, r, kb, all, sm);
    }
  }
}

// smem_bytes > 0 puts S in that much dynamic shared memory (kb·kb values).
template <typename T>
int launch(const T* W, const T* R, T* X, T* F, int B, int nb, int kb, int r,
           int grid, int smem_bytes, void* stream) {
  if (kb <= 0 || kb % kPanel != 0 || nb <= 0 || r <= 0 || grid <= 0 ||
      (smem_bytes > 0 &&
       smem_bytes < kb * kb * static_cast<int>(sizeof(T)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_thomas_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  block_thomas_kernel<T><<<grid, kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      W, R, X, F, B, nb, kb, r, smem_bytes > 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success).  W is
// [B, nb, kb, 3kb], R and X are [B, nb·kb, r], F is grid·(kb·kb +
// nb·kb·(kb + r)) values of scratch; smem_bytes is 0 or the dynamic shared
// memory that holds S (ops/block_thomas.py:launch_config).
int block_thomas_f32(const float* W, const float* R, float* X, float* F,
                     int B, int nb, int kb, int r, int grid, int smem_bytes,
                     void* stream) {
  return launch<float>(W, R, X, F, B, nb, kb, r, grid, smem_bytes, stream);
}

int block_thomas_f64(const double* W, const double* R, double* X, double* F,
                     int B, int nb, int kb, int r, int grid, int smem_bytes,
                     void* stream) {
  return launch<double>(W, R, X, F, B, nb, kb, r, grid, smem_bytes, stream);
}

}  // extern "C"
