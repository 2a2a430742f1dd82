// Batched scalar banded LDL^T solve with many right-hand sides, for sm_90a.
//
// Replaces both Pallas TPU kernels of nodal_tpu/ops/pallas_scalar_band.py:
//   * pallas_scalar_band_solve_multi / pallas_scalar_band_solve, the solve
//     whose whole band sits in VMEM, and
//   * pallas_scalar_band_solve_stream_multi / pallas_scalar_band_solve_stream,
//     the same solve streamed through VMEM in row chunks, which exists only
//     because the VMEM-resident block stops at a few thousand rows.
// On this card one design serves every shape both served: one elimination
// step only touches the pivot row and the w rows below it, so that window
// stays on chip whatever n is, and the factored rows stream out to device
// memory for the backward sweep.
//
// What it computes (the plain version is
// nodal_tpu_torch/ops/scalar_band.py:scalar_band_solve_scan): B systems,
// each an upper band U[n, W1] (U[i, k] = A[i, i+k], diagonal in slot 0,
// w = W1 - 1) of a symmetric positive definite matrix, and right-hand
// sides R[n, n_rhs].  Augmented rows [d, u_1..u_w, rhs_0..] of width
// W1a = W1 + n_rhs are eliminated without pivoting:
//   forward, row i:  d = A[i][0];  m_r = A[i][r] / d          (1 <= r <= w)
//                    A[i+r][k] -= m_r * A[i][k+r]   band slots k <= w - r
//                    A[i+r][k] -= m_r * A[i][k]     rhs slots (never shift)
//   backward:        x_i = b'_i / d - sum_r m_r x_{i+r}
// Rows past n do not exist: couplings that point past the last row are
// ignored (x there reads as 0), as the plain version's scratch rows do.
//
// Design.  One warp solves one system at a time and walks the batch with a
// grid-stride loop; lane k holds augmented slot k (and k+32, k+64, k+96).
// The factored row (d, m_1..m_w, b') of each step goes to a global scratch
// area F, n·W1a values per warp, that the backward sweep reads back.  Two
// variants of the forward sweep:
//   * registers (W1a <= 32: every mesh and branch circuit of the main
//     path): lane k keeps slot k of the window rows i..i+WR in registers,
//     WR >= w a compile-time bucket.  Each step puts the pivot's m_r and
//     its band slots (zero past w) into a small per-warp shared buffer;
//     m_r is then a broadcast read, four (f32) or two (f64) at a time, and
//     the Hankel shift A[i][k+r] a conflict-free read at k+r that needs no
//     mask.  The window moves down one row per step by register moves, and
//     the next row is loaded one step ahead.
//   * shared (W1a > 32, up to 128): the window is a ring of w + 1 rows in
//     shared memory, (w+1)·W1a values per warp, row j in slot j mod (w+1);
//     m_r is broadcast from a per-warp buffer and the shift is a shared
//     read at k+r.
// The backward sweep (both variants) keeps the last w solution rows in a
// shared ring, reads each factored row one row ahead, and sums m_r x_{i+r}
// with one warp reduction per right-hand side.
//
// Bound on the H100.  Device memory sees U and R read once, F written and
// read once and x written once: at the mesh shape (B = 16384, n = 999,
// W1 = 27, one RHS) that is ~5.5 GB in f32, ~1.7 ms at 3.35 TB/s.  The
// register variant executes one shared read, a select and a fused
// multiply-add per band update (plus a quarter of a broadcast read for
// m_r), WR updates a row: ~2.5 ms of shared-memory reads at one warp-wide
// access per clock per SM at that shape, so shared-memory throughput and
// device memory bound it about equally.  The shared variant is bound by
// shared-memory accesses (~4 per update).  At small batches (B = 256)
// both are bound by the latency of one warp's row-after-row recurrence.
// Later work: several systems per warp at small W1a, TMA staging of U.

#include <cuda_runtime.h>

namespace {

// Warps per block; ops/sband.py:MAX_WARPS launches no more.
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// Slot k of augmented row j: U[j][k] for band slots, R[j][k - W1] after.
template <typename T>
__device__ __forceinline__ T aug(const T* __restrict__ Us,
                                 const T* __restrict__ Rs, int j, int k,
                                 int W1, int n_rhs) {
  return k < W1 ? Us[static_cast<size_t>(j) * W1 + k]
                : Rs[static_cast<size_t>(j) * n_rhs + (k - W1)];
}

// One factored row as the backward sweep reads it: m_r for r = lane and
// r = lane + 32 (zero where r is out of the band or past row n-1), the
// pivot d, and b'_c for c = lane + 32·g.
template <typename T>
struct FactoredRow {
  T m0, m1, d, bp[4];

  __device__ __forceinline__ void fetch(const T* __restrict__ Fw, int i,
                                        int n, int W1, int n_rhs,
                                        int lane) {
    const int w = W1 - 1;
    const T* f = Fw + static_cast<size_t>(i) * (W1 + n_rhs);
    const int r1 = lane + 32;
    m0 = (lane >= 1 && lane <= w && i + lane < n) ? f[lane] : T(0);
    m1 = (r1 <= w && i + r1 < n) ? f[r1] : T(0);
    d = f[0];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int c = lane + 32 * g;
      bp[g] = c < n_rhs ? f[W1 + c] : T(0);
    }
  }
};

// Backward substitution of one system from its factored rows Fw [n, W1a]
// into Xs [n, n_rhs].  xr is the warp's shared ring of n_rhs·W1 values:
// column c of solution row j at xr[c·W1 + j mod W1].
template <typename T>
__device__ __forceinline__ void back_substitute(const T* __restrict__ Fw,
                                                T* __restrict__ Xs, T* xr,
                                                int n, int W1, int n_rhs,
                                                int lane) {
  const int WW = W1;
  for (int idx = lane; idx < n_rhs * WW; idx += 32) xr[idx] = T(0);
  __syncwarp();
  FactoredRow<T> next;
  next.fetch(Fw, n - 1, n, W1, n_rhs, lane);
  int xs = (n - 1) % WW;  // ring slot of row i
  int s0 = (xs + lane) % WW;
  int s1 = (xs + lane + 32) % WW;
  for (int i = n - 1; i >= 0; --i) {
    const FactoredRow<T> cur = next;
    if (i > 0) next.fetch(Fw, i - 1, n, W1, n_rhs, lane);
    for (int c = 0; c < n_rhs; ++c) {
      const T* xc = xr + c * WW;
      T part = cur.m0 * xc[s0] + cur.m1 * xc[s1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        part += __shfl_xor_sync(kFull, part, off);
      }
      const T bsrc = c < 32 ? cur.bp[0]
                     : c < 64 ? cur.bp[1]
                     : c < 96 ? cur.bp[2]
                              : cur.bp[3];
      const T xi = __shfl_sync(kFull, bsrc, c & 31) / cur.d - part;
      if (lane == 0) {
        xr[c * WW + xs] = xi;
        Xs[static_cast<size_t>(i) * n_rhs + c] = xi;
      }
    }
    __syncwarp();
    xs = xs == 0 ? WW - 1 : xs - 1;
    s0 = s0 == 0 ? WW - 1 : s0 - 1;
    s1 = s1 == 0 ? WW - 1 : s1 - 1;
  }
  __syncwarp();  // the next system reuses the ring
}

// Shared memory per warp of the register variant, in values: the pivot's
// m_1..m_WR (32), its band slots zero-padded to 64, and the backward ring
// of n_rhs·W1 values rounded up to 16-byte multiples.
__host__ __device__ inline int reg_smem_per_warp(int W1, int n_rhs) {
  return 32 + 64 + ((n_rhs * W1 + 3) & ~3);
}

// m_1..m_WR read as 16-byte vectors: kVec values each.
template <typename T>
struct MVec;
template <>
struct MVec<float> {
  using V = float4;
  static constexpr int kVec = 4;
};
template <>
struct MVec<double> {
  using V = double2;
  static constexpr int kVec = 2;
};

// Register variant: W1a <= 32 and w <= WR.
template <typename T, int WR>
__global__ void __launch_bounds__(kMaxWarps * 32)
    sband_reg_kernel(const T* __restrict__ U, const T* __restrict__ R,
                     T* __restrict__ X, T* __restrict__ F, int B, int n,
                     int W1, int n_rhs, int n_warps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using V = typename MVec<T>::V;
  constexpr int kVec = MVec<T>::kVec;
  union MPack {
    V v;
    T a[kVec];
  };
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int gw = blockIdx.x * (blockDim.x >> 5) + wib;
  if (gw >= n_warps) return;  // only __syncwarp below: a warp may leave

  const int w = W1 - 1;
  const int W1a = W1 + n_rhs;
  const bool active = lane < W1a;
  const bool rhs = active && lane >= W1;
  const bool band = lane >= 1 && lane <= w;
  T* mbuf = reinterpret_cast<T*>(smem_raw) +
            static_cast<size_t>(wib) * reg_smem_per_warp(W1, n_rhs);
  T* pbuf = mbuf + 32;
  T* xr = pbuf + 64;
  T* Fw = F + static_cast<size_t>(gw) * n * W1a;
  // Slots past the band stay zero: m_r = 0 for r > w, and the shifted
  // pivot reads 0 past slot w.
  mbuf[lane] = T(0);
  pbuf[lane] = T(0);
  pbuf[lane + 32] = T(0);

  for (int s = gw; s < B; s += n_warps) {
    const T* Us = U + static_cast<size_t>(s) * n * W1;
    const T* Rs = R + static_cast<size_t>(s) * n * n_rhs;

    // win[r] is slot `lane` of row i + r; rows past n read as 0.
    T win[WR + 1];
#pragma unroll
    for (int r = 0; r <= WR; ++r) {
      win[r] = (active && r < n) ? aug(Us, Rs, r, lane, W1, n_rhs) : T(0);
    }
    T nxt = (active && WR + 1 < n) ? aug(Us, Rs, WR + 1, lane, W1, n_rhs)
                                   : T(0);

    for (int i = 0; i < n; ++i) {
      const T p = win[0];
      const T d = __shfl_sync(kFull, p, 0);
      const T m = band ? p * (T(1) / d) : T(0);
      if (active) Fw[static_cast<size_t>(i) * W1a + lane] = band ? m : p;
      __syncwarp();  // the previous step's readers are done
      if (lane <= w) {
        mbuf[lane] = m;
        pbuf[lane] = p;
      }
      __syncwarp();
#pragma unroll
      for (int v = 0; v * kVec <= WR; ++v) {
        MPack mp;
        mp.v = reinterpret_cast<const V*>(mbuf)[v];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int r = v * kVec + e;
          if (r >= 1 && r <= WR) {
            // Band slots take the pivot's slot lane + r (zero past w), rhs
            // slots the pivot's own slot.
            const T q = rhs ? p : pbuf[lane + r];
            win[r] -= mp.a[e] * q;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < WR; ++r) win[r] = win[r + 1];
      win[WR] = nxt;
      const int j = i + WR + 2;
      nxt = (active && j < n) ? aug(Us, Rs, j, lane, W1, n_rhs) : T(0);
    }

    back_substitute(Fw, X + static_cast<size_t>(s) * n * n_rhs, xr, n, W1,
                    n_rhs, lane);
  }
}

// Shared variant: W1a <= 32·G.  Shared memory per warp: the window ring of
// W1 rows plus one buffer row, (W1 + 1)·W1a values; the backward sweep
// reuses it as its ring.
template <typename T, int G>
__global__ void __launch_bounds__(kMaxWarps * 32)
    sband_shared_kernel(const T* __restrict__ U, const T* __restrict__ R,
                        T* __restrict__ X, T* __restrict__ F, int B, int n,
                        int W1, int n_rhs, int n_warps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int gw = blockIdx.x * (blockDim.x >> 5) + wib;
  if (gw >= n_warps) return;  // only __syncwarp below: a warp may leave

  const int w = W1 - 1;
  const int WW = W1;  // ring rows: the pivot and the w rows below it
  const int W1a = W1 + n_rhs;
  T* ring = reinterpret_cast<T*>(smem_raw) +
            static_cast<size_t>(wib) * (WW + 1) * W1a;
  T* mbuf = ring + static_cast<size_t>(WW) * W1a;
  T* Fw = F + static_cast<size_t>(gw) * n * W1a;

  for (int s = gw; s < B; s += n_warps) {
    const T* Us = U + static_cast<size_t>(s) * n * W1;
    const T* Rs = R + static_cast<size_t>(s) * n * n_rhs;

    for (int j = 0; j < WW && j < n; ++j) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int k = lane + 32 * g;
        if (k < W1a) ring[j * W1a + k] = aug(Us, Rs, j, k, W1, n_rhs);
      }
    }
    // The row that enters the ring at the end of step i, read one step
    // ahead.
    T nxt[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int k = lane + 32 * g;
      nxt[g] = (k < W1a && WW < n) ? aug(Us, Rs, WW, k, W1, n_rhs) : T(0);
    }
    __syncwarp();

    int ps = 0;  // ring slot of pivot row i
    for (int i = 0; i < n; ++i) {
      T* prow = ring + ps * W1a;
      const T inv = T(1) / prow[0];
      T p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int k = lane + 32 * g;
        p[g] = T(0);
        if (k < W1a) {
          const T v = prow[k];
          const bool in_band = k >= 1 && k <= w;
          const T f = in_band ? v * inv : v;
          p[g] = v;
          Fw[static_cast<size_t>(i) * W1a + k] = f;
          if (in_band) mbuf[k] = f;
        }
      }
      __syncwarp();
      const int rmax = min(w, n - 1 - i);
      int rs = ps;
      for (int r = 1; r <= rmax; ++r) {
        rs = rs + 1 == WW ? 0 : rs + 1;
        const T mr = mbuf[r];
        T* trow = ring + rs * W1a;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int k = lane + 32 * g;
          if (k < W1a) {
            const bool is_rhs = k >= W1;
            if (is_rhs || k + r <= w) {
              const T q = is_rhs ? p[g] : prow[k + r];
              trow[k] -= mr * q;
            }
          }
        }
      }
      __syncwarp();
      if (i + WW < n) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int k = lane + 32 * g;
          if (k < W1a) prow[k] = nxt[g];
        }
        const int j = i + WW + 1;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int k = lane + 32 * g;
          nxt[g] = (k < W1a && j < n) ? aug(Us, Rs, j, k, W1, n_rhs) : T(0);
        }
      }
      __syncwarp();
      ps = ps + 1 == WW ? 0 : ps + 1;
    }

    back_substitute(Fw, X + static_cast<size_t>(s) * n * n_rhs, ring, n, W1,
                    n_rhs, lane);
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, T*, int, int, int, int,
                          int);

// The kernel instance for a band of W1 slots with n_rhs right-hand sides;
// ops/sband.py:launch_config picks the same variant.
template <typename T>
KernelFn<T> pick(int W1, int n_rhs) {
  const int w = W1 - 1;
  const int W1a = W1 + n_rhs;
  if (W1a <= 32) {
    if (w <= 3) return sband_reg_kernel<T, 3>;
    if (w <= 7) return sband_reg_kernel<T, 7>;
    if (w <= 11) return sband_reg_kernel<T, 11>;
    if (w <= 15) return sband_reg_kernel<T, 15>;
    if (w <= 19) return sband_reg_kernel<T, 19>;
    if (w <= 23) return sband_reg_kernel<T, 23>;
    if (w <= 27) return sband_reg_kernel<T, 27>;
    return sband_reg_kernel<T, 31>;
  }
  if (W1a <= 64) return sband_shared_kernel<T, 2>;
  if (W1a <= 96) return sband_shared_kernel<T, 3>;
  return sband_shared_kernel<T, 4>;
}

template <typename T>
int launch(const T* U, const T* R, T* X, T* F, int B, int n, int W1,
           int n_rhs, int n_warps, int warps_per_block, int smem_bytes,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KernelFn<T> kernel = pick<T>(W1, n_rhs);
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_warps + warps_per_block - 1) / warps_per_block;
  kernel<<<grid, warps_per_block * 32, smem_bytes, s>>>(U, R, X, F, B, n, W1,
                                                       n_rhs, n_warps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success).  U is [B, n, W1],
// R and X are [B, n, n_rhs], F is n_warps·n·(W1 + n_rhs) values of scratch;
// smem_bytes is warps_per_block times the variant's per-warp shared memory
// (ops/sband.py:launch_config).
int sband_solve_f32(const float* U, const float* R, float* X, float* F,
                    int B, int n, int W1, int n_rhs, int n_warps,
                    int warps_per_block, int smem_bytes, void* stream) {
  return launch<float>(U, R, X, F, B, n, W1, n_rhs, n_warps,
                       warps_per_block, smem_bytes, stream);
}

int sband_solve_f64(const double* U, const double* R, double* X, double* F,
                    int B, int n, int W1, int n_rhs, int n_warps,
                    int warps_per_block, int smem_bytes, void* stream) {
  return launch<double>(U, R, X, F, B, n, W1, n_rhs, n_warps,
                        warps_per_block, smem_bytes, stream);
}

}  // extern "C"
