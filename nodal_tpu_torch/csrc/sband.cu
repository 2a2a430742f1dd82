// Batched scalar banded LDL^T solve with many right-hand sides, for sm_90a.
//
// Replaces both Pallas TPU kernels of nodal_tpu/ops/pallas_scalar_band.py:
//   * pallas_scalar_band_solve_multi / pallas_scalar_band_solve (:152,
//     :225), the solve whose whole band sits in VMEM, and
//   * pallas_scalar_band_solve_stream_multi / _stream (:305, :403), the
//     same solve streamed through VMEM in row chunks, which exists only
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
// Factored row i goes to a scratch area F, n·W1a values per warp, as
// (1/d, m_1..m_w, q = b'_i / d): neither sweep divides again.  Rows past n
// do not exist: couplings that point past the last row are ignored (x
// there reads as 0), as the plain version's scratch rows do.
//
// Design.  One warp solves one system at a time and walks the batch with a
// grid-stride loop.  Two variants:
//   * registers (W1a <= 32: every mesh, midsize and branch shape of the
//     main paths).  Forward: lane k keeps slot k of the window rows
//     i..i+WR in registers, WR >= w a compile-time bucket.  Each step puts
//     the pivot's m_r and its band slots (zero past w) into a small
//     per-warp shared buffer; m_r is then a broadcast read, four (f32) or
//     two (f64) at a time, and the Hankel shift A[i][k+r] a conflict-free
//     read at k+r that needs no mask.  Rows enter the window from a ring in
//     shared memory that cp.async fills kStages rows ahead; each lane copies
//     and reads only its own slot, so the ring needs no barrier.
//     Backward, in column form: lane r holds the pending value of row i - r
//     (q of that row less m·x of every solution known); lane 0's is x_i,
//     which goes to every lane by one shuffle, and each lane r >= 1
//     subtracts m_{i-r,r}·x_i.  That diagonal of F comes through a ring of
//     W1 + kStages factored rows staged kStages rows ahead.  A row's chain
//     is one fused multiply-add and one shuffle; x_i waits in lane i mod 32
//     and goes out 32 rows at a time.
//   * shared (W1a > 32, up to 128): the window is a ring of w + 1 rows in
//     shared memory, (w+1)·W1a values per warp, row j in slot j mod (w+1);
//     m_r is broadcast from a per-warp buffer and the shift is a shared
//     read at k+r.  Its backward keeps the last w solution rows in a
//     shared ring and sums m_r x_{i+r} with one warp reduction per
//     right-hand side.
//
// Bound on the H100.  The inputs read once and x written once are 1.90 GB
// at the mesh shape (B = 16384, n = 999, W1 = 27, one RHS) in f32: 0.567
// ms at 3.35 TB/s (1.134 in f64).  F is written and read back once more,
// 3.67 GB: any design that keeps F in device memory has a floor of 1.66 /
// 3.32 ms.  At 256 systems (the midsize shape) the bound is the latency of
// one warp's row-after-row recurrence: the forward's chain is a shuffle
// of d, the reciprocal, the buffer round trip and a fused multiply-add.
// The register variant takes 79 (f32, WR = 27) and 168 (f64) registers a
// thread under its launch bounds, without spills, three blocks an SM, and
// (96 + 32·(W1 + kStages)) values of shared memory a warp: 4,864 / 9,728
// bytes at the mesh shape (ptxas and cuobjdump on the card; PERF.md §6).
// Later work: several systems per warp at small W1a, F kept on chip.

#include <cuda_runtime.h>

namespace {

// Warps per block; ops/sband.py:MAX_WARPS launches no more.
constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
// Rows the register variant stages ahead of use, in both sweeps; must
// match ops/sband.py:STAGES.
constexpr int kStages = 8;
static_assert((kStages & (kStages - 1)) == 0, "kStages is a power of two");

// One value from device memory into shared memory without the thread
// waiting (cp.async); zeros when !valid, in which case src is not read.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)), "r"(valid ? int(sizeof(T)) : 0)
               : "memory");
}
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's latest groups are in flight.
template <int N>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Slot k of augmented row j: U[j][k] for band slots, R[j][k - W1] after.
template <typename T>
__device__ __forceinline__ T aug(const T* __restrict__ Us,
                                 const T* __restrict__ Rs, int j, int k,
                                 int W1, int n_rhs) {
  return k < W1 ? Us[static_cast<size_t>(j) * W1 + k]
                : Rs[static_cast<size_t>(j) * n_rhs + (k - W1)];
}

// One factored row as the shared variant's backward sweep reads it: m_r
// for r = lane and r = lane + 32 (zero where r is out of the band or past
// row n-1), and q_c = b'_c / d for c = lane + 32·g.
template <typename T>
struct FactoredRow {
  T m0, m1, bp[4];

  __device__ __forceinline__ void fetch(const T* __restrict__ Fw, int i,
                                        int n, int W1, int n_rhs,
                                        int lane) {
    const int w = W1 - 1;
    const T* f = Fw + static_cast<size_t>(i) * (W1 + n_rhs);
    const int r1 = lane + 32;
    m0 = (lane >= 1 && lane <= w && i + lane < n) ? f[lane] : T(0);
    m1 = (r1 <= w && i + r1 < n) ? f[r1] : T(0);
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
      const T xi = __shfl_sync(kFull, bsrc, c & 31) - part;
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

// Slot of row j in a ring of rb rows, for any j >= -rb.
__device__ __forceinline__ int ring_slot(int j, int rb) {
  return j < 0 ? j + rb : j % rb;
}

// Right-hand-side columns the column-form backward carries a pass.
constexpr int kCols = 4;

// Column-form backward substitution of one system whose augmented rows
// fit a warp (W1a <= 32), from its factored rows Fw [n, W1a] (1/d,
// m_1..m_w, q = b'/d) into Xs [n, n_rhs].
//
// At step i (n-1 down to 0) lane r holds the pending value p of row i - r
// for r = 0..w: q of that row minus m·x of every solution already known.
// Lane 0's is x_i.  Each lane r >= 1 subtracts m_{i-r,r}·x_i, the
// diagonal of the factored rows i-1..i-w; lane 1's value is then x_{i-1},
// and the values move down one lane, lane w taking q of row i-1-w.  The
// factored rows are staged kStages rows ahead of that newest row in a
// ring of W1 + kStages rows of 32 values (row j in slot j mod rb, lane k
// copies slot k of each row).  x_i stays in lane i mod 32 and goes out 32
// rows at a time.  kCols columns a pass.
template <typename T>
__device__ __forceinline__ void back_substitute_columns(
    const T* __restrict__ Fw, T* __restrict__ Xs, T* ring, int n, int W1,
    int n_rhs, int lane) {
  const int w = W1 - 1;
  const int W1a = W1 + n_rhs;
  const int rb = W1 + kStages;
  const bool active = lane < W1a;
  const bool band = lane >= 1 && lane <= w;
  const T* src = Fw + lane;  // slot `lane` of row j at src[j·W1a]
  stage_wait<0>();  // the forward's last copies into the ring have landed
  for (int c0 = 0; c0 < n_rhs; c0 += kCols) {
    // Rows n-1 .. n-2-w in one group, then n-3-w .. n-1-w-kStages one
    // group each: each step finds its newest row kStages - 1 groups back.
#pragma unroll 1
    for (int t = 0; t < rb; ++t) {
      const int j = n - 1 - t;
      stage(ring + ring_slot(j, rb) * 32 + lane,
            src + static_cast<size_t>(j < 0 ? 0 : j) * W1a,
            active && j >= 0);
      if (t >= W1) stage_commit();
    }
    stage_wait<kStages - 1>();
    __syncwarp();
    T pend[kCols], xn[kCols], keep[kCols];
    const int jr = n - 1 - lane;  // lane r starts with q of row n-1-r
    const T* qr = ring + ring_slot(jr < 0 ? 0 : jr, rb) * 32 + W1 + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      pend[c] = (lane <= w && jr >= 0 && c0 + c < n_rhs) ? qr[c] : T(0);
      xn[c] = __shfl_sync(kFull, pend[c], 0);
      keep[c] = T(0);
    }
    int sm = band ? ring_slot(n - 1 - lane, rb) : 0;  // row i - lane
    int sq = ring_slot(n - 2 - w, rb);  // slot of row i - 1 - w
    int si = ring_slot(n - 1, rb);      // slot of row i
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
      stage_wait<kStages - 1>();  // row i - 1 - w has landed
      __syncwarp();
      const T m = band ? ring[sm * 32 + lane] : T(0);
      const T* q = ring + sq * 32 + W1 + c0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c0 + c < n_rhs) {
          const T x = xn[c];
          if (lane == (i & 31)) keep[c] = x;
          pend[c] -= m * x;
          xn[c] = __shfl_sync(kFull, pend[c], 1);
          pend[c] = __shfl_down_sync(kFull, pend[c], 1);
          const T qn = q[c];
          if (lane == w) pend[c] = qn;
          if (w == 0) xn[c] = qn;  // no lane 1: row i-1 enters at lane 0
        }
      }
      if ((i & 31) == 0 && i + lane < n) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c0 + c < n_rhs) {
            Xs[static_cast<size_t>(i + lane) * n_rhs + c0 + c] = keep[c];
          }
        }
      }
      // Row i's slot was last read a step ago: it takes row i-1-w-kStages.
      const int j = i - 1 - w - kStages;
      stage(ring + si * 32 + lane,
            src + static_cast<size_t>(j < 0 ? 0 : j) * W1a,
            active && j >= 0);
      stage_commit();
      sm = sm == 0 ? rb - 1 : sm - 1;
      sq = sq == 0 ? rb - 1 : sq - 1;
      si = si == 0 ? rb - 1 : si - 1;
    }
    stage_wait<0>();  // the copies past row 0 land before the ring is reused
    __syncwarp();
  }
}

// Shared memory per warp of the register variant, in values: the pivot's
// m_1..m_WR (32), its band slots zero-padded to 64, and a ring of
// W1 + kStages rows of 32 values, whose first kStages rows the forward
// sweep stages its rows in.
__host__ __device__ inline int reg_smem_per_warp(int W1) {
  return 32 + 64 + (W1 + kStages) * 32;
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

// Register variant: W1a <= 32 and w <= WR.  Three blocks an SM, of up to
// 8 warps in f32 (at most 85 registers a thread) and of up to 4 in f64
// (ops/sband.py:launch_config; at most 170).  Left to itself ptxas took
// 197 and 223, one block of 8 warps an SM and two of 4.
template <typename T, int WR>
__global__ void __launch_bounds__(sizeof(T) == 8 ? kMaxWarps * 16
                                                 : kMaxWarps * 32,
                                  3)
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
            static_cast<size_t>(wib) * reg_smem_per_warp(W1);
  T* pbuf = mbuf + 32;
  T* ring = pbuf + 64;
  T* Fw = F + static_cast<size_t>(gw) * n * W1a;
  T* slot = ring + lane;  // this lane's value of each staged row
  // Slots past the band stay zero: m_r = 0 for r > w, and the shifted
  // pivot reads 0 past slot w.
  mbuf[lane] = T(0);
  pbuf[lane] = T(0);
  pbuf[lane + 32] = T(0);

  for (int s = gw; s < B; s += n_warps) {
    const T* Us = U + static_cast<size_t>(s) * n * W1;
    const T* Rs = R + static_cast<size_t>(s) * n * n_rhs;
    // Slot `lane` of augmented row j is src[j·stride].
    const T* src = lane < W1 ? Us + lane : Rs + (active ? lane - W1 : 0);
    const int stride = lane < W1 ? W1 : n_rhs;

    // Rows WR+1 .. WR+kStages go on their way first, one group each.
    for (int t = 1; t <= kStages; ++t) {
      const int j = WR + t;
      stage(slot + (j & (kStages - 1)) * 32,
            src + static_cast<size_t>(j < n ? j : 0) * stride,
            active && j < n);
      stage_commit();
    }
    // win[r] is slot `lane` of row i + r; rows past n read as 0.  Both
    // loads read the same value.  Under the launch bounds ptxas spilled 56
    // bytes of the f64 set-up with aug's two addresses a row and none with
    // src; with src, the f32 row loop took 11 % longer at 256 systems.
    T win[WR + 1];
#pragma unroll
    for (int r = 0; r <= WR; ++r) {
      if constexpr (sizeof(T) == 8) {
        win[r] = (active && r < n) ? src[static_cast<size_t>(r) * stride]
                                   : T(0);
      } else {
        win[r] = (active && r < n) ? aug(Us, Rs, r, lane, W1, n_rhs) : T(0);
      }
    }

#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const T p = win[0];
      const T inv = T(1) / __shfl_sync(kFull, p, 0);
      const T m = band ? p * inv : T(0);
      if (active) {
        Fw[static_cast<size_t>(i) * W1a + lane] = lane ? p * inv : inv;
      }
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
      // Row i + WR + 1 enters the window from its slot, which then takes
      // row i + WR + 1 + kStages.  A lane reads only what it copied.
      stage_wait<kStages - 1>();
      const int j = i + WR + 1;
      T* js = slot + (j & (kStages - 1)) * 32;
      win[WR] = *js;
      const int jn = j + kStages;
      stage(js, src + static_cast<size_t>(jn < n ? jn : 0) * stride,
            active && jn < n);
      stage_commit();
    }

    back_substitute_columns(Fw, X + static_cast<size_t>(s) * n * n_rhs,
                            ring, n, W1, n_rhs, lane);
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
          const T f = k == 0 ? inv : v * inv;
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
