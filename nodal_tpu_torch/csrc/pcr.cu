// Batched tridiagonal solve for sm_90a: a hybrid of Thomas and parallel
// cyclic reduction, one warp a system.
//
// Replaces the Pallas TPU kernel nodal_tpu/ops/pallas_tridiag.py
// (pcr_solve, pcr_solve_padded): B independent systems
//   dl[i] x[i-1] + d[i] x[i] + du[i] x[i+1] = b[i],   i < n,
// dl[:, 0] and du[:, n-1] ignored.  The plain version of this kernel's
// algorithm is nodal_tpu_torch/ops/pcr.py:thomas_pcr_solve; the function is
// that of nodal_tpu_torch/ops/tridiag.py:tridiag_solve (plain PCR).
//
// Bound on the H100: bytes.  A call must move 5·B·n values through device
// memory (330 MB at B = 16384, n = 1000 in f32, 0.098 ms at 3.35 TB/s),
// against ~10 flops a row.  The TPU kernel's PCR does O(n log n) work: on
// this card its levels cost more shared-memory traffic than the device
// memory side (16 words a row and level).  So the work here is O(n)
// (Laszlo, Giles and Appleyard, ACM TOMS 42(4), 2016):
//   * The system is padded with identity rows (d = 1, a = c = rhs = 0) to
//     32·k rows, k a multiple of the values a 16-byte access holds; lane l
//     owns the chunk of rows s = l·k .. e = s + k - 1.
//   * Forward, over the chunk: each row i > s eliminates x[i-1] but keeps
//     x[s]: a'[i] x[s] + x[i] + c'[i] x[i+1] = d'[i].  Backward: row s + 1
//     as x[s+1] + a''·x[s] + c''·x[e] = d'' (only its three values kept).
//   * Row s (with x[s+1] substituted) couples x[e(l-1)], x[s], x[e]; row e
//     couples x[s], x[e], x[s(l+1)].  These 64 rows, in the order
//     ... e(l-1), s(l), e(l), s(l+1) ..., are tridiagonal: PCR solves them in
//     6 levels over __shfl_sync, two rows a lane, with no shared memory.
//   * Each lane substitutes back over its chunk: x[i] = d'[i] - a'[i] x[s]
//     - c'[i] x[i+1].
// A warp needs no block barrier.  The system lives in shared memory in the
// chunks' order, each lane's chunk in 16-byte units at a stride of an odd
// number of units, so a warp's 16-byte reads of one unit of every chunk
// take the minimum four wavefronts (a one-value pad would break the 16-byte
// alignment that cp.async needs).  The rows arrive by 16-byte cp.async (one
// value a copy when the row pitch or a base pointer is off 16 bytes), and
// the padding rows are written as identity rows, so the sweeps read no
// masks.  The solve is bound by the latency of its dependent chains (a
// division a row), not by the loads: so each warp has one buffer, and an
// SM runs as many warps as buffers fit (12 in f32, 6 in f64 at n = 1000),
// whose solves hide each other's loads (two buffers a warp, loading the
// next system during the solve, ran at half the warps and took 1.2× (f32)
// and 1.7× (f64) as long on the H100).  A system whose buffer would not
// fit a block's shared memory runs the same code on a buffer in a global
// scratch area the wrapper allocates: every chain length works, nothing
// falls back to another solver, and a system's result depends on neither
// B nor the grid.
// Offsets into a batch are size_t.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "grid_common.cuh"

namespace {

using nodal_grid::copy_async;
using nodal_grid::copy_commit;
using nodal_grid::copy_wait;
using nodal_grid::load16;
using nodal_grid::store16;
using nodal_grid::Vec16;

constexpr int kLanes = 32;
// Warps a block at most; ops/pcr.py:MAX_WARPS.
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 232448;  // 227 KB a block on the H100
constexpr unsigned kAll = 0xffffffffu;

// One system in a buffer: four arrays (dl, d, du, b), each 32 chunk slots
// of `stride` 16-byte units, slot l holding rows l·k .. l·k + k - 1 in its
// first k / V units (V = values a unit).
template <typename T>
struct Layout {
  static constexpr int V = Vec16<T>::kN;
  int n, k, units, stride;
  size_t array;  // values an array

  __host__ __device__ Layout(int n_, int k_)
      : n(n_), k(k_), units(k_ / V), stride((k_ / V) | 1),
        array(static_cast<size_t>(kLanes) * ((k_ / V) | 1) * V) {}
  __host__ __device__ size_t values() const { return 4 * array; }
};

// Copies the system at base into buf, through cp.async (kShared) or plain
// loads and stores (a global buffer).  kWide: 16 bytes a copy (n·sizeof(T)
// a multiple of 16 and every pointer aligned), else one value a copy.
template <typename T, bool kShared, bool kWide>
__device__ __forceinline__ void stage_system(
    T* buf, const T* __restrict__ dl, const T* __restrict__ d,
    const T* __restrict__ du, const T* __restrict__ b, size_t base,
    const Layout<T>& L, int lane) {
  constexpr int V = Layout<T>::V;
  const T* src[4] = {dl + base, d + base, du + base, b + base};
  if constexpr (kWide) {
    // Unit u = c·units + q goes to slot c, unit q; u steps by 32.
    const int dc = kLanes / L.units, dq = kLanes % L.units;
    int c = lane / L.units, q = lane % L.units;
    for (int u = lane; u < L.n / V; u += kLanes) {
      T* dst = buf + (static_cast<size_t>(c) * L.stride + q) * V;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        copy_async<16>(dst + a * L.array, src[a] + static_cast<size_t>(u) * V);
      }
      c += dc;
      q += dq;
      if (q >= L.units) {
        q -= L.units;
        ++c;
      }
    }
  } else {
    for (int i = lane; i < L.n; i += kLanes) {
      const int u = i / V, c = u / L.units, q = u - c * L.units;
      T* dst = buf + (static_cast<size_t>(c) * L.stride + q) * V + i % V;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if constexpr (kShared) {
          copy_async<sizeof(T)>(dst + a * L.array, src[a] + i);
        } else {
          dst[a * L.array] = src[a][i];
        }
      }
    }
  }
}

// The padding rows n .. 32·k - 1 as identity rows (dl = du = b = 0,
// d = 1), and du of row n - 1 as 0 (ignored), once every copy has landed.
template <typename T>
__device__ __forceinline__ void pad_system(T* buf, const Layout<T>& L,
                                           int lane) {
  constexpr int V = Layout<T>::V;
  auto at = [&](int i) {
    const int u = i / V, c = u / L.units;
    return buf + (static_cast<size_t>(c) * L.stride + u - c * L.units) * V +
           i % V;
  };
  for (int i = L.n + lane; i < kLanes * L.k; i += kLanes) {
    T* e = at(i);
    e[0] = T(0);
    e[L.array] = T(1);
    e[2 * L.array] = T(0);
    e[3 * L.array] = T(0);
  }
  if (lane == 0) at(L.n - 1)[2 * L.array] = T(0);
}

// One PCR level of the reduced system for a row (A, D, C, R) from its
// neighbours lo and hi at the level's stride (identity rows past the ends),
// as tridiag_solve.
template <typename T>
struct Row {
  T a, d, c, r;
};

template <typename T>
__device__ __forceinline__ Row<T> pcr_step(const Row<T>& x, const Row<T>& lo,
                                           const Row<T>& hi) {
  const T alpha = x.a / lo.d;
  const T gamma = x.c / hi.d;
  return {-alpha * lo.a, x.d - alpha * lo.c - gamma * hi.a, -gamma * hi.c,
          x.r - alpha * lo.r - gamma * hi.r};
}

template <typename T>
__device__ __forceinline__ Row<T> shfl_up(const Row<T>& x, int delta,
                                          int lane) {
  Row<T> y{__shfl_up_sync(kAll, x.a, delta), __shfl_up_sync(kAll, x.d, delta),
           __shfl_up_sync(kAll, x.c, delta),
           __shfl_up_sync(kAll, x.r, delta)};
  if (lane < delta) y = {T(0), T(1), T(0), T(0)};
  return y;
}

template <typename T>
__device__ __forceinline__ Row<T> shfl_down(const Row<T>& x, int delta,
                                            int lane) {
  Row<T> y{__shfl_down_sync(kAll, x.a, delta),
           __shfl_down_sync(kAll, x.d, delta),
           __shfl_down_sync(kAll, x.c, delta),
           __shfl_down_sync(kAll, x.r, delta)};
  if (lane + delta >= kLanes) y = {T(0), T(1), T(0), T(0)};
  return y;
}

// Solves the staged, padded system in buf and writes x[base ..] (dl of
// row 0 reads as 0).  Ends on a __syncwarp: buf may be refilled after it.
template <typename T, bool kWide>
__device__ void solve_system(T* buf, T* __restrict__ x, size_t base,
                             const Layout<T>& L, int lane) {
  constexpr int V = Layout<T>::V;
  T* A = buf + static_cast<size_t>(lane) * L.stride * V;  // dl, then a'
  T* D = A + L.array;                                     // d, then x
  T* C = D + L.array;                                     // du, then c'
  T* R = C + L.array;                                     // b, then d'

  // Forward.  (ap, cp, dp): the previous row's a', c', d'; row s reads as
  // x[s] = x[s] (a' = -1).
  T ap = T(-1), cp = T(0), dp = T(0);
  Row<T> s_row{T(0), T(1), T(0), T(0)};
  for (int q = 0; q < L.units; ++q) {
    T va[V], vd[V], vc[V], vr[V];
    load16(A + q * V, va);
    load16(D + q * V, vd);
    load16(C + q * V, vc);
    load16(R + q * V, vr);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T a = va[v], c = vc[v];
      if (v == 0 && q == 0) {
        s_row = {lane == 0 ? T(0) : a, vd[v], c, vr[v]};
      } else {
        const T inv = T(1) / (vd[v] - a * cp);
        ap = -a * ap * inv;
        cp = c * inv;
        dp = (vr[v] - a * dp) * inv;
      }
      va[v] = ap;
      vc[v] = cp;
      vr[v] = dp;
    }
    store16(A + q * V, va);
    store16(C + q * V, vc);
    store16(R + q * V, vr);
  }
  const Row<T> e_row{ap, T(1), cp, dp};

  // Backward: (ab, cb, db) = (a'', c'', d'') of row i + 1, from x[e] = x[e]
  // down to row s + 1.
  T ab = T(0), cb = T(-1), db = T(0);
  for (int q = L.units - 1; q >= 0; --q) {
    T va[V], vc[V], vr[V];
    load16(A + q * V, va);
    load16(C + q * V, vc);
    load16(R + q * V, vr);
#pragma unroll
    for (int v = V - 1; v >= 0; --v) {
      const int i = q * V + v;
      if (i > 0 && i < L.k - 1) {
        ab = va[v] - vc[v] * ab;
        cb = -vc[v] * cb;
        db = vr[v] - vc[v] * db;
      }
    }
  }

  // The reduced system: row 2·lane is s, row 2·lane + 1 is e.
  Row<T> rs{s_row.a, s_row.d - s_row.c * ab, -s_row.c * cb,
            s_row.r - s_row.c * db};
  Row<T> re = e_row;
  {
    const Row<T> lo = shfl_up(re, 1, lane);    // e of lane - 1
    const Row<T> hi = shfl_down(rs, 1, lane);  // s of lane + 1
    const Row<T> ns = pcr_step(rs, lo, re);
    re = pcr_step(re, rs, hi);
    rs = ns;
  }
#pragma unroll
  for (int h = 1; h < kLanes; h <<= 1) {
    const Row<T> slo = shfl_up(rs, h, lane), shi = shfl_down(rs, h, lane);
    const Row<T> elo = shfl_up(re, h, lane), ehi = shfl_down(re, h, lane);
    rs = pcr_step(rs, slo, shi);
    re = pcr_step(re, elo, ehi);
  }
  const T xs = rs.r / rs.d, xe = re.r / re.d;

  // Back substitution, x into D.
  T xn = xe;
  for (int q = L.units - 1; q >= 0; --q) {
    T va[V], vc[V], vr[V], vx[V];
    load16(A + q * V, va);
    load16(C + q * V, vc);
    load16(R + q * V, vr);
#pragma unroll
    for (int v = V - 1; v >= 0; --v) {
      const int i = q * V + v;
      T xi;
      if (i == L.k - 1) {
        xi = xe;
      } else if (i == 0) {
        xi = xs;
      } else {
        xi = vr[v] - va[v] * xs - vc[v] * xn;
      }
      vx[v] = xi;
      xn = xi;
    }
    store16(D + q * V, vx);
  }
  __syncwarp();

  // Out, in the system's order.
  const T* Xs = buf + L.array;
  if constexpr (kWide) {
    const int dc = kLanes / L.units, dq = kLanes % L.units;
    int c = lane / L.units, q = lane % L.units;
    for (int u = lane; u < L.n / V; u += kLanes) {
      T v[V];
      load16(Xs + (static_cast<size_t>(c) * L.stride + q) * V, v);
      store16(x + base + static_cast<size_t>(u) * V, v);
      c += dc;
      q += dq;
      if (q >= L.units) {
        q -= L.units;
        ++c;
      }
    }
  } else {
    for (int i = lane; i < L.n; i += kLanes) {
      const int u = i / V, c = u / L.units, q = u - c * L.units;
      x[base + i] = Xs[(static_cast<size_t>(c) * L.stride + q) * V + i % V];
    }
  }
  __syncwarp();
}

// Warp g of the grid solves systems g, g + G, ... (G warps) in its buffer:
// dynamic shared memory (kShared), else scratch at g·values.
template <typename T, bool kShared, bool kWide>
__global__ void __launch_bounds__(kMaxWarps* kLanes)
    pcr_kernel(const T* __restrict__ dl, const T* __restrict__ d,
               const T* __restrict__ du, const T* __restrict__ b,
               T* __restrict__ x, T* __restrict__ scratch, int B, int n,
               int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout<T> L(n, k);
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int g = blockIdx.x * warps + warp, G = gridDim.x * warps;
  T* buf = kShared ? reinterpret_cast<T*>(smem_raw) + L.values() * warp
                   : scratch + L.values() * g;
  for (int sys = g; sys < B; sys += G) {
    const size_t base = static_cast<size_t>(sys) * n;
    stage_system<T, kShared, kWide>(buf, dl, d, du, b, base, L, lane);
    if constexpr (kShared) {
      copy_commit();
      copy_wait<0>();
    }
    __syncwarp();  // every lane's copies have landed
    pad_system(buf, L, lane);
    __syncwarp();
    solve_system<T, kWide>(buf, x, base, L, lane);
  }
}

template <typename K>
int opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const T* dl, const T* d, const T* du, const T* b, T* x,
           T* scratch, int B, int n, int k, int warps, int grid, int wide,
           void* stream) {
  constexpr int V = Vec16<T>::kN;
  if (B < 1 || n < 1 || k < 2 || k % V || static_cast<long long>(k) * kLanes < n ||
      warps < 1 || warps > kMaxWarps || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout<T> L(n, k);
  const dim3 block(warps * kLanes);
  if (scratch != nullptr) {
    pcr_kernel<T, false, false><<<grid, block, 0, s>>>(dl, d, du, b, x,
                                                       scratch, B, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = L.values() * sizeof(T) * warps;
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    if ((static_cast<size_t>(n) * sizeof(T)) % 16 || !aligned16(dl) ||
        !aligned16(d) || !aligned16(du) || !aligned16(b) || !aligned16(x)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int err = opt_in(pcr_kernel<T, true, true>, bytes);
    if (err) return err;
    pcr_kernel<T, true, true><<<grid, block, bytes, s>>>(dl, d, du, b, x,
                                                         nullptr, B, n, k);
  } else {
    const int err = opt_in(pcr_kernel<T, true, false>, bytes);
    if (err) return err;
    pcr_kernel<T, true, false><<<grid, block, bytes, s>>>(dl, d, du, b, x,
                                                          nullptr, B, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success).  k: rows a chunk
// (a multiple of 16 / sizeof(T), 32·k >= n); warps: a block's; grid:
// blocks.  scratch == NULL selects the shared-memory variant (wide: 16-byte
// copies), else scratch holds grid·warps buffers of one system.
int pcr_solve_f32(const float* dl, const float* d, const float* du,
                  const float* b, float* x, float* scratch, int B, int n,
                  int k, int warps, int grid, int wide, void* stream) {
  return launch<float>(dl, d, du, b, x, scratch, B, n, k, warps, grid, wide,
                       stream);
}

int pcr_solve_f64(const double* dl, const double* d, const double* du,
                  const double* b, double* x, double* scratch, int B, int n,
                  int k, int warps, int grid, int wide, void* stream) {
  return launch<double>(dl, d, du, b, x, scratch, B, n, k, warps, grid, wide,
                        stream);
}

}  // extern "C"
