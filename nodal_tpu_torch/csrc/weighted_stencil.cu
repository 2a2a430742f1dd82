// Weighted-stencil kernels of the weighted grids and lattices, for sm_90a.
//
// The JAX package has no Pallas kernel for this path: under jit, XLA fuses
// each of these into one loop over the field.  The kernels replace those
// fusions:
//   * weighted_residual     <- weighted_laplacian_matvec
//                              (nodal_tpu/ops/grid_weighted.py:34,
//                              grid_weighted3.py:42) in the CG matvec, and
//                              the residual plus restriction of every level
//                              (grid_weighted.py:99-102, :116;
//                              grid_weighted3.py:118-122, :134)
//   * weighted_jacobi       <- one Jacobi sweep (grid_weighted.py:86-97,
//                              grid_weighted3.py:103-116), with the
//                              replication prolongation (:104-105 / :124-127)
//                              fused into the post-smoothing
//   * weighted_jacobi_block <- the coarsest level's mean-projected sweeps
//                              (grid_weighted.py:109-111,
//                              grid_weighted3.py:131-133)
// Semantics follow the plain versions in
// nodal_tpu_torch/ops/weighted_stencil.py.  Fields are [B, d, h, w] (a 2-D
// grid is d = 1), conductances gx [B, d, h, w-1], gy [B, d, h-1, w], gz
// [B, d-1, h, w].  The Laplacian is the flux form of the JAX package, in
// its term order:
//   y = ((((fxl - fxr) + fyu) - fyd) + fzu) - fzd,
//   fxl = gx[j-1] (x[j] - x[j-1]), fxr = gx[j] (x[j+1] - x[j]), ...
// with a missing edge (the field's boundary) a zero term, and the degree
// deg = ((((gxr + gxl) + gyd) + gyu) + gzd) + gzu.  A sweep is
// x <- x + (omega / max(deg, tiny)) (r - y).  Every product is an _rn
// intrinsic, so the compiler contracts no product into an FMA: a sweep
// and a residual equal the plain versions bit for bit (only the sums of
// the restriction and of the mean projections are taken in another
// order), and a zero conductance at an isolated node gives
// 0 * huge = 0 exactly as there.
//
// Bound on the H100: bytes.  A residual or a sweep reads x, r and the
// conductances once and writes one field: at 1024^2 f32 about 21 MB, 6.3 us
// at 3.35 TB/s, against a few flops a value.  Design: one thread a node
// (a coarse node with the restriction), consecutive threads on consecutive
// columns, so every load is coalesced; a neighbour's x comes again from
// L1 or L2, not device memory (the rows above and below were read by
// the warps beside).  The restriction forms each fine residual in
// registers and writes only the block sums, so the fine residual never
// reaches device memory; the post-smoothing adds the coarse correction as
// it loads x, so the prolonged field never does either.  A small coarsest
// level (x, its ping-pong copy, r and one conductance slot a node an axis
// within 227 KB) runs all its sweeps in shared memory in one block a
// sample, its mean projections as fixed-tree block sums (bit for bit from
// run to run): one launch a V-cycle in place of ~96 * 11.  A larger one
// (the 125^2 coarsest level of a 1000^2 grid) takes one launch a sweep,
// chosen by shape in the wrapper.  Shared-memory halos, TMA and clusters
// are later work.
// All offsets into a batch are size_t.  Each launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>

#include "grid_common.cuh"

namespace {

using nodal_grid::block_sum;

constexpr int kThreads = 256;       // one-node-a-thread kernels
constexpr int kBlockThreads = 512;  // the block kernel at most
constexpr int kMaxGrid = 65535;     // blocks of a grid-stride launch
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;    // 227 KB a block on the H100

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T tiny();
template <>
__device__ __forceinline__ float tiny<float>() {
  return FLT_MIN;
}
template <>
__device__ __forceinline__ double tiny<double>() {
  return DBL_MIN;
}

// omega / max(deg, tiny), NaN kept (as jnp.maximum and torch.clamp keep it).
template <typename T>
__device__ __forceinline__ T dinv_of(T deg, T omega) {
  return omega / (deg < tiny<T>() ? tiny<T>() : deg);
}

// y = L_g x and deg at node c = (k, i, j) of one sample, with v = x there.
// A.x(c, k, i, j) is x at a node; A.gx(c, k, i, j) the conductance of the
// edge from node c to (k, i, j + 1), A.gy to (k, i + 1, j), A.gz to
// (k + 1, i, j).
template <typename T, typename A>
__device__ __forceinline__ void flux_point(const A& a, size_t c, int k, int i,
                                           int j, T v, T& y, T& deg) {
  const int h = a.h, w = a.w;
  T fxl = T(0), fxr = T(0), gxl = T(0), gxr = T(0);
  if (j > 0) {
    gxl = a.gx(c - 1, k, i, j - 1);
    fxl = mul(gxl, v - a.x(c - 1, k, i, j - 1));
  }
  if (j < w - 1) {
    gxr = a.gx(c, k, i, j);
    fxr = mul(gxr, a.x(c + 1, k, i, j + 1) - v);
  }
  T fyu = T(0), fyd = T(0), gyu = T(0), gyd = T(0);
  if (i > 0) {
    gyu = a.gy(c - w, k, i - 1, j);
    fyu = mul(gyu, v - a.x(c - w, k, i - 1, j));
  }
  if (i < h - 1) {
    gyd = a.gy(c, k, i, j);
    fyd = mul(gyd, a.x(c + w, k, i + 1, j) - v);
  }
  y = ((fxl - fxr) + fyu) - fyd;
  deg = ((gxr + gxl) + gyd) + gyu;
  if (a.d > 1) {
    const size_t plane = static_cast<size_t>(h) * w;
    T fzu = T(0), fzd = T(0), gzu = T(0), gzd = T(0);
    if (k > 0) {
      gzu = a.gz(c - plane, k - 1, i, j);
      fzu = mul(gzu, v - a.x(c - plane, k - 1, i, j));
    }
    if (k < a.d - 1) {
      gzd = a.gz(c, k, i, j);
      fzd = mul(gzd, a.x(c + plane, k + 1, i, j) - v);
    }
    y = (y + fzu) - fzd;
    deg = (deg + gzd) + gzu;
  }
}

// One sample's x, plus the replicated coarse correction zc where given
// (x may be null: zero), and its conductances, in device memory.
template <typename T>
struct GlobalAccess {
  const T* xs;
  const T* zs;
  const T* gxs;
  const T* gys;
  const T* gzs;
  int d, h, w, fd;

  __device__ __forceinline__ T x(size_t c, int k, int i, int j) const {
    T v = xs ? xs[c] : T(0);
    if (zs) {
      const int hc = h / 2, wc = w / 2;
      v = v + zs[(static_cast<size_t>(k / fd) * hc + (i >> 1)) * wc +
                 (j >> 1)];
    }
    return v;
  }
  // gx[k][i][j] lies at (k h + i)(w - 1) + j = c - (k h + i).
  __device__ __forceinline__ T gx(size_t c, int k, int i, int) const {
    return gxs[c - (static_cast<size_t>(k) * h + i)];
  }
  // gy[k][i][j] lies at (k (h - 1) + i) w + j = c - k w.
  __device__ __forceinline__ T gy(size_t c, int k, int, int) const {
    return gys[c - static_cast<size_t>(k) * w];
  }
  __device__ __forceinline__ T gz(size_t c, int, int, int) const {
    return gzs[c];
  }
};

// One sample's x and conductance slots in shared memory (a slot a node an
// axis, zero on the field's far faces).
template <typename T>
struct SharedAccess {
  const T* X;
  const T* GX;
  const T* GY;
  const T* GZ;
  int d, h, w;

  __device__ __forceinline__ T x(size_t c, int, int, int) const {
    return X[c];
  }
  __device__ __forceinline__ T gx(size_t c, int, int, int) const {
    return GX[c];
  }
  __device__ __forceinline__ T gy(size_t c, int, int, int) const {
    return GY[c];
  }
  __device__ __forceinline__ T gz(size_t c, int, int, int) const {
    return GZ[c];
  }
};

struct Sizes {
  size_t n, nx, ny, nz;  // values a sample: field, gx, gy, gz
};

inline Sizes sizes_of(int d, int h, int w) {
  const size_t n = static_cast<size_t>(d) * h * w;
  return {n, static_cast<size_t>(d) * h * (w - 1),
          static_cast<size_t>(d) * (h - 1) * w,
          static_cast<size_t>(d - 1) * h * w};
}

template <typename T>
__device__ __forceinline__ GlobalAccess<T> sample_access(
    const T* x, const T* zc, const T* gx, const T* gy, const T* gz, int b,
    Sizes s, size_t nc, int d, int h, int w) {
  return {x ? x + b * s.n : nullptr, zc ? zc + b * nc : nullptr,
          gx + b * s.nx, gy + b * s.ny, gz + b * s.nz, d, h, w,
          d == 1 ? 1 : 2};
}

// (k, i, j) of node c of a sample (a sample holds < 2^31 values).
__device__ __forceinline__ void coords(unsigned c, int h, int w, int& k,
                                       int& i, int& j) {
  const unsigned q = c / static_cast<unsigned>(w);
  j = static_cast<int>(c - q * static_cast<unsigned>(w));
  k = static_cast<int>(q / static_cast<unsigned>(h));
  i = static_cast<int>(q - static_cast<unsigned>(k) * h);
}

// ---------------------------------------------------------------- residual

// The grid-stride loop of the one-node-a-thread kernels: blockIdx.y is the
// sample, the x blocks walk its n nodes.
#define NODE_LOOP(c, n)                                                   \
  for (unsigned c = blockIdx.x * blockDim.x + threadIdx.x; c < (n);     \
       c += gridDim.x * blockDim.x)

// out = r - L_g x, or L_g x + shift[b] with no r.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_kernel(const T* __restrict__ x, const T* __restrict__ r,
                    const T* __restrict__ shift, const T* __restrict__ gx,
                    const T* __restrict__ gy, const T* __restrict__ gz,
                    T* __restrict__ out, int d, int h, int w, Sizes s) {
  const int b = blockIdx.y;
  const auto a = sample_access<T>(x, nullptr, gx, gy, gz, b, s, 0, d, h, w);
  const size_t base = b * s.n;
  NODE_LOOP(c, s.n) {
    int k, i, j;
    coords(c, h, w, k, i, j);
    T y, deg;
    flux_point(a, c, k, i, j, a.xs[c], y, deg);
    out[base + c] = r ? r[base + c] - y : y + shift[b];
  }
}

// out[b, kc, ic, jc] = the sum of r - L_g x over the (fd, 2, 2) block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    restrict_kernel(const T* __restrict__ x, const T* __restrict__ r,
                    const T* __restrict__ gx, const T* __restrict__ gy,
                    const T* __restrict__ gz, T* __restrict__ out, int d,
                    int h, int w, Sizes s, unsigned nc) {
  const int fd = d == 1 ? 1 : 2;
  const int hc = h / 2, wc = w / 2;
  const int b = blockIdx.y;
  const auto a = sample_access<T>(x, nullptr, gx, gy, gz, b, s, 0, d, h, w);
  const T* rs = r + b * s.n;
  NODE_LOOP(cc, nc) {
    int kc, ic, jc;
    coords(cc, hc, wc, kc, ic, jc);
    T sum = T(0);
    for (int dk = 0; dk < fd; ++dk) {
      for (int di = 0; di < 2; ++di) {
        for (int dj = 0; dj < 2; ++dj) {
          const int k = kc * fd + dk, i = 2 * ic + di, j = 2 * jc + dj;
          const unsigned c = (static_cast<unsigned>(k) * h + i) * w + j;
          T y, deg;
          flux_point(a, c, k, i, j, a.xs[c], y, deg);
          sum = sum + (rs[c] - y);
        }
      }
    }
    out[b * static_cast<size_t>(nc) + cc] = sum;
  }
}

// ------------------------------------------------------------------ Jacobi

// One sweep: out = v + dinv (r - L_g v), v = x (zero when null) plus the
// replicated zc where given.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    jacobi_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const T* __restrict__ zc, const T* __restrict__ gx,
                  const T* __restrict__ gy, const T* __restrict__ gz,
                  T* __restrict__ out, int d, int h, int w, Sizes s,
                  size_t nc, T omega) {
  const int b = blockIdx.y;
  const auto a = sample_access<T>(x, zc, gx, gy, gz, b, s, nc, d, h, w);
  const size_t base = b * s.n;
  NODE_LOOP(c, s.n) {
    int k, i, j;
    coords(c, h, w, k, i, j);
    const T v = a.x(c, k, i, j);
    T y, deg;
    flux_point(a, c, k, i, j, v, y, deg);
    out[base + c] = v + mul(dinv_of(deg, omega), r[base + c] - y);
  }
}

// The coarsest level's solve, one sample a block, everything in shared
// memory: X0, X1, R, GX, GY (GZ in a lattice), then the reduction's values.
// r minus its mean, sweeps from zero, the result minus its mean.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    jacobi_block_kernel(const T* __restrict__ r, const T* __restrict__ gx,
                        const T* __restrict__ gy, const T* __restrict__ gz,
                        T* __restrict__ out, int d, int h, int w, Sizes s,
                        int sweeps, T omega) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = static_cast<int>(s.n);
  T* X0 = reinterpret_cast<T*>(smem_raw);
  T* X1 = X0 + n;
  T* R = X1 + n;
  T* GX = R + n;
  T* GY = GX + n;
  T* GZ = GY + n;
  T* red = GZ + (d > 1 ? n : 0);
  const int b = blockIdx.x;
  const size_t base = b * s.n;
  T part = T(0);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    int k, i, j;
    coords(c, h, w, k, i, j);
    X0[c] = T(0);
    R[c] = r[base + c];
    part += R[c];
    GX[c] = j < w - 1 ? gx[b * s.nx + c - (k * h + i)] : T(0);
    GY[c] = i < h - 1 ? gy[b * s.ny + c - k * w] : T(0);
    if (d > 1) GZ[c] = k < d - 1 ? gz[b * s.nz + c] : T(0);
  }
  const T rmean = block_sum(part, red) / T(n);  // its barriers order the loads
  for (int c = threadIdx.x; c < n; c += blockDim.x) R[c] -= rmean;
  __syncthreads();
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    const SharedAccess<T> a{X0, GX, GY, GZ, d, h, w};
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      int k, i, j;
      coords(c, h, w, k, i, j);
      const T v = X0[c];
      T y, deg;
      flux_point(a, c, k, i, j, v, y, deg);
      X1[c] = v + mul(dinv_of(deg, omega), R[c] - y);
    }
    __syncthreads();
    T* tmp = X0;
    X0 = X1;
    X1 = tmp;
  }
  part = T(0);
  for (int c = threadIdx.x; c < n; c += blockDim.x) part += X0[c];
  const T xmean = block_sum(part, red) / T(n);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    out[base + c] = X0[c] - xmean;
  }
}

// Blocks of a one-node-a-thread launch over n nodes a sample, B samples.
inline dim3 grid_of(size_t n, int B) {
  const size_t blocks = (n + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned>(blocks < kMaxGrid ? blocks : kMaxGrid),
              static_cast<unsigned>(B));
}

template <typename T>
int launch_residual(const T* x, const T* r, const T* shift, const T* gx,
                    const T* gy, const T* gz, T* out, int B, int d, int h,
                    int w, int coarse, cudaStream_t stream) {
  const Sizes s = sizes_of(d, h, w);
  if (coarse) {
    const int fd = d == 1 ? 1 : 2;
    const size_t nc = static_cast<size_t>(d / fd) * (h / 2) * (w / 2);
    restrict_kernel<T><<<grid_of(nc, B), kThreads, 0, stream>>>(
        x, r, gx, gy, gz, out, d, h, w, s, static_cast<unsigned>(nc));
  } else {
    residual_kernel<T><<<grid_of(s.n, B), kThreads, 0, stream>>>(
        x, r, shift, gx, gy, gz, out, d, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_jacobi(const T* x, const T* r, const T* zc, const T* gx,
                  const T* gy, const T* gz, T* out, int B, int d, int h,
                  int w, double omega, cudaStream_t stream) {
  const Sizes s = sizes_of(d, h, w);
  const int fd = d == 1 ? 1 : 2;
  const size_t nc = static_cast<size_t>(d / fd) * (h / 2) * (w / 2);
  jacobi_kernel<T><<<grid_of(s.n, B), kThreads, 0, stream>>>(
      x, r, zc, gx, gy, gz, out, d, h, w, s, nc, static_cast<T>(omega));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_jacobi_block(const T* r, const T* gx, const T* gy, const T* gz,
                        T* out, int B, int d, int h, int w, int sweeps,
                        int threads, double omega, cudaStream_t stream) {
  const Sizes s = sizes_of(d, h, w);
  const size_t fields = d > 1 ? 6 : 5;
  const size_t bytes = (fields * s.n + threads) * sizeof(T);
  if (bytes > static_cast<size_t>(kMaxSmem) || threads > kBlockThreads ||
      (threads & (threads - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bytes > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  jacobi_block_kernel<T><<<B, threads, bytes, stream>>>(
      r, gx, gy, gz, out, d, h, w, s, sweeps, static_cast<T>(omega));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define NODAL_WSTENCIL_EXPORTS(T, SUFFIX)                                     \
  extern "C" int wstencil_residual_##SUFFIX(                                  \
      const T* x, const T* r, const T* shift, const T* gx, const T* gy,       \
      const T* gz, T* out, int B, int d, int h, int w, int coarse,            \
      cudaStream_t stream) {                                                  \
    return launch_residual<T>(x, r, shift, gx, gy, gz, out, B, d, h, w,       \
                              coarse, stream);                                \
  }                                                                           \
  extern "C" int wstencil_jacobi_##SUFFIX(                                    \
      const T* x, const T* r, const T* zc, const T* gx, const T* gy,          \
      const T* gz, T* out, int B, int d, int h, int w, double omega,          \
      cudaStream_t stream) {                                                  \
    return launch_jacobi<T>(x, r, zc, gx, gy, gz, out, B, d, h, w, omega,     \
                            stream);                                          \
  }                                                                           \
  extern "C" int wstencil_jacobi_block_##SUFFIX(                              \
      const T* r, const T* gx, const T* gy, const T* gz, T* out, int B,       \
      int d, int h, int w, int sweeps, int threads, double omega,             \
      cudaStream_t stream) {                                                  \
    return launch_jacobi_block<T>(r, gx, gy, gz, out, B, d, h, w, sweeps,     \
                                  threads, omega, stream);                    \
  }

NODAL_WSTENCIL_EXPORTS(float, f32)
NODAL_WSTENCIL_EXPORTS(double, f64)
