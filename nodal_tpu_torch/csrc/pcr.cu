// Batched tridiagonal solve by parallel cyclic reduction (PCR), for sm_90a.
//
// Replaces the Pallas TPU kernel nodal_tpu/ops/pallas_tridiag.py
// (pcr_solve, pcr_solve_padded): B independent systems
//   dl[i] x[i-1] + d[i] x[i] + du[i] x[i+1] = b[i],   i < n,
// dl[:, 0] and du[:, n-1] ignored.  Semantics follow the plain version,
// nodal_tpu_torch/ops/tridiag.py:tridiag_solve, operation for operation:
// pad to m = next_pow2(n) with identity rows (d = 1, a = c = rhs = 0), run
// log2(m) levels in which every row eliminates its +-s couplings (an
// out-of-range neighbour reads as an identity row), then x = rhs / d.
//
// Design.  One CTA solves one system at a time and walks the batch with a
// grid-stride loop.  The four arrays of the system are double-buffered
// (8·m values): a level reads one buffer and writes the other, so it needs
// a single __syncthreads().  Device memory sees 4 values read and 1 written
// per row, as on the TPU.
//   * kShared = true:  the buffers live in dynamic shared memory (the
//     wrapper takes this variant while 8·m·sizeof(T) fits a block's 227 KB:
//     m <= 4096 in f32, m <= 2048 in f64; above 48 KB it is opted in with
//     cudaFuncSetAttribute below).
//   * kShared = false: the same code with the buffers in a global scratch
//     area the wrapper allocates (8·m values per CTA), so every chain length
//     works; nothing falls back to another solver.
//
// Bound on the H100.  Each call must move 5·B·n values through device
// memory (about 330 MB at B = 16384, n = 1000 in f32, ~0.1 ms at the data
// sheet's 3.35 TB/s).  The levels read 12 and write 4 shared-memory words
// per row and level, 16·m·log2(m) words per system, which is more traffic
// than the device-memory side; this first version does nothing about
// either (no cp.async/TMA staging, one system per CTA).

#include <cuda_runtime.h>

namespace {

// Threads per block; ops/pcr.py:MAX_THREADS launches no more.
constexpr int kMaxThreads = 512;

template <typename T, bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
    pcr_kernel(const T* __restrict__ dl, const T* __restrict__ d,
               const T* __restrict__ du, const T* __restrict__ b,
               T* __restrict__ x, T* __restrict__ scratch, int B, int n,
               int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t M = m;  // array stride; 4·m may exceed int
  T* buf = kShared ? reinterpret_cast<T*>(smem_raw)
                   : scratch + static_cast<size_t>(blockIdx.x) * 8 * M;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int sys = blockIdx.x; sys < B; sys += gridDim.x) {
    const size_t base = static_cast<size_t>(sys) * n;
    T* cur = buf;
    T* nxt = buf + 4 * M;

    // Load with identity padding; clear the dangling end couplings.
    for (int i = tid; i < m; i += nt) {
      const bool in = i < n;
      cur[i] = (in && i > 0) ? dl[base + i] : T(0);
      cur[M + i] = (in && i < n - 1) ? du[base + i] : T(0);
      cur[2 * M + i] = in ? d[base + i] : T(1);
      cur[3 * M + i] = in ? b[base + i] : T(0);
    }
    __syncthreads();

    for (int s = 1; s < m; s <<= 1) {
      const T* a = cur;
      const T* c = cur + M;
      const T* dd = cur + 2 * M;
      const T* r = cur + 3 * M;
      for (int i = tid; i < m; i += nt) {
        const int lo = i - s;
        const int hi = i + s;
        const bool has_lo = lo >= 0;
        const bool has_hi = hi < m;
        const T d_lo = has_lo ? dd[lo] : T(1);
        const T d_hi = has_hi ? dd[hi] : T(1);
        const T alpha = a[i] / d_lo;
        const T gamma = c[i] / d_hi;
        const T a_lo = has_lo ? a[lo] : T(0);
        const T c_lo = has_lo ? c[lo] : T(0);
        const T r_lo = has_lo ? r[lo] : T(0);
        const T a_hi = has_hi ? a[hi] : T(0);
        const T c_hi = has_hi ? c[hi] : T(0);
        const T r_hi = has_hi ? r[hi] : T(0);
        nxt[i] = -alpha * a_lo;
        nxt[M + i] = -gamma * c_hi;
        nxt[2 * M + i] = dd[i] - alpha * c_lo - gamma * a_hi;
        nxt[3 * M + i] = r[i] - alpha * r_lo - gamma * r_hi;
      }
      __syncthreads();
      T* t = cur;
      cur = nxt;
      nxt = t;
    }

    for (int i = tid; i < n; i += nt) {
      x[base + i] = cur[3 * M + i] / cur[2 * M + i];
    }
    __syncthreads();  // the next system reloads the buffers
  }
}

template <typename T>
int launch(const T* dl, const T* d, const T* du, const T* b, T* x,
           T* scratch, int B, int n, int m, int threads, int grid,
           int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    if (smem_bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          pcr_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    pcr_kernel<T, true><<<grid, threads, smem_bytes, s>>>(
        dl, d, du, b, x, nullptr, B, n, m);
  } else {
    pcr_kernel<T, false><<<grid, threads, 0, s>>>(dl, d, du, b, x, scratch,
                                                  B, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the launch's cudaGetLastError() (0 on success).  scratch == NULL
// selects the shared-memory variant; otherwise scratch holds grid·8·m
// values.
int pcr_solve_f32(const float* dl, const float* d, const float* du,
                  const float* b, float* x, float* scratch, int B, int n,
                  int m, int threads, int grid, int smem_bytes, void* stream) {
  return launch<float>(dl, d, du, b, x, scratch, B, n, m, threads, grid,
                       smem_bytes, stream);
}

int pcr_solve_f64(const double* dl, const double* d, const double* du,
                  const double* b, double* x, double* scratch, int B, int n,
                  int m, int threads, int grid, int smem_bytes, void* stream) {
  return launch<double>(dl, d, du, b, x, scratch, B, n, m, threads, grid,
                        smem_bytes, stream);
}

}  // extern "C"
