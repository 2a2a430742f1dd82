// Device helpers shared by the grid kernels (stencil.cu and cg.cu) and the
// PCR kernel (pcr.cu), for sm_90a.  Fields are [B, h, w]; the Laplacian is
// the edge-replicate 5-point stencil L_w x = w (4x - up - down - left -
// right).  The cp.async helpers stage rows into shared-memory rings.
#pragma once

#include <cuda_runtime.h>

namespace nodal_grid {

// Index i of the symmetric (mirror) extension of [0, n): period 2n.  A halo
// read through it is the edge-replicate boundary for any halo width.
__device__ __forceinline__ int mirror(int i, int n) {
  const int p = 2 * n;
  int j = i % p;
  if (j < 0) j += p;
  return j < n ? j : p - 1 - j;
}

// L_w x at one cell, the neighbour sum in the plain versions' order
// (up + down + left + right).
template <typename T>
__device__ __forceinline__ T lap_point(T v, T up, T dn, T lf, T rt,
                                       T weight) {
  return weight * (T(4) * v - (((up + dn) + lf) + rt));
}

// Deterministic block sum: each thread's own fixed-stride sum s, then a
// fixed tree.  blockDim.x must be a power of two and red hold blockDim.x
// values.
template <typename T>
__device__ T block_sum(T s, T* red) {
  red[threadIdx.x] = s;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  const T total = red[0];
  __syncthreads();
  return total;
}

// Sum over a warp of each lane's s by a fixed xor tree: every lane gets the
// same value (addition commutes), bit for bit from run to run.
template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------- cp.async staging

// Two values in one 8- or 16-byte access.
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

// kN values in one 16-byte access.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int kN = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int kN = 2;
};

// The kN values at p (16-byte aligned) into v, and back.
template <typename T>
__device__ __forceinline__ void load16(const T* p, T (&v)[Vec16<T>::kN]) {
  const auto t = *reinterpret_cast<const typename Vec16<T>::type*>(p);
  v[0] = t.x;
  v[1] = t.y;
  if constexpr (Vec16<T>::kN == 4) {
    v[2] = t.z;
    v[3] = t.w;
  }
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const T (&v)[Vec16<T>::kN]) {
  typename Vec16<T>::type t;
  t.x = v[0];
  t.y = v[1];
  if constexpr (Vec16<T>::kN == 4) {
    t.z = v[2];
    t.w = v[3];
  }
  *reinterpret_cast<typename Vec16<T>::type*>(p) = t;
}

// kBytes (4, 8 or 16) from device memory into shared memory, asynchronously.
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

}  // namespace nodal_grid
