// Device helpers shared by the grid kernels (stencil.cu and cg.cu), for
// sm_90a.  Fields are [B, h, w]; the Laplacian is the edge-replicate 5-point
// stencil L_w x = w (4x - up - down - left - right).
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

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace nodal_grid
