// The clash screen's pair list and its warp scan, shared by the kernels
// that screen a pose with one warp: K1's warp regime and the search's
// back-off (csrc/clash.cu) and the string grid G1 (csrc/string_grid.cu).
//
// A pair list is packed one word a pair, (i << 16) | j, so that the
// atoms' indices fit 16 bits each.

#pragma once

#include <cuda_runtime.h>

#define WARP_UNROLL 4             // warp scan: 32-pair rows per step
#define WARP_STEP (32 * WARP_UNROLL)
#define MAX_ATOMS_PACKED 65535    // two 16-bit indices per pair word

// products, sums and differences rounded one operation at a time (no
// contraction into a fused multiply-add), as PyTorch's separate
// elementwise kernels round them
__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double rn_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float rn_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double rn_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float rn_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double rn_sub(double a, double b) {
  return __dsub_rn(a, b);
}

// the whole block packs pairs [p0, p0 + np) as (i << 16) | j
__device__ __forceinline__ void pack_pairs(unsigned* dst,
                                           const int* __restrict__ pairs,
                                           int p0, int np) {
  for (int k = threadIdx.x; k < np; k += blockDim.x) {
    const long long at = 2 * ((long long)p0 + k);
    dst[k] = ((unsigned)pairs[at] << 16) | (unsigned)pairs[at + 1];
  }
}

// squared distance of atoms i and j (offsets 3 i, 3 j) of the pose x in
// difference form; ROUNDED: each operation rounded on its own, in the
// order ((dx dx + dy dy) + dz dz)
template <bool ROUNDED, typename T>
__device__ __forceinline__ T pair_d2(const T* x, int i, int j) {
  if constexpr (ROUNDED) {
    const T dx = rn_sub(x[i], x[j]);
    const T dy = rn_sub(x[i + 1], x[j + 1]);
    const T dz = rn_sub(x[i + 2], x[j + 2]);
    return rn_add(rn_add(rn_mul(dx, dx), rn_mul(dy, dy)), rn_mul(dz, dz));
  } else {
    const T dx = x[i] - x[j];
    const T dy = x[i + 1] - x[j + 1];
    const T dz = x[i + 2] - x[j + 2];
    return dx * dx + dy * dy + dz * dz;
  }
}

// one warp counts the pairs of s_pairs[0, np) with d^2 < thr2 on the pose
// x (shared memory), adding to `count`; it stops once the count passes
// max_clashes. Every lane returns the same count. The pair list may lie
// in shared or in device memory.
template <typename T, bool ROUNDED = false>
__device__ __forceinline__ int scan_pairs(const unsigned* s_pairs, int np,
                                          const T* x, T thr2, int count,
                                          int max_clashes, int lane) {
  for (int k0 = 0; k0 < np; k0 += WARP_STEP) {
#pragma unroll
    for (int u = 0; u < WARP_UNROLL; ++u) {
      const int k = k0 + u * 32 + lane;
      bool hit = false;
      if (k < np) {
        const unsigned w = s_pairs[k];
        hit = pair_d2<ROUNDED>(x, 3 * (int)(w >> 16),
                               3 * (int)(w & 0xffffu)) < thr2;
      }
      count += __popc(__ballot_sync(0xffffffffu, hit));
    }
    if (count > max_clashes) break;   // warp-uniform
  }
  return count;
}
