// The first design of the TFD prune's search kernel T1, kept as it was
// written: the yardstick that chip_smoke.py and the card tests hold the
// redesign (tfd_first.cu) against, bit for bit, and time it beside. No
// route launches it (ops/kernels/tfd.first_successor_pass_warp).
//
// What it computes is what tfd_first.cu computes: for every row of one
// pass of the bucketed TFD prune (tscode_tpu/ops/tfd.py:75 and :87 in the
// JAX package) the chunk-relative index of its first similar successor in
// its chunk, or -1, with the same arithmetic (acc = 0.0, then for q = 0,
// ..., Q-1: d = |(double)a_q - (double)b_q|, acc += min(d, |d - 360|);
// a hit is acc < thresh) and the same chunks.
//
// Design: a warp a row. The row's Q values are converted to double once
// into the warp's slice of shared memory; the lanes take j = i+1+lane,
// i+33+lane, ... up to hi, 32 candidates a step, each lane reading its
// candidate's Q floats from device memory (through L1) and summing its
// pair over the torsions; __ballot_sync on acc < thresh and __ffs of the
// ballot give the smallest hit of the step, and the warp stops there. Any
// Q up to ~3,600 runs (the shared slice holds Q doubles a warp).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // rows a block

__global__ void __launch_bounds__(kWarps * 32)
tfd_first_kernel(const float* __restrict__ tf, int Q, long long d,
                 long long k, long long num_active, double thresh,
                 long long row0, int rows, int* __restrict__ first) {
  extern __shared__ double row_fp[];      // kWarps x Q
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= rows) return;                  // warp-uniform
  const long long i = row0 + r;
  const long long step = min(i / d, k - 1);
  const long long lo = d * step;
  const long long hi = step == k - 1 ? num_active : d * (step + 1);
  int out = -1;
  if (hi - lo > 1 && i < hi) {
    double* a = row_fp + warp * Q;
    for (int q = lane; q < Q; q += 32) a[q] = (double)tf[i * Q + q];
    __syncwarp();
    for (long long base = i + 1; base < hi; base += 32) {
      const long long j = base + lane;
      bool hit = false;
      if (j < hi) {
        const float* b = tf + j * Q;
        double acc = 0.0;
        for (int q = 0; q < Q; ++q) {
          const double dq = fabs(a[q] - (double)__ldg(b + q));
          acc += fmin(dq, fabs(dq - 360.0));
        }
        hit = acc < thresh;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m) {
        out = (int)(base + (__ffs(m) - 1) - lo);
        break;
      }
    }
  }
  if (lane == 0) first[r] = out;
}

}  // namespace

extern "C" {

// One pass: launches tfd_first_kernel on `stream` over rows [row0,
// row0 + rows) and returns the launch's cudaError_t. Allocates nothing.
int tfd_first_warp_successor(const void* tf, int Q, long long d, long long k,
                        long long num_active, double thresh, long long row0,
                        int rows, void* first, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (Q < 1 || d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * Q * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tfd_first_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (rows + kWarps - 1) / kWarps;
  tfd_first_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)tf, Q, d, k, num_active, thresh, row0, rows,
      (int*)first);
  return (int)cudaGetLastError();
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
