// First similar successor of every row of a TFD prune pass (kernel T1 of
// the port): one launch covers every chunk of one pass of the bucketed
// TFD prune.
//
// Replaces no Pallas kernel. It replaces the JAX package's jitted tile
// program tscode_tpu/ops/tfd.py:75 (_tfd_sim_tile, over _tfd_delta_tile
// at :61, a lax.scan over the torsions) and the host tile loop that
// drives it, _first_similar_successor (:87), which prune_conformers_tfd
// calls once a chunk: a (512, 4096) tile at a time, each tile read on
// the host. Here the whole pass is one launch and one read.
//
// Interface: the fingerprints tf (n, Q) float32, row-major, n the
// ORIGINAL ensemble size (the prune never compacts them); the pass:
// d = n // k, k and num_active, the active count at the pass's start;
// thresh; the rows [row0, row0 + rows) to decide (a shard's slice, or
// all n). Output first (rows,) int32: for row i, the chunk-relative
// index of the smallest j > i in i's chunk whose wrapped-L1 distance to
// i is < thresh, or -1.
//
// Chunks, as the reference cuts them: row i lies in step = min(i / d,
// k - 1), lo = d * step, hi = d * (step + 1), except that the last step
// ends at num_active. So chunks before the last may run past num_active,
// the last may be empty, and rows past num_active in the last step lie
// in no chunk. Rows in no chunk, and chunks of one row or none, give -1.
//
// Arithmetic, as the plain twin does it (tscode_tpu_torch/ops/tfd.py
// wrapped_l1): acc = 0.0, then for q = 0, 1, ..., Q-1 in that order
// d = |(double)a_q - (double)b_q|, acc += min(d, |d - 360|); a hit is
// acc < thresh. There is no product, so no FMA contraction can change a
// bit: the result equals the twin's exactly.
//
// Bound on this card: operations. A pass walks, for each row, the pairs
// up to and including its first hit (all of the chunk after it when it
// has none); each pair is Q times ~6 float64 operations (two converts
// aside: subtract, abs, subtract, abs, min, add), at 34 TFLOP/s outside
// the tensor cores. csearch_string's prune (6,561 rows, Q = 8) walks
// 21.9M pairs over its 10 passes, ~1.05 G operations, ~0.03 ms in all;
// its k = 1 pass 10.1M pairs, ~0.014 ms. The bytes are the fingerprints
// (6,561 x 8 x 4 = 210 KB, read once, then from L2) and the output.
//
// Design, simple first: a warp a row. The row's Q values are converted
// to double once into the warp's slice of shared memory; the lanes take
// j = i+1+lane, i+33+lane, ... up to hi, 32 candidates a step, each
// lane summing its pair over the torsions; __ballot_sync on acc < thresh
// and __ffs of the ballot give the smallest hit of the step, and the
// warp stops there. So the early exit of the tile loop becomes exact
// and per row, and a row's walk costs ceil(walk / 32) warp steps. Any Q
// runs (a loop over q; the shared slice holds Q doubles a warp). No
// block barrier: a warp past the last row returns at once.

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
int tfd_first_successor(const void* tf, int Q, long long d, long long k,
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
