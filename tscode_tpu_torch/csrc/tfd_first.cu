// First similar successor of every row of a TFD prune pass (kernel T1 of
// the port): one launch covers every chunk of one pass of the bucketed
// TFD prune. The rows of a block walk shared-memory tiles of candidates
// together.
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
// all n); the plan (tile, segment, windows). Output
// first (rows,) int32: for row i, the chunk-relative index of the
// smallest j > i in i's chunk whose wrapped-L1 distance to i is <
// thresh, or -1.
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
// bit: the result equals the twin's and the first design's
// (tfd_first_warp.cu) exactly.
//
// Bound on this card: operations. A pass walks, for each row, the pairs
// up to and including its first hit (all of the chunk after it when it
// has none); each pair is Q times 4 float64 instructions (subtract,
// subtract with an absolute-value operand, min, add; the other absolute
// value is an operand modifier too), none of them an FMA, so the rate is
// the card's 17 T float64 instructions a second (the 34 TFLOP/s peak
// counts an FMA as two operations). csearch_string's k = 1 pass (4,936
// rows, Q = 8) walks 10.1M pairs: ~0.019 ms. The bytes are the
// fingerprints (6,561 x 8 x 4 = 210 KB) and the output.
//
// Design. The first design (a warp a row, each lane reading its
// candidate's Q floats at a Q * 4-byte stride and converting them every
// pair) read every row's chunk again through L1. Here a block of 8 warps
// takes 8 consecutive rows, a warp a row. It stages `tile` candidates
// (j0, j0 + tile) at a time in shared memory as double, converted once a
// tile and stored torsion-major (value q of candidate jj at q * (tile + 1)
// + jj: the lanes' reads of consecutive candidates fall in consecutive
// banks, and the transposing stores, tile + 1 apart, in distinct ones),
// filled by coalesced loads of the tile's contiguous Q * tile floats; the
// rows' own values sit beside it. Every warp walks its row, while live,
// over the tile, 32 candidates a step in order; __ballot_sync on acc <
// thresh and __ffs of the ballot give the row's smallest hit, and the row
// stops there; a row also stops at its chunk's end. The sum's loop over
// the torsions is unrolled for Q <= 8 and Q <= 32 (the same operations in
// the same order), and for Q <= 8 the row's own values sit in registers.
// So a candidate is read and converted once a block, not once a row, and
// each row's result is its exact first hit.
//
// Long walks. A row with no hit walks its whole chunk (4,936 candidates on
// csearch_string's k = 1 pass), one step after another: in one window
// the longest block took 1.7x the mean block's cycles and set the
// kernel's time (tools/kernel_phases.py, clock64 per block). So the walk
// is cut into windows of `segment` candidates, one block per (rows,
// window), all launched at once: window y starts at the block's first
// row + 1 + y segment. Each
// window finds its rows' first hit inside it, and the windows meet in an
// atomicMin on `first` (which holds -1, 0xffffffff unsigned, on entry):
// the smallest hit wins whatever the order, so two runs give the same
// bits. A window skips a row whose hit an earlier window has already
// written. With one window (chunks shorter than a segment) each row is
// written directly.
//
// Unstaged walk (tile = 0): each warp walks its rows on its own, reading
// the candidates from device memory as the first design did, 1,024 a
// window step, with no block barrier. The host takes it where a pass's
// chunks are short (2,048 rows or fewer: the staged tile's barriers and
// loads cost more than the reuse saves; on csearch_string's passes of k
// >= 5, chunks of up to 1,312 rows, it ran 9 to 26% faster, and 24 to 32%
// slower at k = 2 and 1) and where a tile of 32 candidates
// does not fit in shared memory beside the rows (Q past ~700): any Q
// runs.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "phases.cuh"

namespace {

constexpr int kWarps = 8;                 // warps a block

// the wrapped-L1 sum of rows a and b over Q torsions, q = 0, 1, ... in
// order: QCAP > 0 unrolls the loop over QCAP (>= Q) torsions, skipping
// q >= Q; the same operations in the same order either way. A is the
// row's values (an array the unrolled loop keeps in registers, or
// shared memory), b the candidate's, bstride apart (shared memory or tf)
template <int QCAP, typename RowT, typename CandT>
__device__ __forceinline__ double wrapped_l1(const RowT& a, const CandT* b,
                                             int bstride, int Q) {
  double acc = 0.0;
  if (QCAP) {
#pragma unroll
    for (int q = 0; q < QCAP; ++q) {
      if (q < Q) {
        const double dq = fabs((double)a[q] - (double)b[q * bstride]);
        acc += fmin(dq, fabs(dq - 360.0));
      }
    }
  } else {
    for (int q = 0; q < Q; ++q) {
      const double dq = fabs((double)a[q] - (double)b[q * bstride]);
      acc += fmin(dq, fabs(dq - 360.0));
    }
  }
  return acc;
}

// STAGED: candidates from the shared-memory tile, else from tf. Block
// (x, y) walks the candidates of its rows in window y: [w0, w0 +
// segment) with w0 = its first row + 1 + y segment (segment 0: one
// window to the end). TT_PHASES builds: a block's record of 4 slots, as
// its first warp sees them: cycles outside the tiles' loads and walks,
// loading tiles, walking them, tiles
template <bool STAGED, int QCAP>
__global__ void __launch_bounds__(kWarps * 32)
tfd_first_tile_kernel(const float* __restrict__ tf, int Q,
                      long long d, long long k, long long num_active,
                      double thresh, long long row0, int rows, int tile,
                      long long segment, int* __restrict__ first) {
  extern __shared__ double sm[];          // Q x (tile + 1), then the rows'
  const int warp = threadIdx.x >> 5;      // own values, kWarps x Q
  const int lane = threadIdx.x & 31;
  const int tp = tile + 1;
  double* cand = sm;
  double* a = sm + (size_t)Q * tp + warp * Q;
  const long long rb = (long long)blockIdx.x * kWarps;
  const long long r = rb + warp;
  const long long w0 = row0 + rb + 1 + (long long)blockIdx.y * segment;
  const long long w1 = segment ? w0 + segment : LLONG_MAX;
  TT_START(4);
  long long i = 0, lo = 0, hi = 0;
  int out = -1;
  bool live = false;
  if (r < rows) {
    i = row0 + r;
    const long long step = min(i / d, k - 1);
    lo = d * step;
    hi = step == k - 1 ? num_active : d * (step + 1);
    live = hi - lo > 1 && max(w0, i + 1) < min(w1, hi);
    if (STAGED && live)
      for (int q = lane; q < Q; q += 32) a[q] = (double)__ldg(tf + i * Q + q);
  }
  // the block's candidates end at its live rows' largest hi: a tile loads
  // no further (chunks of a few rows on the passes of large k)
  __shared__ long long warp_hi[kWarps];
  long long block_hi = 0;
  if (STAGED) {
    if (lane == 0) warp_hi[warp] = live ? hi : 0;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) block_hi = max(block_hi, warp_hi[w]);
  }
  // candidates a step of the walk: the tile, or 1,024 read from tf
  const int span = STAGED ? tile : 1024;
  for (long long j0 = w0; j0 < w1; j0 += span) {
    // a row whose hit an earlier window found (below this window) is
    // done here; a stale read only costs the walk
    if (blockIdx.y > 0 && live) {         // warp-uniform
      int v = 0;
      if (lane == 0) v = *reinterpret_cast<volatile int*>(first + r);
      v = __shfl_sync(0xffffffffu, v, 0);
      if (v >= 0 && v < w0 - lo) live = false;
    }
    // staged: the block walks together; unstaged: each warp on its own
    if (STAGED ? !__syncthreads_or(live) : !live) break;
    TT_LAP(0);
    if (STAGED) {
      // a live row's candidates lie below its hi <= block_hi, so
      // j0 < block_hi here
      const int m = (int)min((long long)tile, block_hi - j0) * Q;
      const float* src = tf + j0 * Q;
      for (int idx = threadIdx.x; idx < m; idx += kWarps * 32) {
        const int jj = idx / Q;
        cand[(idx - jj * Q) * tp + jj] = (double)__ldg(src + idx);
      }
      __syncthreads();
    }
    TT_LAP(1);
    TT_ADD(3, 1);
    if (live) {                           // warp-uniform
      const long long jlo = max(j0, i + 1);
      const long long jhi = min(min(j0 + span, w1), hi);
      // Q <= 8: the row's values in registers, read once a step (held
      // across the whole walk they made the staged and unstaged passes
      // 13 to 15% slower on an H100)
      double ar[QCAP == 8 ? 8 : 1];
      if (QCAP == 8) {
#pragma unroll
        for (int q = 0; q < (QCAP == 8 ? 8 : 0); ++q)
          ar[q] = q < Q ? (STAGED ? a[q] : (double)__ldg(tf + i * Q + q))
                        : 0.0;
      }
      for (long long base = jlo; base < jhi; base += 32) {
        const long long j = base + lane;
        bool hit = false;
        if (j < jhi) {
          double acc;
          if (QCAP == 8 && STAGED)
            acc = wrapped_l1<8>(ar, cand + (int)(j - j0), tp, Q);
          else if (QCAP == 8)
            acc = wrapped_l1<8>(ar, tf + j * Q, 1, Q);
          else if (STAGED)
            acc = wrapped_l1<QCAP>(a, cand + (int)(j - j0), tp, Q);
          else
            acc = wrapped_l1<0>(tf + i * Q, tf + j * Q, 1, Q);
          hit = acc < thresh;
        }
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (m) {
          out = (int)(base + (__ffs(m) - 1) - lo);
          live = false;
          break;
        }
      }
      if (jhi >= min(w1, hi)) live = false;
    }
    TT_LAP(2);
  }
  TT_LAP(0);
  TT_FLUSH(4, blockIdx.x + (long long)gridDim.x * blockIdx.y,
           threadIdx.x == 0);
  if (r < rows && lane == 0) {
    if (gridDim.y == 1)
      first[r] = out;
    else if (out >= 0)                    // min over the windows; first
      atomicMin(reinterpret_cast<unsigned*>(first + r),  // holds -1 =
                (unsigned)out);           // 0xffffffff, above any hit
  }
}

template <bool STAGED, int QCAP>
int launch(const void* tf, int Q, long long d, long long k,
           long long num_active, double thresh, long long row0, int rows,
           int tile, long long segment, int windows, void* first,
           cudaStream_t stream) {
  auto kernel = tfd_first_tile_kernel<STAGED, QCAP>;
  const size_t smem =
      STAGED ? ((size_t)Q * (tile + 1) + (size_t)kWarps * Q) * sizeof(double)
             : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps),
                  (unsigned)windows);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      (const float*)tf, Q, d, k, num_active, thresh, row0, rows, tile,
      segment, (int*)first);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass: launches tfd_first_tile_kernel on `stream` over rows [row0,
// row0 + rows) of tf (n, Q) and returns the launch's cudaError_t. tile:
// candidates a shared-memory tile (a multiple of 32), 0 for the unstaged
// walk; segment: candidates a window (a multiple of the walk's step),
// windows: how many (1 with segment 0: the whole walk; more: `first` must
// hold -1 on entry). Allocates nothing.
int tfd_first_successor(const void* tf, int Q, long long d,
                        long long k, long long num_active, double thresh,
                        long long row0, int rows, int tile,
                        long long segment, int windows, void* first,
                        void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int span = tile ? tile : 1024;
  if (Q < 1 || d < 1 || k < 1 || tile < 0 || tile % 32 != 0 ||
      (long long)tile * Q > INT_MAX || windows < 1 || windows > 65535 ||
      segment < 0 || segment % span != 0 || (windows > 1 && segment == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define T1_ARGS                                                             \
  tf, Q, d, k, num_active, thresh, row0, rows, tile, segment, windows,      \
      first, s
  if (!tile)
    return Q <= 8 ? launch<false, 8>(T1_ARGS) : launch<false, 0>(T1_ARGS);
  return Q <= 8    ? launch<true, 8>(T1_ARGS)
         : Q <= 32 ? launch<true, 32>(T1_ARGS)
                   : launch<true, 0>(T1_ARGS);
#undef T1_ARGS
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
