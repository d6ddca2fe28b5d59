// The string embed's TFD novelty filter in one launch (kernel V1 of the
// port).
//
// Replaces no Pallas kernel: the JAX package's jitted scan
// tscode_tpu/ops/tfd.py _tfd_novelty_scan (:230, called from
// tfd_novelty_device, :302), a lax.scan over blocks of rows that carries
// a fixed-size cache of accepted fingerprints. The rule is sequential:
// in row order, row i is accepted (novel) iff it passes the accept mask
// and its wrapped-L1 distance to every earlier accepted row is at least
// `thresh`. The distance is summed in float64, torsion by torsion in
// index order (the float32 fingerprints widened exactly), each term
// |a - b|, or |d - 360| past 180: the sums of the native replay
// (tscode_tpu_torch/native/tfd_lru.cpp), stopped, as there, once the
// partial sum reaches thresh (terms are nonnegative, so the decision is
// the same).
//
// One cooperative grid of the card's resident blocks walks the rows in
// tiles of min(`block`, NOV_TILE) rows (the rule's result does not depend
// on the tile); for each tile:
//
// 1. every warp of the grid takes rows of the tile in turn and compares
//    its row with the accepted cache, its lanes on 32 entries at a time,
//    stopping at the first hit. A row that passes the mask and that no
//    entry rejects is undecided: its novel byte is set, it is counted and
//    its bit set in the tile's bit mask (a rejected or masked row's byte
//    is cleared).
// 2. a grid barrier; the U undecided rows are listed in order (each block
//    lists them in shared memory from the bit mask), and every warp of
//    the grid takes rows k of the list in turn and compares row k with
//    each later listed row m, its lanes on 32 of them at a time, writing
//    the bits "m lies within thresh of k" (m > k) to a U x ceil(U / 32)
//    bit matrix in device memory; then a grid barrier. Up to SOLO_ROWS
//    undecided rows, warp 0 of block 0 pairs them alone and there is no
//    barrier.
// 3. warp 0 of block 0 resolves the list in order with no distance left
//    to sum: a bit set of the listed rows that an accepted row rejects,
//    empty at first; the next row not in it is accepted (appended to the
//    cache) and its bit row ORed into the set, so a rejected row costs a
//    bit test and an accepted one a read of its bit row. The rows left in
//    the set get their bytes cleared.
// 4. a grid barrier; every block copies the entries added in step 3 into
//    its shared-memory copy of the cache, and the next tile starts.
//
// The cache (cache_cap x Q float64) is appended in acceptance order in
// device memory; each block holds its first `staged` entries in shared
// memory (odd row stride, so the lanes' entries meet no bank conflict)
// and reads the rest from L2 (ld.global.cg: the entries are written
// during the launch). When a row would be accepted past cache_cap the
// launch stops with ok = 0 (the JAX package's contract: the caller then
// runs the host replay).
//
// What bounds it: the terms that the walked comparisons sum (each
// comparison up to its first hit, each sum up to the torsion where it
// reaches thresh, all Q for a similar pair), four float64 operations a
// term (the difference, its magnitude, the wrap, the sum); step 2 sums
// the pairs of a tile's undecided rows that the sequential rule would
// skip, in parallel, so that step 3's walk is bit tests; on sn2_string's
// 371,822 rows a few hundred grid barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NOV_THREADS 256
#define NOV_TILE 4096
#define SOLO_ROWS 64
#define STATIC_SMEM (48 * 1024)
#define MAX_DEVICES 64

namespace {

const unsigned FULL = 0xffffffffu;

// the cache entry c, torsion q: shared memory for the first `staged`
// entries, else device memory through L2
__device__ __forceinline__ double entry(const double* s_cache, int Qs,
                                        int staged, const double* cache,
                                        int Q, int c, int q) {
  return c < staged ? s_cache[(size_t)c * Qs + q]
                    : __ldcg(cache + (size_t)c * Q + q);
}

// the wrapped-L1 term of torsion values a, b (float64)
__device__ __forceinline__ double term(double a, double b) {
  double d = fabs(__dsub_rn(a, b));
  if (d > 180.0) d = fabs(__dsub_rn(d, 360.0));
  return d;
}

// the row (Q float64 values) lies within thresh of entry c
__device__ __forceinline__ bool similar(const double* row,
                                        const double* s_cache, int Qs,
                                        int staged, const double* cache,
                                        int Q, int c, double thresh) {
  double s = 0.0;
  for (int q = 0; q < Q; ++q) {
    s = __dadd_rn(s, term(row[q], entry(s_cache, Qs, staged, cache, Q, c,
                                        q)));
    if (s >= thresh) return false;
  }
  return s < thresh;
}

// the row lies within thresh of the fingerprint f (Q float32, widened);
// |a - b| is |b - a| to the bit, so the sum is the one the rule makes
__device__ __forceinline__ bool similar_fp(const double* row,
                                           const float* f, int Q,
                                           double thresh) {
  double s = 0.0;
  for (int q = 0; q < Q; ++q) {
    s = __dadd_rn(s, term(row[q], (double)__ldg(f + q)));
    if (s >= thresh) return false;
  }
  return s < thresh;
}

// one warp: does any entry of [c0, c1) lie within thresh of the row?
__device__ __forceinline__ bool any_similar(const double* row,
                                            const double* s_cache, int Qs,
                                            int staged, const double* cache,
                                            int Q, int c0, int c1,
                                            double thresh, int lane) {
  for (int c = c0; c < c1; c += 32) {
    const bool hit = c + lane < c1 && similar(row, s_cache, Qs, staged,
                                              cache, Q, c + lane, thresh);
    if (__any_sync(FULL, hit)) return true;
  }
  return false;
}

// one warp: the set bits of bits[0, W) as a list of their indices in
// order
__device__ __forceinline__ void list_bits(const unsigned* bits, int W,
                                          unsigned short* list, int lane) {
  int base = 0;
  for (int w0 = 0; w0 < W; w0 += 32) {
    unsigned b = w0 + lane < W ? __ldcg(bits + w0 + lane) : 0u;
    const int n = __popc(b);
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    int at = base + incl - n;
    while (b) {
      list[at++] = (unsigned short)(32 * (w0 + lane) + __ffs(b) - 1);
      b &= b - 1;
    }
    base += __shfl_sync(FULL, incl, 31);
  }
  __syncwarp();
}

// warps w0, w0 + stride, ... : for each listed row k of the tile (its
// values into the warp's row slot), the bits of the later listed rows m
// within thresh of it, into sim[k * Wu + m / 32]
__device__ __forceinline__ void pair_rows(const float* fps, long long lo,
                                          int Q, double thresh,
                                          const unsigned short* list, int U,
                                          unsigned* sim, double* row,
                                          long long w0, long long stride,
                                          int lane) {
  const int Wu = (U + 31) >> 5;
  for (long long k = w0; k < U; k += stride) {
    const float* fk = fps + (lo + list[k]) * Q;
    for (int q = lane; q < Q; q += 32) row[q] = (double)fk[q];
    __syncwarp();
    for (int w = (int)(k >> 5); w < Wu; ++w) {
      const int m = 32 * w + lane;
      const bool hit = m > k && m < U &&
                       similar_fp(row, fps + (lo + list[m]) * Q, Q, thresh);
      const unsigned b = __ballot_sync(FULL, hit);
      if (lane == 0) sim[k * Wu + w] = b;
    }
    __syncwarp();   // every lane is done with the row
  }
}

__global__ void __launch_bounds__(NOV_THREADS)
    tfd_novelty_kernel(const float* __restrict__ fps,
                       const unsigned char* __restrict__ accept, long long B,
                       int Q, double thresh, int tile, int cache_cap,
                       int staged, double* __restrict__ cache,
                       unsigned char* __restrict__ novel,
                       int* __restrict__ state, unsigned* __restrict__ bits) {
  extern __shared__ __align__(16) double s_mem[];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int Qs = Q | 1;
  double* s_cache = s_mem;
  double* row = s_mem + (size_t)staged * Qs + (size_t)warp * Q;
  unsigned short* s_list = reinterpret_cast<unsigned short*>(
      s_mem + (size_t)staged * Qs + (size_t)W * Q);
  unsigned* s_rej = reinterpret_cast<unsigned*>(s_list + ((tile + 1) & ~1));
  unsigned* sim = bits + 2 * (NOV_TILE / 32);
  const long long gwarp = (long long)blockIdx.x * W + warp;
  const long long nwarps = (long long)gridDim.x * W;
  const bool lead = blockIdx.x == 0 && warp == 0;
  int count = 0;   // the accepted rows, the same in every thread
  int t = 0;       // the tile's parity picks its bit mask and counter
  for (long long lo = 0; lo < B; lo += tile, t ^= 1) {
    const long long hi = lo + tile < B ? lo + tile : B;
    unsigned* ubits = bits + t * (NOV_TILE / 32);
    // 1. the tile's rows against the cache of the earlier tiles
    for (long long r = lo + gwarp; r < hi; r += nwarps) {
      bool und = accept == nullptr || accept[r] != 0;
      if (und && count > 0) {
        for (int q = lane; q < Q; q += 32) row[q] = (double)fps[r * Q + q];
        __syncwarp();
        und = !any_similar(row, s_cache, Qs, staged, cache, Q, 0, count,
                           thresh, lane);
        __syncwarp();   // every lane is done with the row
      }
      if (lane == 0) {
        novel[r] = und;
        if (und) {
          atomicAdd(state + 2 + t, 1);
          atomicOr(ubits + ((r - lo) >> 5), 1u << ((r - lo) & 31));
        }
      }
    }
    grid.sync();
    // 2. the undecided rows' bit matrix, on every warp or on warp 0
    const int U = __ldcg(state + 2 + t);
    const int Wn = (int)((hi - lo + 31) >> 5);
    if (U > SOLO_ROWS) {
      if (warp == 0) list_bits(ubits, Wn, s_list, lane);
      __syncthreads();
      pair_rows(fps, lo, Q, thresh, s_list, U, sim, row, gwarp, nwarps,
                lane);
      grid.sync();
    } else if (lead && U > 0) {
      list_bits(ubits, Wn, s_list, lane);
      pair_rows(fps, lo, Q, thresh, s_list, U, sim, row, 0, 1, lane);
    }
    // 3. the list resolved in order on warp 0 of block 0
    const int start = count;
    if (lead) {
      const int Wu = (U + 31) >> 5;
      for (int w = lane; w < Wu; w += 32) s_rej[w] = 0u;
      __syncwarp();
      bool over = false;   // the same in every lane
      for (int k = 0; k < U; ++k) {
        // the next listed row that no accepted row rejects
        unsigned open = ~s_rej[k >> 5] & (FULL << (k & 31));
        while (!open && (k >> 5) + 1 < Wu) {
          k = ((k >> 5) + 1) << 5;
          open = ~s_rej[k >> 5];
        }
        if (!open) break;
        k = (k & ~31) + __ffs(open) - 1;
        if (k >= U) break;
        if (count == cache_cap) {
          over = true;
          break;
        }
        const float* fk = fps + (lo + s_list[k]) * Q;
        for (int q = lane; q < Q; q += 32) {
          const double v = (double)fk[q];
          cache[(size_t)count * Q + q] = v;
          if (count < staged) s_cache[(size_t)count * Qs + q] = v;
        }
        for (int w = (k >> 5) + lane; w < Wu; w += 32)
          s_rej[w] |= __ldcg(sim + (size_t)k * Wu + w);
        ++count;
        __syncwarp();   // the set is whole again
      }
      if (!over)
        for (int k = lane; k < U; k += 32)
          if (s_rej[k >> 5] >> (k & 31) & 1u) novel[lo + s_list[k]] = 0;
      // the next tile's mask and counter (last read a tile ago) cleared
      unsigned* next = bits + (t ^ 1) * (NOV_TILE / 32);
      for (int w = lane; w < NOV_TILE / 32; w += 32) next[w] = 0u;
      if (lane == 0) {
        state[0] = over ? cache_cap + 1 : count;
        state[1] = !over;
        state[2 + (t ^ 1)] = 0;
      }
    }
    grid.sync();
    const int now = __ldcg(state);
    if (!__ldcg(state + 1)) break;   // the same in every block
    // 4. the new entries into this block's shared copy
    if (blockIdx.x != 0) {
      const int s0 = start < staged ? start : staged;
      const int s1 = now < staged ? now : staged;
      for (int e = threadIdx.x; e < (s1 - s0) * Q; e += blockDim.x) {
        const int c = s0 + e / Q, q = e % Q;
        s_cache[(size_t)c * Qs + q] = __ldcg(cache + (size_t)c * Q + q);
      }
    }
    count = now;
    __syncthreads();
  }
}

// the block's dynamic shared bytes: the staged entries, a row a warp, the
// list of a tile's undecided rows and its rejected set
size_t smem_bytes(int Q, int staged, int tile) {
  return ((size_t)staged * (Q | 1) + (size_t)(NOV_THREADS / 32) * Q) *
             sizeof(double) +
         (size_t)((tile + 1) & ~1) * sizeof(unsigned short) +
         (size_t)((tile + 31) / 32) * sizeof(unsigned);
}

long long g_optin[MAX_DEVICES];

}  // namespace

extern "C" {

// fps (B, Q) float32; accept (B,) bool or null; cache (cache_cap, Q)
// float64 scratch; novel (B,) bool out; state (4,) int32, zeros but
// state[1] = 1 on entry; out: the accepted rows (cache_cap + 1 after an
// overflow), ok, and the tiles' undecided-row counters (0 after the
// launch); bits, int32 scratch of 2 NOV_TILE / 32 + tile ceil(tile / 32)
// words (tile = min(block, NOV_TILE)), its first 2 NOV_TILE / 32 words
// (the tiles' bit masks) zeros on entry. The grid: every block that
// stays resident, no more than the warps a tile needs.
int tfd_novelty_f64(const void* fps, const void* accept, long long B, int Q,
                    double thresh, int block, int cache_cap, int staged,
                    void* cache, void* novel, void* state, void* bits,
                    long long smem, void* stream) {
  if (B <= 0) return 0;
  if (Q <= 0 || block <= 0 || cache_cap < 0 || staged < 0 ||
      staged > cache_cap)
    return (int)cudaErrorInvalidValue;
  int tile = block < NOV_TILE ? block : NOV_TILE;
  if ((size_t)smem != smem_bytes(Q, staged, tile))
    return (int)cudaErrorInvalidValue;
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > STATIC_SMEM && g_optin[dev] < smem) {
    err = (int)cudaFuncSetAttribute(
        tfd_novelty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
    g_optin[dev] = smem;
  }
  int sms = 0, per = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, tfd_novelty_kernel, NOV_THREADS, (size_t)smem);
  if (err) return err;
  long long most = (long long)sms * per;
  if (most <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long rows = tile < B ? tile : B;
  const long long need = (rows + NOV_THREADS / 32 - 1) / (NOV_THREADS / 32);
  const long long grid = need < most ? need : most;
  const float* f = static_cast<const float*>(fps);
  const unsigned char* a = static_cast<const unsigned char*>(accept);
  double* c = static_cast<double*>(cache);
  unsigned char* n = static_cast<unsigned char*>(novel);
  int* s = static_cast<int*>(state);
  unsigned* b = static_cast<unsigned*>(bits);
  void* args[] = {&f, &a, &B, &Q, &thresh, &tile, &cache_cap, &staged,
                  &c, &n, &s, &b};
  err = (int)cudaLaunchCooperativeKernel(
      (const void*)tfd_novelty_kernel, dim3((unsigned)grid),
      dim3(NOV_THREADS), args, (size_t)smem,
      static_cast<cudaStream_t>(stream));
  if (err) return err;
  return (int)cudaGetLastError();
}

// out: registers a thread, local (spilled) bytes a thread, resident
// blocks an SM at `smem` shared bytes
int tfd_novelty_info(long long smem, int* out) {
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, tfd_novelty_kernel);
  if (err) return err;
  if (smem > STATIC_SMEM)
    err = (int)cudaFuncSetAttribute(
        tfd_novelty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
  if (err) return err;
  int per = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, tfd_novelty_kernel, NOV_THREADS, (size_t)smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per;
  return err;
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
