// Cross-fragment clash screen (kernels K1 and K2 of the port).
//
// Replaces the Pallas TPU kernels of tscode_tpu/ops/pallas/clash.py:
// clash_ok_traced (K1, pallas_call at :119, body _make_clash_kernel_dyn)
// and compenetration_mask_pallas (K2, _clash_call at :55, body
// _make_clash_kernel). Both compute, for each pose (B, N, 3), the number
// of listed (i, j) atom pairs with squared distance below thr^2, in
// difference form (dx*dx + dy*dy + dz*dz, thr^2 rounded in the working
// type), and accept the pose iff that number is <= max_clashes. The
// pair list is a runtime int32 (P, 2) array; any B, N and P and any
// list of distinct pairs are taken (the wrappers' static_pairs gives
// each pair once; a pair listed twice counts twice here).
//
// Two regimes, chosen in Python (ops/kernels/clash.clash_regime) by the
// pair count, each with its own entries per type:
//
// * clash_ok_f32/f64, one thread per pose, for small P (the headline and
//   sn2_string have P = 30). The pair list passes through shared memory
//   in tiles of at most PAIR_TILE pairs; a block's poses are staged in
//   shared memory when they fit beside a tile in 48 KB, else each thread
//   reads its own pose through L1. A thread stops at the first clash past
//   max_clashes, and the block leaves the tile loop once none of its
//   threads is counting (every thread reaches every barrier; the exit
//   test is a block-wide __syncthreads_or). Bound: device-memory bytes.
//   A pose is read once (N*3 values) and writes one byte, the pair loop
//   is ~9 flops per pair: at the headline (B = 415,872, N = 11, P = 30)
//   that is 55 MB in f32, ~17 us at 3.35 TB/s.
//
// * clash_ok_warp_f32/f64, one warp per pose, for large P (the
//   large_n_string grid: N = 148, P = 5,476; two 160-atom fragments:
//   N = 320, P = 25,600). Bound: issue rate. A warp spends about 20
//   instructions per 32 pairs (one packed pair word, six pose loads,
//   nine flops, a compare, a ballot, a popcount), and a pose that never
//   exits early costs P of those pair evaluations: about 52 M at
//   2,048 x 25,600 and 1.14 G at 207,936 x 5,476 in the worst case.
//   - Pair list: packed once per block as one 32-bit word per pair (two
//     16-bit atom indices, so N <= 65,535; the entry refuses more) in
//     dynamic shared memory, resident whole when it fits under the
//     card's opt-in limit (232,448 B less the pose slots, after
//     cudaFuncSetAttribute): 5,476 pairs take 21.9 KB, 25,600 take
//     102.4 KB. Past the limit it passes through in tiles with two block
//     barriers per tile, as in the thread regime.
//   - Poses: each warp owns one pose at a time in a shared-memory slot of
//     N*3*sizeof(T) bytes, double-buffered: the next pose is copied with
//     cp.async while the current one is scanned. The blocks are
//     persistent (as many as fit on the 132 SMs at once) and their warps
//     stride over the poses. The host picks the warps per block (16 down
//     to 1) that put the most warps on an SM, and drops to one slot per
//     warp when that lets every warp take at most one pose where two
//     slots would not. cp.async rather than cp.async.bulk (TMA): a pose
//     is a few hundred bytes to a few KB, its offset b*N*3*sizeof(T) is
//     a multiple of 16 only for some N (N = 11 in f32 is 132 B), and
//     cp.async takes 16-, 8- or 4-byte granules with no mbarrier: the
//     host picks the widest granule that divides the pose size and the
//     base address.
//   - Scan: lane l takes pairs l, l+32, ... (four 32-pair rows per step
//     for independent loads). Pairs are row-major (same i, consecutive
//     j), so a step reads one broadcast word x[3i] and 32 words x[3j]
//     at a stride of 3 words: no bank conflict in f32. In f64 each load
//     is two wavefronts (half-warps, 6-word stride, again conflict
//     free), the minimum for 256 bytes. Counting is
//     __popc(__ballot_sync(...)) into a count equal in every lane, so
//     the exit past max_clashes is warp-uniform: no divergence and no
//     block barrier per pose. Lane 0 writes the byte.
//   - No tensor cores: the inner dimension is 3 and every pair is a
//     gather, and the matmul expansion |a|^2 + |b|^2 - 2 a.b would round
//     differently from the difference form on which the exact float64
//     gates of the port rest.
//
// Crossover: the warp regime from P = 64 up (CLASH_WARP_MIN_PAIRS in
// ops/kernels/clash.py). Measured on an NVIDIA H100 80GB HBM3 at 700 W,
// 415,872 random f32 poses, both kernels forced: P = 30, thread 0.066 ms
// against warp 0.083 ms; P = 49 and 56, even (0.085 to 0.091 ms); P = 64,
// thread 0.269 ms against warp 0.086 ms. In f64 the warp kernel already
// wins at P = 30 (0.082 against 0.097 ms). PERF.md section 6 holds the
// full sweep.

#include <cuda_runtime.h>
#include <stdint.h>

#define PAIR_TILE 2048            // thread regime: pairs per tile (16 KB)
#define STATIC_SMEM (48 * 1024)   // no opt-in attribute needed below this
#define WARP_UNROLL 4             // warp regime: 32-pair rows per step
#define WARP_STEP (32 * WARP_UNROLL)
#define MAX_ATOMS_PACKED 65535    // two 16-bit indices per pair word

// ------------------------------------------------ thread-per-pose regime

template <typename T>
__global__ void clash_ok_kernel(const T* __restrict__ poses, long long B,
                                int N, const int* __restrict__ pairs,
                                int P, T thr2, int max_clashes,
                                unsigned char* __restrict__ out,
                                int tile, size_t tile_bytes,
                                int stage_poses) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_pairs = reinterpret_cast<int*>(smem);
  T* s_pose = reinterpret_cast<T*>(smem + tile_bytes);

  const long long b0 = (long long)blockIdx.x * blockDim.x;
  const long long left = B - b0;
  const int nb = left < blockDim.x ? (int)left : (int)blockDim.x;
  const int stride = N * 3;
  const T* src = poses + b0 * stride;
  if (stage_poses)
    for (int i = threadIdx.x; i < nb * stride; i += blockDim.x)
      s_pose[i] = src[i];

  const int tid = threadIdx.x;
  const T* x = stage_poses ? s_pose + tid * stride : src + tid * stride;
  bool active = tid < nb;
  int count = 0;

  for (int p0 = 0; p0 < P; p0 += tile) {
    // barrier: the poses are staged and the previous tile is consumed
    if (!__syncthreads_or(active)) break;
    const int np = P - p0 < tile ? P - p0 : tile;
    for (int i = tid; i < 2 * np; i += blockDim.x)
      s_pairs[i] = pairs[2 * p0 + i];
    __syncthreads();
    if (active) {
      for (int k = 0; k < np; ++k) {
        const int i = 3 * s_pairs[2 * k], j = 3 * s_pairs[2 * k + 1];
        const T dx = x[i] - x[j];
        const T dy = x[i + 1] - x[j + 1];
        const T dz = x[i + 2] - x[j + 2];
        const T d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < thr2 && ++count > max_clashes) {
          active = false;
          break;
        }
      }
    }
  }
  if (tid < nb) out[b0 + tid] = count <= max_clashes;
}

template <typename T>
static int launch_clash(const void* poses, long long B, int N,
                        const void* pairs, int P, T thr2, int max_clashes,
                        void* out, void* stream) {
  if (B <= 0) return 0;
  const int tile = P < PAIR_TILE ? (P > 0 ? P : 1) : PAIR_TILE;
  const size_t tile_bytes = ((size_t)2 * tile * sizeof(int) + 15) &
                            ~(size_t)15;
  int threads = 128;
  size_t pose_bytes = (size_t)threads * N * 3 * sizeof(T);
  while (tile_bytes + pose_bytes > STATIC_SMEM && threads > 32) {
    threads /= 2;
    pose_bytes = (size_t)threads * N * 3 * sizeof(T);
  }
  const int stage = tile_bytes + pose_bytes <= STATIC_SMEM;
  if (!stage) threads = 128;
  const size_t smem = tile_bytes + (stage ? pose_bytes : 0);
  const long long blocks = (B + threads - 1) / threads;
  clash_ok_kernel<T><<<(unsigned)blocks, threads, smem,
                       (cudaStream_t)stream>>>(
      (const T*)poses, B, N, (const int*)pairs, P, thr2, max_clashes,
      (unsigned char*)out, tile, tile_bytes, stage);
  return (int)cudaGetLastError();
}

// -------------------------------------------------- warp-per-pose regime

template <int G>
__device__ __forceinline__ void cp_async(unsigned char* dst,
                                         const unsigned char* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(G)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// one warp copies one pose of n_gran granules of G bytes
template <int G>
__device__ __forceinline__ void copy_pose(unsigned char* dst,
                                          const unsigned char* src,
                                          int n_gran, int lane) {
  for (int g = lane; g < n_gran; g += 32)
    cp_async<G>(dst + (size_t)g * G, src + (size_t)g * G);
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

// one warp counts the pairs of s_pairs[0, np) with d^2 < thr2 on the pose
// x (shared memory), adding to `count`; it stops once the count passes
// max_clashes. Every lane returns the same count.
template <typename T>
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
        const int i = 3 * (int)(w >> 16), j = 3 * (int)(w & 0xffffu);
        const T dx = x[i] - x[j];
        const T dy = x[i + 1] - x[j + 1];
        const T dz = x[i + 2] - x[j + 2];
        const T d2 = dx * dx + dy * dy + dz * dz;
        hit = d2 < thr2;
      }
      count += __popc(__ballot_sync(0xffffffffu, hit));
    }
    if (count > max_clashes) break;   // warp-uniform
  }
  return count;
}

// tile >= P: the pair list is resident and each warp walks its poses
// with `nbuf` slots (2: the next pose is in flight during the scan).
// tile < P: the list passes through in tiles; the block takes one pose
// per warp at a time, with two barriers per tile.
template <typename T, int G>
__global__ void clash_ok_warp_kernel(const T* __restrict__ poses,
                                     long long B, int N,
                                     const int* __restrict__ pairs, int P,
                                     T thr2, int max_clashes,
                                     unsigned char* __restrict__ out,
                                     int tile, size_t pair_bytes,
                                     size_t slot_bytes, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_pairs = reinterpret_cast<unsigned*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned char* slots = smem + pair_bytes +
                         (size_t)warp * nbuf * slot_bytes;
  const size_t pose_bytes = (size_t)N * 3 * sizeof(T);
  const int n_gran = (int)(pose_bytes / G);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(poses);
  const long long step = (long long)gridDim.x * n_warps;

  if (tile >= P) {
    long long b = (long long)blockIdx.x * n_warps + warp;
    if (b < B) copy_pose<G>(slots, src + b * pose_bytes, n_gran, lane);
    cp_async_commit();
    pack_pairs(s_pairs, pairs, 0, P);
    __syncthreads();   // the only block barrier: the pair list is packed
    for (int s = 0; b < B; b += step, s ^= 1) {
      const long long nb = b + step;
      const unsigned char* cur = slots + (nbuf == 2 ? s : 0) * slot_bytes;
      if (nbuf == 2) {
        if (nb < B)
          copy_pose<G>(slots + (s ^ 1) * slot_bytes, src + nb * pose_bytes,
                       n_gran, lane);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();   // every lane's granules of this pose have landed
      const int count = scan_pairs<T>(s_pairs, P,
                                      reinterpret_cast<const T*>(cur), thr2,
                                      0, max_clashes, lane);
      if (lane == 0) out[b] = count <= max_clashes;
      __syncwarp();   // every lane has read `cur` before it is refilled
      if (nbuf == 1 && nb < B) {
        copy_pose<G>(slots, src + nb * pose_bytes, n_gran, lane);
        cp_async_commit();
      }
    }
    cp_async_wait<0>();
    return;
  }

  const T* x = reinterpret_cast<const T*>(slots);
  for (long long b0 = (long long)blockIdx.x * n_warps; b0 < B; b0 += step) {
    const long long b = b0 + warp;
    bool active = b < B;
    if (active) copy_pose<G>(slots, src + b * pose_bytes, n_gran, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    int count = 0;
    for (int p0 = 0; p0 < P; p0 += tile) {
      // barrier: the previous tile is consumed by every warp
      if (!__syncthreads_or(active)) break;
      const int np = P - p0 < tile ? P - p0 : tile;
      pack_pairs(s_pairs, pairs, p0, np);
      __syncthreads();
      if (active) {
        count = scan_pairs<T>(s_pairs, np, x, thr2, count, max_clashes,
                              lane);
        active = count <= max_clashes;
      }
    }
    if (b < B && lane == 0) out[b] = count <= max_clashes;
  }
}

struct WarpPlan {
  int warps;          // warps per block
  int nbuf;           // pose slots per warp
  int blocks_per_sm;  // resident blocks per SM (occupancy)
  int tile;           // pairs per shared-memory tile (P: resident)
  long long blocks;   // grid size
  int granule;        // cp.async bytes per copy
  size_t smem;        // dynamic shared memory per block
};

static WarpPlan g_last_plan;

static size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

template <typename T>
static int launch_clash_warp(const void* poses, long long B, int N,
                             const void* pairs, int P, T thr2,
                             int max_clashes, void* out, void* stream) {
  typedef void (*Fn)(const T*, long long, int, const int*, int, T, int,
                     unsigned char*, int, size_t, size_t, int);
  if (B <= 0) return 0;
  if (N <= 0 || N > MAX_ATOMS_PACKED || P < 0)
    return (int)cudaErrorInvalidValue;

  const size_t pose_bytes = (size_t)N * 3 * sizeof(T);
  const uintptr_t addr = (uintptr_t)poses;
  const int G = (pose_bytes % 16 == 0 && addr % 16 == 0)  ? 16
                : (pose_bytes % 8 == 0 && addr % 8 == 0) ? 8
                                                         : 4;
  const Fn fn = G == 16  ? clash_ok_warp_kernel<T, 16>
                : G == 8 ? clash_ok_warp_kernel<T, 8>
                         : clash_ok_warp_kernel<T, 4>;

  // the plan depends only on (B, N, P, G) for this type: computed once
  // for each new key, so repeated launches pay no occupancy queries
  static long long key_B = -1;
  static int key_N = -1, key_P = -1, key_G = -1, key_dev = -1;
  static WarpPlan plan;
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (B != key_B || N != key_N || P != key_P || G != key_G ||
      dev != key_dev) {
    int n_sm = 0, optin = 0;
    if ((err = (int)cudaDeviceGetAttribute(
             &n_sm, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = (int)cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) ||
        (err = (int)cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)))
      return err;
    const size_t slot = align16(pose_bytes);
    const size_t resident = align16((size_t)4 * (P > 0 ? P : 1));
    WarpPlan best[3] = {};   // by nbuf (1, 2)
    for (int W = 16; W >= 1; W /= 2)
      for (int nbuf = 1; nbuf <= 2; ++nbuf) {
        const size_t smem = resident + (size_t)W * nbuf * slot;
        if (smem > (size_t)optin) continue;
        int occ = 0;
        if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &occ, fn, W * 32, smem)))
          return err;
        if (occ * W > best[nbuf].blocks_per_sm * best[nbuf].warps)
          best[nbuf] = WarpPlan{W, nbuf, occ, P, 0, G, smem};
      }
    const long long cap2 = (long long)n_sm * best[2].blocks_per_sm *
                           best[2].warps;
    const long long cap1 = (long long)n_sm * best[1].blocks_per_sm *
                           best[1].warps;
    if (best[2].warps && !(B > cap2 && B <= cap1))
      plan = best[2];
    else if (best[1].warps)
      plan = best[1];
    else {
      // tiled: one slot per warp, the rest of the opt-in limit for pairs
      plan = WarpPlan{};
      for (int W = 8; W >= 1 && !plan.warps; W /= 2) {
        const size_t slots = (size_t)W * slot;
        if (slots + (size_t)4 * WARP_STEP > (size_t)optin) continue;
        const int tile = (int)(((size_t)optin - slots) / 4) &
                         ~(WARP_STEP - 1);
        const size_t smem = (size_t)4 * tile + slots;
        int occ = 0;
        if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &occ, fn, W * 32, smem)))
          return err;
        if (occ) plan = WarpPlan{W, 1, occ, tile, 0, G, smem};
      }
      if (!plan.warps) return (int)cudaErrorInvalidValue;
    }
    const long long need = (B + plan.warps - 1) / plan.warps;
    const long long fill = (long long)n_sm * plan.blocks_per_sm;
    plan.blocks = need < fill ? need : fill;
    key_B = B, key_N = N, key_P = P, key_G = G, key_dev = dev;
  }
  g_last_plan = plan;
  fn<<<(unsigned)plan.blocks, plan.warps * 32, plan.smem,
       (cudaStream_t)stream>>>(
      (const T*)poses, B, N, (const int*)pairs, P, thr2, max_clashes,
      (unsigned char*)out, plan.tile,
      plan.tile >= P ? align16((size_t)4 * (P > 0 ? P : 1))
                     : (size_t)4 * plan.tile,
      align16(pose_bytes), plan.nbuf);
  return (int)cudaGetLastError();
}

extern "C" {

int clash_ok_f32(const void* poses, long long B, int N, const void* pairs,
                 int P, float thr2, int max_clashes, void* out,
                 void* stream) {
  return launch_clash<float>(poses, B, N, pairs, P, thr2, max_clashes, out,
                             stream);
}

int clash_ok_f64(const void* poses, long long B, int N, const void* pairs,
                 int P, double thr2, int max_clashes, void* out,
                 void* stream) {
  return launch_clash<double>(poses, B, N, pairs, P, thr2, max_clashes, out,
                              stream);
}

int clash_ok_warp_f32(const void* poses, long long B, int N,
                      const void* pairs, int P, float thr2, int max_clashes,
                      void* out, void* stream) {
  return launch_clash_warp<float>(poses, B, N, pairs, P, thr2, max_clashes,
                                  out, stream);
}

int clash_ok_warp_f64(const void* poses, long long B, int N,
                      const void* pairs, int P, double thr2,
                      int max_clashes, void* out, void* stream) {
  return launch_clash_warp<double>(poses, B, N, pairs, P, thr2, max_clashes,
                                   out, stream);
}

// the plan of the last warp-regime launch: warps per block, slots per
// warp, blocks per SM, pairs per tile, blocks, granule bytes, shared
// memory bytes
int clash_warp_last_plan(long long* out) {
  const WarpPlan& p = g_last_plan;
  out[0] = p.warps, out[1] = p.nbuf, out[2] = p.blocks_per_sm;
  out[3] = p.tile, out[4] = p.blocks, out[5] = p.granule;
  out[6] = (long long)p.smem;
  return 0;
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
