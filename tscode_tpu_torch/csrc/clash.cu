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
// pair count and the pose size, each with its own entries per type, and
// the search's back-off entry:
//
// * clash_ok_f32/f64, one thread per pose, for small P (the headline and
//   sn2_string have P = 30, K2's chelotropic stage 36): the ring kernel.
//   Bound: device-memory bytes. A pose is read once (N*3 values) and
//   writes one byte, the pair loop is ~9 flops per pair: at the headline
//   (B = 415,872, N = 11, P = 30) that is 55 MB in f32, 16.5 us at
//   3.35 TB/s. The v1 kernel (clash_ok_v1_f32/f64, the first thread
//   kernel, kept below as the yardstick and for poses too large for the
//   ring) reached a third of it: each non-persistent block staged
//   its 128 poses with scalar loads, then its pair list, behind a
//   barrier, before any compute, so no block overlapped its copy with
//   its scan and the 3,249 blocks ran in about two waves with a tail
//   (0.0568 ms against the ring's 0.0284 on 415,872 random f32 poses).
//   - Persistent blocks of T = 128 threads (as many as fit on the 132
//     SMs: 6 a SM with 2 stages at N = 11 in f32), each walking tiles of
//     T poses (tiles b, b + gridDim.x, ...).
//   - A ring of `stages` shared-memory stages, each with its own
//     mbarrier (count blockDim.x: every thread arrives once a tile). A
//     tile whose global start is 16-byte aligned and whose size is a
//     multiple of 16 is one TMA bulk copy (cp.async.bulk ...
//     complete_tx, issued by thread 0 with arrive.expect_tx); T = 128
//     makes every whole tile a multiple of 16 bytes. A base off the
//     16-byte grid (a slice of a larger tensor, e.g. poses[1:] at N = 11
//     in f32: 132 B) or a ragged last tile is the granule path: every
//     thread copies 8- or 4-byte granules with cp.async and arrives
//     through cp.async.mbarrier.arrive.noinc. Tiles k+1 .. k+stages-1
//     are in flight while tile k is scanned; one block barrier a tile
//     frees its stage. The kernel counts the tiles of each path.
//   - The pair list, one 32-bit word per pair as in the warp regime,
//     stays resident in shared memory; one thread per pose scans it from
//     the staged tile in the same difference form, keeping atom i's
//     coordinates while consecutive pairs share it (pairs are
//     row-major), and stops past max_clashes. Results are written
//     coalesced, one byte a pose.
//   - Measured (chip_smoke.py --k1, NVIDIA H100 80GB HBM3, 700 W, 415,872
//     random poses, P = 30 at N = 11): 2 stages beat 3 and 4 (f32 0.0282
//     / 0.0287 / 0.0310 ms; more stages put fewer blocks on an SM), tiles
//     of 64, 128 and 256 within 3%. The granule path costs 1.2x (f32
//     0.0350 ms) to 1.3x (f64, N = 15: 0.0926 against 0.0726) the bulk
//     path. On the headline's own poses the ring takes 0.0275 ms (60% of
//     the 0.0165 ms bound), the v1 kernel 0.0517 (chip_smoke.py phase 5).
//   - Bank conflicts: a pose stride of 3N values puts gcd(3N, 32)
//     threads of a warp (gcd(3N, 16) of a half-warp in f64) on one bank:
//     4-way at N = 12, 8-way at N = 8, 16-way at N = 16. Padded slots
//     (an odd stride, one cp.async granule a value) were measured and
//     left out: at N = 12, the one even N a route sends (chelotropic),
//     they cost more than the 4-way conflict (f32 0.0486 against 0.0396
//     ms); they paid only at N = 8 and 16 (f64 0.0365 against 0.0560;
//     f32 0.0729 against 0.1227), which no route sends.
//   - Poses too large for a ring of two 32-pose stages (N > 151 in f64,
//     302 in f32, fewer with a long pair list) go to the v1 kernel: a
//     tile of less than one warp would leave most of a block idle.
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
// * torsion_backoff_f64, the conformer search's 5-degree back-off of
//   one torsion for every candidate in one launch (the port's per-step
//   loop made one K1 launch and ~12 PyTorch ops a retreat step, 0.41 to
//   0.65 ms a step against K1's 0.0058 ms: the launch floor, which no
//   faster per-step kernel closes). One warp per candidate, its pose in
//   shared memory; per step the moved atoms are rebuilt from the
//   torsion's Rodrigues terms (computed once in PyTorch) with the
//   rounding order of PyTorch's separate kernels (__dmul_rn / __dadd_rn,
//   no FMA contraction; cos and sin from libdevice), then K1's pair scan
//   (scan_pairs) decides; the first clash-free step is kept. The terms
//   are read only for the moved atoms. Bound: the function's bytes, the
//   pose and the angle read once, the frame and the flag written once
//   (2 x 24 N + 9 bytes a candidate); the step operations weigh less.
//
// Crossover: the warp regime from CLASH_WARP_MIN_PAIRS pairs up
// (ops/kernels/clash.py), from chip_smoke.py phase 3's sweep on an
// NVIDIA H100 80GB HBM3 at 700 W, 415,872 random poses, ring / warp /
// v1 kernel ms: f64 P = 30 0.0456 / 0.0800 / 0.0949 (the v1 kernel
// lost to the warp kernel already at P = 30), P = 56 0.0731 / 0.0910 /
// 0.1799, P = 64 (N = 16) 0.2189 / 0.0854; f32 P = 30 0.0287 / 0.0781 /
// 0.0571, P = 56 0.0431 / 0.0866 / 0.0837, P = 64 (N = 16) 0.1227 /
// 0.0817, P = 144 0.1538 / 0.1007 / 0.2964. Both types cross between 56
// and 64. At P = 75 the ring leads on 415,872 poses (f64 0.0929 /
// 0.1003) but not on small batches (81 to 972 poses: 0.0096 against
// 0.0034 ms), so the warp regime starts at 64 in both types. PERF.md
// section 6 holds the sweep.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clash_scan.cuh"

#define PAIR_TILE 2048            // v1 kernel: pairs per tile (16 KB)
#define STATIC_SMEM (48 * 1024)   // no opt-in attribute needed below this
#define RING_MAX_STAGES 4         // thread regime: shared-memory stages
#define RING_BAR_BYTES 32         // RING_MAX_STAGES mbarriers of 8 bytes
#define MAX_DEVICES 64            // per-card opt-in bookkeeping

static size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Raise a kernel's dynamic shared memory limit to `bytes` on the current
// card, once per (kernel, card, larger size): the attribute is per card.
template <typename Fn>
static int opt_in_smem(Fn fn, long long bytes, long long* done) {
  if (bytes <= STATIC_SMEM) return 0;
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return 0;
  err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err) done[dev] = bytes;
  return err;
}

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

// ------------------------------------- thread-per-pose regime (the ring)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// the arrival of this thread, once every cp.async it issued has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Every thread of the block calls this for one tile, and every thread
// arrives on the stage's barrier exactly once (its count is blockDim.x):
// the bulk path's elected thread with the tile's byte count, the others
// plainly; on the granule path each thread once its cp.async granules
// have landed. Returns 1 for a bulk tile, 0 for a granule tile.
template <typename T>
__device__ __forceinline__ int load_tile(unsigned char* stage,
                                         uint64_t* bar,
                                         const unsigned char* src, int np,
                                         int N) {
  const unsigned pose_bytes = (unsigned)N * 3 * sizeof(T);
  const unsigned bytes = (unsigned)np * pose_bytes;
  const uintptr_t a = (uintptr_t)src;
  if (a % 16 == 0 && bytes % 16 == 0) {
    if (threadIdx.x == 0) {
      // the stage was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_expect_tx(bar, bytes);
      bulk_copy(stage, src, bytes, bar);
    } else {
      mbar_arrive(bar);
    }
    return 1;
  }
  // a base or a ragged last tile off the 16-byte grid
  if (a % 8 == 0 && bytes % 8 == 0) {
    for (unsigned g = threadIdx.x; g < bytes / 8; g += blockDim.x)
      cp_async<8>(stage + (size_t)g * 8, src + (size_t)g * 8);
  } else {
    for (unsigned g = threadIdx.x; g < bytes / 4; g += blockDim.x)
      cp_async<4>(stage + (size_t)g * 4, src + (size_t)g * 4);
  }
  mbar_arrive_cp_async(bar);
  return 0;
}

// Persistent blocks of `tile` threads walk tiles of `tile` poses: block
// b takes tiles b, b + gridDim.x, ... A ring of `stages` shared-memory
// stages holds the next tiles in flight while one is scanned; one thread
// per pose scans the block's resident pair list.
template <typename T>
__global__ void clash_ok_ring_kernel(const T* __restrict__ poses,
                                     long long B, int N,
                                     const int* __restrict__ pairs, int P,
                                     T thr2, int max_clashes,
                                     unsigned char* __restrict__ out,
                                     int stages, size_t pair_bytes,
                                     size_t stage_bytes,
                                     unsigned long long* tile_paths) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned* s_pairs = reinterpret_cast<unsigned*>(smem + RING_BAR_BYTES);
  unsigned char* ring = smem + RING_BAR_BYTES + pair_bytes;
  const int tile = blockDim.x, tid = threadIdx.x;
  const long long n_tiles = (B + tile - 1) / tile;
  const long long mine = (long long)blockIdx.x < n_tiles
                             ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1
                             : 0;
  const size_t pose_bytes = (size_t)N * 3 * sizeof(T);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(poses);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  pack_pairs(s_pairs, pairs, 0, P);
  __syncthreads();   // barriers initialised, the pair list packed

  unsigned long long n_bulk = 0, n_gran = 0;
  auto issue = [&](long long k) {
    const long long t = blockIdx.x + k * gridDim.x, p0 = t * tile;
    const int np = B - p0 < tile ? (int)(B - p0) : tile;
    const int s = (int)(k % stages);
    if (load_tile<T>(ring + (size_t)s * stage_bytes, &bars[s],
                     src + p0 * pose_bytes, np, N))
      ++n_bulk;
    else
      ++n_gran;
  };
  for (long long k = 0; k < stages - 1 && k < mine; ++k) issue(k);
  for (long long k = 0; k < mine; ++k) {
    // stage (k + stages - 1) % stages was freed by the last barrier
    if (k + stages - 1 < mine) issue(k + stages - 1);
    const int s = (int)(k % stages);
    mbar_wait(&bars[s], (unsigned)((k / stages) & 1));
    const long long p0 = (blockIdx.x + k * gridDim.x) * tile;
    if (p0 + tid < B) {
      const T* x = reinterpret_cast<const T*>(ring + (size_t)s * stage_bytes)
                   + (size_t)tid * N * 3;
      int count = 0, last = -1;
      T xi = 0, yi = 0, zi = 0;
      for (int k2 = 0; k2 < P; ++k2) {
        const unsigned w = s_pairs[k2];
        const int i = 3 * (int)(w >> 16), j = 3 * (int)(w & 0xffffu);
        if (i != last) {   // pairs are row-major: block-uniform
          xi = x[i], yi = x[i + 1], zi = x[i + 2];
          last = i;
        }
        const T dx = xi - x[j];
        const T dy = yi - x[j + 1];
        const T dz = zi - x[j + 2];
        const T d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < thr2 && ++count > max_clashes) break;
      }
      out[p0 + tid] = count <= max_clashes;
    }
    __syncthreads();   // every thread is done with stage s
  }
  if (tid == 0 && tile_paths != nullptr && mine > 0) {
    atomicAdd(&tile_paths[0], n_bulk);
    atomicAdd(&tile_paths[1], n_gran);
  }
}

static long long g_ring_optin[2][MAX_DEVICES];

template <typename T>
static int launch_clash_ring(const void* poses, long long B, int N,
                             const void* pairs, int P, T thr2,
                             int max_clashes, void* out, void* stream,
                             int tile, int stages, long long blocks,
                             long long smem, void* tile_paths) {
  if (B <= 0) return 0;
  if (N <= 0 || N > MAX_ATOMS_PACKED || P < 0 || tile <= 0 ||
      tile > 1024 || stages < 2 || stages > RING_MAX_STAGES || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t pair_bytes = align16((size_t)4 * P);
  const size_t stage_bytes = align16((size_t)tile * N * 3 * sizeof(T));
  if ((size_t)smem != RING_BAR_BYTES + pair_bytes + stages * stage_bytes)
    return (int)cudaErrorInvalidValue;
  const auto fn = clash_ok_ring_kernel<T>;
  int err = opt_in_smem(fn, smem, g_ring_optin[sizeof(T) == 8]);
  if (err) return err;
  fn<<<(unsigned)blocks, tile, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)poses, B, N, (const int*)pairs, P, thr2, max_clashes,
      (unsigned char*)out, stages, pair_bytes, stage_bytes,
      (unsigned long long*)tile_paths);
  return (int)cudaGetLastError();
}

// ------------------------- thread-per-pose regime, the v1 kernel (kept)

// The yardstick the ring kernel is timed against, and the kernel of
// poses too large for its ring (any N and P): non-persistent blocks
// of up to 128 threads, each staging its poses with scalar loads, then
// the pair list in tiles of PAIR_TILE behind block barriers, the poses
// read in place (through L1) when they do not fit in 48 KB. Reached
// through clash_ok_v1_f32/f64.
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

// ------------------------------------------ the search's back-off entry

#define BACKOFF_STEP 5.0          // degrees a retreat step takes back
// the constant of ATen's deg2rad (pi / 180 rounded to a double)
#define DEG2RAD 0.017453292519943295769236907684886127134428718885417

// One warp per candidate b: the candidate's pose in shared memory; for
// s = 0 ... max_steps, while eff = angle - 5 s >= 0, the moved atoms at
// step s (the Rodrigues terms fixed + across cos + turned sin, each
// operation rounded on its own as PyTorch's separate kernels round it),
// then K1's pair scan (scan_pairs) of the `other x move` list; the first
// clash-free step is kept. Angle-0 rows stay as they are and count as
// not rotated.
template <typename T>
__global__ void torsion_backoff_kernel(
    const T* __restrict__ coords, const T* __restrict__ fixed,
    const T* __restrict__ across, const T* __restrict__ turned,
    const T* __restrict__ angles, long long B, int N,
    const int* __restrict__ move, int M, const int* __restrict__ pairs,
    int P, T thr2, int max_clashes, int max_steps, T* __restrict__ out,
    unsigned char* __restrict__ rotated, size_t pair_bytes,
    size_t move_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_pairs = reinterpret_cast<unsigned*>(smem);
  int* s_move = reinterpret_cast<int*>(smem + pair_bytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = N * 3;
  T* x = reinterpret_cast<T*>(smem + pair_bytes + move_bytes) +
         (size_t)warp * per;
  pack_pairs(s_pairs, pairs, 0, P);
  for (int m = threadIdx.x; m < M; m += blockDim.x) s_move[m] = move[m];
  __syncthreads();   // the only block barrier
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const size_t row = (size_t)b * per;
  for (int e = lane; e < per; e += 32) x[e] = coords[row + e];
  const T angle = angles[b];
  bool found = false;
  if (angle != (T)0) {
    for (int s = 0; s <= max_steps; ++s) {
      const T eff = __dsub_rn(angle, (T)s * (T)BACKOFF_STEP);
      if (!(eff >= (T)0)) break;   // and so every later step
      const T rad = __dmul_rn(eff, (T)DEG2RAD);
      const T c = cos(rad), sn = sin(rad);
      __syncwarp();   // every lane is done with the last step's pose
      for (int m = lane; m < M; m += 32) {
        const int a = 3 * s_move[m];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const size_t at = row + a + d;
          x[a + d] = __dadd_rn(__dadd_rn(fixed[at], __dmul_rn(across[at], c)),
                               __dmul_rn(turned[at], sn));
        }
      }
      __syncwarp();   // the moved atoms of step s are in place
      if (scan_pairs<T>(s_pairs, P, x, thr2, 0, max_clashes, lane) <=
          max_clashes) {
        found = true;   // warp-uniform
        break;
      }
    }
  }
  __syncwarp();
  for (int e = lane; e < per; e += 32)
    out[row + e] = found ? x[e] : coords[row + e];
  if (lane == 0) rotated[b] = found;
}

static long long g_backoff_optin[MAX_DEVICES];

static int launch_torsion_backoff(
    const void* coords, const void* fixed, const void* across,
    const void* turned, const void* angles, long long B, int N,
    const void* move, int M, const void* pairs, int P, double thr2,
    int max_clashes, int max_steps, void* out, void* rotated, void* stream,
    int warps, long long blocks, long long smem) {
  if (B <= 0) return 0;
  if (N <= 0 || N > MAX_ATOMS_PACKED || M < 0 || P < 0 || warps <= 0 ||
      warps > 32 || blocks <= 0 || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  const size_t pair_bytes = align16((size_t)4 * P);
  const size_t move_bytes = align16((size_t)4 * M);
  if ((size_t)smem != pair_bytes + move_bytes +
                          (size_t)warps * N * 3 * sizeof(double))
    return (int)cudaErrorInvalidValue;
  const auto fn = torsion_backoff_kernel<double>;
  int err = opt_in_smem(fn, smem, g_backoff_optin);
  if (err) return err;
  fn<<<(unsigned)blocks, warps * 32, (size_t)smem, (cudaStream_t)stream>>>(
      (const double*)coords, (const double*)fixed, (const double*)across,
      (const double*)turned, (const double*)angles, B, N, (const int*)move,
      M, (const int*)pairs, P, thr2, max_clashes, max_steps, (double*)out,
      (unsigned char*)rotated, pair_bytes, move_bytes);
  return (int)cudaGetLastError();
}

extern "C" {

// the thread regime: the ring kernel, with the launch plan of
// ops/kernels/clash.thread_plan; tile_paths (two uint64 on the card, or
// null) gains the tiles loaded by bulk copy and by granules
int clash_ok_f32(const void* poses, long long B, int N, const void* pairs,
                 int P, float thr2, int max_clashes, void* out,
                 void* stream, int tile, int stages, long long blocks,
                 long long smem, void* tile_paths) {
  return launch_clash_ring<float>(poses, B, N, pairs, P, thr2, max_clashes,
                                  out, stream, tile, stages, blocks, smem,
                                  tile_paths);
}

int clash_ok_f64(const void* poses, long long B, int N, const void* pairs,
                 int P, double thr2, int max_clashes, void* out,
                 void* stream, int tile, int stages, long long blocks,
                 long long smem, void* tile_paths) {
  return launch_clash_ring<double>(poses, B, N, pairs, P, thr2,
                                   max_clashes, out, stream, tile, stages,
                                   blocks, smem, tile_paths);
}

// the v1 thread kernel: the yardstick, and poses too large for the ring
int clash_ok_v1_f32(const void* poses, long long B, int N, const void* pairs,
                    int P, float thr2, int max_clashes, void* out,
                    void* stream) {
  return launch_clash<float>(poses, B, N, pairs, P, thr2, max_clashes, out,
                             stream);
}

int clash_ok_v1_f64(const void* poses, long long B, int N, const void* pairs,
                    int P, double thr2, int max_clashes, void* out,
                    void* stream) {
  return launch_clash<double>(poses, B, N, pairs, P, thr2, max_clashes, out,
                              stream);
}

// the search's back-off, one launch per torsion (float64 only)
int torsion_backoff_f64(const void* coords, const void* fixed,
                        const void* across, const void* turned,
                        const void* angles, long long B, int N,
                        const void* move, int M, const void* pairs, int P,
                        double thr2, int max_clashes, int max_steps,
                        void* out, void* rotated, void* stream, int warps,
                        long long blocks, long long smem) {
  return launch_torsion_backoff(coords, fixed, across, turned, angles, B, N,
                                move, M, pairs, P, thr2, max_clashes,
                                max_steps, out, rotated, stream, warps,
                                blocks, smem);
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
