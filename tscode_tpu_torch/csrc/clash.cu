// Cross-fragment clash screen (kernels K1 and K2 of the port).
//
// Replaces the Pallas TPU kernels of tscode_tpu/ops/pallas/clash.py:
// clash_ok_traced (body _make_clash_kernel_dyn) and
// compenetration_mask_pallas (_clash_call, body _make_clash_kernel).
// Both compute, for each pose, the number of listed (i, j) atom pairs
// with squared distance below thr^2, and accept the pose iff that
// number is <= max_clashes. One kernel serves both entries here.
//
// Design. One thread per pose. The TPU version put poses along the
// 128-wide lanes and unrolled a compile-time pair list; on Hopper the
// pair list is a runtime int32 (P, 2) array that passes through shared
// memory in tiles of at most PAIR_TILE pairs, so any pair count and any
// batch size B is taken (no 2048-pose blocks, no padding). When a
// block's poses fit in shared memory beside one pair tile, the block
// stages them there with coalesced loads; otherwise each thread reads
// its own pose from global memory (through L1). A thread stops counting
// at the first clash past max_clashes, and the block leaves the tile
// loop as soon as none of its threads is still counting.
//
// Barriers. Every thread of a block, finished or out of range, runs
// the same tile loop and reaches every __syncthreads: a thread that is
// done only clears its `active` flag. The loop's exit test is a
// block-wide __syncthreads_or, so all threads leave together.
//
// Bound on this card: device-memory bytes. A pose is read once
// (N*3 values) and writes one byte; the pair loop is ~9 flops per pair
// from shared memory. At the headline shape (B = 415,872, N = 11,
// P = 30) that is 55 MB in f32, which H100 HBM moves in ~17 us at
// 3.35 TB/s; the kernel is expected to sit near launch and latency
// overheads, not compute.

#include <cuda_runtime.h>

#define PAIR_TILE 2048            // pairs per shared-memory tile (16 KB)
#define STATIC_SMEM (48 * 1024)   // no opt-in attribute needed below this

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

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
