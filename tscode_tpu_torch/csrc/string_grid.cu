// The string embed's pose grid with its clash screen (kernel G1 of the
// port).
//
// Replaces no Pallas kernel: the JAX package's jitted string grid
// (tscode_tpu/embeds/string.py _string_sweep_bcast, :134, its block
// _string_bcast_block, :76; bench.py _embed_clash_all, :117, and
// _embed_clash_all_mapped, :190), which builds every pose of the
// (c2, c1, l2, l1, ai) grid, screens it with K1 and compacts the
// survivors by the mask. Here no pose is written but a survivor.
//
// Inputs: the two molecules' conformers, the lobe centers, and two
// rotation tables built in PyTorch (ops/kernels/string_grid.grid_tables):
// align (g, n1c, k2, k1, 3, 3), which turns molecule 2's lobe onto
// molecule 1's, and spin (n1c, k1, A, 3, 3), the turn about molecule 1's
// orbital. For grid row (c2, c1, l2, l1, ai), in C order:
//
//   R = spin[c1, l1, ai] @ align[c2, c1, l2, l1]
//   t = centers1[c1, l1] - R centers2[c2, l2]
//   pose = [coords1[c1]; coords2[c2] R^T + t]
//
// every product and sum rounded one operation at a time, in the order
// of ops/kernels/string_grid.string_grid_order_plain (R_ij = (s_i0 a_0j +
// s_i1 a_1j) + s_i2 a_2j, the rotated atom ((R_i0 x + R_i1 y) + R_i2 z) +
// t_i), so that the twin gives the same bits. A pose passes when none of
// the listed (i, j) pairs lies closer than thr, its squared distance in
// difference form ((dx dx + dy dy) + dz dz, rounded the same way) below
// thr^2 rounded in the working type (K1's test, max_clashes 0).
//
// Two launches, B1's pattern (csrc/block_screen.cu):
//
// * string_keep: one block a (c2, c1) group, its k2 k1 A rows; writes the
//   ok byte of every row and the group's kept count. Two regimes, K1's
//   switch at CLASH_WARP_MIN_PAIRS (64 pairs; chosen in Python, plan_for):
//   - thread: a thread a row. The group's two conformers and the pair
//     list are staged in shared memory; each thread rotates molecule 2's
//     atoms into its own column of a shared array (atom-major, the
//     threads side by side: no bank conflict) and walks the pairs, all
//     threads on the same pair at once (molecule 1's atoms and the pair
//     word are broadcasts), stopping at its first clash.
//   - warp: a warp a row. The row's whole pose goes to the warp's slot in
//     shared memory (molecule 1's atoms once a block), then K1's warp
//     scan (csrc/clash_scan.cuh scan_pairs, rounded) walks the pairs.
//     The pair list is staged while it fits, else read from device memory.
// * string_write: from an exclusive scan of the groups' counts (torch,
//   on the device) and an optional base offset held on the device, one
//   block a group rebuilds the kept rows' frames (the same arithmetic,
//   the same bits) and writes their poses, or only the atoms listed in
//   `heavy`, at their grid-order offsets; consecutive threads write
//   consecutive values of the block's contiguous run of output rows.
//   Rows at or past `bound` (a pool's size) are not written.
//
// What bounds it: at the headline (415,872 rows, 11 atoms, 30 pairs) the
// work is ~45 flops a frame, ~18 a rotated atom and ~9 a pair, 0.42
// MB of ok bytes and ~3 MB of kept heavy atoms: a few microseconds of
// the card either way, so launch and latency (the frames' dependent
// chains, the per-thread pair walk) set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "clash_scan.cuh"

#define STATIC_SMEM (48 * 1024)
#define MAX_DEVICES 64
#define WRITE_THREADS 128
#define REGIME_THREAD 0
#define REGIME_WARP 1

namespace {

__host__ __device__ size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

template <typename T>
struct Grid {
  const T* coords1;   // (n1c, N1, 3)
  const T* coords2;   // (g, N2, 3), the launch's c2 values
  const T* centers1;  // (n1c, k1, 3)
  const T* centers2;  // (g, k2, 3)
  const T* align;     // (g, n1c, k2, k1, 9)
  const T* spin;      // (n1c, k1, A, 9)
  int N1, N2, n1c, k1, k2, A;
};

// R (9 values) and t (3) of row r of group (c2l, c1), the group's rows in
// (l2, l1, ai) order
template <typename T>
__device__ __forceinline__ void frame(const Grid<T>& g, int c2l, int c1,
                                      int r, T* Rt) {
  const int per_l2 = g.k1 * g.A;
  const int l2 = r / per_l2;
  const int rem = r - l2 * per_l2;
  const int l1 = rem / g.A;
  const int ai = rem - l1 * g.A;
  const T* al = g.align +
                ((((long long)c2l * g.n1c + c1) * g.k2 + l2) * g.k1 + l1) * 9;
  const T* sp = g.spin + (((long long)c1 * g.k1 + l1) * g.A + ai) * 9;
  const T* p1 = g.centers1 + ((long long)c1 * g.k1 + l1) * 3;
  const T* p2 = g.centers2 + ((long long)c2l * g.k2 + l2) * 3;
  T a[9], s[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    a[e] = al[e];
    s[e] = sp[e];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rt[i * 3 + j] = rn_add(rn_add(rn_mul(s[i * 3], a[j]),
                                    rn_mul(s[i * 3 + 1], a[3 + j])),
                             rn_mul(s[i * 3 + 2], a[6 + j]));
  const T q0 = p2[0], q1 = p2[1], q2 = p2[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    Rt[9 + i] = rn_sub(p1[i], rn_add(rn_add(rn_mul(Rt[i * 3], q0),
                                            rn_mul(Rt[i * 3 + 1], q1)),
                                     rn_mul(Rt[i * 3 + 2], q2)));
}

// component d of the atom c (3 values) moved by the frame Rt
template <typename T>
__device__ __forceinline__ T moved(const T* Rt, const T* c, int d) {
  return rn_add(rn_add(rn_add(rn_mul(Rt[d * 3], c[0]),
                              rn_mul(Rt[d * 3 + 1], c[1])),
                       rn_mul(Rt[d * 3 + 2], c[2])),
                Rt[9 + d]);
}

// the block's sum of `v` (every thread calls it; blockDim a multiple of 32)
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;   // in thread 0
}

// ---------------------------------------------------- string_keep, thread

template <typename T>
__global__ void string_keep_thread_kernel(Grid<T> g,
                                          const unsigned* __restrict__ pairs,
                                          int P, int stage_pairs, T thr2,
                                          unsigned char* __restrict__ ok,
                                          int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[32];
  const int tid = threadIdx.x, bd = blockDim.x;
  const unsigned* s_pairs = pairs;
  size_t off = 0;
  if (stage_pairs) {
    unsigned* sp = reinterpret_cast<unsigned*>(smem);
    for (int k = tid; k < P; k += bd) sp[k] = pairs[k];
    s_pairs = sp;
    off = align16((size_t)4 * P);
  }
  T* s_c1 = reinterpret_cast<T*>(smem + off);
  T* s_c2 = s_c1 + g.N1 * 3;
  T* s_x = s_c2 + g.N2 * 3;
  const long long grp = blockIdx.x;
  const int c2l = (int)(grp / g.n1c), c1 = (int)(grp % g.n1c);
  for (int e = tid; e < g.N1 * 3; e += bd)
    s_c1[e] = g.coords1[(long long)c1 * g.N1 * 3 + e];
  for (int e = tid; e < g.N2 * 3; e += bd)
    s_c2[e] = g.coords2[(long long)c2l * g.N2 * 3 + e];
  __syncthreads();
  const int rows = g.k2 * g.k1 * g.A;
  const int n1x3 = g.N1 * 3;
  int kept = 0;
  for (int r = tid; r < rows; r += bd) {
    T Rt[12];
    frame(g, c2l, c1, r, Rt);
    for (int n = 0; n < g.N2; ++n)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s_x[(n * 3 + d) * bd + tid] = moved(Rt, s_c2 + n * 3, d);
    bool good = true;
    for (int k = 0; k < P; ++k) {
      const unsigned w = s_pairs[k];
      const int i = 3 * (int)(w >> 16), j = 3 * (int)(w & 0xffffu);
      T xi[3], xj[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        xi[d] = i < n1x3 ? s_c1[i + d] : s_x[(i - n1x3 + d) * bd + tid];
        xj[d] = j < n1x3 ? s_c1[j + d] : s_x[(j - n1x3 + d) * bd + tid];
      }
      const T dx = rn_sub(xi[0], xj[0]);
      const T dy = rn_sub(xi[1], xj[1]);
      const T dz = rn_sub(xi[2], xj[2]);
      if (rn_add(rn_add(rn_mul(dx, dx), rn_mul(dy, dy)), rn_mul(dz, dz)) <
          thr2) {
        good = false;
        break;
      }
    }
    ok[grp * rows + r] = good;
    kept += good;
  }
  const int total = block_sum(kept, red);
  if (tid == 0) counts[grp] = total;
}

// ------------------------------------------------------ string_keep, warp

template <typename T>
__global__ void string_keep_warp_kernel(Grid<T> g,
                                        const unsigned* __restrict__ pairs,
                                        int P, int stage_pairs, T thr2,
                                        size_t slot_vals,
                                        unsigned char* __restrict__ ok,
                                        int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5;
  const unsigned* s_pairs = pairs;
  size_t off = 0;
  if (stage_pairs) {
    unsigned* sp = reinterpret_cast<unsigned*>(smem);
    for (int k = tid; k < P; k += blockDim.x) sp[k] = pairs[k];
    s_pairs = sp;
    off = align16((size_t)4 * P);
  }
  T* x = reinterpret_cast<T*>(smem + off) + (size_t)warp * slot_vals;
  const long long grp = blockIdx.x;
  const int c2l = (int)(grp / g.n1c), c1 = (int)(grp % g.n1c);
  const int n1x3 = g.N1 * 3, n2x3 = g.N2 * 3;
  const T* c1p = g.coords1 + (long long)c1 * n1x3;
  const T* c2p = g.coords2 + (long long)c2l * n2x3;
  for (int e = lane; e < n1x3; e += 32) x[e] = c1p[e];
  __syncthreads();   // the pair list is staged
  const int rows = g.k2 * g.k1 * g.A;
  int kept = 0;
  for (int r = warp; r < rows; r += W) {
    T Rt[12];
    frame(g, c2l, c1, r, Rt);
    for (int e = lane; e < n2x3; e += 32) {
      const int n = e / 3;
      x[n1x3 + e] = moved(Rt, c2p + n * 3, e - n * 3);
    }
    __syncwarp();   // the pose is in place
    const int count = scan_pairs<T, true>(s_pairs, P, x, thr2, 0, 0, lane);
    __syncwarp();   // every lane is done with the pose
    if (lane == 0) ok[grp * rows + r] = count == 0;
    kept += count == 0;
  }
  const int total = block_sum(lane == 0 ? kept : 0, red);
  if (tid == 0) counts[grp] = total;
}

// ------------------------------------------------------------ string_write

template <typename T>
__global__ void __launch_bounds__(WRITE_THREADS)
    string_write_kernel(Grid<T> g, const unsigned char* __restrict__ ok,
                        const long long* __restrict__ offsets,
                        const long long* __restrict__ base, long long bound,
                        const int* __restrict__ heavy, int H,
                        T* __restrict__ out) {
  __shared__ T s_rt[WRITE_THREADS * 12];
  __shared__ int s_warp[WRITE_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long grp = blockIdx.x;
  const int c2l = (int)(grp / g.n1c), c1 = (int)(grp % g.n1c);
  const int rows = g.k2 * g.k1 * g.A;
  const int n1 = g.N1;
  const T* c1p = g.coords1 + (long long)c1 * n1 * 3;
  const T* c2p = g.coords2 + (long long)c2l * g.N2 * 3;
  long long at = offsets[grp] + (base != nullptr ? *base : 0);
  for (int r0 = 0; r0 < rows; r0 += WRITE_THREADS) {
    const int r = r0 + tid;
    const bool k = r < rows && ok[grp * rows + r];
    const unsigned bits = __ballot_sync(0xffffffffu, k);
    if (lane == 0) s_warp[warp] = __popc(bits);
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < WRITE_THREADS / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      tile += s_warp[w];
    }
    if (k) {
      const int rank = before + __popc(bits & ((1u << lane) - 1u));
      frame(g, c2l, c1, r, s_rt + rank * 12);
    }
    __syncthreads();   // the tile's frames are in place
    const long long items = (long long)tile * H;
    for (long long it = tid; it < items; it += WRITE_THREADS) {
      const int kr = (int)(it / H);
      const int h = (int)(it - (long long)kr * H);
      const long long dst = at + kr;
      if (dst >= bound) continue;
      const int a = heavy != nullptr ? heavy[h] : h;
      T* o = out + (dst * H + h) * 3;
      if (a < n1) {
        o[0] = c1p[a * 3];
        o[1] = c1p[a * 3 + 1];
        o[2] = c1p[a * 3 + 2];
      } else {
        const T* Rt = s_rt + kr * 12;
        const T* c = c2p + (a - n1) * 3;
        o[0] = moved(Rt, c, 0);
        o[1] = moved(Rt, c, 1);
        o[2] = moved(Rt, c, 2);
      }
    }
    at += tile;
    __syncthreads();   // s_rt and s_warp are free again
  }
}

template <typename Fn>
int opt_in_smem(Fn fn, long long bytes, long long* done) {
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

long long g_optin[2][2][MAX_DEVICES];   // [f64][regime][card]

template <typename T>
Grid<T> make_grid(const void* coords1, const void* coords2,
                  const void* centers1, const void* centers2,
                  const void* align, const void* spin, int N1, int N2,
                  int n1c, int k1, int k2, int A) {
  return Grid<T>{static_cast<const T*>(coords1),
                 static_cast<const T*>(coords2),
                 static_cast<const T*>(centers1),
                 static_cast<const T*>(centers2),
                 static_cast<const T*>(align),
                 static_cast<const T*>(spin),
                 N1, N2, n1c, k1, k2, A};
}

// the keep launch's shared bytes (ops/kernels/string_grid.plan_for
// computes the same)
template <typename T>
long long keep_smem(int regime, int threads, int stage_pairs, int N1,
                    int N2, int P, size_t* slot_vals) {
  const size_t pair_bytes = stage_pairs ? align16((size_t)4 * P) : 0;
  *slot_vals = align16((size_t)(N1 + N2) * 3 * sizeof(T)) / sizeof(T);
  if (regime == REGIME_WARP)
    return (long long)(pair_bytes + (size_t)(threads / 32) * *slot_vals *
                                        sizeof(T));
  return (long long)(pair_bytes + (size_t)(N1 + N2 + (size_t)N2 * threads) *
                                      3 * sizeof(T));
}

template <typename T>
int launch_keep(const void* coords1, const void* coords2,
                const void* centers1, const void* centers2,
                const void* align, const void* spin, int N1, int N2,
                int n1c, int g2, int k1, int k2, int A, const void* pairs,
                int P, double thr2, void* ok, void* counts, int regime,
                int threads, int stage_pairs, void* stream) {
  const long long groups = (long long)g2 * n1c;
  if (groups == 0 || k1 * k2 * A == 0) return 0;
  if (N1 <= 0 || N2 <= 0 || N1 + N2 > MAX_ATOMS_PACKED || P < 0 ||
      threads < 32 || threads > 1024 || threads % 32 ||
      (regime != REGIME_THREAD && regime != REGIME_WARP) ||
      groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  size_t slot_vals = 0;
  const long long smem =
      keep_smem<T>(regime, threads, stage_pairs, N1, N2, P, &slot_vals);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const Grid<T> g = make_grid<T>(coords1, coords2, centers1, centers2, align,
                                 spin, N1, N2, n1c, k1, k2, A);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* pw = static_cast<const unsigned*>(pairs);
  unsigned char* o = static_cast<unsigned char*>(ok);
  int* c = static_cast<int*>(counts);
  const int f64 = sizeof(T) == 8;
  int err;
  if (regime == REGIME_THREAD) {
    const auto fn = string_keep_thread_kernel<T>;
    err = opt_in_smem(fn, smem, g_optin[f64][0]);
    if (err) return err;
    fn<<<(unsigned)groups, threads, (size_t)smem, st>>>(g, pw, P, stage_pairs,
                                                       (T)thr2, o, c);
  } else {
    const auto fn = string_keep_warp_kernel<T>;
    err = opt_in_smem(fn, smem, g_optin[f64][1]);
    if (err) return err;
    fn<<<(unsigned)groups, threads, (size_t)smem, st>>>(
        g, pw, P, stage_pairs, (T)thr2, slot_vals, o, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_write(const void* coords1, const void* coords2,
                 const void* centers1, const void* centers2,
                 const void* align, const void* spin, int N1, int N2,
                 int n1c, int g2, int k1, int k2, int A, const void* ok,
                 const void* offsets, const void* base, long long bound,
                 const void* heavy, int H, void* out, void* stream) {
  const long long groups = (long long)g2 * n1c;
  if (groups == 0 || k1 * k2 * A == 0) return 0;
  if (N1 <= 0 || N2 <= 0 || H <= 0 || groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Grid<T> g = make_grid<T>(coords1, coords2, centers1, centers2, align,
                                 spin, N1, N2, n1c, k1, k2, A);
  string_write_kernel<T><<<(unsigned)groups, WRITE_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const unsigned char*>(ok),
      static_cast<const long long*>(offsets),
      static_cast<const long long*>(base), bound,
      static_cast<const int*>(heavy), H, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define KEEP_ARGS                                                           \
  const void *coords1, const void *coords2, const void *centers1,          \
      const void *centers2, const void *align, const void *spin, int N1,   \
      int N2, int n1c, int g2, int k1, int k2, int A, const void *pairs,   \
      int P, double thr2, void *ok, void *counts, int regime, int threads, \
      int stage_pairs, void *stream
#define KEEP_CALL                                                         \
  coords1, coords2, centers1, centers2, align, spin, N1, N2, n1c, g2, k1, \
      k2, A, pairs, P, thr2, ok, counts, regime, threads, stage_pairs, stream
#define WRITE_ARGS                                                         \
  const void *coords1, const void *coords2, const void *centers1,         \
      const void *centers2, const void *align, const void *spin, int N1,  \
      int N2, int n1c, int g2, int k1, int k2, int A, const void *ok,     \
      const void *offsets, const void *base, long long bound,             \
      const void *heavy, int H, void *out, void *stream
#define WRITE_CALL                                                          \
  coords1, coords2, centers1, centers2, align, spin, N1, N2, n1c, g2, k1,  \
      k2, A, ok, offsets, base, bound, heavy, H, out, stream

int string_keep_f32(KEEP_ARGS) { return launch_keep<float>(KEEP_CALL); }
int string_keep_f64(KEEP_ARGS) { return launch_keep<double>(KEEP_CALL); }
int string_write_f32(WRITE_ARGS) { return launch_write<float>(WRITE_CALL); }
int string_write_f64(WRITE_ARGS) { return launch_write<double>(WRITE_CALL); }

// out: registers a thread and local (spilled) bytes a thread of the
// keep kernel of `regime` and of the write kernel, for f64 or f32
int string_grid_info(int f64, int regime, int* out) {
  cudaFuncAttributes a, w;
  int err;
  if (f64) {
    err = (int)cudaFuncGetAttributes(
        &a, regime == REGIME_WARP
                ? (const void*)string_keep_warp_kernel<double>
                : (const void*)string_keep_thread_kernel<double>);
    if (!err)
      err = (int)cudaFuncGetAttributes(&w, string_write_kernel<double>);
  } else {
    err = (int)cudaFuncGetAttributes(
        &a, regime == REGIME_WARP
                ? (const void*)string_keep_warp_kernel<float>
                : (const void*)string_keep_thread_kernel<float>);
    if (!err)
      err = (int)cudaFuncGetAttributes(&w, string_write_kernel<float>);
  }
  if (err) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = w.numRegs;
  out[3] = (int)w.localSizeBytes;
  return 0;
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
