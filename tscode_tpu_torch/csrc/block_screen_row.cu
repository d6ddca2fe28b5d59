// The first design of the block-sweep kernel B1, kept as it was written:
// the yardstick that chip_smoke.py and the card tests hold the redesign
// (block_screen.cu) against, bit for bit, and time it beside. No route
// launches it (ops/kernels/block_screen.launch_row).
//
// What it computes is what block_screen.cu computes (the poses of every
// block row of a chunk over the angle grid, their clash screen and the
// greedy angular dedup; tscode_tpu/embeds/cyclical.py:255 and :350 in the
// JAX package), but it writes every pose, poses (rows, A, N, 3), beside
// keep (rows, A) bool, and leaves the compaction to the caller.
//
// Interface: per molecule m < M (2 or 3) its conformers x_m (n_m, N_m, 3);
// the rows' conformer ids confs (rows, M) int32; per (row, m) 18 values
// geo (rows, M, 18): R_align row-major, the unit rotation axis, the
// centre of rotation cor, the translation pos0; per (angle, m) the sine
// and cosine of half the step angle sc (A, M, 2); the cross-fragment
// pair list (P, 2) int32; thr^2 of the clash screen in the sweep's type;
// the dedup's two gates (rmsd, maxdev).
//
// Design: a warp a block row, 4 rows a block. The lanes build the row's
// poses, angle lane, lane + 32, ...; they sit in the warp's slice of
// shared memory where 4 slices of A N 3 values fit in a block, and are
// then copied to the output in coalesced stores; otherwise the lanes
// write them to the output and read them back from there after
// __syncwarp (any N runs). Clash screen: below 64 pairs a lane walks its
// poses' pairs (K1's thread regime); from 64 the warp takes a pose's
// pairs 32 at a time (K1's warp regime). The dedup kept angle by kept
// angle, a bit per angle in registers, over tiles of 1,024 angles, K3's
// pair arithmetic from qcp_pair.cuh. Measured on the routes (NVIDIA H100,
// float64): 21 to 55% of a bound that is the full pose write.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "phases.cuh"
#include "qcp_pair.cuh"

namespace {

constexpr int kWarps = 4;                 // block rows a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGeo = 18;                  // values of a (row, molecule)
constexpr int kMaxMols = 3;
constexpr int kTile = 32 * 32;            // angles a tile: a bit an
                                          // angle, 32 a lane

struct Mols {
  const void* x[kMaxMols];                // conformers (n_m, N_m, 3)
  int n[kMaxMols];                        // atoms N_m
  int M;
};

// pose of angle a of row r (3 N values) into out: each molecule's atoms
// moved by R_step(axis, angle) R_align and its translation
template <typename T>
__device__ __forceinline__ void build_pose(const Mols& mols,
                                           const int* __restrict__ confs,
                                           const T* __restrict__ geo,
                                           const T* __restrict__ sc,
                                           long long r, int a, T* out) {
  const int M = mols.M;
  int off = 0;
  for (int m = 0; m < M; ++m) {
    const T* g = geo + ((size_t)r * M + m) * kGeo;
    const T s = __ldg(sc + ((size_t)a * M + m) * 2);
    const T q0 = __ldg(sc + ((size_t)a * M + m) * 2 + 1);
    const T q1 = s * __ldg(g + 9), q2 = s * __ldg(g + 10),
            q3 = s * __ldg(g + 11);
    // ops/linalg.quaternion_to_rotation_matrix (scalar last: q0 = w)
    T Rs[3][3];
    Rs[0][0] = (T)2 * (q0 * q0 + q1 * q1) - (T)1;
    Rs[0][1] = (T)2 * (q1 * q2 - q0 * q3);
    Rs[0][2] = (T)2 * (q1 * q3 + q0 * q2);
    Rs[1][0] = (T)2 * (q1 * q2 + q0 * q3);
    Rs[1][1] = (T)2 * (q0 * q0 + q2 * q2) - (T)1;
    Rs[1][2] = (T)2 * (q2 * q3 - q0 * q1);
    Rs[2][0] = (T)2 * (q1 * q3 - q0 * q2);
    Rs[2][1] = (T)2 * (q2 * q3 + q0 * q1);
    Rs[2][2] = (T)2 * (q0 * q0 + q3 * q3) - (T)1;
    T R[3][3], t[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        R[i][k] = Rs[i][0] * __ldg(g + k) + Rs[i][1] * __ldg(g + 3 + k) +
                  Rs[i][2] * __ldg(g + 6 + k);
      const T c0 = __ldg(g + 12), c1 = __ldg(g + 13), c2 = __ldg(g + 14);
      t[i] = __ldg(g + 12 + i) - (Rs[i][0] * c0 + Rs[i][1] * c1 +
                                  Rs[i][2] * c2) + __ldg(g + 15 + i);
    }
    const int Nm = mols.n[m];
    const T* x = static_cast<const T*>(mols.x[m]) +
                 (size_t)__ldg(confs + (size_t)r * M + m) * Nm * 3;
    T* o = out + 3 * off;
    for (int n = 0; n < Nm; ++n) {
      const T x0 = __ldg(x + 3 * n), x1 = __ldg(x + 3 * n + 1),
              x2 = __ldg(x + 3 * n + 2);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        o[3 * n + i] = R[i][0] * x0 + R[i][1] * x1 + R[i][2] * x2 + t[i];
    }
    off += Nm;
  }
}

// one lane: does pose x clash on any listed pair (K1's thread regime)?
template <typename T>
__device__ __forceinline__ bool lane_clashes(const T* x,
                                             const int2* __restrict__ pairs,
                                             int P, T thr2) {
  int last = -1;
  T xi = 0, yi = 0, zi = 0;
  for (int k = 0; k < P; ++k) {
    const int2 w = __ldg(pairs + k);
    const int i = 3 * w.x, j = 3 * w.y;
    if (i != last) {
      xi = x[i], yi = x[i + 1], zi = x[i + 2];
      last = i;
    }
    const T dx = xi - x[j];
    const T dy = yi - x[j + 1];
    const T dz = zi - x[j + 2];
    const T d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < thr2) return true;
  }
  return false;
}

// the warp: does pose x clash on any listed pair (K1's warp regime)?
template <typename T>
__device__ __forceinline__ bool warp_clashes(const T* x,
                                             const int2* __restrict__ pairs,
                                             int P, T thr2, int lane) {
  for (int k0 = 0; k0 < P; k0 += 32) {
    const int k = k0 + lane;
    bool hit = false;
    if (k < P) {
      const int2 w = __ldg(pairs + k);
      const int i = 3 * w.x, j = 3 * w.y;
      const T dx = x[i] - x[j];
      const T dy = x[i + 1] - x[j + 1];
      const T dz = x[i + 2] - x[j + 2];
      const T d2 = dx * dx + dy * dy + dz * dz;
      hit = d2 < thr2;
    }
    if (__any_sync(kFull, hit)) return true;   // warp-uniform
  }
  return false;
}

// SMEM: the warp's poses in its slice of shared memory, else in the
// output; WARP_CLASH: the warp screens a pose's pairs together. TT_PHASES
// builds: a row's record of 8 slots: cycles building, writing, screening,
// summing norms and in the dedup, the dedup's steps, the live lanes over
// its steps, rows
template <typename T, bool SMEM, bool WARP_CLASH>
__global__ void __launch_bounds__(kWarps * 32)
block_screen_kernel(Mols mols, const int* __restrict__ confs,
                    const T* __restrict__ geo, const T* __restrict__ sc,
                    int A, const int2* __restrict__ pairs, int P, T thr2,
                    T gate_rmsd, T gate_maxdev, long long rows, T* poses,
                    unsigned char* keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= rows) return;                    // the whole warp
  int N = 0;
  for (int m = 0; m < mols.M; ++m) N += mols.n[m];
  const int stride = 3 * N;
  const size_t row_vals = (size_t)A * stride;
  T* out = poses + (size_t)r * row_vals;
  T* store = SMEM ? reinterpret_cast<T*>(smem) + warp * row_vals : out;
  TT_START(8);

  for (int a = lane; a < A; a += 32)
    build_pose<T>(mols, confs, geo, sc, r, a, store + (size_t)a * stride);
  __syncwarp();
  TT_LAP(0);
  if (SMEM) {
    for (size_t i = lane; i < row_vals; i += 32) out[i] = store[i];
  }
  TT_LAP(1);

  const T sqrt_n = sqrt((T)N);
  unsigned char* keep_row = keep + (size_t)r * A;
  for (int base = 0; base < A; base += kTile) {
    const int end = min(A, base + kTile);
    // clash screen: bit j of ok is angle base + lane + 32 j
    unsigned ok = 0;
    if (WARP_CLASH) {
      for (int a = base; a < end; ++a) {
        const bool clean = !warp_clashes<T>(store + (size_t)a * stride,
                                            pairs, P, thr2, lane);
        if (clean && ((a - base) & 31) == lane) ok |= 1u << ((a - base) >> 5);
      }
    } else {
      for (int a = base + lane, j = 0; a < end; a += 32, ++j)
        if (!lane_clashes<T>(store + (size_t)a * stride, pairs, P, thr2))
          ok |= 1u << j;
    }
    TT_LAP(2);
    T ga[32];
    for (unsigned rem = ok; rem; rem &= rem - 1) {
      const int j = __ffs(rem) - 1;
      ga[j] = qcpk::row_norm2<T, 0>(
          store + (size_t)(base + lane + 32 * j) * stride, stride);
    }
    TT_LAP(3);

    // the greedy dedup: the live angles meet the angles kept in earlier
    // tiles in order (c walks them 32 at a time, kb the kept among
    // them), then those kept in this tile, kept angle by kept angle
    unsigned live = ok, kept = 0, kb = 0;
    int c = 0, cb = 0;
    for (;;) {
      while (!kb && c < base && __any_sync(kFull, live)) {
        kb = __ballot_sync(kFull, keep_row[c + lane] != 0);
        cb = c;
        c += 32;
      }
      int q;
      if (kb) {
        q = cb + __ffs(kb) - 1;
        kb &= kb - 1;
      } else {
        const int mine = live ? lane + 32 * (__ffs(live) - 1) : INT_MAX;
        const int t = __reduce_min_sync(kFull, mine);
        if (t == INT_MAX) break;
        if ((t & 31) == lane) {
          kept |= 1u << (t >> 5);
          live &= ~(1u << (t >> 5));
        }
        c = base;
        q = base + t;
        TT_ADD(5, 1);
        TT_ADD(6, __popc(__ballot_sync(kFull, live != 0)));
      }
      const T* Q = store + (size_t)q * stride;
      for (unsigned rem = live; rem; rem &= rem - 1) {
        const int j = __ffs(rem) - 1;
        const T* Pp = store + (size_t)(base + lane + 32 * j) * stride;
        if (qcpk::pair_hits<T, 0>(Pp, Q, N, ga[j], gate_rmsd, gate_maxdev,
                                  sqrt_n))
          live &= ~(1u << j);
      }
    }
    for (int a = base + lane, j = 0; a < end; a += 32, ++j)
      keep_row[a] = (kept >> j) & 1u;
    __syncwarp();
    TT_LAP(4);
  }
  TT_ADD(7, 1);
  TT_FLUSH(8, r, lane == 0);
}

template <typename T, bool SMEM, bool WARP_CLASH>
int launch_form(const Mols& mols, const void* confs, const void* geo,
                const void* sc, int A, const void* pairs, int P, T thr2,
                T gate_rmsd, T gate_maxdev, long long rows, void* poses,
                void* keep, size_t smem, cudaStream_t stream) {
  auto kernel = block_screen_kernel<T, SMEM, WARP_CLASH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (rows + kWarps - 1) / kWarps;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      mols, (const int*)confs, (const T*)geo, (const T*)sc, A,
      (const int2*)pairs, P, thr2, gate_rmsd, gate_maxdev, rows, (T*)poses,
      (unsigned char*)keep);
  return (int)cudaGetLastError();
}

// smem_poses: 1 for the shared-memory form (kWarps slices of A N 3
// values), 0 for poses read back from the output; warp_clash: 1 for the
// warp's clash screen (P >= 64 on the host's rule)
template <typename T>
int launch_screen(const void* x0, const void* x1, const void* x2, int n0,
                  int n1, int n2, int M, const void* confs, const void* geo,
                  const void* sc, int A, const void* pairs, int P, T thr2,
                  T gate_rmsd, T gate_maxdev, long long rows, void* poses,
                  void* keep, int smem_poses, int warp_clash, void* stream) {
  if (M < 2 || M > kMaxMols || A < 1 || P < 0 ||
      rows < 0 || (rows + kWarps - 1) / kWarps > INT_MAX || n0 < 1 ||
      n1 < 1 || (M == 3 && n2 < 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Mols mols{{x0, x1, M == 3 ? x2 : nullptr},
                  {n0, n1, M == 3 ? n2 : 0}, M};
  const int N = n0 + n1 + (M == 3 ? n2 : 0);
  const size_t smem =
      smem_poses ? (size_t)kWarps * A * 3 * N * sizeof(T) : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (smem_poses && warp_clash)
    return launch_form<T, true, true>(mols, confs, geo, sc, A, pairs, P,
                                      thr2, gate_rmsd, gate_maxdev, rows,
                                      poses, keep, smem, s);
  if (smem_poses)
    return launch_form<T, true, false>(mols, confs, geo, sc, A, pairs, P,
                                       thr2, gate_rmsd, gate_maxdev, rows,
                                       poses, keep, smem, s);
  if (warp_clash)
    return launch_form<T, false, true>(mols, confs, geo, sc, A, pairs, P,
                                       thr2, gate_rmsd, gate_maxdev, rows,
                                       poses, keep, smem, s);
  return launch_form<T, false, false>(mols, confs, geo, sc, A, pairs, P,
                                      thr2, gate_rmsd, gate_maxdev, rows,
                                      poses, keep, smem, s);
}

}  // namespace

extern "C" {

int block_screen_row_f32(const void* x0, const void* x1, const void* x2, int n0,
                     int n1, int n2, int M, const void* confs,
                     const void* geo, const void* sc, int A,
                     const void* pairs, int P, float thr2, float gate_rmsd,
                     float gate_maxdev, long long rows, void* poses,
                     void* keep, int smem_poses, int warp_clash,
                     void* stream) {
  return launch_screen<float>(x0, x1, x2, n0, n1, n2, M, confs, geo, sc, A,
                              pairs, P, thr2, gate_rmsd, gate_maxdev, rows,
                              poses, keep, smem_poses, warp_clash, stream);
}

int block_screen_row_f64(const void* x0, const void* x1, const void* x2, int n0,
                     int n1, int n2, int M, const void* confs,
                     const void* geo, const void* sc, int A,
                     const void* pairs, int P, double thr2,
                     double gate_rmsd, double gate_maxdev, long long rows,
                     void* poses, void* keep, int smem_poses, int warp_clash,
                     void* stream) {
  return launch_screen<double>(x0, x1, x2, n0, n1, n2, M, confs, geo, sc, A,
                               pairs, P, thr2, gate_rmsd, gate_maxdev, rows,
                               poses, keep, smem_poses, warp_clash, stream);
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
