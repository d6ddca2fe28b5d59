// The cyclical block sweep of one chunk of block rows (kernel B1 of the
// port), in two launches: the screen writes each row's keep bits and its
// kept count, never a pose; the write rebuilds only the kept poses, into
// a compacted array at offsets from a scan of the counts.
//
// Replaces no Pallas kernel. It replaces the JAX package's jitted block
// programs tscode_tpu/embeds/cyclical.py:255 (_block_screen: the pose
// expansion _block_poses :124 with the block-local gate matrices
// tscode_tpu/ops/rmsd_prune.py:115 _pair_gate_matrices, and the greedy
// keep _greedy_keep_device :236) and :350 (_block_screen_multi, three
// molecules, _block_poses_multi :1264), which _block_screen_mapped_compact
// (:304) maps over chunks and then compacts by the keep mask. The first
// design of B1 (block_screen_row.cu) wrote every pose of the chunk, about
// 99% of which the screen or the dedup drops, and left the compaction to
// a nonzero and a gather of the full poses.
//
// Interface, screen: per molecule m < M (2 or 3) its conformers x_m (n_m,
// N_m, 3); the rows' conformer ids confs (rows, M) int32; per (row, m)
// 18 values geo (rows, M, 18): R_align row-major, the unit rotation axis,
// the centre of rotation cor, the translation pos0; per (angle, m) the
// sine and cosine of half the step angle sc (A, M, 2); the cross-fragment
// pair list (P, 2) int32; thr^2 of the clash screen; the dedup's two
// gates (rmsd, maxdev); the store's layout (a row's poses at `stride`
// values apart, in shared memory or in a global scratch of `slots` rows).
// Outputs keep (rows, A) bool and counts (rows,) int32. Write: the same
// geometry, keep, offsets (rows,) int64 (the exclusive scan of counts)
// and survivors (S, N, 3): row r's kept poses at offsets[r], ...,
// in angle order, molecule m's atoms after those of the molecules before
// it. So the survivors lie in generation order, row by row, angle by
// angle, as the mask compaction of the full poses would give them.
//
// Arithmetic, both launches: a pose of molecule m is R x + t with R =
// R_step R_align and t = cor - R_step cor + pos0, R_step the quaternion
// (sin * axis, cos) turned into a matrix as ops/linalg.
// quaternion_to_rotation_matrix does (frame(), pose_atom()): the same
// expressions, in the same order, as block_screen_row.cu's build_pose, so
// a survivor is bit for bit the pose the first design wrote. The clash
// screen is K1's: direct differences of the listed pairs, d^2 < thr^2, a
// pose passes with no such pair. The gates are K3's pair arithmetic
// (qcp_pair.cuh: lambda_max by Newton, the rmsd gate, the maxdev gate
// only in the band sqrt(N) rmsd >= maxdev gate), pose t superposed onto a
// kept pose t0, GA pose t's squared norm.
//
// The greedy rule (angle t is kept when it passed the screen and no angle
// kept before it is similar) needs only pairs (t, kept t0): the smallest
// live angle (passed, not yet dropped) is kept; every live angle after it
// is gated against it at once, the lanes taking one angle each, and drops
// out on a hit; repeat. So each angle meets the kept angles before it in
// order until its first hit, as in the greedy scan, and the keep bits are
// the greedy keep's. Past 1,024 angles a row is walked in tiles of 1,024
// (a bit an angle, 32 a lane): a tile's live angles first meet the angles
// kept in the tiles before it, in order (read back from keep), then each
// other.
//
// Bound on this card: operations. The screen reads its inputs and writes
// a byte an angle and a count a row; the write moves only the survivors
// (~1% of the poses on the routes: da_cyclical_xl at 62, 19,562 of
// 1,660,608, 2.1 MB in float64). The work: A poses a row of ~100 M + 18 N
// operations, the clash pairs walked to each pose's first hit (~9 each),
// and ~24 N + 380 operations a gate pair that the dedup reads (~4 pairs a
// row on da_cyclical_xl, ~21 to 26 on chelotropic and the three-molecule
// grid).
//
// Design. Screen: a warp a block row, 4 warps a block. The first design
// (block_screen_row.cu) spent a row's cycles (tools/kernel_phases.py,
// clock64 per phase; da_cyclical_xl / chelotropic / three molecules) on
// building the poses, each lane reading its conformer atom by atom from
// device memory (~10,000 / 12,000 / 9,500 cycles a row); the clash
// screen, the pair list read from device memory pair by pair (6,100 /
// 13,700; the warp regime at 75 pairs 30,500); the dedup (4,600 / 16,300
// / 9,700: a step is K3's whole pair arithmetic, ~30 Newton steps with a
// division each, for as many lanes as have a live angle); its pose write
// (1,600 to 2,400). With ~20 warps an SM every phase is bound by the
// instructions the SM issues, so here:
//   - no pose is written: the row's poses live in the warp's store only;
//   - the block stages the pair list in shared memory once (up to 2,048
//     pairs), and each warp its row's conformers and geometry (3 N + 18
//     M values) in its slice, read once from device memory; the lanes
//     build the row's poses from those copies, a lane an (angle,
//     molecule) part where that takes fewer rounds (36 angles of two
//     molecules: three rounds of a molecule, not four), else a lane an
//     angle;
//   - a lane screens its own pose's pairs, four pairs a step before the
//     early-exit test (K1's thread regime); the warp takes a pose's pairs
//     32 at a time (K1's warp regime) only below 8 angles a row with 64
//     pairs or more, where the lanes would idle;
//   - a passed pose's squared norm is summed once, into its pose's value
//     3 N; registers are capped for 5 blocks an SM (B1_MIN_BLOCKS).
// The store holds a row's A poses `stride` values apart (3 N + 1, made
// odd by the host, so the lanes' 8-byte reads of their own poses fall in
// distinct banks: a stride of 36 at N = 12 gave 4-way conflicts). Where 4
// rows fit in shared memory (the `smem` form, every route chunk) the
// warp's slice (staged row and store) is in shared memory and a warp
// takes one row; otherwise (A N past ~2,400 in float64, the card tests'
// A = 216 at N = 60, DEEP's 5,329 angles) each warp of a grid of `slots`
// warps (as many as a scratch of bounded size holds) owns a slice of a
// global scratch and walks rows slots apart; shared memory then holds the
// staged pair list alone, so any A and N run. Write: a warp a row; a
// ballot of each 32 angles' keep bits gives the kept ones in order and
// their ranks; the warp rebuilds each kept pose, a lane an atom. The host
// reads the scan's total once a chunk to size the survivors, where the
// first design's compaction read a nonzero's count. No atomics, no tensor
// cores: two runs give the same bits.

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
// the screen's blocks an SM must hold: registers capped at 102 a thread
// (uncapped, ptxas took up to 124: 16 warps an SM; tools/kernel_phases.py
// builds and times the other caps, B1_MIN_BLOCKS 0 for none)
#ifndef B1_MIN_BLOCKS
#define B1_MIN_BLOCKS 5
#endif
#if B1_MIN_BLOCKS
#define B1_KEEP_BOUNDS __launch_bounds__(kWarps * 32, B1_MIN_BLOCKS)
#else
#define B1_KEEP_BOUNDS __launch_bounds__(kWarps * 32)
#endif

struct Mols {
  const void* x[kMaxMols];                // conformers (n_m, N_m, 3)
  int n[kMaxMols];                        // atoms N_m
  int M;
};

// the transform of one molecule at one angle from the row's 18 values g
// (R_align, axis, cor, pos0; in device or shared memory) and the angle's
// half sine s and cosine q0: R = R_step R_align and t = cor - R_step cor
// + pos0 (block_screen_row.cu's build_pose)
template <typename T>
__device__ __forceinline__ void frame(const T* __restrict__ g, T s, T q0,
                                      T R[3][3], T t[3]) {
  const T q1 = s * g[9], q2 = s * g[10], q3 = s * g[11];
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
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      R[i][k] = Rs[i][0] * g[k] + Rs[i][1] * g[3 + k] + Rs[i][2] * g[6 + k];
    const T c0 = g[12], c1 = g[13], c2 = g[14];
    t[i] = g[12 + i] - (Rs[i][0] * c0 + Rs[i][1] * c1 + Rs[i][2] * c2) +
           g[15 + i];
  }
}

// atom n of a conformer x (device or shared memory) moved by (R, t)
// into o[3 n .. 3 n + 2]
template <typename T>
__device__ __forceinline__ void pose_atom(const T* __restrict__ x, int n,
                                          const T R[3][3], const T t[3],
                                          T* __restrict__ o) {
  const T x0 = x[3 * n], x1 = x[3 * n + 1], x2 = x[3 * n + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[3 * n + i] = R[i][0] * x0 + R[i][1] * x1 + R[i][2] * x2 + t[i];
}

template <typename T>
__device__ __forceinline__ const T* conformer(const Mols& mols,
                                              const int* __restrict__ confs,
                                              long long r, int m) {
  return static_cast<const T*>(mols.x[m]) +
         (size_t)__ldg(confs + (size_t)r * mols.M + m) * mols.n[m] * 3;
}

// molecule m of the pose of angle a (its atoms, at atom offset off of the
// pose) into pose, one lane, from the row's staged values: its
// conformers' atoms (3 N) then its geometry (M x 18)
template <typename T>
__device__ __forceinline__ void build_part(const T* __restrict__ info,
                                           const T* __restrict__ sc, int a,
                                           int m, int M, int Nm, int off,
                                           int N, T* __restrict__ pose) {
  T R[3][3], t[3];
  frame<T>(info + 3 * N + m * kGeo, __ldg(sc + ((size_t)a * M + m) * 2),
           __ldg(sc + ((size_t)a * M + m) * 2 + 1), R, t);
  const T* x = info + 3 * off;
  T* o = pose + 3 * off;
#pragma unroll 4
  for (int n = 0; n < Nm; ++n) pose_atom<T>(x, n, R, t, o);
}

// one lane: does pose x clash on any listed pair (K1's thread regime)?
// Four pairs a step, then the step's hits: the same d^2 of each pair,
// only the exit a step later
template <typename T>
__device__ __forceinline__ bool lane_clashes(const T* __restrict__ x,
                                             const int2* __restrict__ pairs,
                                             int P, T thr2) {
  int k = 0;
  for (; k + 4 <= P; k += 4) {
    bool hit = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int2 w = pairs[k + u];
      const int i = 3 * w.x, j = 3 * w.y;
      const T dx = x[i] - x[j];
      const T dy = x[i + 1] - x[j + 1];
      const T dz = x[i + 2] - x[j + 2];
      const T d2 = dx * dx + dy * dy + dz * dz;
      hit |= d2 < thr2;
    }
    if (hit) return true;
  }
  for (; k < P; ++k) {
    const int2 w = pairs[k];
    const int i = 3 * w.x, j = 3 * w.y;
    const T dx = x[i] - x[j];
    const T dy = x[i + 1] - x[j + 1];
    const T dz = x[i + 2] - x[j + 2];
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
      const int2 w = pairs[k];
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

// Shared memory of a block of the screen: the pair list (staged up to
// kStagePairs pairs, 16-byte aligned), then in the smem form each warp's
// slice. A warp's slice (of shared memory, or of the global scratch in
// the scratch form): the row's staged values (its conformers' 3 N atoms,
// its M x 18 geometry), then its store of A poses `stride` values apart.
constexpr int kStagePairs = 2048;

__host__ __device__ inline size_t pairs_bytes(int P) {
  return P <= kStagePairs ? ((size_t)P * sizeof(int2) + 15) / 16 * 16 : 0;
}

__host__ __device__ inline size_t warp_vals(int A, int stride, int N,
                                            int M) {
  // rounded to an even count, so each warp's slice stays 16-byte aligned
  const size_t v = (size_t)A * stride + 3 * N + kGeo * M;
  return (v + 1) / 2 * 2;
}

// SMEM: the warp's slice is in shared memory (a row a warp), else in the
// global scratch (rows `slots` apart); WARP_CLASH: the warp screens a
// pose's pairs together. TT_PHASES builds: a warp's record of 8 slots, as
// in block_screen_row.cu: cycles building, writing (none here),
// screening, summing norms and in the dedup, the dedup's steps, the live
// lanes over its steps, rows
template <typename T, bool SMEM, bool WARP_CLASH>
__global__ void B1_KEEP_BOUNDS
block_keep_kernel(Mols mols, const int* __restrict__ confs,
                  const T* __restrict__ geo, const T* __restrict__ sc, int A,
                  const int2* __restrict__ pairs, int P, T thr2, T gate_rmsd,
                  T gate_maxdev, long long rows, int stride, T* scratch,
                  long long slots, unsigned char* keep, int* counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  const int M = mols.M;
  int N = 0;
  for (int m = 0; m < M; ++m) N += mols.n[m];
  // the pair list, once a block, before any warp leaves
  int2* staged = reinterpret_cast<int2*>(smem);
  const size_t pb = pairs_bytes(P);
  if (pb)
    for (int k = threadIdx.x; k < P; k += kWarps * 32) staged[k] = pairs[k];
  __syncthreads();
  const int2* pl = pb ? staged : pairs;
  if (gw >= slots) return;                  // the whole warp
  const size_t slice = warp_vals(A, stride, N, M);
  T* info = SMEM ? reinterpret_cast<T*>(smem + pb) + warp * slice
                 : scratch + gw * slice;
  T* store = info + 3 * N + kGeo * M;
  const T sqrt_n = sqrt((T)N);
  TT_START(8);

  for (long long r = gw; r < rows; r += slots) {
    __syncwarp();                           // the last row's reads done
    TT_RESTART();
    // the row's conformers and geometry, read once, then read by every
    // lane from the warp's slice
    int off = 0;
    for (int m = 0; m < M; ++m) {
      const T* x = conformer<T>(mols, confs, r, m);
      for (int v = lane; v < 3 * mols.n[m]; v += 32)
        info[3 * off + v] = __ldg(x + v);
      off += mols.n[m];
    }
    for (int v = lane; v < kGeo * M; v += 32)
      info[3 * N + v] = __ldg(geo + (size_t)r * M * kGeo + v);
    __syncwarp();
    // the lanes take (angle, molecule) parts where that takes fewer
    // rounds (72 for 36 angles of two molecules: three, where a lane an
    // angle took four), else whole angles
    if ((A * M + 31) / 32 < (A + 31) / 32 * M) {
      for (int it = lane; it < A * M; it += 32) {
        const int a = it / M, m = it - a * M;
        const int off =
            m == 0 ? 0 : m == 1 ? mols.n[0] : mols.n[0] + mols.n[1];
        build_part<T>(info, sc, a, m, M, mols.n[m], off, N,
                      store + (size_t)a * stride);
      }
    } else {
      for (int a = lane; a < A; a += 32)
        for (int m = 0, off = 0; m < M; off += mols.n[m], ++m)
          build_part<T>(info, sc, a, m, M, mols.n[m], off, N,
                        store + (size_t)a * stride);
    }
    __syncwarp();
    TT_LAP(0);

    unsigned char* keep_row = keep + (size_t)r * A;
    int n_kept = 0;
    for (int base = 0; base < A; base += kTile) {
      const int end = min(A, base + kTile);
      // clash screen: bit j of ok is angle base + lane + 32 j
      unsigned ok = 0;
      if (WARP_CLASH) {
        for (int a = base; a < end; ++a) {
          const bool clean = !warp_clashes<T>(store + (size_t)a * stride,
                                              pl, P, thr2, lane);
          if (clean && ((a - base) & 31) == lane)
            ok |= 1u << ((a - base) >> 5);
        }
      } else {
        for (int a = base + lane, j = 0; a < end; a += 32, ++j)
          if (!lane_clashes<T>(store + (size_t)a * stride, pl, P, thr2))
            ok |= 1u << j;
      }
      TT_LAP(2);
      // each passed angle's squared norm, once, in its pose's value 3 N
      for (unsigned rem = ok; rem; rem &= rem - 1) {
        T* Pp = store +
                (size_t)(base + lane + 32 * (__ffs(rem) - 1)) * stride;
        Pp[3 * N] = qcpk::row_norm2<T, 0>(Pp, 3 * N);
      }
      __syncwarp();
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
          if (qcpk::pair_hits<T, 0>(Pp, Q, N, Pp[3 * N], gate_rmsd,
                                    gate_maxdev, sqrt_n))
            live &= ~(1u << j);
        }
      }
      for (int a = base + lane, j = 0; a < end; a += 32, ++j)
        keep_row[a] = (kept >> j) & 1u;
      n_kept += __popc(kept);
      __syncwarp();
      TT_LAP(4);
    }
    n_kept = __reduce_add_sync(kFull, n_kept);
    if (lane == 0) counts[r] = n_kept;
    TT_ADD(7, 1);
  }
  TT_FLUSH(8, gw, lane == 0);
}

// the kept poses of row r at out[offsets[r]], ...: a warp a row, a lane
// an atom
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
block_write_kernel(Mols mols, const int* __restrict__ confs,
                   const T* __restrict__ geo, const T* __restrict__ sc, int A,
                   long long rows, const unsigned char* __restrict__ keep,
                   const long long* __restrict__ offsets, T* out) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;                    // the whole warp
  int N = 0;
  for (int m = 0; m < mols.M; ++m) N += mols.n[m];
  const unsigned char* keep_row = keep + (size_t)r * A;
  long long s = __ldg(offsets + r);
  for (int base = 0; base < A; base += 32) {
    const int a = base + lane;
    for (unsigned bits = __ballot_sync(kFull, a < A && keep_row[a] != 0);
         bits; bits &= bits - 1, ++s) {
      const int at = base + __ffs(bits) - 1;
      T* o = out + (size_t)s * 3 * N;
      for (int m = 0; m < mols.M; ++m) {
        T R[3][3], t[3];
        const size_t am = ((size_t)at * mols.M + m) * 2;
        frame<T>(geo + ((size_t)r * mols.M + m) * kGeo, __ldg(sc + am),
                 __ldg(sc + am + 1), R, t);
        const T* x = conformer<T>(mols, confs, r, m);
        for (int n = lane; n < mols.n[m]; n += 32)
          pose_atom<T>(x, n, R, t, o);
        o += 3 * mols.n[m];
      }
    }
  }
}

template <typename T, bool SMEM, bool WARP_CLASH>
int launch_keep(const Mols& mols, const void* confs, const void* geo,
                const void* sc, int A, const void* pairs, int P, T thr2,
                T gate_rmsd, T gate_maxdev, long long rows, int stride,
                void* scratch, long long slots, void* keep, void* counts,
                cudaStream_t stream) {
  auto kernel = block_keep_kernel<T, SMEM, WARP_CLASH>;
  int N = 0;
  for (int m = 0; m < mols.M; ++m) N += mols.n[m];
  const size_t smem =
      pairs_bytes(P) +
      (SMEM ? kWarps * warp_vals(A, stride, N, mols.M) * sizeof(T) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (slots + kWarps - 1) / kWarps;
  kernel<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      mols, (const int*)confs, (const T*)geo, (const T*)sc, A,
      (const int2*)pairs, P, thr2, gate_rmsd, gate_maxdev, rows, stride,
      (T*)scratch, slots, (unsigned char*)keep, (int*)counts);
  return (int)cudaGetLastError();
}

bool bad_mols(int n0, int n1, int n2, int M) {
  return M < 2 || M > kMaxMols || n0 < 1 || n1 < 1 || (M == 3 && n2 < 1);
}

Mols make_mols(const void* x0, const void* x1, const void* x2, int n0,
               int n1, int n2, int M) {
  return Mols{{x0, x1, M == 3 ? x2 : nullptr}, {n0, n1, M == 3 ? n2 : 0}, M};
}

// scratch null: the smem form (a row a warp, slots >= rows); else the
// scratch form on `slots` warps, each owning a slice of the scratch
// (warp_vals values) and walking rows slots apart. warp_clash: the warp's
// clash screen
template <typename T>
int screen(const void* x0, const void* x1, const void* x2, int n0, int n1,
           int n2, int M, const void* confs, const void* geo, const void* sc,
           int A, const void* pairs, int P, T thr2, T gate_rmsd,
           T gate_maxdev, long long rows, int stride, void* scratch,
           long long slots, void* keep, void* counts, int warp_clash,
           void* stream) {
  if (bad_mols(n0, n1, n2, M) || A < 1 || P < 0 || rows < 0 ||
      stride < 3 * (n0 + n1 + (M == 3 ? n2 : 0)) + 1 || slots < 1 ||
      (scratch == nullptr && slots < rows) ||
      (slots + kWarps - 1) / kWarps > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Mols mols = make_mols(x0, x1, x2, n0, n1, n2, M);
  cudaStream_t s = (cudaStream_t)stream;
#define B1_KEEP(SM, WC)                                                     \
  launch_keep<T, SM, WC>(mols, confs, geo, sc, A, pairs, P, thr2, gate_rmsd, \
                         gate_maxdev, rows, stride, scratch, slots, keep,    \
                         counts, s)
  if (scratch == nullptr)
    return warp_clash ? B1_KEEP(true, true) : B1_KEEP(true, false);
  return warp_clash ? B1_KEEP(false, true) : B1_KEEP(false, false);
#undef B1_KEEP
}

template <typename T>
int write(const void* x0, const void* x1, const void* x2, int n0, int n1,
          int n2, int M, const void* confs, const void* geo, const void* sc,
          int A, long long rows, const void* keep, const void* offsets,
          void* out, void* stream) {
  if (bad_mols(n0, n1, n2, M) || A < 1 || rows < 0 ||
      (rows + kWarps - 1) / kWarps > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  block_write_kernel<T><<<(unsigned)blocks, kWarps * 32, 0,
                          (cudaStream_t)stream>>>(
      make_mols(x0, x1, x2, n0, n1, n2, M), (const int*)confs, (const T*)geo,
      (const T*)sc, A, rows, (const unsigned char*)keep,
      (const long long*)offsets, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int block_keep_f32(const void* x0, const void* x1, const void* x2, int n0,
                   int n1, int n2, int M, const void* confs, const void* geo,
                   const void* sc, int A, const void* pairs, int P,
                   float thr2, float gate_rmsd, float gate_maxdev,
                   long long rows, int stride, void* scratch,
                   long long slots, void* keep, void* counts, int warp_clash,
                   void* stream) {
  return screen<float>(x0, x1, x2, n0, n1, n2, M, confs, geo, sc, A, pairs,
                       P, thr2, gate_rmsd, gate_maxdev, rows, stride,
                       scratch, slots, keep, counts, warp_clash, stream);
}

int block_keep_f64(const void* x0, const void* x1, const void* x2, int n0,
                   int n1, int n2, int M, const void* confs, const void* geo,
                   const void* sc, int A, const void* pairs, int P,
                   double thr2, double gate_rmsd, double gate_maxdev,
                   long long rows, int stride, void* scratch,
                   long long slots, void* keep, void* counts, int warp_clash,
                   void* stream) {
  return screen<double>(x0, x1, x2, n0, n1, n2, M, confs, geo, sc, A, pairs,
                        P, thr2, gate_rmsd, gate_maxdev, rows, stride,
                        scratch, slots, keep, counts, warp_clash, stream);
}

int block_write_f32(const void* x0, const void* x1, const void* x2, int n0,
                    int n1, int n2, int M, const void* confs, const void* geo,
                    const void* sc, int A, long long rows, const void* keep,
                    const void* offsets, void* out, void* stream) {
  return write<float>(x0, x1, x2, n0, n1, n2, M, confs, geo, sc, A, rows,
                      keep, offsets, out, stream);
}

int block_write_f64(const void* x0, const void* x1, const void* x2, int n0,
                    int n1, int n2, int M, const void* confs, const void* geo,
                    const void* sc, int A, long long rows, const void* keep,
                    const void* offsets, void* out, void* stream) {
  return write<double>(x0, x1, x2, n0, n1, n2, M, confs, geo, sc, A, rows,
                       keep, offsets, out, stream);
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
