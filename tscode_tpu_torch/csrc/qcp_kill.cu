// QCP two-gate pair kill for the bucketed RMSD prune (kernel K3 of the
// port), designed for Hopper: a row's walk is split over the lanes of a
// warp.
//
// Replaces the Pallas TPU kernel tscode_tpu/ops/pallas/qcp.py:240
// (qcp_kill_blocks_pallas, defined at :219, body _one_block), whose
// semantics are those of the prune's pair math,
// tscode_tpu/ops/rmsd_prune._pair_kill_core: an active row p dies when
// some later row q of its chunk, active at pass start, has Kabsch rmsd
// < thr AND maximum per-atom deviation < 2*thr (no centering). A q
// counts even if it dies in the same pass, so the kill bit is an OR
// over pairs and any early exit is only a shortcut.
//
// Interface: the pool hs (n, N, 3); the active rows act (M,) in pool
// order; end (M,), the exclusive end (a position in act) of each
// position's chunk; thr; the launch plan (lanes_log2, budget). Output
// kill (M,). One launch covers one whole prune pass, with no host sync.
//
// Pair arithmetic, operation by operation as the thread-per-row design
// had it (the float64 gates rest on it): the 3x3 correlation S summed in
// atom order, Theobald's quartic coefficients, lambda_max by Newton from
// (GA+GB)/2 (12 steps in f32, 30 in f64, IEEE division, denominator
// guarded at 1e-30, no early stop), then the rmsd gate. Since maxdev <=
// sqrt(N)*rmsd after the optimal rotation, the maxdev gate follows from
// the rmsd gate for N <= 4; for N > 4 the Horn adjugate eigenvector ->
// rotation -> maxdev path runs only in the band sqrt(N)*rmsd >= 2*thr.
//
// Bound on this card. A pass reads each active row once (48 B in f32 at
// N = 4) plus act and end, and writes one byte per row: the headline's
// first pass (k = 10,000, 202,362 rows) moves 11.5 MB, 3.4 us at
// 3.35 TB/s, while the ~236 k pair evaluations its data need (~350
// flops each) take 1.2 us at 67 TFLOP/s: bound by bytes. But one pair is
// a dependent chain of ~2,000 cycles (the act[q] gather, the pose load,
// 12 Newton steps with a division each, a sqrt), so a design that walks
// a row on one thread runs for its longest row: 754 pairs at that pass,
// ~0.8 ms, ~0.4% of the bound.
//
// Design. Phase 1: each warp takes 32 >> lanes_log2 consecutive rows,
// 2^lanes_log2 lanes per row; the lanes of a row take q = p+1+sub,
// p+1+sub+g, ... (g = 2^lanes_log2) for the first `budget` candidates,
// and a row is decided when a lane of its group hits (a masked
// __ballot_sync, the same in every lane of the group) or its candidates
// run out; the loop is warp-uniform (__any_sync) with no block barrier
// per row. Phase 2: the rows still undecided after the budget go to a
// block-wide list in shared memory; the block's warps take them one at
// a time (an atomic counter) and walk each 32 candidates a step, one per
// lane, leaving at the first step with a hit. A 754-pair walk becomes
// ~24 warp steps, and a 19-candidate walk one. The host picks the plan
// per pass from the active count (ops/kernels/qcp.launch_plan, measured
// by chip_smoke.py --qcp-plans): one lane per row when the pass has
// rows enough to fill the card, more lanes per row when it has few, and
// a budget of one step, so phase 1 decides the rows whose first
// candidates hit and phase 2 walks the rest. On an H100 the headline's
// first pass fell from 0.81 to 0.029 ms in f32 (PERF.md). Per-pair
// latency: each lane loads the
// next candidate's pose and the index after it before the current
// pair's Newton loop (a register double buffer), and at N = 4 a pose
// arrives in 16-byte words (3 in f32, 6 in f64) when the pool is
// 16-byte aligned. GA is computed once per row; GB stays per pair: it is
// summed in the same loop as S from the values already loaded, off the
// Newton chain, and a per-row table would cost a second pass over the
// pool.
//
// No tensor cores: the inner dimension is N*3 = 12 at the headline, and
// a matrix-product form of S would change the rounding that the exact
// float64 gates rest on.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // warps per block
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct NewtonSteps;
template <> struct NewtonSteps<float> { static constexpr int value = 12; };
template <> struct NewtonSteps<double> { static constexpr int value = 30; };

template <typename T>
__device__ __forceinline__ T det3(T a00, T a01, T a02, T a10, T a11, T a12,
                                  T a20, T a21, T a22) {
  return a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20) +
         a02 * (a10 * a21 - a11 * a20);
}

// 16-byte words of a pose
template <typename T> struct Word16;
template <> struct Word16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(float* d, float4 w) {
    d[0] = w.x; d[1] = w.y; d[2] = w.z; d[3] = w.w;
  }
};
template <> struct Word16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ void unpack(double* d, double2 w) {
    d[0] = w.x; d[1] = w.y;
  }
};

// A pose of NA atoms held in registers (NA > 0), loaded in 16-byte words
// when VEC; with NA == 0 (any N) a pointer into the pool instead.
template <typename T, int NA, bool VEC> struct Pose {
  T v[3 * NA];
  __device__ __forceinline__ void load(const T* __restrict__ src) {
    if constexpr (VEC) {
      using W = Word16<T>;
      const typename W::type* s =
          reinterpret_cast<const typename W::type*>(src);
#pragma unroll
      for (int i = 0; i < 3 * NA / W::n; ++i) W::unpack(v + i * W::n,
                                                         __ldg(s + i));
    } else {
#pragma unroll
      for (int i = 0; i < 3 * NA; ++i) v[i] = __ldg(src + i);
    }
  }
  __device__ __forceinline__ const T* data() const { return v; }
};

template <typename T, bool VEC> struct Pose<T, 0, VEC> {
  const T* p;
  __device__ __forceinline__ void load(const T* src) { p = src; }
  __device__ __forceinline__ const T* data() const { return p; }
};

// Does the pair (p, q) pass both similarity gates? N = NA when NA > 0.
template <typename T, int NA>
__device__ __forceinline__ bool pair_hits(const T* __restrict__ P,
                                          const T* __restrict__ Q, int n_rt,
                                          T GA, T thr, T two_thr, T sqrt_n) {
  const int N = NA > 0 ? NA : n_rt;
  T Sxx = 0, Sxy = 0, Sxz = 0, Syx = 0, Syy = 0, Syz = 0, Szx = 0, Szy = 0,
    Szz = 0, GB = 0;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const T px = P[3 * n], py = P[3 * n + 1], pz = P[3 * n + 2];
    const T qx = Q[3 * n], qy = Q[3 * n + 1], qz = Q[3 * n + 2];
    Sxx += px * qx; Sxy += px * qy; Sxz += px * qz;
    Syx += py * qx; Syy += py * qy; Syz += py * qz;
    Szx += pz * qx; Szy += pz * qy; Szz += pz * qz;
    GB += qx * qx + qy * qy + qz * qz;
  }

  // characteristic quartic of Horn's key matrix: x^4 + C2 x^2 + C1 x + C0
  const T Sxx2 = Sxx * Sxx, Syy2 = Syy * Syy, Szz2 = Szz * Szz;
  const T Sxy2 = Sxy * Sxy, Syz2 = Syz * Syz, Sxz2 = Sxz * Sxz;
  const T Syx2 = Syx * Syx, Szy2 = Szy * Szy, Szx2 = Szx * Szx;
  const T SyzSzymSyySzz2 = (T)2 * (Syz * Szy - Syy * Szz);
  const T Sxx2Syy2Szz2Syz2Szy2 = Syy2 + Szz2 - Sxx2 + Syz2 + Szy2;
  const T C2 = (T)-2 * (Sxx2 + Syy2 + Szz2 + Sxy2 + Syx2 + Sxz2 + Szx2 +
                        Syz2 + Szy2);
  const T C1 = (T)8 * (Sxx * Syz * Szy + Syy * Szx * Sxz + Szz * Sxy * Syx -
                       Sxx * Syy * Szz - Syz * Szx * Sxy - Szy * Syx * Sxz);
  const T SxzpSzx = Sxz + Szx, SyzpSzy = Syz + Szy, SxypSyx = Sxy + Syx;
  const T SyzmSzy = Syz - Szy, SxzmSzx = Sxz - Szx, SxymSyx = Sxy - Syx;
  const T SxxpSyy = Sxx + Syy, SxxmSyy = Sxx - Syy;
  const T Sxy2Sxz2Syx2Szx2 = Sxy2 + Sxz2 - Syx2 - Szx2;
  const T C0 =
      Sxy2Sxz2Syx2Szx2 * Sxy2Sxz2Syx2Szx2 +
      (Sxx2Syy2Szz2Syz2Szy2 + SyzSzymSyySzz2) *
          (Sxx2Syy2Szz2Syz2Szy2 - SyzSzymSyySzz2) +
      (-(SxzpSzx)*SyzmSzy + SxymSyx * (SxxmSyy - Szz)) *
          (-(SxzmSzx)*SyzpSzy + SxymSyx * (SxxmSyy + Szz)) +
      (-(SxzpSzx)*SyzpSzy - SxypSyx * (SxxpSyy - Szz)) *
          (-(SxzmSzx)*SyzmSzy - SxypSyx * (SxxpSyy + Szz)) +
      (SxypSyx * SyzpSzy + SxzpSzx * (SxxmSyy + Szz)) *
          (-(SxymSyx)*SyzmSzy + SxzpSzx * (SxxpSyy + Szz)) +
      (SxypSyx * SyzmSzy + SxzmSzx * (SxxmSyy - Szz)) *
          (-(SxymSyx)*SyzpSzy + SxzmSzx * (SxxpSyy - Szz));

  T lam = (T)0.5 * (GA + GB);
#pragma unroll
  for (int it = 0; it < NewtonSteps<T>::value; ++it) {
    const T lam2 = lam * lam;
    const T b = (lam2 + C2) * lam;
    const T a = b + C1;
    const T num = a * lam + C0;
    T den = (T)2 * lam2 * lam + b + a;
    den = fabs(den) > (T)1e-30 ? den : (T)1e-30;
    lam = lam - num / den;
  }

  const T msd = (GA + GB - (T)2 * lam) / (T)N;
  const T rmsd = sqrt(msd > (T)0 ? msd : (T)0);
  if (!(rmsd < thr)) return false;
  if (N <= 4 || !(sqrt_n * rmsd >= two_thr)) return true;

  // ambiguous band: eigenvector of Horn's key matrix from the adjugate
  // of (K - lam I), first row of largest norm, identity if degenerate
  T A[4][4];
  A[0][0] = Sxx + Syy + Szz - lam; A[0][1] = Syz - Szy;
  A[0][2] = Szx - Sxz;             A[0][3] = Sxy - Syx;
  A[1][1] = Sxx - Syy - Szz - lam; A[1][2] = Sxy + Syx;
  A[1][3] = Szx + Sxz;
  A[2][2] = -Sxx + Syy - Szz - lam; A[2][3] = Syz + Szy;
  A[3][3] = -Sxx - Syy + Szz - lam;
  A[1][0] = A[0][1]; A[2][0] = A[0][2]; A[3][0] = A[0][3];
  A[2][1] = A[1][2]; A[3][1] = A[1][3]; A[3][2] = A[2][3];

  T best[4] = {0, 0, 0, 0};
  T best_n2 = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int r0 = r == 0 ? 1 : 0, r1 = r <= 1 ? 2 : 1, r2 = r <= 2 ? 3 : 2;
    T c[4];
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const int c0 = col == 0 ? 1 : 0, c1 = col <= 1 ? 2 : 1,
                c2 = col <= 2 ? 3 : 2;
      const T m = det3(A[r0][c0], A[r0][c1], A[r0][c2], A[r1][c0], A[r1][c1],
                       A[r1][c2], A[r2][c0], A[r2][c1], A[r2][c2]);
      c[col] = ((r + col) & 1) ? -m : m;
    }
    const T n2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + c[3] * c[3];
    if (r == 0 || n2 > best_n2) {
      best[0] = c[0]; best[1] = c[1]; best[2] = c[2]; best[3] = c[3];
      best_n2 = n2;
    }
  }
  T qw = 1, qx = 0, qy = 0, qz = 0;
  if (best_n2 > (T)1e-22) {
    const T s = sqrt(best_n2 > (T)1e-30 ? best_n2 : (T)1e-30);
    qw = best[0] / s; qx = best[1] / s;
    qy = best[2] / s; qz = best[3] / s;
  }
  const T R00 = (T)2 * (qw * qw + qx * qx) - (T)1;
  const T R01 = (T)2 * (qx * qy - qw * qz);
  const T R02 = (T)2 * (qx * qz + qw * qy);
  const T R10 = (T)2 * (qx * qy + qw * qz);
  const T R11 = (T)2 * (qw * qw + qy * qy) - (T)1;
  const T R12 = (T)2 * (qy * qz - qw * qx);
  const T R20 = (T)2 * (qx * qz - qw * qy);
  const T R21 = (T)2 * (qy * qz + qw * qx);
  const T R22 = (T)2 * (qw * qw + qz * qz) - (T)1;

  T maxdev2 = 0;
  for (int n = 0; n < N; ++n) {
    const T px = P[3 * n], py = P[3 * n + 1], pz = P[3 * n + 2];
    const T dx = R00 * px + R01 * py + R02 * pz - Q[3 * n];
    const T dy = R10 * px + R11 * py + R12 * pz - Q[3 * n + 1];
    const T dz = R20 * px + R21 * py + R22 * pz - Q[3 * n + 2];
    const T d2 = dx * dx + dy * dy + dz * dz;
    maxdev2 = d2 > maxdev2 ? d2 : maxdev2;
  }
  return sqrt(maxdev2) < two_thr;
}

// squared norm of a row, summed element by element
template <typename T, int NA>
__device__ __forceinline__ T row_norm2(const T* P, int stride) {
  const int S3 = NA > 0 ? 3 * NA : stride;
  T G = 0;
#pragma unroll
  for (int i = 0; i < S3; ++i) G += P[i] * P[i];
  return G;
}

template <typename T, int NA, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
qcp_kill_warp_kernel(const T* __restrict__ hs, int N,
                     const int* __restrict__ act,
                     const int* __restrict__ end, int M, T thr,
                     int lanes_log2, int budget,
                     unsigned char* __restrict__ kill) {
  __shared__ int undecided[kWarps * 32];
  __shared__ int n_undecided, next_row;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = 1 << lanes_log2;            // lanes per row in phase 1
  const int sub = lane & (g - 1), grp = lane >> lanes_log2;
  const unsigned gmask = g == 32 ? kFull : ((1u << g) - 1u) << (grp * g);
  const int stride = 3 * N;
  const T two_thr = (T)2 * thr;
  const T sqrt_n = sqrt((T)N);
  if (threadIdx.x == 0) {
    n_undecided = 0;
    next_row = 0;
  }
  __syncthreads();

  // phase 1: the g lanes of row p take q = p+1+sub, p+1+sub+g, ... below
  // lim = min(end[p], p+1+budget)
  const int p = (blockIdx.x * kWarps + warp) * (32 >> lanes_log2) + grp;
  const bool live = p < M;
  const int e = live ? end[p] : 0;
  const int lim = e - p - 1 <= budget ? e : p + 1 + budget;
  Pose<T, NA, VEC> P, Q, Qn;
  T GA = 0;
  int q = p + 1 + sub, qi_next = 0;
  if (live) {
    P.load(hs + (size_t)act[p] * stride);
    GA = row_norm2<T, NA>(P.data(), stride);
    if (q < lim) Q.load(hs + (size_t)act[q] * stride);
    if (q + g < lim) qi_next = act[q + g];
  }
  bool hit = false;                         // the same in the row's lanes
  for (;;) {
    const bool mine = live && !hit && q < lim;
    if (!__any_sync(kFull, mine)) break;
    // prefetch the next candidate's pose and the index after it
    int qi_after = 0;
    if (mine && q + g < lim) Qn.load(hs + (size_t)qi_next * stride);
    if (mine && q + 2 * g < lim) qi_after = act[q + 2 * g];
    const bool h = mine && pair_hits<T, NA>(P.data(), Q.data(), N, GA, thr,
                                            two_thr, sqrt_n);
    const unsigned hits = __ballot_sync(kFull, h);   // every lane votes
    hit = hit || (hits & gmask) != 0;
    Q = Qn;
    qi_next = qi_after;
    q += g;
  }
  if (live && sub == 0) {
    if (hit || lim >= e)
      kill[p] = hit;
    else
      undecided[atomicAdd(&n_undecided, 1)] = p;
  }
  __syncthreads();

  // phase 2: the block's warps take its undecided rows one at a time,
  // 32 candidates a step from p+1+budget on
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(&next_row, 1);
    i = __shfl_sync(kFull, i, 0);
    if (i >= n_undecided) break;
    const int r = undecided[i];
    const int er = end[r];
    Pose<T, NA, VEC> R, Q2, Q2n;
    R.load(hs + (size_t)act[r] * stride);
    const T GR = row_norm2<T, NA>(R.data(), stride);
    int base = r + 1 + budget, qj_next = 0;
    if (base + lane < er) Q2.load(hs + (size_t)act[base + lane] * stride);
    if (base + 32 + lane < er) qj_next = act[base + 32 + lane];
    bool found = false;
    for (; base < er; base += 32) {         // warp-uniform
      const int qq = base + lane;
      int qj_after = 0;
      if (qq + 32 < er) Q2n.load(hs + (size_t)qj_next * stride);
      if (qq + 64 < er) qj_after = act[qq + 64];
      const bool h = qq < er && pair_hits<T, NA>(R.data(), Q2.data(), N, GR,
                                                 thr, two_thr, sqrt_n);
      if (__ballot_sync(kFull, h)) {
        found = true;
        break;
      }
      Q2 = Q2n;
      qj_next = qj_after;
    }
    if (lane == 0) kill[r] = found;
  }
}

template <typename T, int NA, bool VEC>
int launch_instance(const T* hs, int N, const int* act, const int* end,
                    int M, T thr, int lanes_log2, int budget,
                    unsigned char* kill, cudaStream_t stream) {
  const int rows_per_block = kWarps * (32 >> lanes_log2);
  const int blocks = (M + rows_per_block - 1) / rows_per_block;
  qcp_kill_warp_kernel<T, NA, VEC><<<blocks, kWarps * 32, 0, stream>>>(
      hs, N, act, end, M, thr, lanes_log2, budget, kill);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_qcp(const void* hs, int N, const void* act, const void* end,
               int M, T thr, int lanes_log2, int budget, void* kill,
               void* stream) {
  if (M <= 0) return 0;
  if (lanes_log2 < 0 || lanes_log2 > 5 || budget < 0)
    return (int)cudaErrorInvalidValue;
  const T* h = (const T*)hs;
  const int* a = (const int*)act;
  const int* e = (const int*)end;
  unsigned char* k = (unsigned char*)kill;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 4) {
    if ((uintptr_t)hs % 16 == 0)
      return launch_instance<T, 4, true>(h, N, a, e, M, thr, lanes_log2,
                                         budget, k, s);
    return launch_instance<T, 4, false>(h, N, a, e, M, thr, lanes_log2,
                                        budget, k, s);
  }
  return launch_instance<T, 0, false>(h, N, a, e, M, thr, lanes_log2, budget,
                                      k, s);
}

}  // namespace

extern "C" {

int qcp_kill_f32(const void* hs, int N, const void* act, const void* end,
                 int M, float thr, int lanes_log2, int budget, void* kill,
                 void* stream) {
  return launch_qcp<float>(hs, N, act, end, M, thr, lanes_log2, budget, kill,
                           stream);
}

int qcp_kill_f64(const void* hs, int N, const void* act, const void* end,
                 int M, double thr, int lanes_log2, int budget, void* kill,
                 void* stream) {
  return launch_qcp<double>(hs, N, act, end, M, thr, lanes_log2, budget,
                            kill, stream);
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
