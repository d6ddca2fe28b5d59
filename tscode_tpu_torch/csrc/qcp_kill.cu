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
// The second entry, qcp_kill_dev_f32/f64, takes a pass whose row count M
// the card holds (an int32 in device memory, written by the compaction
// before it): it reads M, runs only when the schedule's gate k == 1 or
// 20 k < M is open, derives the plan from M as the host would, clears
// alive[act[p]] for each killed row, and its grid is fixed for the
// largest M its buffers hold. So a whole schedule of passes can be
// captured in one CUDA graph (ops/rmsd_prune.device_schedule). Both
// entries launch the same kernel, so the pair arithmetic is the same.
//
// Pair arithmetic (qcp_pair.cuh, shared with the block sweep B1),
// operation by operation as the thread-per-row design had it (the
// float64 gates rest on it): the 3x3 correlation S summed in atom order,
// Theobald's quartic coefficients, lambda_max by Newton from (GA+GB)/2
// (12 steps in f32, 30 in f64, IEEE division, denominator guarded at
// 1e-30, no early stop), then the rmsd gate. Since maxdev <=
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

#include "qcp_pair.cuh"

namespace {

using qcpk::pair_hits;
using qcpk::row_norm2;

constexpr int kWarps = 4;                 // warps per block
constexpr unsigned kFull = 0xffffffffu;

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

// the lanes per row (log2) of a pass over M rows, ops/kernels/qcp.py's
// launch_plan: the most, up to 32, that keep the pass at plan_warps warps
__device__ __forceinline__ int plan_lanes(long long M, int plan_warps) {
  int l = 0;
  while (l < 5 && (M * (2LL << l) + 31) / 32 <= plan_warps) ++l;
  return l;
}

// One kernel for both entries. With m_dev null the host gives the pass
// (M, lanes_log2, budget). With m_dev set (the capturable entry) the
// block reads M there, leaves when the schedule's gate of pass k, k == 1
// or 20 k < M, is shut, and derives the plan from M by launch_plan's
// rule; the grid then covers the largest plan of any M the buffers hold
// and the blocks past the pass's rows leave at once. With alive set, a
// killed row's bit alive[act[p]] is cleared too (the kernel never reads
// alive, so the update is safe inside the pass).
template <typename T, int NA, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
qcp_kill_warp_kernel(const T* __restrict__ hs, int N,
                     const int* __restrict__ act,
                     const int* __restrict__ end, int M, T thr,
                     int lanes_log2, int budget,
                     unsigned char* __restrict__ kill,
                     const int* __restrict__ m_dev, long long k,
                     int plan_warps, int budget_steps,
                     unsigned char* __restrict__ alive) {
  __shared__ int undecided[kWarps * 32];
  __shared__ int n_undecided, next_row;
  if (m_dev != nullptr) {                   // uniform over the grid
    M = *m_dev;
    if (!(k == 1 || 20 * k < (long long)M)) return;
    lanes_log2 = plan_lanes(M, plan_warps);
    budget = budget_steps << lanes_log2;
  }
  if ((long long)blockIdx.x * (kWarps * (32 >> lanes_log2)) >= M) return;
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
    if (hit || lim >= e) {
      kill[p] = hit;
      if (hit && alive != nullptr) alive[act[p]] = 0;
    } else
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
    if (lane == 0) {
      kill[r] = found;
      if (found && alive != nullptr) alive[act[r]] = 0;
    }
  }
}

// what a launch is given besides the pool: the pass's rows, its plan (or
// the device count, the gate and the plan rule), the outputs
struct PassArgs {
  const int* act;
  const int* end;
  int M, lanes_log2, budget;
  unsigned char* kill;
  const int* m_dev;
  long long k;
  int plan_warps, budget_steps;
  unsigned char* alive;
};

template <typename T, int NA, bool VEC>
int launch_instance(const T* hs, int N, T thr, const PassArgs& a, int blocks,
                    cudaStream_t stream) {
  qcp_kill_warp_kernel<T, NA, VEC><<<blocks, kWarps * 32, 0, stream>>>(
      hs, N, a.act, a.end, a.M, thr, a.lanes_log2, a.budget, a.kill, a.m_dev,
      a.k, a.plan_warps, a.budget_steps, a.alive);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_qcp(const void* hs, int N, T thr, const PassArgs& a, int blocks,
               void* stream) {
  if (blocks <= 0) return 0;
  const T* h = (const T*)hs;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 4) {
    if ((uintptr_t)hs % 16 == 0)
      return launch_instance<T, 4, true>(h, N, thr, a, blocks, s);
    return launch_instance<T, 4, false>(h, N, thr, a, blocks, s);
  }
  return launch_instance<T, 0, false>(h, N, thr, a, blocks, s);
}

// a pass of M rows given by the host: exactly its plan's blocks
template <typename T>
int launch_host_pass(const void* hs, int N, const void* act, const void* end,
                     int M, T thr, int lanes_log2, int budget, void* kill,
                     void* stream) {
  if (M <= 0) return 0;
  if (lanes_log2 < 0 || lanes_log2 > 5 || budget < 0)
    return (int)cudaErrorInvalidValue;
  const int rows_per_block = kWarps * (32 >> lanes_log2);
  const PassArgs a{(const int*)act, (const int*)end, M, lanes_log2, budget,
                   (unsigned char*)kill, nullptr, 0, 0, 0, nullptr};
  return launch_qcp<T>(hs, N, thr, a, (M + rows_per_block - 1) /
                                          rows_per_block, stream);
}

// a pass whose row count M lies in device memory (m_dev) and whose gate
// is k's: `blocks` fixed by the caller for the largest M it can hold
template <typename T>
int launch_device_pass(const void* hs, int N, const void* act,
                       const void* end, const void* m_dev, long long k, T thr,
                       int plan_warps, int budget_steps, int blocks,
                       void* kill, void* alive, void* stream) {
  if (m_dev == nullptr || k < 1 || plan_warps < 1 || budget_steps < 0 ||
      budget_steps > (1 << 20))
    return (int)cudaErrorInvalidValue;
  const PassArgs a{(const int*)act, (const int*)end, 0, 0, 0,
                   (unsigned char*)kill, (const int*)m_dev, k, plan_warps,
                   budget_steps, (unsigned char*)alive};
  return launch_qcp<T>(hs, N, thr, a, blocks, stream);
}

}  // namespace

extern "C" {

int qcp_kill_f32(const void* hs, int N, const void* act, const void* end,
                 int M, float thr, int lanes_log2, int budget, void* kill,
                 void* stream) {
  return launch_host_pass<float>(hs, N, act, end, M, thr, lanes_log2, budget,
                                 kill, stream);
}

int qcp_kill_f64(const void* hs, int N, const void* act, const void* end,
                 int M, double thr, int lanes_log2, int budget, void* kill,
                 void* stream) {
  return launch_host_pass<double>(hs, N, act, end, M, thr, lanes_log2,
                                  budget, kill, stream);
}

int qcp_kill_dev_f32(const void* hs, int N, const void* act, const void* end,
                     const void* m_dev, long long k, float thr,
                     int plan_warps, int budget_steps, int blocks, void* kill,
                     void* alive, void* stream) {
  return launch_device_pass<float>(hs, N, act, end, m_dev, k, thr, plan_warps,
                                   budget_steps, blocks, kill, alive, stream);
}

int qcp_kill_dev_f64(const void* hs, int N, const void* act, const void* end,
                     const void* m_dev, long long k, double thr,
                     int plan_warps, int budget_steps, int blocks,
                     void* kill, void* alive, void* stream) {
  return launch_device_pass<double>(hs, N, act, end, m_dev, k, thr,
                                    plan_warps, budget_steps, blocks, kill,
                                    alive, stream);
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
