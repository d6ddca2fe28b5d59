// The dimer saddle search on the internal force field, every step of a
// structure in one launch (D1).
//
// Replaces no Pallas kernel: the JAX package runs
// tscode_tpu/saddle.py:21 dimer_saddle as one jitted program, a
// lax.scan over n_steps whose body is the dimer step on jax.grad of the
// energy. The port ran that step (18 finite-difference Hessian actions
// and a force, ~2,600 PyTorch kernels) captured in a CUDA graph and
// replayed n_steps times from the host (saddle._dimer_step under
// capture.graph_loop).
//
// What the kernel computes, for each structure, for at most n_steps
// steps of saddle._dimer_step on the analytic forces of ff_forces.cuh
// (ff.FireTerms: the force field, springs and half-springs):
//   4 power steps    u <- normalize(project(hv(u))), u from v;
//   sigma = 1.1 |u . hv(u)| + 1;
//   n_rot shifts     v <- normalize(project(sigma v - hv(v)));
//   curv = v . hv(v); the force f at c;
//   the climbing rule, the done latch and the step clipped to 0.1 A.
// hv(x) = -(F(c + dr x) - F(c - dr x)) / (2 dr), each displaced
// coordinate c + (dr x) rounded as PyTorch rounds it; project subtracts
// the mean over atoms (not for one atom); normalize divides by the norm
// floored at 1e-12. The products and sums of the vector algebra are
// rounded one by one (__dmul_rn, __dadd_rn: no contraction into fused
// multiply-adds), as PyTorch's elementwise ops round them. A structure
// leaves its loop once done has latched: its coordinates no longer move
// from there, so the outputs equal the JAX scan's full length. v0 is the
// caller's (saddle.dimer_start's bits).
//
// Every reduction (the mean, the norms, the dots, the largest atomic
// force and step) is taken in one fixed order: each 32-atom chunk by xor
// butterfly, the chunks in order (the staged form: a thread an atom,
// a warp a chunk, the warps in order), then in a cluster the blocks'
// sums in rank order, read by every thread. No atomics: two launches
// repeat their bits, and every thread holds the same sums, so the
// branches are uniform. Each atom's force is summed from zero in
// ff.incidence order, then its springs, in every form; so on one block
// every form gives the staged form's bits.
//
// Bound. A step evaluates the force field 37 times (18 Hessian actions
// of two displaced copies, and f): ~20 flops a pair term, ~60 an angle,
// ~110 a dihedral, on every term of the topology, plus ~60 flops an atom
// of vector algebra per action; the tables and coordinates are read once
// and the coordinates written once. So a call is bound by operations
// (at 34 TFLOP/s f64, microseconds for the scan's 27-atom ring), but a
// lone structure runs as a chain of 18 dependent Hessian actions a step
// (the force at c rides in the last one's pass), each a term pass, the
// atoms' sums and two reductions: latency, not throughput, sets its
// pace.
//
// The forms (ops/kernels/dimer.launch_plan picks lone where its shared
// memory fits, else large):
//   lone    one structure on W warps (W in 1, 2, 4, 8, 16), all of it in
//           shared memory. Each action first writes the two displaced
//           copies, c + (dr x) and c - (dr x), once (the terms then read
//           plain coordinates, the same bits as the staged form's
//           reads); a thread a (copy, term) slot, the slots grouped by
//           kind so that a warp holds one kind, stages its term's forces
//           in the entries, held transposed (atom a's k-th entry at k N +
//           a); a thread a (copy, atom, component) sums them
//           (neighbouring threads reading neighbouring values); a thread
//           an atom adds the springs and forms hv, then the reductions
//           (shuffles, one barrier each: __syncwarp on one warp, bar.sync
//           1 on more). The last action evaluates c as a third copy in
//           its pass.
//   large   a thread-block cluster a structure (16 blocks: past the
//           portable 8, by the non-portable attribute), the atoms split
//           between the blocks, G lanes an atom (a power of two) walking
//           its incidence entries, each lane loading the codes and then
//           the terms of 4 of its entries before it computes them, the
//           group's values gathered in entry order by shuffles. Each
//           block holds the structure's
//           coordinates and both copies in shared memory where they fit
//           (9 N values; an owner writes its atoms' values into every
//           block's copy through distributed shared memory), else in
//           device memory, written once an action and read through L2;
//           partial sums through distributed shared memory in rank order,
//           cluster barriers between the phases.
//   staged  the first design, the yardstick: a block a structure, the state
//           and each entry's force for both copies in shared memory, a
//           thread a (copy, term) then a (copy, atom), every coordinate
//           read of a term recomputing c +- (dr x) (Displaced), the force
//           at c a pass of its own, block reductions over 16 warps.
// Entries dimer_f32 / dimer_f64 return the cudaError_t of the launch;
// dimer_info reports a form's registers, local memory and resident
// blocks. TT_PHASES builds (csrc/phases.cuh, tools/kernel_phases.py): a
// structure's record of cycles by phase (Lap).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "ff_forces.cuh"
#include "phases.cuh"

namespace cg = cooperative_groups;
using namespace ffk;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr long long STATIC_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr int PORTABLE_CLUSTER = 8;    // the portable cluster size
constexpr int MAX_CLUSTER = 16;        // past it: the non-portable size

enum Form : int { FORM_STAGED = 0, FORM_LONE = 1, FORM_LARGE = 2 };
// kernels (a type's): staged, lone, large in device memory, large in
// shared memory; both types
constexpr int N_KERNELS = 8;
// the launch plan, a host array: ops/kernels/dimer.Plan.args
enum PlanField : int { P_FORM, P_THREADS, P_SMEM, P_ENTRIES, P_CLUSTER,
                       P_LANES, P_SHARED, P_SLOTS, P_LO0, P_LO1, P_LO2,
                       P_LO3, P_DEGREE, N_PLAN };
// the large form's walk: each lane loads this many of its entries' codes,
// then their terms, before it computes any of them
constexpr int WALK_BATCH = 4;
// TT_PHASES builds (tools/kernel_phases.py): a structure's record, the
// cycles of its first thread by phase (each lap ends at the barrier that
// closes the phase, so it holds the slowest thread's time), then counts
enum Lap : int { L_TERM, L_ATOM, L_REDUCE, L_ALGEBRA, L_FORCE, L_SETUP,
                 L_STEPS, L_PASSES, N_LAPS };
using Laps = TtLaps<N_LAPS>;

// products, sums and quotients rounded one at a time
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double quot(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float quot(float a, float b) {
  return __fdiv_rn(a, b);
}

// x . y of one atom's three components, summed in order
template <typename T>
__device__ __forceinline__ T dot_atom(const T* x, const T* y) {
  return add(add(mul(x[0], y[0]), mul(x[1], y[1])), mul(x[2], y[2]));
}

// the coordinates of a displaced copy: c + (h x) (minus: c - (h x)), or
// c itself where x is null. Plain loads: the state may lie in device
// memory that this block writes between barriers.
template <typename T>
struct Displaced {
  const T* c;
  const T* x;
  T h;
  bool minus;
  __device__ __forceinline__ T operator()(int a, int k) const {
    const int i = 3 * a + k;
    if (!x) return c[i];
    const T d = mul(h, x[i]);
    return minus ? sub(c[i], d) : add(c[i], d);
  }
};

// three sums and a max over the block, the same bits in every thread:
// each warp by xor butterfly, then the warps' values in order; ends
// with a barrier, so red may be reused at once
template <typename T>
__device__ __forceinline__ void block_reduce(T& s0, T& s1, T& s2, T& m,
                                             T* red, Laps& laps) {
  laps.lap(L_ALGEBRA);
  for (int o = 16; o > 0; o >>= 1) {
    s0 = add(s0, __shfl_xor_sync(0xffffffffu, s0, o));
    s1 = add(s1, __shfl_xor_sync(0xffffffffu, s1, o));
    s2 = add(s2, __shfl_xor_sync(0xffffffffu, s2, o));
    m = tmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  const int w = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[w] = s0;
    red[MAX_WARPS + w] = s1;
    red[2 * MAX_WARPS + w] = s2;
    red[3 * MAX_WARPS + w] = m;
  }
  __syncthreads();
  s0 = red[0];
  s1 = red[MAX_WARPS];
  s2 = red[2 * MAX_WARPS];
  m = red[3 * MAX_WARPS];
  for (int k = 1; k < nw; ++k) {
    s0 = add(s0, red[k]);
    s1 = add(s1, red[MAX_WARPS + k]);
    s2 = add(s2, red[2 * MAX_WARPS + k]);
    m = tmax(m, red[3 * MAX_WARPS + k]);
  }
  __syncthreads();
  laps.lap(L_REDUCE);
}

template <typename T>
__device__ __forceinline__ T block_sum(T s, T* red, Laps& laps) {
  T z1 = T(0), z2 = T(0), z3 = T(0);
  block_reduce(s, z1, z2, z3, red, laps);
  return s;
}

// the forces of `copies` copies, the first at c + (h x) into f0, the
// second at c - (h x) into f1 (x null: one copy at c): a thread a (copy,
// term) stages its term's forces in the entries, then a thread a (copy,
// atom) sums them. Opens with a barrier (x was just written) and closes
// with one.
template <typename T>
__device__ __forceinline__ void copy_forces(const Tables<T>& t, int N, int E,
                                            const T* c, const T* x, T h,
                                            int copies, T* f0, T* f1,
                                            T* contrib, Laps& laps) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool force = x == nullptr;
  __syncthreads();
  laps.lap(L_ALGEBRA);
  const int nterm = t.nb + t.na + t.np + t.nd;
  for (int s = tid; s < copies * nterm; s += nt) {
    const int copy = s >= nterm, term = s - copy * nterm;
    const Displaced<T> at{c, x, h, copy == 1};
    T o[4][3];
    stage(contrib + copy * 3LL * E, __ldg(t.entries + term),
          term_forces(at, PackedLoad<T>{t}(term), t.bond_k, o), o);
  }
  __syncthreads();
  laps.lap(force ? L_FORCE : L_TERM);
  for (int s = tid; s < copies * N; s += nt) {
    const int copy = s >= N, a = s - copy * N;
    const Displaced<T> at{c, x, h, copy == 1};
    const int lo = __ldg(t.inc_off + a), hi = __ldg(t.inc_off + a + 1);
    T fa[3];
    atom_force_staged(at, a, lo, hi, contrib + copy * 3LL * E, t.springs,
                      fa);
    T* f = (copy ? f1 : f0) + 3 * a;
    f[0] = fa[0];
    f[1] = fa[1];
    f[2] = fa[2];
  }
  __syncthreads();
  laps.lap(force ? L_FORCE : L_ATOM);
  laps.add(L_PASSES, 1);
}

// w (3 N, a thread's own atoms) <- normalize(project(w)), written to out
template <typename T>
__device__ __forceinline__ void project_normalize(T* w, T* out, int N,
                                                  T* red, Laps& laps) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (N > 1) {
    T s0 = T(0), s1 = T(0), s2 = T(0), m = T(0);
    for (int a = tid; a < N; a += nt) {
      s0 = add(s0, w[3 * a]);
      s1 = add(s1, w[3 * a + 1]);
      s2 = add(s2, w[3 * a + 2]);
    }
    block_reduce(s0, s1, s2, m, red, laps);
    const T n = T(N);
    const T mean[3] = {quot(s0, n), quot(s1, n), quot(s2, n)};
    for (int a = tid; a < N; a += nt)
      for (int k = 0; k < 3; ++k) w[3 * a + k] = sub(w[3 * a + k], mean[k]);
  }
  T q = T(0);
  for (int a = tid; a < N; a += nt) q = add(q, dot_atom(w + 3 * a, w + 3 * a));
  const T den = tmax(ksqrt(block_sum(q, red, laps)), T(FLOOR));
  for (int a = tid; a < N; a += nt)
    for (int k = 0; k < 3; ++k) out[3 * a + k] = quot(w[3 * a + k], den);
}

// the staged form, the first design: one structure a block, the state in
// dynamic shared memory, followed by the entries' forces of both copies,
// 2 x 3 E values
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
dimer_kernel(const T* __restrict__ coords, const T* __restrict__ v0,
             T* __restrict__ out, bool* __restrict__ done_out,
             int* __restrict__ steps_out, int N, const Tables<T> t, int E,
             int n_steps, int n_rot, double dr_, double step_size_,
             double fmax_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[4 * MAX_WARPS];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long n3 = 3LL * N;
  T* c = reinterpret_cast<T*>(smem_raw);
  T* v = c + n3;
  T* u = v + n3;
  T* fa = u + n3;
  T* fb = fa + n3;
  T* contrib = fb + n3;
  const T dr = T(dr_), two_dr = T(2.0 * dr_), step_size = T(step_size_);
  const T fmax = T(fmax_);
  Laps laps;
  for (long long k = tid; k < n3; k += nt) {
    c[k] = coords[b * n3 + k];
    v[k] = v0[k];
  }
  // the values were stored by component and are read by atom below
  __syncthreads();
  laps.lap(L_SETUP);
  int steps = 0;
  bool done = false;
  // fa <- hv(x) = -(F(c + dr x) - F(c - dr x)) / (2 dr), a thread's atoms
  auto hv = [&](const T* x) {
    copy_forces<T>(t, N, E, c, x, dr, 2, fa, fb, contrib, laps);
    for (int a = tid; a < N; a += nt)
      for (int k = 0; k < 3; ++k) {
        const int i = 3 * a + k;
        fa[i] = quot(-sub(fa[i], fb[i]), two_dr);
      }
  };
  // x . fa over the block
  auto dot = [&](const T* x) {
    T s = T(0);
    for (int a = tid; a < N; a += nt) s = add(s, dot_atom(x + 3 * a, fa + 3 * a));
    return block_sum(s, red, laps);
  };
  while (steps < n_steps && !done) {
    // shifted power iteration: v <- normalize((sigma I - H) v) converges
    // to the most negative curvature mode for sigma above lambda_max,
    // which the power steps on u estimate
    for (int a = tid; a < N; a += nt)
      for (int k = 0; k < 3; ++k) u[3 * a + k] = v[3 * a + k];
    for (int i = 0; i < 4; ++i) {
      hv(u);
      project_normalize(fa, u, N, red, laps);
    }
    hv(u);
    const T sigma = add(mul(T(1.1), fabs(dot(u))), T(1));
    for (int i = 0; i < n_rot; ++i) {
      hv(v);
      for (int a = tid; a < N; a += nt)
        for (int k = 0; k < 3; ++k) {
          const int j = 3 * a + k;
          fa[j] = sub(mul(sigma, v[j]), fa[j]);
        }
      project_normalize(fa, v, N, red, laps);
    }
    hv(v);
    const T curv = dot(v);
    copy_forces<T>(t, N, E, c, nullptr, T(0), 1, fa, nullptr, contrib,
                   laps);
    // f . v and the largest squared atomic force
    T along = T(0), z1 = T(0), z2 = T(0), fm = T(0);
    for (int a = tid; a < N; a += nt) {
      along = add(along, dot_atom(fa + 3 * a, v + 3 * a));
      fm = tmax(fm, dot_atom(fa + 3 * a, fa + 3 * a));
    }
    block_reduce(along, z1, z2, fm, red, laps);
    const T fmax_now = ksqrt(fm);
    // negative curvature: the dimer translation (the force with its
    // mode component inverted); positive curvature near a stationary
    // point: climb the softest mode (reversed parallel force and a
    // kick); positive curvature under a large force: the inverted-force
    // step
    const bool climbing = curv >= T(0) && fmax_now < mul(T(10), fmax);
    done = fmax_now < fmax && curv < T(0);
    ++steps;
    laps.add(L_STEPS, 1);
    if (done) break;
    // a component of the unclipped step
    auto step_of = [&](int j) {
      const T par = mul(along, v[j]);
      const T eff = climbing ? add(-par, mul(fmax, v[j]))
                             : sub(fa[j], mul(T(2), par));
      return mul(step_size, eff);
    };
    T md = T(0);
    for (int a = tid; a < N; a += nt) {
      const T st[3] = {step_of(3 * a), step_of(3 * a + 1), step_of(3 * a + 2)};
      md = tmax(md, dot_atom(st, st));
    }
    T y0 = T(0), y1 = T(0), y2 = T(0);
    block_reduce(y0, y1, y2, md, red, laps);
    const T scale = tmin(quot(T(0.1), tmax(ksqrt(md), T(FLOOR))), T(1));
    for (int a = tid; a < N; a += nt)
      for (int k = 0; k < 3; ++k) {
        const int j = 3 * a + k;
        c[j] = add(c[j], mul(step_of(j), scale));
      }
  }
  __syncthreads();
  for (long long k = tid; k < n3; k += nt) out[b * n3 + k] = c[k];
  if (tid == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
  laps.lap(L_SETUP);
  laps.flush(b, tid == 0);
}

// ------------------------------------------------------- lone and large

// three sums and a max over the warp, the same bits in every lane (the
// butterfly of block_reduce)
template <typename T>
__device__ __forceinline__ void butterfly(T* s) {
  for (int o = 16; o > 0; o >>= 1) {
    s[0] = add(s[0], __shfl_xor_sync(0xffffffffu, s[0], o));
    s[1] = add(s[1], __shfl_xor_sync(0xffffffffu, s[1], o));
    s[2] = add(s[2], __shfl_xor_sync(0xffffffffu, s[2], o));
    s[3] = tmax(s[3], __shfl_xor_sync(0xffffffffu, s[3], o));
  }
}

// The atoms that one block owns, base .. end - 1, in chunks of 32: chunk
// k on warp k mod W, its atom base + 32 k + lane on that lane (so a
// thread owns atoms tid, tid + 32 W, ... past base). Reductions: each
// chunk by xor butterfly, the chunks in order (the block's sum), then in
// a cluster the blocks' sums in rank order. For N <= 512 atoms on one
// block these are the staged form's sums bit for bit: its thread holds
// atom tid, its warp a chunk, and the warps are added in order.
template <typename T, bool CLUSTER>
struct Atoms {
  int base, end, chunks, warp, warps, lane, nt;
  T* red;          // 2 x 4 x chunks: a reduction's chunk values
  T* part;         // CLUSTER: 2 x 4, this block's sums
  int parity;

  __device__ __forceinline__ Atoms(int base_, int end_, T* red_, T* part_)
      : base(base_), end(end_), red(red_), part(part_), parity(0) {
    chunks = end > base ? (end - base + 31) / 32 : 0;
    warp = threadIdx.x >> 5;
    warps = blockDim.x >> 5;
    lane = threadIdx.x & 31;
    nt = blockDim.x;
  }

  // f(a) for each atom the thread owns
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    for (int k = warp; k < chunks; k += warps) {
      const int a = base + 32 * k + lane;
      if (a < end) f(a);
    }
  }

  // out = sums of s[0..2] and max of s[3] over the structure's atoms,
  // vals(a, s) adding atom a's values to s (from zero); the same bits in
  // every thread of the structure
  template <typename F>
  __device__ __forceinline__ void reduce(F vals, T* out, Laps& laps) {
    T* r = red + parity * 4 * chunks;
    for (int k = warp; k < chunks; k += warps) {
      T s[4] = {T(0), T(0), T(0), T(0)};
      const int a = base + 32 * k + lane;
      if (a < end) vals(a, s);
      butterfly(s);
      if (lane == 0)
        for (int j = 0; j < 4; ++j) r[j * chunks + k] = s[j];
    }
    laps.lap(L_ALGEBRA);
    if (CLUSTER)
      __syncthreads();
    else
      group_sync(1, nt);
    T s[4] = {T(0), T(0), T(0), T(0)};
    if (chunks > 0)
      for (int j = 0; j < 4; ++j) s[j] = r[j * chunks];
    for (int k = 1; k < chunks; ++k) {
      for (int j = 0; j < 3; ++j) s[j] = add(s[j], r[j * chunks + k]);
      s[3] = tmax(s[3], r[3 * chunks + k]);
    }
    if (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      T* p = part + parity * 4;
      if (threadIdx.x == 0)
        for (int j = 0; j < 4; ++j) p[j] = s[j];
      cluster.sync();
      const int cl = (int)cluster.num_blocks();
      for (int rk = 0; rk < cl; ++rk) {
        const T* q = cluster.map_shared_rank(p, rk);
        if (rk == 0) {
          for (int j = 0; j < 4; ++j) s[j] = q[j];
        } else {
          for (int j = 0; j < 3; ++j) s[j] = add(s[j], q[j]);
          s[3] = tmax(s[3], q[3]);
        }
      }
    }
    for (int j = 0; j < 4; ++j) out[j] = s[j];
    parity ^= 1;
    laps.lap(L_REDUCE);
  }
};

// the run's constants
template <typename T>
struct StepArgs {
  int n_steps, n_rot;
  T step_size, fmax;
};

// The dimer steps on one structure: ctx holds its layout. ctx.forces(x,
// copies) evaluates the copies at c + (dr x), c - (dr x) and (copies 3)
// c; then ctx.hv(a, h) gives atom a's -(F+ - F-) / (2 dr) and ctx.fc(a,
// f) its force at c. ctx.V / U / W(a) are atom a's mode, power vector
// and work vector (3 values each, the owner's); ctx.c_step(a, k, d) adds
// d to its coordinate k. Every expression is the staged form's.
template <typename T, typename Ctx>
__device__ __forceinline__ void dimer_steps(Ctx& x, int N,
                                            const StepArgs<T>& p,
                                            int& steps, bool& done,
                                            Laps& laps) {
  auto& at = x.atoms;
  T s[4];
  // out <- normalize(project(w)), w(a, W(a)) writing each atom's w
  // w(a, W(a)) first lays the thread's own time so far to the atoms'
  // force sums
  auto normalize_into = [&](auto w, bool to_v) {
    if (N > 1) {
      at.reduce([&](int a, T* q) {
        T* wa = x.W(a);
        w(a, wa);
        for (int k = 0; k < 3; ++k) q[k] = add(q[k], wa[k]);
      }, s, laps);
      const T n = T(N);
      const T mean[3] = {quot(s[0], n), quot(s[1], n), quot(s[2], n)};
      at.reduce([&](int a, T* q) {
        T* wa = x.W(a);
        for (int k = 0; k < 3; ++k) wa[k] = sub(wa[k], mean[k]);
        q[0] = add(q[0], dot_atom(wa, wa));
      }, s, laps);
    } else {
      at.reduce([&](int a, T* q) {
        T* wa = x.W(a);
        w(a, wa);
        q[0] = add(q[0], dot_atom(wa, wa));
      }, s, laps);
    }
    const T den = tmax(ksqrt(s[0]), T(FLOOR));
    at.each([&](int a) {
      const T* wa = x.W(a);
      T* o = to_v ? x.V(a) : x.U(a);
      for (int k = 0; k < 3; ++k) o[k] = quot(wa[k], den);
    });
  };
  while (steps < p.n_steps && !done) {
    // shifted power iteration: v <- normalize((sigma I - H) v) converges
    // to the most negative curvature mode for sigma above lambda_max,
    // which the power steps on u estimate
    at.each([&](int a) {
      for (int k = 0; k < 3; ++k) x.U(a)[k] = x.V(a)[k];
    });
    for (int i = 0; i < 4; ++i) {
      x.forces(true, 2, laps);
      normalize_into([&](int a, T* w) {
        x.hv(a, w);
        laps.lap(L_ATOM);
      }, false);
    }
    x.forces(true, 2, laps);
    at.reduce([&](int a, T* q) {
      T h[3];
      x.hv(a, h);
      laps.lap(L_ATOM);
      q[0] = add(q[0], dot_atom(x.U(a), h));
    }, s, laps);
    const T sigma = add(mul(T(1.1), fabs(s[0])), T(1));
    for (int i = 0; i < p.n_rot; ++i) {
      x.forces(false, 2, laps);
      normalize_into([&](int a, T* w) {
        x.hv(a, w);
        laps.lap(L_ATOM);
        const T* v = x.V(a);
        for (int k = 0; k < 3; ++k) w[k] = sub(mul(sigma, v[k]), w[k]);
      }, true);
    }
    // the last action and the force at c in one pass: curv = v . hv(v),
    // f . v and the largest squared atomic force; f kept in W
    x.forces(false, 3, laps);
    at.reduce([&](int a, T* q) {
      T h[3];
      x.hv(a, h);
      T* f = x.W(a);
      x.fc(a, f);
      laps.lap(L_ATOM);
      const T* v = x.V(a);
      q[0] = add(q[0], dot_atom(v, h));
      q[1] = add(q[1], dot_atom(f, v));
      q[3] = tmax(q[3], dot_atom(f, f));
    }, s, laps);
    const T curv = s[0], along = s[1];
    const T fmax_now = ksqrt(s[3]);
    // negative curvature: the dimer translation (the force with its
    // mode component inverted); positive curvature near a stationary
    // point: climb the softest mode (reversed parallel force and a
    // kick); positive curvature under a large force: the inverted-force
    // step
    const bool climbing = curv >= T(0) && fmax_now < mul(T(10), p.fmax);
    done = fmax_now < p.fmax && curv < T(0);
    ++steps;
    laps.add(L_STEPS, 1);
    if (done) break;
    // a component of atom a's unclipped step
    auto step_of = [&](int a, int k) {
      const T* v = x.V(a);
      const T par = mul(along, v[k]);
      const T eff = climbing ? add(-par, mul(p.fmax, v[k]))
                             : sub(x.W(a)[k], mul(T(2), par));
      return mul(p.step_size, eff);
    };
    at.reduce([&](int a, T* q) {
      const T st[3] = {step_of(a, 0), step_of(a, 1), step_of(a, 2)};
      q[3] = tmax(q[3], dot_atom(st, st));
    }, s, laps);
    const T scale = tmin(quot(T(0.1), tmax(ksqrt(s[3]), T(FLOOR))), T(1));
    at.each([&](int a) {
      for (int k = 0; k < 3; ++k) x.c_step(a, k, mul(step_of(a, k), scale));
    });
    laps.lap(L_ALGEBRA);
  }
}

// lone: one structure a block on W warps (32 W threads), all of it in
// shared memory: the coordinates c, the copies' coordinates at c + (dr x)
// and c - (dr x), the mode, power and work vectors (3 N each), each
// incidence entry's force for the three copies, each copy's entry sums
// (3 N each), the reductions' chunk values. The entries are held
// transposed, atom a's k-th entry at k N + a (EP = N x the largest
// degree values a copy; t.entries holds each term role's position so,
// ops/kernels/dimer.transposed_entries): component x of atom a's k-th
// entry at 3 (k N + a) + x, so that the threads summing one component of
// neighbouring atoms read neighbouring values.
template <typename T>
struct Lone {
  Atoms<T, false> atoms;
  const Tables<T>& t;
  const Slots sl;
  int N, EP;
  T dr, two_dr;
  T *c, *cp, *cm, *v, *u, *w, *contrib, *sums;

  __device__ __forceinline__ T* V(int a) const { return v + 3 * a; }
  __device__ __forceinline__ T* U(int a) const { return u + 3 * a; }
  __device__ __forceinline__ T* W(int a) const { return w + 3 * a; }
  __device__ __forceinline__ void c_step(int a, int k, T d) {
    c[3 * a + k] = add(c[3 * a + k], d);
  }
  // the displaced copies of the thread's atoms, rounded as Displaced
  // rounds them; then every slot (copy, term) of the term pass writes its
  // term's forces to its atoms' entries of that copy; then a thread a
  // (copy, atom, component) adds that component of the atom's entries in
  // incidence order, from zero (atom_force_staged's sums before the
  // springs)
  __device__ __forceinline__ void forces(bool along_u, int copies,
                                         Laps& laps) {
    const T* x = along_u ? u : v;
    atoms.each([&](int a) {
      for (int k = 0; k < 3; ++k) {
        const int i = 3 * a + k;
        const T d = mul(dr, x[i]);
        cp[i] = add(c[i], d);
        cm[i] = sub(c[i], d);
      }
    });
    group_sync(1, atoms.nt);
    laps.lap(L_ALGEBRA);
    const int n = copies * sl.n;
    for (int s = threadIdx.x; s < n; s += atoms.nt) {
      const int copy = s >= 2 * sl.n ? 2 : s >= sl.n;
      const int term = slot_term(t, sl, s - copy * sl.n);
      if (term < 0) continue;
      const SmemCoords<T> at{copy == 0 ? cp : copy == 1 ? cm : c};
      T o[4][3];
      stage(contrib + copy * 3LL * EP, __ldg(t.entries + term),
            term_forces(at, PackedLoad<T>{t}(term), t.bond_k, o), o);
    }
    group_sync(1, atoms.nt);
    laps.lap(L_TERM);
    const int n3 = 3 * N;
    for (int s = threadIdx.x; s < copies * n3; s += atoms.nt) {
      const int copy = s >= 2 * n3 ? 2 : s >= n3;
      const int r = s - copy * n3, a = r / 3;
      const T* e = contrib + copy * 3LL * EP + r;
      const int deg = __ldg(t.inc_off + a + 1) - __ldg(t.inc_off + a);
      T f = T(0);
#pragma unroll 4
      for (int k = 0; k < deg; ++k) f += e[3LL * k * N];
      sums[copy * n3 + r] = f;
    }
    group_sync(1, atoms.nt);
    laps.lap(L_ATOM);
    laps.add(L_PASSES, 1);
  }
  // a copy's force on atom a: its entry sums, then its springs
  __device__ __forceinline__ void force(int a, int copy, T* f) const {
    const T* e = sums + copy * 3LL * N + 3 * a;
    f[0] = e[0];
    f[1] = e[1];
    f[2] = e[2];
    add_springs(SmemCoords<T>{copy == 0 ? cp : copy == 1 ? cm : c}, a,
                t.springs, f);
  }
  __device__ __forceinline__ void hv(int a, T* h) const {
    T f0[3], f1[3];
    force(a, 0, f0);
    force(a, 1, f1);
    for (int k = 0; k < 3; ++k) h[k] = quot(-sub(f0[k], f1[k]), two_dr);
  }
  __device__ __forceinline__ void fc(int a, T* f) const { force(a, 2, f); }
};

// the shared values of the lone form (ops/kernels/dimer.launch_plan)
__host__ __device__ __forceinline__ long long lone_values(int N, int EP) {
  return 27LL * N + 9LL * EP + 8LL * ((N + 31) / 32);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
dimer_lone_kernel(const T* __restrict__ coords, const T* __restrict__ v0,
                  T* __restrict__ out, bool* __restrict__ done_out,
                  int* __restrict__ steps_out, int N, const Tables<T> t,
                  int EP, const Slots sl, int n_steps, int n_rot,
                  double dr_, double step_size_, double fmax_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x;
  const long long n3 = 3LL * N;
  T* c = reinterpret_cast<T*>(smem_raw);
  T* contrib = c + 6 * n3;
  T* sums = contrib + 9LL * EP;
  Lone<T> x{Atoms<T, false>(0, N, sums + 3 * n3, nullptr), t, sl, N, EP,
            T(dr_), T(2.0 * dr_), c, c + n3, c + 2 * n3, c + 3 * n3,
            c + 4 * n3, c + 5 * n3, contrib, sums};
  Laps laps;
  x.atoms.each([&](int a) {
    for (int k = 0; k < 3; ++k) {
      c[3 * a + k] = coords[b * n3 + 3 * a + k];
      x.v[3 * a + k] = v0[3 * a + k];
    }
  });
  laps.lap(L_SETUP);
  const StepArgs<T> p{n_steps, n_rot, T(step_size_), T(fmax_)};
  int steps = 0;
  bool done = false;
  dimer_steps(x, N, p, steps, done, laps);
  x.atoms.each([&](int a) {
    for (int k = 0; k < 3; ++k) out[b * n3 + 3 * a + k] = c[3 * a + k];
  });
  if (threadIdx.x == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
  laps.lap(L_SETUP);
  laps.flush(b, threadIdx.x == 0);
}

// large: a thread-block cluster a structure, the atoms split between its
// blocks (a block's owned atoms a0 .. a1 - 1), G lanes an atom walking its
// incidence entries. SHARED: every block holds the whole structure's
// coordinates and its displaced copies (3 x 3 N) in shared memory, an
// owner writing its atoms' values into every block's copy (distributed
// shared memory), and its own atoms' vectors beside them; otherwise all
// of it lives in device memory (work: 21 N values a structure), the
// copies read through L2.
template <typename T, bool SHARED>
struct Large {
  Atoms<T, true> atoms;
  const Tables<T>& t;
  int N, G;
  T dr, two_dr;
  T *c, *cp, *cm;          // 3 N each: the whole structure
  T *v, *u, *w, *h;        // the owned atoms' (from atoms.base)

  __device__ __forceinline__ int li(int a) const {
    return 3 * (a - atoms.base);
  }
  __device__ __forceinline__ T* V(int a) const { return v + li(a); }
  __device__ __forceinline__ T* U(int a) const { return u + li(a); }
  __device__ __forceinline__ T* W(int a) const { return w + li(a); }
  __device__ __forceinline__ T cget(int i) const {
    return SHARED ? c[i] : __ldcg(c + i);
  }
  // a value of the structure into every block's copy (SHARED), else
  // into device memory
  __device__ __forceinline__ void put(T* arr, int i, T val) const {
    if (SHARED) {
      cg::cluster_group cluster = cg::this_cluster();
      const int cl = (int)cluster.num_blocks();
      for (int r = 0; r < cl; ++r) cluster.map_shared_rank(arr, r)[i] = val;
    } else {
      arr[i] = val;
    }
  }
  __device__ __forceinline__ void c_step(int a, int k, T d) {
    const int i = 3 * a + k;
    put(c, i, add(cget(i), d));
  }
  // the walk: G lanes on an atom's entries, lane j of the group on entry
  // lo + G r + j; the group's values added to each copy's force in entry
  // order (the lanes' values gathered by shuffles), then its springs: the
  // staged form's sums. Then hv into h and (copies 3) the force at c into
  // W, by the group's first lane.
  template <int COPIES, typename C>
  __device__ __forceinline__ void walk(const C& p0, const C& p1,
                                       const C& p2) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int gl = tid & (G - 1), ng = nt / G;
    const int gi = tid / G, warp_first = (tid & ~31) / G;
    for (int it = 0;; ++it) {
      if (atoms.base + warp_first + it * ng >= atoms.end) break;
      const int a = atoms.base + gi + it * ng;
      const bool has = a < atoms.end;
      int lo = 0, hi = 0;
      if (has) {
        lo = __ldg(t.inc_off + a);
        hi = __ldg(t.inc_off + a + 1);
      }
      int rounds = (hi - lo + G - 1) / G;
      if (G > 1) rounds = __reduce_max_sync(0xffffffffu, rounds);
      T f[3][3] = {{T(0), T(0), T(0)}, {T(0), T(0), T(0)},
                   {T(0), T(0), T(0)}};
      for (int r0 = 0; r0 < rounds; r0 += WALK_BATCH) {
        // the batch's codes, then its terms: the loads in flight together
        int code[WALK_BATCH];
        bool ok[WALK_BATCH];
        int4 q[WALK_BATCH];
        T tz[WALK_BATCH];
#pragma unroll
        for (int u = 0; u < WALK_BATCH; ++u) {
          const int e = lo + (r0 + u) * G + gl;
          ok[u] = r0 + u < rounds && e < hi;
          code[u] = ok[u] ? __ldg(t.inc_code + e) : 0;
        }
#pragma unroll
        for (int u = 0; u < WALK_BATCH; ++u) {
          q[u] = ok[u] ? __ldg(t.atoms + (code[u] >> 2))
                       : make_int4(0, 0, 0, 0);
          tz[u] = ok[u] ? __ldg(t.t0 + (code[u] >> 2)) : T(0);
        }
#pragma unroll 1
        for (int u = 0; u < WALK_BATCH; ++u) {
          if (r0 + u >= rounds) break;
          const TermRec<T> rec = term_rec(kind_of(t, code[u] >> 2), q[u],
                                          tz[u]);
          const int role = code[u] & 3;
#pragma unroll
          for (int cp_ = 0; cp_ < COPIES; ++cp_) {
            T val[3] = {T(0), T(0), T(0)};
            if (ok[u]) {
              T o[4][3];
              term_forces(cp_ == 0 ? p0 : cp_ == 1 ? p1 : p2, rec, t.bond_k,
                          o);
              for (int k = 0; k < 3; ++k)
                val[k] = role == 0 ? o[0][k]
                         : role == 1 ? o[1][k]
                         : role == 2 ? o[2][k] : o[3][k];
            }
            if (G == 1) {
              if (ok[u])
                for (int k = 0; k < 3; ++k) f[cp_][k] += val[k];
            } else {
              // the group's entries of this round in order: lane j's
              const int first = lo + (r0 + u) * G;
              for (int j = 0; j < G; ++j)
                for (int k = 0; k < 3; ++k) {
                  const T y = __shfl_sync(0xffffffffu, val[k], j, G);
                  if (first + j < hi) f[cp_][k] += y;
                }
            }
          }
        }
      }
      if (has) {
#pragma unroll
        for (int cp_ = 0; cp_ < COPIES; ++cp_)
          add_springs(cp_ == 0 ? p0 : cp_ == 1 ? p1 : p2, a, t.springs,
                      f[cp_]);
        if (gl == 0) {
          T* hv_a = h + li(a);
          for (int k = 0; k < 3; ++k)
            hv_a[k] = quot(-sub(f[0][k], f[1][k]), two_dr);
          if (COPIES == 3)
            for (int k = 0; k < 3; ++k) W(a)[k] = f[2][k];
        }
      }
    }
  }
  __device__ __forceinline__ void forces(bool along_u, int copies,
                                         Laps& laps) {
    const T* x = along_u ? u : v;
    atoms.each([&](int a) {
      for (int k = 0; k < 3; ++k) {
        const int i = 3 * a + k;
        const T d = mul(dr, x[li(a) + k]);
        const T ci = cget(i);
        put(cp, i, add(ci, d));
        put(cm, i, sub(ci, d));
      }
    });
    if (!SHARED) __threadfence();
    cg::this_cluster().sync();
    laps.lap(L_ALGEBRA);
    using C = typename std::conditional<SHARED, SmemCoords<T>,
                                        GlobalCoords<T>>::type;
    if (copies == 3)
      walk<3>(C{cp}, C{cm}, C{c});
    else
      walk<2>(C{cp}, C{cm}, C{c});
    __syncthreads();
    laps.lap(L_ATOM);
    laps.add(L_PASSES, 1);
  }
  __device__ __forceinline__ void hv(int a, T* out) const {
    for (int k = 0; k < 3; ++k) out[k] = h[li(a) + k];
  }
  // the walk of the last pass left the force at c in W already
  __device__ __forceinline__ void fc(int, T*) const {}
};

// the large form's block: its owned atoms (a cluster's blocks take
// ceil(N / CL) each, in rank order)
__host__ __device__ __forceinline__ int large_per(int N, int cl) {
  return (N + cl - 1) / cl;
}

// the large form's shared values a block (SHARED: the structure's
// coordinates and copies, the owned atoms' four vectors) and its work
// values a structure (otherwise)
__host__ __device__ __forceinline__ long long large_values(int N, int cl,
                                                           bool shared) {
  const int per = large_per(N, cl);
  const long long red = 8LL * ((per + 31) / 32);
  return shared ? 9LL * N + 12LL * per + red : red;
}

template <typename T, bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS)
dimer_large_kernel(const T* __restrict__ coords, const T* __restrict__ v0,
                   T* __restrict__ out, bool* __restrict__ done_out,
                   int* __restrict__ steps_out, T* work, int N,
                   const Tables<T> t, int G, int n_steps, int n_rot,
                   double dr_, double step_size_, double fmax_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T part[8];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / cl;
  const long long n3 = 3LL * N;
  const int per = large_per(N, cl);
  const int a0 = min(N, rank * per), a1 = min(N, a0 + per);
  T* sm = reinterpret_cast<T*>(smem_raw);
  // SHARED: c, cp, cm, then v, u, w, h (3 per each), then the reductions'
  // chunk values; else c, cp, cm, v, u, w, h of every atom in work
  T* base = SHARED ? sm : work + b * 21LL * N;
  T* own = SHARED ? base + 3 * n3 : base + 3 * n3 + 3LL * a0;
  const long long stride = SHARED ? 3LL * per : n3;
  T* red = SHARED ? sm + 3 * n3 + 12LL * per : sm;
  Large<T, SHARED> x{Atoms<T, true>(a0, a1, red, part), t, N, G, T(dr_),
                     T(2.0 * dr_), base, base + n3, base + 2 * n3, own,
                     own + stride, own + 2 * stride, own + 3 * stride};
  Laps laps;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (SHARED)
    for (long long k = tid; k < n3; k += nt) x.c[k] = coords[b * n3 + k];
  x.atoms.each([&](int a) {
    for (int k = 0; k < 3; ++k) {
      if (!SHARED) x.c[3 * a + k] = coords[b * n3 + 3 * a + k];
      x.V(a)[k] = v0[3 * a + k];
    }
  });
  if (!SHARED) __threadfence();
  cluster.sync();
  laps.lap(L_SETUP);
  const StepArgs<T> p{n_steps, n_rot, T(step_size_), T(fmax_)};
  int steps = 0;
  bool done = false;
  dimer_steps(x, N, p, steps, done, laps);
  // every block's last c update is in (its writes precede the barrier)
  if (!SHARED) __threadfence();
  cluster.sync();
  x.atoms.each([&](int a) {
    for (int k = 0; k < 3; ++k)
      out[b * n3 + 3 * a + k] = x.cget(3 * a + k);
  });
  // no block leaves while another may still read its shared memory
  cluster.sync();
  if (rank == 0 && tid == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
  laps.lap(L_SETUP);
  laps.flush(b, rank == 0 && tid == 0);
}

// ---------------------------------------------------------------- launch

// raise a kernel's dynamic shared memory limit past 48 KB on the current
// card, once per (kernel, card, larger size)
int opt_in_smem(const void* fn, int id, long long bytes) {
  static long long done[N_KERNELS][MAX_DEVICES] = {{0}};
  if (bytes <= STATIC_SMEM) return 0;
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[id][dev] >= bytes) return 0;
  err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err) done[id][dev] = bytes;
  return err;
}

// the kernel of a plan, and its own slot in opt_in_smem's table
template <typename T>
const void* form_kernel(const long long* plan, int* id) {
  const int form = (int)plan[P_FORM];
  const bool shared = plan[P_SHARED] != 0;
  *id = (sizeof(T) == 8 ? N_KERNELS / 2 : 0) +
        (form == FORM_LARGE ? FORM_LARGE + shared : form);
  switch (form) {
    case FORM_LONE:
      return (const void*)dimer_lone_kernel<T>;
    case FORM_LARGE:
      return shared ? (const void*)dimer_large_kernel<T, true>
                    : (const void*)dimer_large_kernel<T, false>;
    default:
      return (const void*)dimer_kernel<T>;
  }
}

template <typename T>
int launch(const void* coords, const void* v0, void* out, void* done,
           void* steps, void* work, long long B, int N,
           const long long* plan, int nb, int na, int np, int nd, T bond_k,
           const void* atoms, const void* entries, const void* t0,
           const void* inc_off, const void* inc_code, const void* springs,
           const void* spring_t, long long ns, const void* k_s,
           const void* half, long long nh, const void* k_h, int n_steps,
           int n_rot, double dr, double step_size, double fmax,
           void* stream) {
  if (B <= 0) return 0;
  const int form = (int)plan[P_FORM], threads = (int)plan[P_THREADS];
  const int cl = (int)plan[P_CLUSTER], lanes = (int)plan[P_LANES];
  const bool shared = plan[P_SHARED] != 0;
  const long long smem = plan[P_SMEM];
  if (form < FORM_STAGED || form > FORM_LARGE || threads <= 0 ||
      threads % 32 || threads > MAX_THREADS || N <= 0 ||
      (form == FORM_LARGE && !shared) != (work != nullptr) ||
      (form == FORM_LARGE &&
       (cl < 1 || cl > MAX_CLUSTER || lanes < 1 || lanes > 32 ||
        (lanes & (lanes - 1)) || threads % lanes)))
    return (int)cudaErrorInvalidValue;
  int id = 0;
  const void* fn = form_kernel<T>(plan, &id);
  int err = opt_in_smem(fn, id, smem);
  if (err) return err;
  if (form == FORM_LARGE && cl > PORTABLE_CLUSTER) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  Tables<T> t;
  t.nb = nb;
  t.na = na;
  t.np = np;
  t.nd = nd;
  t.bond_k = bond_k;
  t.atoms = static_cast<const int4*>(atoms);
  t.entries = static_cast<const int4*>(entries);
  t.t0 = static_cast<const T*>(t0);
  t.inc_off = static_cast<const int*>(inc_off);
  t.inc_code = static_cast<const int*>(inc_code);
  t.springs.pairs = static_cast<const long long*>(springs);
  t.springs.target = static_cast<const T*>(spring_t);
  t.springs.n = ns;
  t.springs.k = static_cast<const T*>(k_s);
  t.springs.half = static_cast<const long long*>(half);
  t.springs.nh = nh;
  t.springs.k_h = static_cast<const T*>(k_h);
  const T* c = static_cast<const T*>(coords);
  const T* v = static_cast<const T*>(v0);
  T* o = static_cast<T*>(out);
  bool* d = static_cast<bool*>(done);
  int* s = static_cast<int*>(steps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int E = (int)plan[P_ENTRIES];
  if (form == FORM_LONE) {
    Slots sl;
    for (int k = 0; k < 4; ++k) sl.lo[k] = (int)plan[P_LO0 + k];
    sl.n = (int)plan[P_SLOTS];
    const int EP = (int)plan[P_DEGREE] * N;
    dimer_lone_kernel<T><<<(unsigned)B, threads, (size_t)smem, st>>>(
        c, v, o, d, s, N, t, EP, sl, n_steps, n_rot, dr, step_size, fmax);
  } else if (form == FORM_LARGE) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(B * cl), 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    T* wk = static_cast<T*>(work);
    err = (int)cudaLaunchKernelEx(
        &cfg, shared ? dimer_large_kernel<T, true>
                     : dimer_large_kernel<T, false>,
        c, v, o, d, s, wk, N, t, lanes, n_steps, n_rot, dr, step_size, fmax);
    if (err) return err;
  } else {
    dimer_kernel<T><<<(unsigned)B, threads, (size_t)smem, st>>>(
        c, v, o, d, s, N, t, E, n_steps, n_rot, dr, step_size, fmax);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int info(const long long* plan, int* out) {
  int id = 0;
  const void* fn = form_kernel<T>(plan, &id);
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, fn);
  if (err) return err;
  err = opt_in_smem(fn, id, plan[P_SMEM]);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, (int)plan[P_THREADS], (size_t)plan[P_SMEM]);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return err;
}

}  // namespace

extern "C" {

#define DIMER_ENTRY(NAME, T)                                                 \
  int NAME(const void* coords, const void* v0, void* out, void* done,       \
           void* steps, void* work, long long B, int N,                     \
           const long long* plan, int nb, int na, int np, int nd, T bond_k, \
           const void* atoms, const void* entries, const void* t0,          \
           const void* inc_off, const void* inc_code, const void* springs,  \
           const void* spring_t, long long ns, const void* k_s,             \
           const void* half, long long nh, const void* k_h, int n_steps,    \
           int n_rot, double dr, double step_size, double fmax,             \
           void* stream) {                                                  \
    return launch<T>(coords, v0, out, done, steps, work, B, N, plan, nb,    \
                     na, np, nd, bond_k, atoms, entries, t0, inc_off,       \
                     inc_code, springs, spring_t, ns, k_s, half, nh, k_h,   \
                     n_steps, n_rot, dr, step_size, fmax, stream);          \
  }

DIMER_ENTRY(dimer_f32, float)
DIMER_ENTRY(dimer_f64, double)

// out: registers a thread, local (spilled) bytes a thread, resident
// blocks an SM of the plan's kernel at its threads and shared bytes
int dimer_info(const long long* plan, int f64, int* out) {
  return f64 ? info<double>(plan, out) : info<float>(plan, out);
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
