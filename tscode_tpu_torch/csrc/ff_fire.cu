// FIRE on the internal force field, every step of a batch in one launch.
//
// Replaces no Pallas kernel: the JAX package runs
// tscode_tpu/optimizers.py:41 fire_minimize_batch as one jitted program,
// a lax.scan over n_steps whose body is jax.grad of ff_energy
// (tscode_tpu/ff.py:126, with the springs of the bend, the scan points
// and adjust_spacings_batch added) and the FIRE update. The port ran it
// as one step (autograd forces, then optimizers.fire_step: ~180 kernels)
// captured in a CUDA graph and replayed n_steps times from the host.
//
// What every form computes: from rest, for each structure, up to n_steps
// steps of fire_step's arithmetic (optimizers.py) on the analytic forces
// of ff_forces.cuh: the power and the two norms, the uphill / grow / dt /
// alpha rules, the semi-implicit Euler step, the 0.2 A cap on the largest
// atomic displacement (the velocity rescaled too); frozen atoms get no
// force; a structure whose largest atomic force is under fmax stops with
// its coordinates as they are and leaves the loop (fire_minimize_batch
// returns only the coordinates, the energies and the flags, which the
// JAX scan's masked steps leave as they are). Each atom's force is summed
// from zero in ff.incidence order, every sum in a fixed order, no
// atomics: two launches give the same bits. The tables of the terms are
// read once a launch (ops/kernels/ff_fire.packed_terms: int32 atoms and
// incidence entries, rows of 4) into registers or shared memory.
//
// Bound. A batch is bound by operations: a step of a structure evaluates
// every term once (a pair ~20 flops, an angle ~60, a dihedral ~110, with
// acos / atan2 / sin / cos) and updates every atom (~60 flops); the
// tables (a few KB) are read once and the coordinates read and written
// once. The work follows the data: the steps each structure takes before
// it stops (returned per structure). A lone structure (a bend, a scan
// point) is bound by latency: a chain of dependent steps, each as long as
// its slowest term, the atom sums, the reductions and the barriers.
// Measured (chip_smoke.py phase 13, NVIDIA H100 80GB HBM3, 700 W, f64):
// the 24,417 x 15 batch 2.08 ms in the warp form, 4.6% of its operations
// bound (4.55 ms in the first design); a bend's call of one 15-atom
// structure 0.130 ms in the lone form, 2.0 us a step (0.300 ms).
//
// The forms (ops/kernels/ff_fire.launch_plan picks one from B, N, the
// terms, the entries and the card's resident warps by the rule that
// phase 13's sweeps on the card set):
//   group  one structure on W warps, G structures a block, a thread a
//          term slot (its term's atoms, entries and reference value in
//          registers for the launch). Each term's forces go to its
//          atoms' incidence entries in shared memory; then the atoms are
//          summed. N <= 32: the first warp owns an atom a lane (force,
//          velocity in registers) and does the sums, both reductions and
//          the update with shuffles alone, so a step pays two barriers;
//          N > 32: the W warps share the atoms and reduce through shared
//          memory (four barriers). The barriers are the structure's own
//          (__syncwarp for one warp, a named barrier for W), so the
//          structures of a block stop independently.
//          "lone": the slots grouped by kind, each warp holding terms of
//          one kind, so bonds, angles and pairs run side by side on their
//          own warps; one structure on as many warps as its slots or
//          atoms fill (up to 16), a batch's structures on fewer, so that
//          more of them are in flight. "warp": one warp a structure, the
//          slots packed, eight structures a block (small structures in
//          large batches).
//   large  any N that device memory holds: a thread-block cluster a
//          structure (up to 8 blocks, the atoms split between them, a
//          thread an atom up to 512 a block); the per-atom arrays in
//          device memory (they stay in L2), each atom's
//          owner computing its terms itself in incidence order (the
//          dense repulsion table rules out staging at these sizes); the
//          blocks' partial sums exchanged through distributed shared
//          memory, read in rank order; cluster barriers between the
//          phases. A cluster rather than a cooperative grid: its blocks
//          are co-scheduled by the hardware, so a batch of large
//          structures needs no co-residency of the whole grid, and its
//          barrier is the hardware's.
// The first design, a block a structure, stays in ff_fire_block.cu as
// the yardstick (launch(..., regime='block')).
// Entries ff_fire_f32 / ff_fire_f64 return the cudaError_t of the launch;
// ff_fire_info reports a form's registers, local memory and resident
// blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ff_forces.cuh"

namespace cg = cooperative_groups;
using namespace ffk;

namespace {

constexpr int N_MIN = 5;
constexpr double ALPHA0 = 0.1;
constexpr double F_INC = 1.1;
constexpr double F_DEC = 0.5;
constexpr double F_ALPHA = 0.99;
constexpr double DT_MAX_FACTOR = 10.0;
constexpr double MAX_DISP = 0.2;
constexpr long long STATIC_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr int LARGE_THREADS = 512;     // the large form: an atom a thread
constexpr int GROUP_THREADS = 512;     // group form: W warps x G groups
constexpr int WARP_THREADS = 256;      // the warp form: G one-warp groups
constexpr int MAX_GROUPS = 15;         // named barriers 1..15
constexpr int MAX_CLUSTER = 8;         // the portable cluster size

enum Form : int { FORM_LONE = 0, FORM_WARP = 1, FORM_LARGE = 2 };
// the launch plan, a host array: ops/kernels/ff_fire.Plan.args
enum PlanField : int { P_FORM, P_THREADS, P_GROUPS, P_WARPS, P_CLUSTER,
                       P_SMEM, P_STAGED, P_SLOTS, P_LO0, P_LO1, P_LO2,
                       P_LO3, P_ENTRIES };

// ------------------------------------------------------------ FIRE rules

// a structure's FIRE controls and the step's rules (fire_step)
template <typename T>
struct Fire {
  T dt, alpha, dt_max;
  int n_pos;
  // set by rules(): the step's uphill flag, dt, next alpha and the
  // velocity mix factor q = |v| / max(|f|, 1e-12)
  bool uphill;
  T dt_new, alpha_next, q;

  __device__ __forceinline__ explicit Fire(double dt0)
      : dt(T(dt0)), alpha(T(ALPHA0)), dt_max(T(dt0 * DT_MAX_FACTOR)),
        n_pos(0), uphill(false), dt_new(T(0)), alpha_next(T(0)),
        q(T(0)) {}

  // the rules of one step from its power and squared norms; stepped()
  // mixes with this step's alpha until advance()
  __device__ __forceinline__ void rules(T power, T ff, T vv) {
    q = ksqrt(vv) * (ff < T(FLOOR) * T(FLOOR) ? T(1) / T(FLOOR)
                                              : krsqrt(ff));
    uphill = power <= T(0);
    const int n_new = uphill ? 0 : n_pos + 1;
    const bool grow = n_new > N_MIN;
    dt_new = uphill ? dt * T(F_DEC) : (grow ? tmin(dt * T(F_INC), dt_max)
                                             : dt);
    alpha_next = uphill ? T(ALPHA0) : (grow ? alpha * T(F_ALPHA) : alpha);
    n_pos = n_new;
  }

  // one component's stepped velocity
  __device__ __forceinline__ T stepped(T v, T f) const {
    const T mixed = (T(1) - alpha) * v + (alpha * f) * q;
    return (uphill ? T(0) : mixed) + dt_new * f;
  }

  __device__ __forceinline__ void advance() {
    dt = dt_new;
    alpha = alpha_next;
  }
};

// the cap's factor from the largest squared atomic step: min(0.2 /
// max(d, 1e-12), 1), whose quotient is at least 1 (so the factor 1)
// wherever d <= 0.2; the division only past it
template <typename T>
__device__ __forceinline__ T cap_scale(T md) {
  const T d = ksqrt(md);
  return d <= T(MAX_DISP) ? T(1)
                          : tmin(T(MAX_DISP) / tmax(d, T(FLOOR)), T(1));
}

// sums of s0..s2 and the max of m3 over a warp, the same bits in every
// lane
template <typename T>
__device__ __forceinline__ void warp_reduce(T& s0, T& s1, T& s2, T& m3) {
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    m3 = tmax(m3, __shfl_xor_sync(0xffffffffu, m3, o));
  }
}

template <typename T>
__device__ __forceinline__ T warp_max(T m) {
  for (int o = 16; o > 0; o >>= 1)
    m = tmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// sums of s0..s2 and the max of m3 over the nw warps of one structure
// (warp butterflies, then the warps in order through buf[4][nw]), the
// same bits in every thread; sync is the structure's barrier
template <typename T, typename S>
__device__ __forceinline__ void group_reduce(T& s0, T& s1, T& s2, T& m3,
                                             T* buf, int w, int nw,
                                             const S& sync) {
  warp_reduce(s0, s1, s2, m3);
  if ((threadIdx.x & 31) == 0) {
    buf[w] = s0;
    buf[nw + w] = s1;
    buf[2 * nw + w] = s2;
    buf[3 * nw + w] = m3;
  }
  sync();
  s0 = buf[0];
  s1 = buf[nw];
  s2 = buf[2 * nw];
  m3 = buf[3 * nw];
  for (int k = 1; k < nw; ++k) {
    s0 += buf[k];
    s1 += buf[nw + k];
    s2 += buf[2 * nw + k];
    m3 = tmax(m3, buf[3 * nw + k]);
  }
}

template <typename T, typename S>
__device__ __forceinline__ T group_max(T m, T* buf, int w, int nw,
                                       const S& sync) {
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) buf[w] = m;
  sync();
  m = buf[0];
  for (int k = 1; k < nw; ++k) m = tmax(m, buf[k]);
  return m;
}

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

struct GroupSync {
  int id, count;
  __device__ __forceinline__ void operator()() const {
    group_sync(id, count);
  }
};

// ------------------------------------------------------------ group form

// the shared values of one structure in the group form
__host__ __device__ __forceinline__ long long group_values(int N, int E,
                                                           int W,
                                                           bool small) {
  return small ? 3LL * N + 3LL * E : 12LL * N + 3LL * E + 5LL * W;
}

// BATCH: the warp form's instantiation, its registers capped so that
// 3 (f64) or 4 (f32) blocks of WARP_THREADS fit an SM
template <typename T, bool SMALL, bool BATCH>
__global__ void __launch_bounds__(BATCH ? WARP_THREADS : GROUP_THREADS,
                                  BATCH ? (sizeof(T) == 8 ? 3 : 4) : 1)
ff_fire_group_kernel(const T* __restrict__ coords, T* __restrict__ out,
                     bool* __restrict__ done_out,
                     int* __restrict__ steps_out, long long B, int N,
                     const Tables<T> t,
                     const unsigned char* __restrict__ freeze,
                     long long freeze_stride, int n_steps, double dt0,
                     double fmax, int W, int G, int E, const Slots sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int stop[MAX_GROUPS];
  const int gt = 32 * W;
  const int g = threadIdx.x / gt, tig = threadIdx.x - g * gt;
  const long long b = (long long)blockIdx.x * G + g;
  if (b >= B) return;             // a whole structure's threads leave
  const GroupSync sync{1 + g, gt};
  T* c = reinterpret_cast<T*>(smem_raw) + g * group_values(N, E, W, SMALL);
  T* contrib = c + 3 * N;
  T* v = contrib + 3 * E;         // N > 32: the atoms' state, reductions
  T* f = v + 3 * N;
  T* vs = f + 3 * N;
  T* red = vs + 3 * N;
  T* red_disp = red + 4 * W;
  const SmemCoords<T> at{c};
  const T* cin = coords + b * 3 * N;
  for (int k = tig; k < 3 * N; k += gt) {
    c[k] = cin[k];
    if (!SMALL) v[k] = T(0);
  }
  const unsigned char* fr = freeze ? freeze + b * freeze_stride : nullptr;
  // this thread's first slot, held for the launch
  const int my_term = tig < sl.n ? slot_term(t, sl, tig) : -1;
  TermRec<T> mine{};
  int4 my_e = make_int4(0, 0, 0, 0);
  if (my_term >= 0) {
    mine = PackedLoad<T>{t}(my_term);
    my_e = __ldg(t.entries + my_term);
  }
  // N <= 32: lane a of the first warp owns atom a for the launch
  const int lane = tig & 31;
  const bool first = tig < 32;
  int lo = 0, hi = 0;
  bool held = false;             // an atom that moves
  T va[3] = {T(0), T(0), T(0)};
  if (SMALL && first && lane < N) {
    lo = __ldg(t.inc_off + lane);
    hi = __ldg(t.inc_off + lane + 1);
    held = !(fr && fr[lane]);
  }
  if (tig == 0) stop[g] = 0;
  Fire<T> fire(dt0);
  const T fmax_t = T(fmax);
  int steps = 0;
  bool done = false;
  sync();
  for (int step = 0; step < n_steps; ++step) {
    for (int s = tig; s < sl.n; s += gt) {
      const bool own = s == tig;
      const int term = own ? my_term : slot_term(t, sl, s);
      if (term < 0) continue;
      const TermRec<T> r = own ? mine : PackedLoad<T>{t}(term);
      const int4 e = own ? my_e : __ldg(t.entries + term);
      T o[4][3];
      stage(contrib, e, term_forces(at, r, t.bond_k, o), o);
    }
    sync();
    if (SMALL) {
      if (first) {
        T fa[3] = {T(0), T(0), T(0)};
        if (held) atom_force_staged(at, lane, lo, hi, contrib, t.springs, fa);
        T power = fa[0] * va[0] + fa[1] * va[1] + fa[2] * va[2];
        T ff = fa[0] * fa[0] + fa[1] * fa[1] + fa[2] * fa[2];
        T vv = va[0] * va[0] + va[1] * va[1] + va[2] * va[2];
        T fm = ff;
        warp_reduce(power, ff, vv, fm);
        ++steps;
        if (ksqrt(fm) < fmax_t) {     // stopped: coordinates as they are
          done = true;
          if (lane == 0) stop[g] = 1;
        } else {
          fire.rules(power, ff, vv);
          T vsa[3], sq = T(0);
          for (int x = 0; x < 3; ++x) {
            vsa[x] = fire.stepped(va[x], fa[x]);
            const T st = fire.dt_new * vsa[x];
            sq += st * st;
          }
          const T scale = cap_scale(warp_max(sq));
          if (lane < N)
            for (int x = 0; x < 3; ++x) {
              c[3 * lane + x] = c[3 * lane + x] +
                                (fire.dt_new * vsa[x]) * scale;
              va[x] = vsa[x] * scale;
            }
          fire.advance();
        }
      }
      sync();
      if (stop[g]) break;
    } else {
      T power = T(0), ff = T(0), vv = T(0), fm = T(0);
      for (int a = tig; a < N; a += gt) {
        T fa[3] = {T(0), T(0), T(0)};
        if (!(fr && fr[a]))
          atom_force_staged(at, a, __ldg(t.inc_off + a),
                            __ldg(t.inc_off + a + 1), contrib, t.springs,
                            fa);
        for (int x = 0; x < 3; ++x) f[3 * a + x] = fa[x];
        const T* vp = v + 3 * a;
        power += fa[0] * vp[0] + fa[1] * vp[1] + fa[2] * vp[2];
        ff += fa[0] * fa[0] + fa[1] * fa[1] + fa[2] * fa[2];
        vv += vp[0] * vp[0] + vp[1] * vp[1] + vp[2] * vp[2];
        fm = tmax(fm, fa[0] * fa[0] + fa[1] * fa[1] + fa[2] * fa[2]);
      }
      group_reduce(power, ff, vv, fm, red, tig >> 5, W, sync);
      ++steps;
      if (ksqrt(fm) < fmax_t) {
        done = true;
        break;
      }
      fire.rules(power, ff, vv);
      T md = T(0);
      for (int a = tig; a < N; a += gt) {
        T sq = T(0);
        for (int x = 0; x < 3; ++x) {
          const int k = 3 * a + x;
          const T vk = fire.stepped(v[k], f[k]);
          vs[k] = vk;
          const T st = fire.dt_new * vk;
          sq += st * st;
        }
        md = tmax(md, sq);
      }
      const T scale = cap_scale(group_max(md, red_disp, tig >> 5, W, sync));
      for (int a = tig; a < N; a += gt)
        for (int x = 0; x < 3; ++x) {
          const int k = 3 * a + x;
          c[k] = c[k] + (fire.dt_new * vs[k]) * scale;
          v[k] = vs[k] * scale;
        }
      fire.advance();
      sync();
    }
  }
  T* o = out + b * 3 * N;
  for (int k = tig; k < 3 * N; k += gt) o[k] = c[k];
  if (tig == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
}

// ------------------------------------------------------------ large form

// a cluster a structure; work holds the velocities, forces and stepped
// velocities (3 x B x 3N). SHARED: each block keeps all the structure's
// coordinates in its shared memory, an owner writing its atoms' new
// ones into every block's copy (distributed shared memory); otherwise
// out holds them during the run, read through L2.
template <typename T, bool SHARED>
__global__ void __launch_bounds__(LARGE_THREADS)
ff_fire_large_kernel(const T* __restrict__ coords, T* out, T* work,
                     bool* __restrict__ done_out,
                     int* __restrict__ steps_out, long long B, int N,
                     const Tables<T> t,
                     const unsigned char* __restrict__ freeze,
                     long long freeze_stride, int n_steps, double dt0,
                     double fmax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[4 * (LARGE_THREADS / 32)];
  __shared__ T red_disp[LARGE_THREADS / 32];
  __shared__ T part[4];           // this block's sums, read by the cluster
  __shared__ T part_disp[1];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / CL;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int w = tid >> 5, nw = nt >> 5;
  const BlockSync sync;
  const int per = (N + CL - 1) / CL;  // this block's atoms a0 .. a1 - 1
  const int a0 = rank * per, a1 = min(N, a0 + per);
  T* c = SHARED ? reinterpret_cast<T*>(smem_raw) : out + b * 3 * N;
  T* v = work + b * 3 * N;
  T* f = v + B * 3 * N;
  T* vs = f + B * 3 * N;
  const T* cin = coords + b * 3 * N;
  if (SHARED)
    for (int k = tid; k < 3 * N; k += nt) c[k] = cin[k];
  for (int k = 3 * a0 + tid; k < 3 * a1; k += nt) {
    if (!SHARED) c[k] = cin[k];
    v[k] = T(0);
  }
  const unsigned char* fr = freeze ? freeze + b * freeze_stride : nullptr;
  const PackedLoad<T> load{t};
  Fire<T> fire(dt0);
  const T fmax_t = T(fmax);
  int steps = 0;
  bool done = false;
  __threadfence();
  cluster.sync();
  for (int step = 0; step < n_steps; ++step) {
    T power = T(0), ff = T(0), vv = T(0), fm = T(0);
    for (int a = a0 + tid; a < a1; a += nt) {
      T fa[3] = {T(0), T(0), T(0)};
      if (!(fr && fr[a])) {
        const int lo = __ldg(t.inc_off + a), hi = __ldg(t.inc_off + a + 1);
        if (SHARED)
          atom_force(SmemCoords<T>{c}, a, lo, hi, t.inc_code, load,
                     t.bond_k, t.springs, fa);
        else
          atom_force(GlobalCoords<T>{c}, a, lo, hi, t.inc_code, load,
                     t.bond_k, t.springs, fa);
      }
      for (int x = 0; x < 3; ++x) f[3 * a + x] = fa[x];
      const T* vp = v + 3 * a;
      power += fa[0] * vp[0] + fa[1] * vp[1] + fa[2] * vp[2];
      ff += fa[0] * fa[0] + fa[1] * fa[1] + fa[2] * fa[2];
      vv += vp[0] * vp[0] + vp[1] * vp[1] + vp[2] * vp[2];
      fm = tmax(fm, fa[0] * fa[0] + fa[1] * fa[1] + fa[2] * fa[2]);
    }
    group_reduce(power, ff, vv, fm, red, w, nw, sync);
    if (tid == 0) {
      part[0] = power;
      part[1] = ff;
      part[2] = vv;
      part[3] = fm;
    }
    cluster.sync();
    // the blocks' sums in rank order: the same bits in every block
    power = ff = vv = fm = T(0);
    for (int r = 0; r < CL; ++r) {
      const T* p = cluster.map_shared_rank(part, r);
      power += p[0];
      ff += p[1];
      vv += p[2];
      fm = tmax(fm, p[3]);
    }
    ++steps;
    if (ksqrt(fm) < fmax_t) {
      done = true;
      break;
    }
    fire.rules(power, ff, vv);
    T md = T(0);
    for (int a = a0 + tid; a < a1; a += nt) {
      T sq = T(0);
      for (int x = 0; x < 3; ++x) {
        const int k = 3 * a + x;
        const T vk = fire.stepped(v[k], f[k]);
        vs[k] = vk;
        const T st = fire.dt_new * vk;
        sq += st * st;
      }
      md = tmax(md, sq);
    }
    md = group_max(md, red_disp, w, nw, sync);
    if (tid == 0) part_disp[0] = md;
    cluster.sync();
    md = T(0);
    for (int r = 0; r < CL; ++r)
      md = tmax(md, *cluster.map_shared_rank(part_disp, r));
    const T scale = cap_scale(md);
    // every block has read its copy's coordinates (the barrier above)
    for (int a = a0 + tid; a < a1; a += nt)
      for (int x = 0; x < 3; ++x) {
        const int k = 3 * a + x;
        const T ck = c[k] + (fire.dt_new * vs[k]) * scale;
        if (SHARED)
          for (int r = 0; r < CL; ++r) cluster.map_shared_rank(c, r)[k] = ck;
        else
          c[k] = ck;
        v[k] = vs[k] * scale;
      }
    fire.advance();
    __threadfence();
    cluster.sync();
  }
  if (SHARED)
    for (int k = 3 * a0 + tid; k < 3 * a1; k += nt) out[b * 3 * N + k] = c[k];
  // no block leaves while another may still read its shared memory
  cluster.sync();
  if (rank == 0 && tid == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
}

// ---------------------------------------------------------------- launch

// raise a kernel's dynamic shared memory limit past 48 KB on the current
// card, once per (kernel, card, larger size)
int opt_in_smem(const void* fn, int id, long long bytes) {
  static long long done[32][MAX_DEVICES] = {{0}};
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

// the kernel of a form, and its own slot in opt_in_smem's table
template <typename T>
const void* form_kernel(int form, bool small, bool shared, int* id) {
  *id = (sizeof(T) == 8 ? 16 : 0) + 4 * form + 2 * small + shared;
  switch (form) {
    case FORM_LONE:
      return small ? (const void*)ff_fire_group_kernel<T, true, false>
                   : (const void*)ff_fire_group_kernel<T, false, false>;
    case FORM_WARP:
      return small ? (const void*)ff_fire_group_kernel<T, true, true>
                   : (const void*)ff_fire_group_kernel<T, false, true>;
    default:
      return shared ? (const void*)ff_fire_large_kernel<T, true>
                    : (const void*)ff_fire_large_kernel<T, false>;
  }
}

template <typename T>
int launch(const void* coords, void* out, void* done, void* steps,
           void* work, long long B, int N, const long long* plan, int nb,
           int na, int np, int nd, T bond_k, const void* atoms,
           const void* entries, const void* t0, const void* inc_off,
           const void* inc_code, const void* springs, const void* spring_t,
           long long ns, const void* k_s, const void* half, long long nh,
           const void* k_h, const void* freeze, long long freeze_stride,
           int n_steps, double dt0, double fmax, void* stream) {
  if (B <= 0) return 0;
  const int form = (int)plan[P_FORM], threads = (int)plan[P_THREADS];
  const int G = (int)plan[P_GROUPS], W = (int)plan[P_WARPS];
  const int CL = (int)plan[P_CLUSTER];
  const long long smem = plan[P_SMEM];
  const bool group = form == FORM_LONE || form == FORM_WARP;
  const int most = form == FORM_LONE ? GROUP_THREADS
                   : form == FORM_WARP ? WARP_THREADS : LARGE_THREADS;
  if (form < FORM_LONE || form > FORM_LARGE || threads <= 0 ||
      threads % 32 || threads > most ||
      (group && (G < 1 || G > MAX_GROUPS || 32 * W * G != threads)) ||
      (form == FORM_LARGE && (CL < 1 || CL > MAX_CLUSTER)))
    return (int)cudaErrorInvalidValue;
  const bool small = N <= 32, shared = plan[P_STAGED] != 0;
  int id = 0;
  const void* fn = form_kernel<T>(form, small, shared, &id);
  int err = opt_in_smem(fn, id, smem);
  if (err) return err;
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
  T* o = static_cast<T*>(out);
  bool* d = static_cast<bool*>(done);
  int* s = static_cast<int*>(steps);
  const unsigned char* fr = static_cast<const unsigned char*>(freeze);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group) {
    Slots sl;
    for (int k = 0; k < 4; ++k) sl.lo[k] = (int)plan[P_LO0 + k];
    sl.n = (int)plan[P_SLOTS];
    const unsigned grid = (unsigned)((B + G - 1) / G);
    const int E = (int)plan[P_ENTRIES];
    using K = void (*)(const T*, T*, bool*, int*, long long, int,
                       const Tables<T>, const unsigned char*, long long, int,
                       double, double, int, int, int, const Slots);
    const K kernel = reinterpret_cast<K>(const_cast<void*>(fn));
    kernel<<<grid, threads, (size_t)smem, st>>>(
        c, o, d, s, B, N, t, fr, freeze_stride, n_steps, dt0, fmax, W, G, E,
        sl);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(B * CL), 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = (int)cudaLaunchKernelEx(
        &cfg, shared ? ff_fire_large_kernel<T, true>
                     : ff_fire_large_kernel<T, false>,
        c, o, static_cast<T*>(work), d, s, B, N, t, fr, freeze_stride,
        n_steps, dt0, fmax);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int info(const long long* plan, int N, int* out) {
  int id = 0;
  const void* fn = form_kernel<T>((int)plan[P_FORM], N <= 32,
                                  plan[P_STAGED] != 0, &id);
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

#define FF_FIRE_ENTRY(NAME, T)                                               \
  int NAME(const void* coords, void* out, void* done, void* steps,          \
           void* work, long long B, int N, const long long* plan, int nb,   \
           int na, int np, int nd, T bond_k, const void* atoms,             \
           const void* entries, const void* t0, const void* inc_off,        \
           const void* inc_code, const void* springs,                       \
           const void* spring_t, long long ns, const void* k_s,             \
           const void* half, long long nh, const void* k_h,                 \
           const void* freeze, long long freeze_stride, int n_steps,        \
           double dt0, double fmax, void* stream) {                         \
    return launch<T>(coords, out, done, steps, work, B, N, plan, nb, na,    \
                     np, nd, bond_k, atoms, entries, t0, inc_off, inc_code, \
                     springs, spring_t, ns, k_s, half, nh, k_h, freeze,     \
                     freeze_stride, n_steps, dt0, fmax, stream);            \
  }

FF_FIRE_ENTRY(ff_fire_f32, float)
FF_FIRE_ENTRY(ff_fire_f64, double)

// out: registers a thread, local (spilled) bytes a thread, resident
// blocks an SM of the plan's kernel at its threads and shared bytes
int ff_fire_info(const long long* plan, int N, int f64, int* out) {
  return f64 ? info<double>(plan, N, out) : info<float>(plan, N, out);
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
