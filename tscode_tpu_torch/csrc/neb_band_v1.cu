// The nudged elastic band's relaxation on the internal force field, every
// step of a band in one launch: N1's first design, kept unchanged as the
// yardstick of the redesign in neb_band.cu (its own library, launched only
// on request: ops/kernels/neb.launch_v1). It evaluates each term once for
// the energy and again in each of its atoms' walks, reading the tables
// from device memory every step.
//
// Replaces no Pallas kernel: the JAX package runs tscode_tpu/neb.py:219
// _neb_relax as one jitted program, a lax.scan over n_steps whose body is
// neb_forces (:168: the image energies, jax.grad of them, band_forces)
// and _fire_band_update (:177). The port ran that step (~230 PyTorch
// kernels) captured in a CUDA graph and replayed n_steps times from the
// host (neb._band_body under capture.graph_loop).
//
// What the kernel computes, for at most n_steps steps of a band of I
// images of N atoms whose endpoints do not move:
//   the energies of the interior images (the endpoints' once, at the
//   start) and their forces, analytic (ff_forces.cuh, ff.FireTerms);
//   each interior image's improved upwind tangent on the energies
//   (t+ where the energies rise through it, t- where they fall, else the
//   mix of both weighted by the larger and the smaller energy step
//   toward the higher neighbour), normalised with a 1e-12 floor;
//   the force less its part along the tangent plus the spring force
//   k (|c[i+1] - c[i]| - |c[i] - c[i-1]|) along it; with `climbing` the
//   first highest interior image takes f - 2 f_par instead;
//   the band's FIRE update on scalar controls
//   (optimizers.fire_band_update): done latched when the largest atomic
//   force is under fmax, power and norms over the whole band, dt growing
//   to at most 4 dt0, the step capped at 0.05 A over the whole band.
// The band leaves its loop once done has latched (the chain no longer
// moves from there, so the output equals the scan's full length). The
// products, sums and quotients of the band algebra are rounded one at a
// time (no fused multiply-add), as PyTorch's elementwise ops round them.
//
// Fixed orders, no atomics (two launches give the same bits):
//   an atom's force: its incidence entries in order, then its springs
//   (ff_fire.ff_forces_plain's order);
//   an image's energy: its term energies in slot order (bonds, angles,
//   repulsion pairs, dihedrals, springs, half-springs, each kind from a
//   multiple of 32), each 32 slots by xor butterfly, the chunks in order
//   (ff_fire.ff_energy_plain's order);
//   an image's sums over its atoms: each 32-atom chunk by xor butterfly,
//   the chunks in order; the band's: the images' sums in image order.
//
// Bound. The function's work a step is each term of every interior image
// once for its energy and forces together (~20 flops a pair term, ~60 an
// angle, ~110 a dihedral, ~3 more for the energy) and ~100 flops an atom
// of band algebra; the tables and the chain are read once and the chain
// written once. The kernel evaluates a term once for the energy and again
// in each of its atoms' walks. So a call is bound by operations, but a
// band is a chain of dependent steps, each a term pass, the energies'
// chunk sums and four rounds of reductions behind barriers: at the sizes
// NEB runs, latency sets its pace.
//
// The forms (ops/kernels/neb.launch_plan):
//   lone   one block a band. Every image's coordinates, the interior
//          images' velocities, forces and tangents and the energies'
//          chunk sums sit in shared memory; G lanes an atom walk its
//          incidence entries (the large form of the dimer kernel's walk),
//          a warp an image takes its band algebra and reductions;
//          __syncthreads between the phases.
//   large  a thread-block cluster a band (up to 8 blocks), the interior
//          images dealt to its blocks in order. A block holds its images'
//          coordinates, velocities, forces and tangents in shared memory
//          where they fit (SHARED), else in device memory; the interior
//          images' coordinates are mirrored in device memory for the
//          neighbours' tangents (read through L2), the energies' chunk
//          sums kept there too. Each image's energy and band partial
//          sums are written into every block's shared memory (distributed
//          shared memory) by its owner and read in image order; cluster
//          barriers between the phases that cross blocks. Any I and N.
//   grid   a cooperative grid a band (the blocks that stay resident on
//          the card, one an SM): the term pass of every interior image
//          (the energies' chunks, the walk) spread over all its threads,
//          the band algebra on the images' owners as in the large form;
//          every array in device memory, energies and partial sums too,
//          read through L2 where another block wrote them; grid barriers
//          between the phases (five a step). A launch that would not fit
//          on the card is refused, never left to hang. Any I and N.
// Every form sums in the same orders, so all give the same bits.
// Entry neb_band_f64 returns the cudaError_t of the launch; neb_info
// reports a form's registers, local memory and resident blocks. TT_PHASES
// builds (csrc/phases.cuh, tools/kernel_phases.py --n1): each block's
// record of its first thread's cycles by phase (Lap).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "ff_forces.cuh"
#include "phases.cuh"

namespace cg = cooperative_groups;
using namespace ffk;

namespace {

constexpr int MAX_THREADS = 512;
constexpr long long STATIC_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr int WALK_BATCH = 4;
constexpr int KINDS = 6;               // the energy slots' kinds
constexpr double STEP_CAP = 0.05;      // A, the band's largest step
constexpr double DT_GROW = 4.0;        // dt grows to at most 4 dt0

enum Form : int { FORM_LONE = 0, FORM_LARGE = 1, FORM_GRID = 2 };
// kernels: lone, large in device memory, large in shared memory, grid
constexpr int N_KERNELS = 4;
// the launch plan, a host array: ops/kernels/neb.Plan.args
enum PlanField : int { P_FORM, P_THREADS, P_SMEM, P_CLUSTER, P_LANES,
                       P_SHARED, P_SLOTS, P_LO0, N_PLAN = P_LO0 + KINDS };
// the band partial sums of an image, red[q * M + image - 1]
enum Red : int { R_POWER, R_FSQ, R_VSQ, R_FMAX, R_STEP, N_RED };
// TT_PHASES builds: a block's record, the cycles of its first thread by
// phase (the energy chunks, the walk, the energies' sums, the band algebra
// C, the controls and velocities D, the move E, the wait at each of the
// five barriers that close A to E, set-up and write-out), then the steps
enum Lap : int { L_ENERGY, L_WALK, L_ESUM, L_C, L_D, L_E, L_SYNC_A,
                 L_SYNC_B, L_SYNC_C, L_SYNC_D, L_SYNC_E, L_SETUP, L_STEPS,
                 N_LAPS };
using Laps = TtLaps<N_LAPS>;

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double quot(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T dot_atom(const T* x, const T* y) {
  return add(add(mul(x[0], y[0]), mul(x[1], y[1])), mul(x[2], y[2]));
}

// the energy slots of an image: kind k's terms at slots lo[k] ..
// lo[k] + count - 1, each kind from a multiple of 32
struct ESlots {
  int lo[KINDS];
  int n;
};

// the energy of slot `slot` (0 for a slot that holds no term)
template <typename T, typename C>
__device__ __forceinline__ T slot_energy(const Tables<T>& t,
                                         const ESlots& sl, const C& c,
                                         int slot) {
  const long long count[KINDS] = {t.nb, t.na, t.np, t.nd, t.springs.n,
                                  t.springs.nh};
  int base = 0;
  for (int k = 0; k < 4; ++k) {
    if (slot >= sl.lo[k] && slot < sl.lo[k] + count[k])
      return term_energy(c, PackedLoad<T>{t}(base + slot - sl.lo[k]),
                         t.bond_k);
    base += (int)count[k];
  }
  for (int h = 0; h < 2; ++h)
    if (slot >= sl.lo[4 + h] && slot < sl.lo[4 + h] + count[4 + h])
      return spring_energy(c, t.springs, slot - sl.lo[4 + h], h == 1);
  return T(0);
}

// the energy chunks of n_img images: a warp a (image, chunk), each lane
// a slot, the 32 slots by xor butterfly, written to row_of(image)[chunk];
// thread tid of nt (a block's, or the grid's)
template <typename T, typename AccOf, typename RowOf>
__device__ __forceinline__ void energy_chunks(const Tables<T>& t,
                                              const ESlots& sl, int K,
                                              int n_img, int tid, int nt,
                                              const AccOf& acc_of,
                                              const RowOf& row_of) {
  const int lane = tid & 31, nw = nt >> 5;
  for (int q = tid >> 5; q < n_img * K; q += nw) {
    const int img = q / K, k = q - img * K;
    T e = slot_energy(t, sl, acc_of(img), 32 * k + lane);
    for (int o = 16; o > 0; o >>= 1)
      e = add(e, __shfl_xor_sync(0xffffffffu, e, o));
    if (lane == 0) row_of(img)[k] = e;
  }
}

// the true forces of n_img images: item p = (image p / N, atom p % N), G
// lanes an atom, lane j of the group on entry lo + G r + j, each lane
// loading the codes and then the terms of WALK_BATCH of its entries
// before it computes them; the group's values added in entry order (the
// lanes' values gathered by shuffles), then the atom's springs:
// ff_forces_plain's sums. The group's first lane writes out_of(image).
// Thread tid of nt (a block's, or the grid's).
template <typename T, typename AccOf, typename OutOf>
__device__ __forceinline__ void walk_forces(const Tables<T>& t, int N,
                                            int n_img, int G, int tid,
                                            int nt, const AccOf& acc_of,
                                            const OutOf& out_of) {
  const int gl = tid & (G - 1), ng = nt / G;
  const int gi = tid / G, warp_first = (tid & ~31) / G;
  const int items = n_img * N;
  for (int it = 0;; ++it) {
    if (warp_first + it * ng >= items) break;
    const int p = gi + it * ng;
    const bool has = p < items;
    const int img = has ? p / N : 0;
    const int a = has ? p - img * N : 0;
    const auto acc = acc_of(img);
    int lo = 0, hi = 0;
    if (has) {
      lo = __ldg(t.inc_off + a);
      hi = __ldg(t.inc_off + a + 1);
    }
    int rounds = (hi - lo + G - 1) / G;
    if (G > 1) rounds = __reduce_max_sync(0xffffffffu, rounds);
    T f[3] = {T(0), T(0), T(0)};
    for (int r0 = 0; r0 < rounds; r0 += WALK_BATCH) {
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
        T val[3] = {T(0), T(0), T(0)};
        if (ok[u]) {
          T o[4][3];
          term_forces(acc, rec, t.bond_k, o);
          for (int k = 0; k < 3; ++k)
            val[k] = role == 0 ? o[0][k]
                     : role == 1 ? o[1][k]
                     : role == 2 ? o[2][k] : o[3][k];
        }
        if (G == 1) {
          if (ok[u])
            for (int k = 0; k < 3; ++k) f[k] += val[k];
        } else {
          // the group's entries of this round in order: lane j's
          const int first = lo + (r0 + u) * G;
          for (int j = 0; j < G; ++j)
            for (int k = 0; k < 3; ++k) {
              const T y = __shfl_sync(0xffffffffu, val[k], j, G);
              if (first + j < hi) f[k] += y;
            }
        }
      }
    }
    if (has) {
      add_springs(acc, a, t.springs, f);
      if (gl == 0) {
        T* o = out_of(img) + 3 * a;
        o[0] = f[0];
        o[1] = f[1];
        o[2] = f[2];
      }
    }
  }
}

// s[0..2] summed and s[3] maxed over the atoms 0 .. N - 1 of an image by
// one warp, vals(a, s) adding atom a's values to s (from zero): each
// 32-atom chunk by xor butterfly, the chunks in order; every lane ends
// with the same bits
template <typename T, typename F>
__device__ __forceinline__ void image_reduce(int N, const F& vals, T* out) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < N; base += 32) {
    T s[4] = {T(0), T(0), T(0), T(0)};
    if (base + lane < N) vals(base + lane, s);
    for (int o = 16; o > 0; o >>= 1) {
      s[0] = add(s[0], __shfl_xor_sync(0xffffffffu, s[0], o));
      s[1] = add(s[1], __shfl_xor_sync(0xffffffffu, s[1], o));
      s[2] = add(s[2], __shfl_xor_sync(0xffffffffu, s[2], o));
      s[3] = tmax(s[3], __shfl_xor_sync(0xffffffffu, s[3], o));
    }
    if (base == 0) {
      for (int j = 0; j < 4; ++j) out[j] = s[j];
    } else {
      for (int j = 0; j < 3; ++j) out[j] = add(out[j], s[j]);
      out[3] = tmax(out[3], s[3]);
    }
  }
}

// the shared values of a form (ops/kernels/neb.launch_plan): lone, every
// image's coordinates, the interior images' velocities, forces and
// tangents, the energies' chunk sums (I x K), the energies, the band
// partial sums; large, a block's images' four arrays where SHARED, the
// energies and the partial sums
__host__ __device__ __forceinline__ long long lone_values(int I, int N,
                                                          int K) {
  const long long n3 = 3LL * N, M = I - 2;
  return I * n3 + 3 * M * n3 + (long long)I * K + I + N_RED * M;
}
__host__ __device__ __forceinline__ int large_per(int M, int cl) {
  return (M + cl - 1) / cl;
}
__host__ __device__ __forceinline__ long long large_values(int I, int N,
                                                           int cl,
                                                           bool shared) {
  const long long M = I - 2;
  return (shared ? 4LL * large_per((int)M, cl) * 3 * N : 0) + I +
         N_RED * M;
}
template <typename T>
__device__ __forceinline__ T ld(const T* p, bool l2) {
  return l2 ? __ldcg(p) : *p;
}

// CLUSTER: the large form; GRID: the grid form (a cooperative grid a
// band: the term pass of every interior image spread over all its
// blocks, the band algebra on the owners of the images, grid barriers
// between the phases; every array in device memory, read through L2
// where another block wrote it)
template <typename T, bool CLUSTER, bool SHARED, bool GRID>
__global__ void __launch_bounds__(MAX_THREADS)
neb_band_kernel(const T* __restrict__ chain, T* __restrict__ out,
                bool* __restrict__ done_out, int* __restrict__ steps_out,
                T* work, int I, int N, const Tables<T> t, const ESlots sl,
                int G, int n_steps, double k_spring_, double dt0_,
                double fmax_, int climbing) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int M = I - 2;
  const int n3 = 3 * N;
  const int K = sl.n / 32;
  constexpr bool MULTI = CLUSTER || GRID;
  int rank = 0, cl = 1;
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    cl = (int)cluster.num_blocks();
  }
  if constexpr (GRID) {
    rank = (int)blockIdx.x;
    cl = (int)gridDim.x;
  }
  // the owned interior images, j0 + 1 .. j1 (lone: all of them)
  const int per = MULTI ? large_per(M, cl) : M;
  const int j0 = min(M, rank * per), j1 = min(M, j0 + per);
  const int m = j1 - j0;
  // the arrays: cown/v/f/tg(jl) of the owned image jl, ech rows by image
  T *cbase, *vbase, *fbase, *tbase, *ech, *mirror = nullptr;
  T *e_all, *red;
  if (!MULTI) {
    cbase = sm + n3;                     // interior image j at j n3
    vbase = sm + (long long)I * n3;
    fbase = vbase + (long long)M * n3;
    tbase = fbase + (long long)M * n3;
    ech = tbase + (long long)M * n3;
    e_all = ech + (long long)I * K;
  } else {
    mirror = work;
    ech = work + 4LL * M * n3;
    if (SHARED) {
      cbase = sm;
      vbase = sm + (long long)per * n3;
      fbase = vbase + (long long)per * n3;
      tbase = fbase + (long long)per * n3;
      e_all = tbase + (long long)per * n3;
    } else {
      cbase = mirror + (long long)j0 * n3;
      vbase = work + (long long)M * n3 + (long long)j0 * n3;
      fbase = vbase + (long long)M * n3;
      tbase = fbase + (long long)M * n3;
      e_all = GRID ? ech + (long long)I * K : sm;
    }
  }
  red = e_all + I;
  // the forces of interior image j (the grid's term pass writes any)
  T* const f_all = GRID ? work + 2LL * M * n3 : nullptr;
  const T k_spring = T(k_spring_), dt0 = T(dt0_), fmax = T(fmax_);
  using Own = typename std::conditional<MULTI && !SHARED, GlobalCoords<T>,
                                        SmemCoords<T>>::type;
  auto cown = [&](int jl) { return cbase + (long long)jl * n3; };
  auto vown = [&](int jl) { return vbase + (long long)jl * n3; };
  auto fown = [&](int jl) { return fbase + (long long)jl * n3; };
  auto tgown = [&](int jl) { return tbase + (long long)jl * n3; };
  // image i's coordinates for reading, and whether through L2
  auto image = [&](int i) -> const T* {
    if (!MULTI) return sm + (long long)i * n3;
    if (i == 0 || i == I - 1) return chain + (long long)i * n3;
    if (i - 1 >= j0 && i - 1 < j1) return cown(i - 1 - j0);
    return mirror + (long long)(i - 1) * n3;
  };
  auto remote = [&](int i) {
    return MULTI && i > 0 && i < I - 1 && !(i - 1 >= j0 && i - 1 < j1);
  };
  // an energy, a partial sum, a force: written by another block in the
  // grid form
  auto e_at = [&](int i) { return ld(e_all + i, GRID); };
  auto red_at = [&](int q) { return ld(red + q, GRID); };
  // a value into every block's copy of a shared array
  auto put = [&](T* arr, int i, T val) {
    if constexpr (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int r = 0; r < cl; ++r) cluster.map_shared_rank(arr, r)[i] = val;
    } else {
      arr[i] = val;
    }
  };
  auto sync_all = [&]() {
    if constexpr (CLUSTER) {
      __threadfence();
      cg::this_cluster().sync();
    } else if constexpr (GRID) {
      __threadfence();
      cg::this_grid().sync();
    } else {
      __syncthreads();
    }
  };

  Laps laps;
  // set-up: the coordinates, velocities at rest, the endpoints' energies
  if (!MULTI) {
    for (long long k = tid; k < (long long)I * n3; k += nt) sm[k] = chain[k];
  } else {
    for (int jl = 0; jl < m; ++jl)
      for (int k = tid; k < n3; k += nt) {
        const T x = chain[(long long)(j0 + jl + 1) * n3 + k];
        cown(jl)[k] = x;
        if (SHARED) mirror[(long long)(j0 + jl) * n3 + k] = x;
      }
  }
  for (int jl = 0; jl < m; ++jl)
    for (int k = tid; k < n3; k += nt) vown(jl)[k] = T(0);
  // (a cluster: every block has started before any writes into another's
  // shared memory)
  sync_all();
  if (rank == 0) {
    energy_chunks(t, sl, K, 2, tid, nt,
                  [&](int e) { return SmemCoords<T>{image(e ? I - 1 : 0)}; },
                  [&](int e) { return ech + (long long)(e ? I - 1 : 0) * K; });
    __syncthreads();
    if (tid < 2) {
      const int i = tid ? I - 1 : 0;
      T e = T(0);
      for (int k = 0; k < K; ++k) e = add(e, ech[(long long)i * K + k]);
      put(e_all, i, e);
    }
  }
  sync_all();
  laps.lap(L_SETUP);

  int steps = 0, n_pos = 0;
  bool done = false;
  T dt = dt0, alpha = T(0.1);
  const T dt_cap = mul(dt0, T(DT_GROW));
  while (steps < n_steps) {
    // A: the owned images' energy chunks and true forces; the grid form
    // spreads every interior image's over all its threads
    if (GRID) {
      const int gt = rank * nt + tid, gn = cl * nt;
      energy_chunks(t, sl, K, M, gt, gn,
                    [&](int j) { return Own{mirror + (long long)j * n3}; },
                    [&](int j) { return ech + (long long)(j + 1) * K; });
      laps.lap(L_ENERGY);
      walk_forces(t, N, M, G, gt, gn,
                  [&](int j) { return Own{mirror + (long long)j * n3}; },
                  [&](int j) { return f_all + (long long)j * n3; });
      laps.lap(L_WALK);
      sync_all();
    } else {
      energy_chunks(
          t, sl, K, m, tid, nt, [&](int jl) { return Own{cown(jl)}; },
          [&](int jl) { return ech + (long long)(j0 + jl + 1) * K; });
      laps.lap(L_ENERGY);
      walk_forces(t, N, m, G, tid, nt, [&](int jl) { return Own{cown(jl)}; },
                  [&](int jl) { return fown(jl); });
      laps.lap(L_WALK);
      __syncthreads();
    }
    laps.lap(L_SYNC_A);
    // B: the owned images' energies, into every block
    if (tid < m) {
      const int i = j0 + tid + 1;
      const T* row = ech + (long long)i * K;
      T e = T(0);
      for (int k = 0; k < K; ++k) e = add(e, ld(row + k, GRID));
      put(e_all, i, e);
    }
    laps.lap(L_ESUM);
    sync_all();
    laps.lap(L_SYNC_B);
    // the first highest interior image
    int top = 1;
    for (int i = 2; i < I - 1; ++i)
      if (e_at(i) > e_at(top)) top = i;
    // C: a warp an owned image: tangent, projection, springs, climbing;
    // the image's partial sums of the FIRE update
    for (int jl = warp; jl < m; jl += nw) {
      const int i = j0 + jl + 1;
      const T* cp = image(i - 1);
      const T* cn = image(i + 1);
      const bool lp = remote(i - 1), ln = remote(i + 1);
      const T* c = cown(jl);
      T* tg = tgown(jl);
      T* f = fown(jl);
      const T* v = vown(jl);
      const T ep = e_at(i - 1), em = e_at(i), en = e_at(i + 1);
      const bool up = en > em && em > ep;
      const bool down = en < em && em < ep;
      const T an = fabs(sub(en, em)), ap = fabs(sub(ep, em));
      const T dmax = tmax(an, ap), dmin = tmin(an, ap);
      const bool higher_next = en > ep;
      T s[4];
      image_reduce(N, [&](int a, T* q) {
        for (int k = 0; k < 3; ++k) {
          const int x = 3 * a + k;
          const T cx = c[x];
          const T tp = sub(ld(cn + x, ln), cx);
          const T tm = sub(cx, ld(cp + x, lp));
          const T raw = up     ? tp
                        : down ? tm
                        : higher_next ? add(mul(tp, dmax), mul(tm, dmin))
                                      : add(mul(tp, dmin), mul(tm, dmax));
          tg[x] = raw;
          q[0] = add(q[0], mul(raw, raw));
          q[1] = add(q[1], mul(tp, tp));
          q[2] = add(q[2], mul(tm, tm));
        }
      }, s);
      const T den = tmax(ksqrt(s[0]), T(FLOOR));
      const T ks = mul(k_spring, sub(ksqrt(s[1]), ksqrt(s[2])));
      image_reduce(N, [&](int a, T* q) {
        for (int k = 0; k < 3; ++k) {
          const int x = 3 * a + k;
          const T th = quot(tg[x], den);
          tg[x] = th;
          q[0] = add(q[0], mul(ld(f + x, GRID), th));
        }
      }, s);
      const T along = s[0];
      const bool climb = climbing && i == top;
      image_reduce(N, [&](int a, T* q) {
        T nf[3];
        for (int k = 0; k < 3; ++k) {
          const int x = 3 * a + k;
          const T th = tg[x];
          const T par = mul(along, th);
          const T fx = ld(f + x, GRID);
          nf[k] = climb ? sub(fx, mul(T(2), par))
                        : add(sub(fx, par), mul(ks, th));
          f[x] = nf[k];
        }
        const T* va = v + 3 * a;
        q[0] = add(q[0], dot_atom(nf, va));
        q[1] = add(q[1], dot_atom(nf, nf));
        q[2] = add(q[2], dot_atom(va, va));
        q[3] = tmax(q[3], dot_atom(nf, nf));
      }, s);
      if (lane == 0) {
        put(red, R_POWER * M + i - 1, s[0]);
        put(red, R_FSQ * M + i - 1, s[1]);
        put(red, R_VSQ * M + i - 1, s[2]);
        put(red, R_FMAX * M + i - 1, s[3]);
      }
    }
    laps.lap(L_C);
    sync_all();
    laps.lap(L_SYNC_C);
    // D: the band's controls, the same bits in every thread
    T power = T(0), fsq = T(0), vsq = T(0), fm = T(0);
    for (int j = 0; j < M; ++j) {
      power = add(power, red_at(R_POWER * M + j));
      fsq = add(fsq, red_at(R_FSQ * M + j));
      vsq = add(vsq, red_at(R_VSQ * M + j));
      fm = tmax(fm, red_at(R_FMAX * M + j));
    }
    ++steps;
    laps.add(L_STEPS, 1);
    if (ksqrt(fm) < fmax) {
      done = true;
      break;
    }
    const T f_norm = ksqrt(fsq), v_norm = ksqrt(vsq);
    const bool uphill = power <= T(0);
    n_pos = uphill ? 0 : n_pos + 1;
    const bool grow = n_pos > 5;
    const T dt_new = uphill ? mul(dt, T(0.5))
                     : grow ? tmin(mul(dt, T(1.1)), dt_cap) : dt;
    const T alpha_new = uphill ? T(0.1) : grow ? mul(alpha, T(0.99)) : alpha;
    const T keep = sub(T(1), alpha);
    const T fden = tmax(f_norm, T(FLOOR));
    for (int jl = warp; jl < m; jl += nw) {
      const int i = j0 + jl + 1;
      T* v = vown(jl);
      const T* f = fown(jl);
      T s[4];
      image_reduce(N, [&](int a, T* q) {
        T st[3];
        for (int k = 0; k < 3; ++k) {
          const int x = 3 * a + k;
          const T fx = ld(f + x, GRID);
          const T mixed =
              add(mul(keep, v[x]), quot(mul(mul(alpha, fx), v_norm), fden));
          const T stepped = add(uphill ? T(0) : mixed, mul(dt_new, fx));
          v[x] = stepped;
          st[k] = mul(dt_new, stepped);
        }
        q[3] = tmax(q[3], dot_atom(st, st));
      }, s);
      if (lane == 0) put(red, R_STEP * M + i - 1, s[3]);
    }
    dt = dt_new;
    alpha = alpha_new;
    laps.lap(L_D);
    sync_all();
    laps.lap(L_SYNC_D);
    // E: the step, capped over the whole band
    T md = T(0);
    for (int j = 0; j < M; ++j) md = tmax(md, red_at(R_STEP * M + j));
    const T scale = tmin(quot(T(STEP_CAP), tmax(ksqrt(md), T(FLOOR))), T(1));
    for (int jl = warp; jl < m; jl += nw) {
      T* c = cown(jl);
      T* v = vown(jl);
      for (int a = lane; a < N; a += 32)
        for (int k = 0; k < 3; ++k) {
          const int x = 3 * a + k;
          const T stepped = v[x];
          const T nx = add(c[x], mul(mul(dt, stepped), scale));
          c[x] = nx;
          if (CLUSTER && SHARED)
            mirror[(long long)(j0 + jl) * n3 + x] = nx;
          v[x] = mul(stepped, scale);
        }
    }
    laps.lap(L_E);
    // (the grid: the next term pass reads every image's coordinates)
    if (GRID)
      sync_all();
    else
      __syncthreads();
    laps.lap(L_SYNC_E);
  }
  // the chain out: the owned images, and the endpoints by rank 0
  for (int jl = 0; jl < m; ++jl)
    for (int k = tid; k < n3; k += nt)
      out[(long long)(j0 + jl + 1) * n3 + k] = cown(jl)[k];
  if (rank == 0) {
    for (int k = tid; k < n3; k += nt) {
      out[k] = chain[k];
      out[(long long)(I - 1) * n3 + k] = chain[(long long)(I - 1) * n3 + k];
    }
    if (tid == 0) {
      *done_out = done;
      *steps_out = steps;
    }
  }
  laps.lap(L_SETUP);
  laps.flush(rank, tid == 0);
  // no block leaves while another may still read its shared memory
  if constexpr (CLUSTER) cg::this_cluster().sync();
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

const void* form_kernel(const long long* plan, int* id) {
  const bool large = plan[P_FORM] == FORM_LARGE;
  const bool shared = plan[P_SHARED] != 0;
  if (plan[P_FORM] == FORM_GRID) {
    *id = 3;
    return (const void*)neb_band_kernel<double, false, false, true>;
  }
  *id = large ? 1 + shared : 0;
  if (!large) return (const void*)neb_band_kernel<double, false, true, false>;
  return shared ? (const void*)neb_band_kernel<double, true, true, false>
                : (const void*)neb_band_kernel<double, true, false, false>;
}

// the blocks of a cooperative grid of the kernel fn that stay resident
// on the current card at `threads` threads and `smem` shared bytes
int resident_blocks(const void* fn, int threads, long long smem, int* out) {
  int dev = 0, sms = 0, per = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, fn, threads, (size_t)smem);
  *out = sms * per;
  return err;
}

int launch(const void* chain, void* out, void* done, void* steps,
           void* work, int I, int N, const long long* plan, int nb, int na,
           int np, int nd, double bond_k, const void* atoms, const void* t0,
           const void* inc_off, const void* inc_code, const void* springs,
           const void* spring_t, long long ns, const void* k_s,
           const void* half, long long nh, const void* k_h, int n_steps,
           double k_spring, double dt0, double fmax, int climbing,
           void* stream) {
  const int form = (int)plan[P_FORM], threads = (int)plan[P_THREADS];
  const int cl = (int)plan[P_CLUSTER], lanes = (int)plan[P_LANES];
  const bool shared = plan[P_SHARED] != 0;
  const long long smem = plan[P_SMEM];
  ESlots sl;
  sl.n = (int)plan[P_SLOTS];
  for (int k = 0; k < KINDS; ++k) sl.lo[k] = (int)plan[P_LO0 + k];
  const int K = sl.n / 32;
  if ((form != FORM_LONE && form != FORM_LARGE && form != FORM_GRID) ||
      threads <= 0 ||
      threads % 32 || threads > MAX_THREADS || I < 3 || N <= 0 ||
      sl.n % 32 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      (form == FORM_LONE && (!shared || work != nullptr ||
                             smem != lone_values(I, N, K) * 8)) ||
      (form == FORM_LARGE &&
       (cl < 1 || cl > MAX_CLUSTER || cl > I - 2 || work == nullptr ||
        smem != large_values(I, N, cl, shared) * 8)) ||
      (form == FORM_GRID &&
       (cl < 1 || shared || work == nullptr || smem != 0)))
    return (int)cudaErrorInvalidValue;
  int id = 0;
  const void* fn = form_kernel(plan, &id);
  int err = opt_in_smem(fn, id, smem);
  if (err) return err;
  if (form == FORM_GRID) {
    // every block of a grid barrier must be resident: refuse, never hang
    int most = 0;
    err = resident_blocks(fn, threads, smem, &most);
    if (err) return err;
    if (cl > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Tables<double> t;
  t.nb = nb;
  t.na = na;
  t.np = np;
  t.nd = nd;
  t.bond_k = bond_k;
  t.atoms = static_cast<const int4*>(atoms);
  t.entries = nullptr;
  t.t0 = static_cast<const double*>(t0);
  t.inc_off = static_cast<const int*>(inc_off);
  t.inc_code = static_cast<const int*>(inc_code);
  t.springs.pairs = static_cast<const long long*>(springs);
  t.springs.target = static_cast<const double*>(spring_t);
  t.springs.n = ns;
  t.springs.k = static_cast<const double*>(k_s);
  t.springs.half = static_cast<const long long*>(half);
  t.springs.nh = nh;
  t.springs.k_h = static_cast<const double*>(k_h);
  const double* c = static_cast<const double*>(chain);
  double* o = static_cast<double*>(out);
  bool* d = static_cast<bool*>(done);
  int* s = static_cast<int*>(steps);
  double* wk = static_cast<double*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == FORM_LONE) {
    neb_band_kernel<double, false, true, false>
        <<<1, threads, (size_t)smem, st>>>(c, o, d, s, wk, I, N, t, sl, lanes,
                                           n_steps, k_spring, dt0, fmax,
                                           climbing);
  } else if (form == FORM_GRID) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cl, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = (int)cudaLaunchKernelEx(
        &cfg, neb_band_kernel<double, false, false, true>, c, o, d, s, wk, I,
        N, t, sl, lanes, n_steps, k_spring, dt0, fmax, climbing);
    if (err) return err;
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cl, 1, 1);
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
    err = (int)cudaLaunchKernelEx(
        &cfg, shared ? neb_band_kernel<double, true, true, false>
                     : neb_band_kernel<double, true, false, false>,
        c, o, d, s, wk, I, N, t, sl, lanes, n_steps, k_spring, dt0, fmax,
        climbing);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int neb_band_f64(const void* chain, void* out, void* done, void* steps,
                 void* work, int I, int N, const long long* plan, int nb,
                 int na, int np, int nd, double bond_k, const void* atoms,
                 const void* t0, const void* inc_off, const void* inc_code,
                 const void* springs, const void* spring_t, long long ns,
                 const void* k_s, const void* half, long long nh,
                 const void* k_h, int n_steps, double k_spring, double dt0,
                 double fmax, int climbing, void* stream) {
  return launch(chain, out, done, steps, work, I, N, plan, nb, na, np, nd,
                bond_k, atoms, t0, inc_off, inc_code, springs, spring_t, ns,
                k_s, half, nh, k_h, n_steps, k_spring, dt0, fmax, climbing,
                stream);
}

// out: registers a thread, local (spilled) bytes a thread, resident
// blocks an SM of the plan's kernel at its threads and shared bytes
int neb_info(const long long* plan, int* out) {
  int id = 0;
  const void* fn = form_kernel(plan, &id);
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

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
