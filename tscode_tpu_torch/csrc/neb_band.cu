// The nudged elastic band's relaxation on the internal force field, every
// step of a band in one launch (N1).
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
// Fixed orders, no atomics (two launches give the same bits, and the
// bits of the first design, neb_band_v1.cu):
//   an atom's force: its incidence entries in order, then its springs
//   (ff_fire.ff_forces_plain's order);
//   an image's energy: its term energies in slot order (bonds, angles,
//   repulsion pairs, dihedrals, springs, half-springs, each kind from a
//   multiple of 32), each 32 slots by xor butterfly, the chunks in order
//   (ff_fire.ff_energy_plain's order);
//   an image's sums over its atoms: each 32-atom chunk by xor butterfly,
//   the chunks in order; the band's: the images' sums in image order.
//
// The step. A: the term pass. A thread takes one energy slot of one
// image: it evaluates the slot's term once, its energy (summed by the
// warp's butterfly into the image's chunk) and its forces, which it
// writes to the term's vectors in the image's entry array (term-major: a
// pair term's force on its first atom, the second's being its negation,
// exactly; an angle's three and a dihedral's four in role order). A2: a
// thread an (image, atom) adds its incidence entries' vectors in order
// (ops/kernels/neb.entry_sources: each entry's vector and sign), then its
// springs; B beside it: each image's energy from its chunks. C: the
// tangent, projection, springs and the image's FIRE partial sums; D: the
// band's controls and the velocities; E: the capped move. The band
// algebra of an image runs on a group of the block's warps (an image of
// more than 32 atoms: its chunks dealt over the group, the chunk values
// met behind a named barrier of the group; of at most 32: one warp and
// shuffles alone).
//
// Bound. The function's work a step is each term of every interior image
// once for its energy and forces together (~20 flops a pair term, ~60 an
// angle, ~110 a dihedral, ~3 more for the energy) and ~100 flops an atom
// of band algebra; the tables and the chain are read once and the chain
// written once. So a call is bound by operations, but a band is a chain
// of dependent steps, each a term pass, the atoms' sums, the energies'
// chunk sums and four rounds of reductions behind barriers: at the sizes
// NEB runs, latency sets its pace; at thousands of atoms an image the
// entry arrays (24 bytes a pair term) go through device memory.
//
// The forms (ops/kernels/neb.launch_plan):
//   lone   one block a band, everything in shared memory: every image's
//          coordinates, the interior images' velocities, forces,
//          tangents and entry arrays, the energies' chunk sums, and the
//          force field's tables (term atoms, t0, incidence offsets and
//          entry sources), copied in once a launch. Block barriers.
//   large  a thread-block cluster a band (up to 8 blocks), the interior
//          images dealt to its blocks in order. A block holds its images'
//          coordinates, velocities, forces and tangents in shared memory
//          where they fit (SHARED), else in device memory, and its
//          images' entry arrays and the tables where they fit beside them
//          (STAGED), else in device memory; the interior images'
//          coordinates are mirrored in device memory for the neighbours'
//          tangents (read through L2), the energies' chunk sums kept
//          there too. Each image's energy and band partial sums are
//          written into every block's shared memory (distributed shared
//          memory) by its owner and read in image order; three cluster
//          barriers a step (energies, partial sums, step cap).
//   grid   a cooperative grid a band (the blocks that stay resident on
//          the card, one an SM): the term pass of every interior image
//          spread over all its warps (consecutive warps on the same 32
//          terms of successive images, the tables read in term order), the
//          atoms' sums over all its threads, the band algebra on the
//          images' owners; every array in device memory, read through L2
//          where another block wrote it; grid barriers between the
//          phases (five a step). A launch that would not fit on the card
//          is refused, never left to hang. Any I and N.
// Every form sums in the same orders, so all give the same bits.
// Entry neb_band_f64 returns the cudaError_t of the launch; neb_info
// reports a form's registers, local memory and resident blocks. TT_PHASES
// builds (csrc/phases.cuh, tools/kernel_phases.py --n1): each block's
// record of its first thread's cycles by phase (Lap).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ff_forces.cuh"
#include "phases.cuh"

namespace cg = cooperative_groups;
using namespace ffk;

namespace {

constexpr int MAX_THREADS = 512;
constexpr long long STATIC_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr int MAX_GROUPS = 8;          // named barriers 1 .. 8
constexpr int KINDS = 6;               // the energy slots' kinds
constexpr double STEP_CAP = 0.05;      // A, the band's largest step
constexpr double DT_GROW = 4.0;        // dt grows to at most 4 dt0

enum Form : int { FORM_LONE = 0, FORM_LARGE = 1, FORM_GRID = 2 };
// kernels: lone, large, grid
constexpr int N_KERNELS = 3;
// the launch plan, a host array: ops/kernels/neb.Plan.args
enum PlanField : int { P_FORM, P_THREADS, P_SMEM, P_CLUSTER, P_SHARED,
                       P_STAGED, P_SLOTS, P_LO0, N_PLAN = P_LO0 + KINDS };
// the band partial sums of an image, red[q * M + image - 1]
enum Red : int { R_POWER, R_FSQ, R_VSQ, R_FMAX, R_STEP, N_RED };
// TT_PHASES builds: a block's record, the cycles of its first thread by
// phase (the term pass A, the atoms' sums and energies A2/B, the band
// algebra C, the controls and velocities D, the move E, the wait at each
// barrier that closes them, set-up and write-out), then the steps
enum Lap : int { L_TERM, L_ATOM, L_C, L_D, L_E, L_SYNC_A, L_SYNC_B,
                 L_SYNC_C, L_SYNC_D, L_SYNC_E, L_SETUP, L_STEPS, N_LAPS };
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

__device__ __forceinline__ double dot_atom(const double* x, const double* y) {
  return add(add(mul(x[0], y[0]), mul(x[1], y[1])), mul(x[2], y[2]));
}

// the energy slots of an image: kind k's terms at slots lo[k] ..
// lo[k] + count - 1, each kind from a multiple of 32
struct ESlots {
  int lo[KINDS];
  int n;
};

// the band's force field: the term tables (in shared memory when staged,
// read with plain loads; else in device memory, read-only), each term
// kind's vectors in an image's entry array from vb[k], w[k] a term
template <typename T>
struct Band {
  int nb, na, np, nd;
  T bond_k;
  const int4* atoms;      // (terms,) the atoms in role order
  const T* t0;            // (terms,)
  const int* off;         // (N + 1,) incidence offsets
  const int* src;         // (entries,) 2 vector + negated
  bool staged;
  Springs<T> springs;
};

// a table entry: from shared memory (STAGED) or read-only device memory
template <bool STAGED, typename V>
__device__ __forceinline__ V ldt(const V* p) {
  if constexpr (STAGED)
    return *p;
  else
    return __ldg(p);
}

// coordinates of one image, (N, 3) row-major: plain loads, or through L2
// (L2) where another block of a cluster writes them between barriers
template <bool L2>
struct Coords {
  const double* p;
  __device__ __forceinline__ double operator()(int a, int x) const {
    if constexpr (L2)
      return __ldcg(p + 3 * a + x);
    else
      return p[3 * a + x];
  }
};

// the vectors an image's entry array holds for a term of kind k (a pair
// term one: its force on its first atom), and the first of kind k's
__host__ __device__ __forceinline__ int kind_width(int k) {
  return k == ANGLE ? 3 : k == DIHEDRAL ? 4 : 1;
}
__host__ __device__ __forceinline__ long long band_vectors(int nb, int na,
                                                           int np, int nd) {
  return (long long)nb + 3LL * na + np + 4LL * nd;
}

// A: slot `slot` of one image: its term's energy (returned; 0 for a slot
// that holds none) and, where ent is given, its forces into the term's
// vectors of the image's entry array
template <bool STAGED, typename T, typename C>
__device__ __forceinline__ T slot_pass(const Band<T>& t, const ESlots& sl,
                                       const C& c, int slot, T* ent) {
  const int count[4] = {t.nb, t.na, t.np, t.nd};
  int base = 0;
  long long vb = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (slot >= sl.lo[k] && slot < sl.lo[k] + count[k]) {
      const int i = slot - sl.lo[k];
      const int term = base + i;
      const TermRec<T> rec = term_rec(k, ldt<STAGED>(t.atoms + term),
                                      ldt<STAGED>(t.t0 + term));
      const T e = term_energy(c, rec, t.bond_k);
      if (ent != nullptr) {
        T o[4][3];
        term_forces(c, rec, t.bond_k, o);
        const int w = kind_width(k);
        T* dst = ent + 3 * (vb + (long long)i * w);
        for (int r = 0; r < 4; ++r)
          if (r < w)
            for (int x = 0; x < 3; ++x) dst[3 * r + x] = o[r][x];
      }
      return e;
    }
    base += count[k];
    vb += (long long)count[k] * kind_width(k);
  }
  const long long scount[2] = {t.springs.n, t.springs.nh};
  for (int h = 0; h < 2; ++h)
    if (slot >= sl.lo[4 + h] && slot < sl.lo[4 + h] + scount[h])
      return spring_energy(c, t.springs, slot - sl.lo[4 + h], h == 1);
  return T(0);
}

// A over n_img images: a warp a (chunk, image) item, consecutive warps on
// the same 32 slots of successive images; each lane a slot, the 32 slots'
// energies by xor butterfly into ech_of(image)[chunk]; thread tid of nt
template <bool STAGED, typename T, typename CoordsOf, typename RowOf,
          typename EntOf>
__device__ __forceinline__ void term_pass(const Band<T>& t, const ESlots& sl,
                                          int K, int n_img, int tid, int nt,
                                          const CoordsOf& coords_of,
                                          const RowOf& ech_of,
                                          const EntOf& ent_of) {
  const int lane = tid & 31, nw = nt >> 5;
  for (int q = tid >> 5; q < n_img * K; q += nw) {
    const int k = q / n_img, img = q - k * n_img;
    T e = slot_pass<STAGED>(t, sl, coords_of(img), 32 * k + lane,
                            ent_of(img));
    for (int o = 16; o > 0; o >>= 1)
      e = add(e, __shfl_xor_sync(0xffffffffu, e, o));
    if (lane == 0) ech_of(img)[k] = e;
  }
}

// the lanes a group of the atoms' sums: the most (a power of two up to
// 32) that keep `items` groups within `threads` threads
__device__ __forceinline__ int sum_lanes(long long items, long long threads) {
  int g = 32;
  while (g > 1 && items * g > threads) g >>= 1;
  return g;
}

// A2: the true forces of n_img images, G lanes an (image, atom,
// component) item (a block's forms: one; the grid's: sum_lanes, its
// entries in device memory): that component of its entries' vectors in
// incidence order (negated where the source says so), from zero, then its
// springs: ff_forces_plain's sums. Each lane loads SUM_BATCH of the
// group's entries a round (lane j the entries j, j + G, ...; the next
// round's sources loaded ahead), then every lane of the group adds the
// round's values in entry order from shuffles. Entry vectors in device
// memory (ENT_L2) are read through L2: other blocks wrote them.
constexpr int SUM_BATCH = 8;
template <bool STAGED, bool ENT_L2, typename T, typename CoordsOf,
          typename EntOf, typename OutOf>
__device__ __forceinline__ void atom_sums(const Band<T>& t, int N, int n_img,
                                          int tid, int nt, int G,
                                          const CoordsOf& coords_of,
                                          const EntOf& ent_of,
                                          const OutOf& out_of) {
  const int items = 3 * n_img * N;
  const int gl = tid & (G - 1), ng = nt / G;
  const int gi = tid / G, warp_first = (tid & ~31) / G;
  constexpr int U = SUM_BATCH;
  for (int it = 0;; ++it) {
    if (warp_first + it * ng >= items) break;
    const int p = gi + it * ng;
    const bool has = p < items;
    const int img = has ? p / (3 * N) : 0;
    const int r = has ? p - img * 3 * N : 0;
    const int a = r / 3, x = r - 3 * a;
    const T* ent = ent_of(img) + x;
    int lo = 0, hi = 0;
    if (has) {
      lo = ldt<STAGED>(t.off + a);
      hi = ldt<STAGED>(t.off + a + 1);
    }
    int rounds = (hi - lo + G * U - 1) / (G * U);
    rounds = __reduce_max_sync(0xffffffffu, rounds);
    int src[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = lo + u * G + gl;
      src[u] = e < hi ? ldt<STAGED>(t.src + e) : 0;
    }
    T acc = T(0);
    for (int rd = 0; rd < rounds; ++rd) {
      const int first = lo + rd * G * U;
      T val[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = first + u * G + gl;
        const T* v = ent + 3LL * (src[u] >> 1);
        const T y = e < hi ? (ENT_L2 ? __ldcg(v) : *v) : T(0);
        val[u] = (src[u] & 1) ? -y : y;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = first + G * U + u * G + gl;
        src[u] = e < hi ? ldt<STAGED>(t.src + e) : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (G == 1) {
          if (first + u < hi) acc += val[u];
        } else {
          for (int j = 0; j < G; ++j) {
            const T y = __shfl_sync(0xffffffffu, val[u], j, G);
            if (first + u * G + j < hi) acc += y;
          }
        }
      }
    }
    if (has) {
      if (t.springs.n || t.springs.nh) {
        T f[3] = {acc, acc, acc};
        add_springs(coords_of(img), a, t.springs, f);
        acc = x == 0 ? f[0] : x == 1 ? f[1] : f[2];
      }
      if (gl == 0) out_of(img)[r] = acc;
    }
  }
}

// an image's energy from its K chunk sums at row, by one warp: each
// round the lanes hold 32 consecutive chunks (read through L2 where
// another block wrote them, ESUM_AHEAD rounds ahead), and every lane adds
// them in chunk order from the shuffles; the same bits in every lane as
// the chunks added one after the other
constexpr int ESUM_AHEAD = 4;
template <bool L2, typename T>
__device__ __forceinline__ T warp_energy(const T* row, int K) {
  const int lane = threadIdx.x & 31;
  auto load = [&](int k) -> T {
    if (k >= K) return T(0);
    if constexpr (L2)
      return __ldcg(row + k);
    else
      return row[k];
  };
  T ahead[ESUM_AHEAD];
#pragma unroll
  for (int r = 0; r < ESUM_AHEAD; ++r) ahead[r] = load(32 * r + lane);
  T e = T(0);
  for (int base = 0; base < K; base += 32) {
    const T cur = ahead[0];
#pragma unroll
    for (int r = 0; r + 1 < ESUM_AHEAD; ++r) ahead[r] = ahead[r + 1];
    ahead[ESUM_AHEAD - 1] = load(base + 32 * ESUM_AHEAD + lane);
    if (base + 32 <= K) {
#pragma unroll
      for (int l = 0; l < 32; ++l)
        e = add(e, __shfl_sync(0xffffffffu, cur, l));
    } else {
      for (int l = 0; l < K - base; ++l)
        e = add(e, __shfl_sync(0xffffffffu, cur, l));
    }
  }
  return e;
}

// The band algebra's partition of a block: G groups of gw warps, one
// image of the block's at a time on a group (images g, g + G, ...), an
// image's 32-atom chunks dealt over the group's warps (chunk k on its
// warp k mod gw, atom 32 k + lane on that lane). reduce(): sums of
// s[0..2] and the max of s[3] over the image's atoms, each chunk by xor
// butterfly, the chunks in order, the same bits in every thread of the
// group (one chunk: the warp's shuffles alone; more: the chunk values in
// one of two buffers of the group, behind its named barrier 1 + g, so
// no closing barrier).
struct Group {
  int G, gw, g, r, lane, CH, N;
  double* buf;       // 2 x 4 x CH
  int parity;
  bool active;

  __device__ __forceinline__ Group(int G_, int gw_, int N_, double* rbuf)
      : G(G_), gw(gw_), N(N_), parity(0) {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    CH = (N + 31) / 32;
    g = warp / gw;
    r = warp - g * gw;
    active = g < G;
    buf = rbuf + 8LL * CH * (active ? g : 0);
  }

  template <typename F>
  __device__ __forceinline__ void reduce(F vals, double* out) {
    if (CH == 1) {
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      if (lane < N) vals(lane, s);
      for (int o = 16; o > 0; o >>= 1) {
        s[0] = add(s[0], __shfl_xor_sync(0xffffffffu, s[0], o));
        s[1] = add(s[1], __shfl_xor_sync(0xffffffffu, s[1], o));
        s[2] = add(s[2], __shfl_xor_sync(0xffffffffu, s[2], o));
        s[3] = tmax(s[3], __shfl_xor_sync(0xffffffffu, s[3], o));
      }
      for (int j = 0; j < 4; ++j) out[j] = s[j];
      return;
    }
    double* rb = buf + parity * 4 * CH;
    for (int k = r; k < CH; k += gw) {
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      const int a = 32 * k + lane;
      if (a < N) vals(a, s);
      for (int o = 16; o > 0; o >>= 1) {
        s[0] = add(s[0], __shfl_xor_sync(0xffffffffu, s[0], o));
        s[1] = add(s[1], __shfl_xor_sync(0xffffffffu, s[1], o));
        s[2] = add(s[2], __shfl_xor_sync(0xffffffffu, s[2], o));
        s[3] = tmax(s[3], __shfl_xor_sync(0xffffffffu, s[3], o));
      }
      if (lane == 0)
        for (int j = 0; j < 4; ++j) rb[j * CH + k] = s[j];
    }
    group_sync(1 + g, 32 * gw);
    double s[4];
    for (int j = 0; j < 4; ++j) s[j] = rb[j * CH];
    for (int k = 1; k < CH; ++k) {
      for (int j = 0; j < 3; ++j) s[j] = add(s[j], rb[j * CH + k]);
      s[3] = tmax(s[3], rb[3 * CH + k]);
    }
    for (int j = 0; j < 4; ++j) out[j] = s[j];
    parity ^= 1;
  }

  // f(a) for the image's atoms on this thread (the move)
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    for (int a = 32 * r + lane; a < N; a += 32 * gw) f(a);
  }
  // the group's first thread
  __device__ __forceinline__ bool first() const {
    return r == 0 && lane == 0;
  }
};

// Where a form keeps its arrays (ops/kernels/neb.layout mirrors the
// sizes): shared memory byte offsets (-1: not there) and device memory
// (work) value offsets (-1: not there), and the groups of the band
// algebra
struct Layout {
  long long c, v, f, tg, nbr, ech, e, red, rbuf, ent, t0, atoms, off, src,
      bytes;
  long long w_mirror, w_v, w_f, w_tg, w_ech, w_ent, w_e, w_red, values;
  int G, gw, per;
};

__host__ __forceinline__ long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// form, threads, I, N, the energy chunks K, the terms, entries and
// vectors an image, blocks, whether the large form's arrays and its entry
// arrays and tables sit in shared memory
__host__ Layout make_layout(int form, int threads, int I, int N, int K,
                            long long T, long long E, long long V, int cl,
                            bool shared, bool staged) {
  Layout L;
  const long long n3 = 3LL * N, M = I - 2;
  const int nw = threads / 32, CH = (N + 31) / 32;
  const int per = form == FORM_LONE ? (int)M : (int)((M + cl - 1) / cl);
  L.per = per;
  L.G = per < nw ? per : nw;
  if (L.G > MAX_GROUPS) L.G = MAX_GROUPS;
  if (L.G < 1) L.G = 1;
  L.gw = CH == 1 ? 1 : (nw / L.G < CH ? nw / L.G : CH);
  if (L.gw < 1) L.gw = 1;
  const bool lone = form == FORM_LONE, grid = form == FORM_GRID;
  const bool arrays = lone || (form == FORM_LARGE && shared);
  const bool tables = !grid && arrays && staged;
  long long b = 0;
  auto take = [&](long long values) {
    const long long at = b;
    b += 8 * values;
    return at;
  };
  const long long imgs = lone ? M : per;
  L.c = arrays ? take((lone ? I : per) * n3) : -1;
  L.v = arrays ? take(imgs * n3) : -1;
  L.f = arrays ? take(imgs * n3) : -1;
  L.tg = arrays ? take(imgs * n3) : -1;
  L.nbr = arrays && !lone ? take(2 * n3) : -1;
  L.ech = lone || tables ? take((long long)I * K) : -1;
  L.e = take(I);
  L.red = take(N_RED * M);
  L.rbuf = take(8LL * CH * L.G);
  L.ent = tables ? take(imgs * 3 * V) : -1;
  L.t0 = tables ? take(T) : -1;
  if (tables) {
    b = align16(b);
    L.atoms = b;
    b += 16 * T;
    L.off = b;
    b += 4LL * (N + 1);
    L.src = b;
    b += 4 * E;
  } else {
    L.atoms = L.off = L.src = -1;
  }
  L.bytes = b;
  long long w = 0;
  auto wtake = [&](long long values) {
    const long long at = w;
    w += values;
    return at;
  };
  L.w_mirror = lone ? -1 : wtake(M * n3);
  L.w_v = lone || arrays ? -1 : wtake(M * n3);
  L.w_f = lone || arrays ? -1 : wtake(M * n3);
  L.w_tg = lone || arrays ? -1 : wtake(M * n3);
  L.w_ech = L.ech >= 0 ? -1 : wtake((long long)I * K);
  L.w_ent = tables ? -1 : wtake(M * 3 * V);
  L.w_e = grid ? wtake(I) : -1;
  L.w_red = grid ? wtake(N_RED * M) : -1;
  L.values = w;
  return L;
}

template <typename T>
__device__ __forceinline__ T ld(const T* p, bool l2) {
  return l2 ? __ldcg(p) : *p;
}

// CLUSTER: the large form; GRID: the grid form; neither: the lone form
template <bool CLUSTER, bool GRID>
__global__ void __launch_bounds__(MAX_THREADS)
neb_band_kernel(const double* __restrict__ chain, double* __restrict__ out,
                bool* __restrict__ done_out, int* __restrict__ steps_out,
                double* work, int I, int N, Band<double> t, const ESlots sl,
                const Layout L, int n_steps, double k_spring, double dt0,
                double fmax, int climbing) {
  using T = double;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto sm = [&](long long at) {
    return reinterpret_cast<T*>(smem_raw + at);
  };
  const int tid = threadIdx.x, nt = blockDim.x;
  const int M = I - 2;
  const int n3 = 3 * N;
  const int K = sl.n / 32;
  const long long V3 = 3 * band_vectors(t.nb, t.na, t.np, t.nd);
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
  const int per = L.per;
  const int j0 = min(M, rank * per), j1 = min(M, j0 + per);
  const int m = j1 - j0;
  const bool arrays = L.c >= 0;        // the own images' arrays in smem
  T* mirror = L.w_mirror >= 0 ? work + L.w_mirror : nullptr;
  // the large form's images either side of its own (arrays in shared
  // memory): the owners write them into this block's copy as they move
  T* nbr = L.nbr >= 0 ? sm(L.nbr) : nullptr;
  T* ech = L.ech >= 0 ? sm(L.ech) : work + L.w_ech;
  const bool ech_l2 = L.ech < 0;     // the chunk sums in device memory
  T* e_all = GRID ? work + L.w_e : sm(L.e);
  T* red = GRID ? work + L.w_red : sm(L.red);
  // the own image jl's arrays (lone: jl = j, the interior image)
  auto cown = [&](int jl) -> T* {
    if (!MULTI) return sm(L.c) + (long long)(jl + 1) * n3;
    return arrays ? sm(L.c) + (long long)jl * n3
                  : mirror + (long long)(j0 + jl) * n3;
  };
  auto arr = [&](long long s_at, long long w_at, int jl) -> T* {
    return arrays ? sm(s_at) + (long long)jl * n3
                  : work + w_at + (long long)(j0 + jl) * n3;
  };
  auto vown = [&](int jl) { return arr(L.v, L.w_v, jl); };
  auto fown = [&](int jl) { return arr(L.f, L.w_f, jl); };
  auto tgown = [&](int jl) { return arr(L.tg, L.w_tg, jl); };
  // image i's coordinates for reading, and whether through L2
  auto image = [&](int i) -> const T* {
    if (!MULTI) return sm(L.c) + (long long)i * n3;
    if (i - 1 >= j0 && i - 1 < j1) return cown(i - 1 - j0);
    if (nbr != nullptr && (i == j0 || i == j1 + 1))
      return nbr + (i == j0 ? 0 : n3);
    if (i == 0 || i == I - 1) return chain + (long long)i * n3;
    return mirror + (long long)(i - 1) * n3;
  };
  auto remote = [&](int i) {
    return MULTI && i > 0 && i < I - 1 && !(i - 1 >= j0 && i - 1 < j1) &&
           !(nbr != nullptr && (i == j0 || i == j1 + 1));
  };
  // the own images' coordinates in device memory are read through L2
  const bool own_l2 = MULTI && !arrays;
  // the energies and partial sums as this block reads them: the grid
  // copies the values in device memory into shared memory behind each
  // barrier, so its scalar loops read them there
  const T* e_loc = sm(L.e);
  const T* red_loc = sm(L.red);
  auto e_at = [&](int i) { return e_loc[i]; };
  auto red_at = [&](int q) { return red_loc[q]; };
  auto to_local = [&](const T* from, long long at, int n) {
    if constexpr (GRID) {
      for (int k = tid; k < n; k += nt) sm(at)[k] = __ldcg(from + k);
      __syncthreads();
    }
  };
  // a value into every block's copy of a shared array
  auto put = [&](T* a, int i, T val) {
    if constexpr (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int r = 0; r < cl; ++r) cluster.map_shared_rank(a, r)[i] = val;
    } else {
      a[i] = val;
    }
  };
  // (a cluster barrier releases and acquires at cluster scope, a grid
  // barrier at device scope: the writes to device memory before it are
  // seen by the L2 reads after it)
  auto sync_all = [&]() {
    if constexpr (CLUSTER)
      cg::this_cluster().sync();
    else if constexpr (GRID)
      cg::this_grid().sync();
    else
      __syncthreads();
  };
  Laps laps;
  // set-up: the tables into shared memory (staged), the coordinates,
  // velocities at rest
  if (L.atoms >= 0) {
    const long long nterms = (long long)t.nb + t.na + t.np + t.nd;
    const int E = __ldg(t.off + N);
    int4* atoms = reinterpret_cast<int4*>(smem_raw + L.atoms);
    T* t0 = sm(L.t0);
    int* off = reinterpret_cast<int*>(smem_raw + L.off);
    int* src = reinterpret_cast<int*>(smem_raw + L.src);
    for (long long k = tid; k < nterms; k += nt) {
      atoms[k] = __ldg(t.atoms + k);
      t0[k] = __ldg(t.t0 + k);
    }
    for (int k = tid; k <= N; k += nt) off[k] = __ldg(t.off + k);
    for (int k = tid; k < E; k += nt) src[k] = __ldg(t.src + k);
    t.atoms = atoms;
    t.t0 = t0;
    t.off = off;
    t.src = src;
    t.staged = true;
  } else {
    t.staged = false;
  }
  if (!MULTI) {
    for (long long k = tid; k < (long long)I * n3; k += nt)
      sm(L.c)[k] = chain[k];
  } else {
    for (int jl = 0; jl < m; ++jl)
      for (int k = tid; k < n3; k += nt) {
        const T x = chain[(long long)(j0 + jl + 1) * n3 + k];
        if (arrays) cown(jl)[k] = x;
        mirror[(long long)(j0 + jl) * n3 + k] = x;
      }
  }
  for (int jl = 0; jl < m; ++jl)
    for (int k = tid; k < n3; k += nt) vown(jl)[k] = T(0);
  if (nbr != nullptr)
    for (int k = tid; k < n3; k += nt) {
      nbr[k] = chain[(long long)j0 * n3 + k];
      nbr[n3 + k] = chain[(long long)min(j1 + 1, I - 1) * n3 + k];
    }
  // (a cluster: every block has started before any writes into another's
  // shared memory)
  sync_all();
  // the endpoints' energies
  if (rank == 0) {
    auto ends = [&](int e) { return Coords<false>{image(e ? I - 1 : 0)}; };
    auto rows = [&](int e) { return ech + (long long)(e ? I - 1 : 0) * K; };
    auto none = [&](int) { return (T*)nullptr; };
    if (t.staged)
      term_pass<true>(t, sl, K, 2, tid, nt, ends, rows, none);
    else
      term_pass<false>(t, sl, K, 2, tid, nt, ends, rows, none);
    __syncthreads();
    if (tid < 64) {
      const T* row = rows(tid >= 32);
      const T e = ech_l2 ? warp_energy<true>(row, K)
                         : warp_energy<false>(row, K);
      if ((tid & 31) == 0) put(e_all, tid < 32 ? 0 : I - 1, e);
    }
  }
  sync_all();
  laps.lap(L_SETUP);

  Group grp(L.G, L.gw, N, sm(L.rbuf));
  int steps = 0, n_pos = 0;
  bool done = false;
  T dt = dt0, alpha = T(0.1);
  const T dt_cap = mul(dt0, T(DT_GROW));
  const T kspr = k_spring;
  while (steps < n_steps) {
    // A: the term pass; A2: the atoms' sums; B beside A2: the energies
    if (GRID) {
      // every image's coordinates by plain loads: the grid barrier makes
      // the owners' writes before it visible to the loads after it
      const int gt = rank * nt + tid, gn = cl * nt;
      auto coords_of = [&](int j) {
        return Coords<false>{mirror + (long long)j * n3};
      };
      auto ent_of = [&](int j) { return work + L.w_ent + j * V3; };
      term_pass<false>(t, sl, K, M, gt, gn, coords_of,
                       [&](int j) { return ech + (long long)(j + 1) * K; },
                       ent_of);
      laps.lap(L_TERM);
      sync_all();
      laps.lap(L_SYNC_A);
      atom_sums<false, true>(
          t, N, M, gt, gn, sum_lanes(3LL * M * N, gn), coords_of, ent_of,
          [&](int j) { return work + L.w_f + (long long)j * n3; });
    } else {
      auto ent_of = [&](int jl) -> T* {
        return L.ent >= 0 ? sm(L.ent) + jl * V3
                          : work + L.w_ent + (j0 + jl) * V3;
      };
      auto ech_of = [&](int jl) { return ech + (long long)(j0 + jl + 1) * K; };
      if (t.staged) {
        auto coords_of = [&](int jl) { return Coords<false>{cown(jl)}; };
        term_pass<true>(t, sl, K, m, tid, nt, coords_of, ech_of, ent_of);
        laps.lap(L_TERM);
        __syncthreads();
        laps.lap(L_SYNC_A);
        atom_sums<true, false>(t, N, m, tid, nt, 1, coords_of, ent_of,
                               [&](int jl) { return fown(jl); });
      } else if (own_l2) {
        auto coords_of = [&](int jl) { return Coords<true>{cown(jl)}; };
        term_pass<false>(t, sl, K, m, tid, nt, coords_of, ech_of, ent_of);
        laps.lap(L_TERM);
        __syncthreads();
        laps.lap(L_SYNC_A);
        atom_sums<false, true>(t, N, m, tid, nt, 1, coords_of, ent_of,
                               [&](int jl) { return fown(jl); });
      } else {
        auto coords_of = [&](int jl) { return Coords<false>{cown(jl)}; };
        term_pass<false>(t, sl, K, m, tid, nt, coords_of, ech_of, ent_of);
        laps.lap(L_TERM);
        __syncthreads();
        laps.lap(L_SYNC_A);
        atom_sums<false, true>(t, N, m, tid, nt, 1, coords_of, ent_of,
                               [&](int jl) { return fown(jl); });
      }
    }
    // B: an image's energy a warp, the last warps of the block (of the
    // grid), which hold the fewest atoms' sums
    {
      const int nw = nt >> 5;
      const int w = GRID ? (rank * nt + tid) >> 5 : tid >> 5;
      const int wn = GRID ? cl * nw : nw;
      for (int j = wn - 1 - w; j < (GRID ? M : m); j += wn) {
        const int i = GRID ? j + 1 : j0 + j + 1;
        const T* row = ech + (long long)i * K;
        const T e = ech_l2 ? warp_energy<true>(row, K)
                           : warp_energy<false>(row, K);
        if ((tid & 31) == 0) put(e_all, i, e);
      }
    }
    laps.lap(L_ATOM);
    sync_all();
    laps.lap(L_SYNC_B);
    to_local(e_all, L.e, I);
    // the first highest interior image
    int top = 1;
    for (int i = 2; i < I - 1; ++i)
      if (e_at(i) > e_at(top)) top = i;
    // C: an image a group: tangent, projection, springs, climbing; the
    // image's partial sums of the FIRE update
    for (int jl = grp.g; grp.active && jl < m; jl += grp.G) {
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
      grp.reduce([&](int a, T* q) {
        for (int k = 0; k < 3; ++k) {
          const int x = 3 * a + k;
          const T cx = ld(c + x, own_l2);
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
      const T ks = mul(kspr, sub(ksqrt(s[1]), ksqrt(s[2])));
      grp.reduce([&](int a, T* q) {
        for (int k = 0; k < 3; ++k) {
          const int x = 3 * a + k;
          const T th = quot(tg[x], den);
          tg[x] = th;
          q[0] = add(q[0], mul(ld(f + x, GRID), th));
        }
      }, s);
      const T along = s[0];
      const bool climb = climbing && i == top;
      grp.reduce([&](int a, T* q) {
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
      if (grp.first()) {
        put(red, R_POWER * M + i - 1, s[0]);
        put(red, R_FSQ * M + i - 1, s[1]);
        put(red, R_VSQ * M + i - 1, s[2]);
        put(red, R_FMAX * M + i - 1, s[3]);
      }
    }
    laps.lap(L_C);
    sync_all();
    laps.lap(L_SYNC_C);
    to_local(red, L.red, R_STEP * M);
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
    for (int jl = grp.g; grp.active && jl < m; jl += grp.G) {
      const int i = j0 + jl + 1;
      T* v = vown(jl);
      const T* f = fown(jl);
      T s[4];
      grp.reduce([&](int a, T* q) {
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
      if (grp.first()) put(red, R_STEP * M + i - 1, s[3]);
    }
    dt = dt_new;
    alpha = alpha_new;
    laps.lap(L_D);
    sync_all();
    laps.lap(L_SYNC_D);
    to_local(red + R_STEP * M, L.red + 8LL * R_STEP * M, M);
    // E: the step, capped over the whole band
    T md = T(0);
    for (int j = 0; j < M; ++j) md = tmax(md, red_at(R_STEP * M + j));
    const T scale = tmin(quot(T(STEP_CAP), tmax(ksqrt(md), T(FLOOR))), T(1));
    for (int jl = grp.g; grp.active && jl < m; jl += grp.G) {
      T* c = cown(jl);
      T* v = vown(jl);
      grp.each([&](int a) {
        for (int k = 0; k < 3; ++k) {
          const int x = 3 * a + k;
          const T stepped = v[x];
          const T nx = add(ld(c + x, own_l2), mul(mul(dt, stepped), scale));
          c[x] = nx;
          if (nbr != nullptr) {
            // the neighbouring blocks' copies of this block's end images
            cg::cluster_group cluster = cg::this_cluster();
            if (jl == m - 1 && j0 + jl + 1 < M)
              cluster.map_shared_rank(nbr, rank + 1)[x] = nx;
            if (jl == 0 && j0 >= 1)
              cluster.map_shared_rank(nbr, rank - 1)[n3 + x] = nx;
          }
          v[x] = mul(stepped, scale);
        }
      });
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
      out[(long long)(j0 + jl + 1) * n3 + k] = ld(cown(jl) + k, own_l2);
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

const void* form_kernel(int form) {
  return form == FORM_GRID    ? (const void*)neb_band_kernel<false, true>
         : form == FORM_LARGE ? (const void*)neb_band_kernel<true, false>
                              : (const void*)neb_band_kernel<false, false>;
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

// the plan's layout for a band of I images of N atoms under term counts
// nb, na, np, nd and E incidence entries
Layout plan_layout(const long long* plan, int I, int N, int nb, int na,
                   int np, int nd, long long E) {
  const long long T = (long long)nb + na + np + nd;
  return make_layout((int)plan[P_FORM], (int)plan[P_THREADS], I, N,
                     (int)(plan[P_SLOTS] / 32), T, E,
                     band_vectors(nb, na, np, nd), (int)plan[P_CLUSTER],
                     plan[P_SHARED] != 0, plan[P_STAGED] != 0);
}

int launch(const void* chain, void* out, void* done, void* steps,
           void* work, long long work_values, int I, int N,
           const long long* plan, int nb, int na, int np, int nd,
           double bond_k, const void* atoms, const void* t0,
           const void* inc_off, const void* src, long long E,
           const void* springs, const void* spring_t, long long ns,
           const void* k_s, const void* half, long long nh, const void* k_h,
           int n_steps, double k_spring, double dt0, double fmax,
           int climbing, void* stream) {
  const int form = (int)plan[P_FORM], threads = (int)plan[P_THREADS];
  const int cl = (int)plan[P_CLUSTER];
  const long long smem = plan[P_SMEM];
  ESlots sl;
  sl.n = (int)plan[P_SLOTS];
  for (int k = 0; k < KINDS; ++k) sl.lo[k] = (int)plan[P_LO0 + k];
  if ((form != FORM_LONE && form != FORM_LARGE && form != FORM_GRID) ||
      threads <= 0 || threads % 32 || threads > MAX_THREADS || I < 3 ||
      N <= 0 || sl.n % 32 || cl < 1 ||
      (form == FORM_LONE && cl != 1) ||
      (form == FORM_LARGE && (cl > MAX_CLUSTER || cl > I - 2)))
    return (int)cudaErrorInvalidValue;
  const Layout L = plan_layout(plan, I, N, nb, na, np, nd, E);
  if (smem != L.bytes || work_values != L.values ||
      (L.values > 0) != (work != nullptr))
    return (int)cudaErrorInvalidValue;
  const int id = form;
  const void* fn = form_kernel(form);
  int err = opt_in_smem(fn, id, smem);
  if (err) return err;
  if (form == FORM_GRID) {
    // every block of a grid barrier must be resident: refuse, never hang
    int most = 0;
    err = resident_blocks(fn, threads, smem, &most);
    if (err) return err;
    if (cl > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  Band<double> t;
  t.nb = nb;
  t.na = na;
  t.np = np;
  t.nd = nd;
  t.bond_k = bond_k;
  t.atoms = static_cast<const int4*>(atoms);
  t.t0 = static_cast<const double*>(t0);
  t.off = static_cast<const int*>(inc_off);
  t.src = static_cast<const int*>(src);
  t.staged = false;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cl, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (form == FORM_GRID) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = form == FORM_LARGE ? cl : 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = form == FORM_LONE ? 0 : 1;
  if (form == FORM_GRID)
    err = (int)cudaLaunchKernelEx(&cfg, neb_band_kernel<false, true>, c, o,
                                  d, s, wk, I, N, t, sl, L, n_steps,
                                  k_spring, dt0, fmax, climbing);
  else if (form == FORM_LARGE)
    err = (int)cudaLaunchKernelEx(&cfg, neb_band_kernel<true, false>, c, o,
                                  d, s, wk, I, N, t, sl, L, n_steps,
                                  k_spring, dt0, fmax, climbing);
  else
    err = (int)cudaLaunchKernelEx(&cfg, neb_band_kernel<false, false>, c, o,
                                  d, s, wk, I, N, t, sl, L, n_steps,
                                  k_spring, dt0, fmax, climbing);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int neb_band_f64(const void* chain, void* out, void* done, void* steps,
                 void* work, long long work_values, int I, int N,
                 const long long* plan, int nb, int na, int np, int nd,
                 double bond_k, const void* atoms, const void* t0,
                 const void* inc_off, const void* src, long long E,
                 const void* springs, const void* spring_t, long long ns,
                 const void* k_s, const void* half, long long nh,
                 const void* k_h, int n_steps, double k_spring, double dt0,
                 double fmax, int climbing, void* stream) {
  return launch(chain, out, done, steps, work, work_values, I, N, plan, nb,
                na, np, nd, bond_k, atoms, t0, inc_off, src, E, springs,
                spring_t, ns, k_s, half, nh, k_h, n_steps, k_spring, dt0,
                fmax, climbing, stream);
}

// out: the shared bytes and device-memory values of the plan's layout
// for a band of I images of N atoms under these term counts and E
// incidence entries (ops/kernels/neb.layout computes the same)
int neb_layout(const long long* plan, int I, int N, int nb, int na, int np,
               int nd, long long E, long long* out) {
  const Layout L = plan_layout(plan, I, N, nb, na, np, nd, E);
  out[0] = L.bytes;
  out[1] = L.values;
  out[2] = L.G;
  out[3] = L.gw;
  return 0;
}

// out: registers a thread, local (spilled) bytes a thread, resident
// blocks an SM of the plan's kernel at its threads and shared bytes
int neb_info(const long long* plan, int* out) {
  const int form = (int)plan[P_FORM];
  if (form < FORM_LONE || form > FORM_GRID) return (int)cudaErrorInvalidValue;
  const void* fn = form_kernel(form);
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, fn);
  if (err) return err;
  err = opt_in_smem(fn, form, plan[P_SMEM]);
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
