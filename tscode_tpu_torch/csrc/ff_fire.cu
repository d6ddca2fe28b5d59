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
// Here one thread block relaxes one structure for all its steps:
//   - its coordinates, velocities, forces and stepped velocities live in
//     dynamic shared memory (4 x 3N values); the FIRE controls (dt,
//     alpha, steps since the last uphill one, done) in registers, the
//     same in every thread, since every thread derives them from the
//     same block reductions;
//   - the analytic force on an atom is summed from zero in a fixed
//     order: the force-field terms of the atom's incidence list (CSR
//     built on the device once per topology, ff.incidence: code = 4 term
//     + role, terms numbered bonds, angles, repulsion pairs, E/Z
//     dihedrals), then the springs, then the half-springs. Staged form
//     (the rule): a thread a term computes the term once and writes its
//     forces on its 2 to 4 atoms to those atoms' incidence entries in
//     shared memory (positions ff.incidence gives); after a barrier a
//     thread an atom sums its entries in order. Per-atom form (tables
//     whose entries do not fit in shared memory beside the structure,
//     ~9,600 entries in f64): a thread an atom computes each of its
//     terms itself. Both sum the same values in the same order. No
//     atomics: the same inputs give the same bits on every run;
//   - a step is fire_step's arithmetic (optimizers.py): the power and
//     the two norms as one fixed-order block reduction (warp butterflies,
//     then the warps in order), the uphill / grow / dt / alpha rules, the
//     semi-implicit Euler step, the 0.2 A cap on the largest atomic
//     displacement (a second reduction; the velocity is rescaled too);
//     frozen atoms get no force; a structure whose largest atomic force
//     is under fmax stops with its coordinates as they are, and its
//     block leaves the loop (fire_minimize_batch returns only the
//     coordinates, the energies and the flags, which the JAX scan's
//     masked steps leave as they are).
// Three block barriers a step (the coordinates written, one in each
// reduction), four staged (the entries written).
//
// Bound. A batch is bound by operations: each step of each structure
// evaluates every term (a pair term ~20 flops, an angle ~60, a dihedral
// ~110, with acos / atan2 / sin / cos; the per-atom form once per atom
// of the term) and ~60 flops of update an atom; the tables (a few KB)
// stay in L1/L2 and the coordinates are read and written once. The work
// follows the data: the steps each structure takes before it stops
// (returned per structure). One structure (a bend, a scan point) is
// bound by latency: a chain of dependent steps in one block on one SM.
// The per-atom form's step is the longest atom's terms in sequence; the
// staged form cuts it to one term's latency per round of blockDim.x
// terms, the longest atom's sum of shared-memory entries and the
// barriers: 4.6 against 17 us a step at 15 atoms in f64, and 4.5
// against 16.9 ms on 24,417 such structures (chip_smoke.py phase 13,
// NVIDIA H100 80GB HBM3, 700 W). The design does not try to fill the
// card with one structure. Tensor cores and TMA are not used.
//
// Blocks of whole warps, up to 256 threads (ops/kernels/ff_fire.
// launch_plan: one a term or an atom, whichever is more, staged; one an
// atom otherwise); a thread walks several where there are more; the
// others only join the reductions. Entries ff_fire_f32 / ff_fire_f64
// return the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_WARPS = 8;           // ff_fire.MAX_THREADS / 32
constexpr int N_MIN = 5;
constexpr double ALPHA0 = 0.1;
constexpr double F_INC = 1.1;
constexpr double F_DEC = 0.5;
constexpr double F_ALPHA = 0.99;
constexpr double DT_MAX_FACTOR = 10.0;
constexpr double MAX_DISP = 0.2;
constexpr double FLOOR = 1e-12;
constexpr double COS_CLIP = 1.0 - 1e-9;
constexpr double K_ANGLE = 30.0;
constexpr double K_REP = 50.0;
constexpr double K_DIH = 30.0;
constexpr double HALF_ONSET = 2.5;
constexpr long long STATIC_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;

template <typename T>
struct Terms {
  const long long* bonds;
  const T* bond_r0;
  long long nb;
  T bond_k;
  const long long* angles;
  const T* angle_t0;
  long long na;
  const long long* pairs;
  const T* pair_r0;
  long long np;
  const long long* dih;
  const T* dih_t0;
  long long nd;
  const int* inc_off;
  const int* inc_code;
  const int* inc_pos;
  const long long* springs;
  const T* spring_t;
  long long ns;
  const T* k_s;
  const long long* half;
  long long nh;
  const T* k_h;
};

enum PairKind { BOND, REPULSION, SPRING, HALF };

__device__ __forceinline__ double my_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float my_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double my_acos(double x) { return acos(x); }
__device__ __forceinline__ float my_acos(float x) { return acosf(x); }
__device__ __forceinline__ double my_atan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float my_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double my_sin(double x) { return sin(x); }
__device__ __forceinline__ float my_sin(float x) { return sinf(x); }
__device__ __forceinline__ double my_cos(double x) { return cos(x); }
__device__ __forceinline__ float my_cos(float x) { return cosf(x); }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

// the forces of a pair term with dE/dd = g(d) on its two atoms:
// out[0] = -g/d (x_i - x_j), out[1] = +g/d (x_i - x_j)
template <typename T>
__device__ __forceinline__ void pair_forces(const T* c, long long i,
                                            long long j, PairKind kind, T p,
                                            T k, T (*out)[3]) {
  const T dx = c[3 * i] - c[3 * j];
  const T dy = c[3 * i + 1] - c[3 * j + 1];
  const T dz = c[3 * i + 2] - c[3 * j + 2];
  const T d = my_sqrt(dx * dx + dy * dy + dz * dz);
  T g;
  if (kind == REPULSION) {
    const T o = p - d;
    g = o > T(0) ? -(T(2) * k) * o : T(0);
  } else if (kind == HALF) {
    const T x = d - p;
    g = x > T(0) ? (T(2) * k) * x : T(0);
  } else {
    g = (T(2) * k) * (d - p);
  }
  const T coef = d > T(0) ? g / d : T(0);
  const T s = -coef;
  out[0][0] = s * dx;
  out[0][1] = s * dy;
  out[0][2] = s * dz;
  out[1][0] = coef * dx;
  out[1][1] = coef * dy;
  out[1][2] = coef * dz;
}

// K_ANGLE (acos(cos) - t0)^2 on (i, j, k), j central, forces in the
// order i, j, k; no force outside the cosine's clip, the norm product
// floored at 1e-12 (ff_energy)
template <typename T>
__device__ __forceinline__ void angle_forces(const T* c, const long long* q,
                                             T t0, T (*out)[3]) {
  const long long i = q[0], j = q[1], k = q[2];
  T v1[3], v2[3];
  for (int x = 0; x < 3; ++x) {
    v1[x] = c[3 * i + x] - c[3 * j + x];
    v2[x] = c[3 * k + x] - c[3 * j + x];
  }
  const T n1sq = v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2];
  const T n2sq = v2[0] * v2[0] + v2[1] * v2[1] + v2[2] * v2[2];
  T den = my_sqrt(n1sq) * my_sqrt(n2sq);
  const bool floored = den < T(FLOOR);
  den = tmax(den, T(FLOOR));
  const T cs = (v1[0] * v2[0] + v1[1] * v2[1] + v1[2] * v2[2]) / den;
  const bool outside = cs < -T(COS_CLIP) || cs > T(COS_CLIP);
  const T g = outside ? T(0)
                      : (T(2) * T(K_ANGLE)) * (my_acos(cs) - t0) *
                            (T(-1) / my_sqrt(T(1) - cs * cs));
  for (int x = 0; x < 3; ++x) {
    const T dc1 = floored ? v2[x] / den : v2[x] / den - cs * v1[x] / n1sq;
    const T dc2 = floored ? v1[x] / den : v1[x] / den - cs * v2[x] / n2sq;
    const T fi = -g * dc1, fk = -g * dc2;
    out[0][x] = fi;
    out[1][x] = -(fi + fk);
    out[2][x] = fk;
  }
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// K_DIH wrap(phi - t0)^2 on (p0, p1, p2, p3): phi as ff_energy takes it,
// its gradient in Bekker's closed form (d wrap / d phi = 1); no force
// from a quadruplet with a collinear end
template <typename T>
__device__ __forceinline__ void dihedral_forces(const T* c,
                                                const long long* q, T t0,
                                                T (*out)[3]) {
  T b0[3], b1[3], b2[3];
  for (int x = 0; x < 3; ++x) {
    b0[x] = c[3 * q[0] + x] - c[3 * q[1] + x];
    b1[x] = c[3 * q[2] + x] - c[3 * q[1] + x];
    b2[x] = c[3 * q[3] + x] - c[3 * q[2] + x];
  }
  T m[3], n[3];
  cross(b0, b1, m);
  cross(b2, b1, n);
  const T mm = dot3(m, m), nn = dot3(n, n);
  if (!(mm > T(0)) || !(nn > T(0))) {
    for (int r = 0; r < 4; ++r) out[r][0] = out[r][1] = out[r][2] = T(0);
    return;
  }
  const T nb1 = my_sqrt(dot3(b1, b1));
  const T nb1c = tmax(nb1, T(FLOOR));
  T b1n[3], v[3], w[3], bv[3];
  for (int x = 0; x < 3; ++x) b1n[x] = b1[x] / nb1c;
  const T s0 = dot3(b0, b1n), s2 = dot3(b2, b1n);
  for (int x = 0; x < 3; ++x) {
    v[x] = b0[x] - s0 * b1n[x];
    w[x] = b2[x] - s2 * b1n[x];
  }
  cross(b1n, v, bv);
  const T phi = my_atan2(dot3(bv, w), dot3(v, w));
  const T u = phi - t0;
  const T g = (T(2) * T(K_DIH)) * my_atan2(my_sin(u), my_cos(u));
  const T nb1sq = nb1 * nb1;
  const T a = dot3(b0, b1) / nb1sq;
  const T cc = -dot3(b2, b1) / nb1sq;
  for (int x = 0; x < 3; ++x) {
    const T d0 = nb1 / mm * m[x];
    const T d3 = -nb1 / nn * n[x];
    out[0][x] = -g * d0;
    out[1][x] = -g * ((a - T(1)) * d0 - cc * d3);
    out[2][x] = -g * ((cc - T(1)) * d3 - a * d0);
    out[3][x] = -g * d3;
  }
}

// the forces of force-field term `term` (numbered as in ff.incidence) on
// its atoms, in role order; returns the number of atoms
template <typename T>
__device__ __forceinline__ int term_forces(const T* c, long long term,
                                           const Terms<T>& t, T (*out)[3]) {
  const long long ang0 = t.nb, rep0 = ang0 + t.na, dih0 = rep0 + t.np;
  if (term < ang0) {
    pair_forces(c, __ldg(t.bonds + 2 * term), __ldg(t.bonds + 2 * term + 1),
                BOND, __ldg(t.bond_r0 + term), t.bond_k, out);
    return 2;
  }
  if (term < rep0) {
    const long long r = term - ang0;
    const long long q[3] = {__ldg(t.angles + 3 * r),
                            __ldg(t.angles + 3 * r + 1),
                            __ldg(t.angles + 3 * r + 2)};
    angle_forces(c, q, __ldg(t.angle_t0 + r), out);
    return 3;
  }
  if (term < dih0) {
    const long long r = term - rep0;
    pair_forces(c, __ldg(t.pairs + 2 * r), __ldg(t.pairs + 2 * r + 1),
                REPULSION, __ldg(t.pair_r0 + r), T(K_REP), out);
    return 2;
  }
  const long long r = term - dih0;
  const long long q[4] = {__ldg(t.dih + 4 * r), __ldg(t.dih + 4 * r + 1),
                          __ldg(t.dih + 4 * r + 2), __ldg(t.dih + 4 * r + 3)};
  dihedral_forces(c, q, __ldg(t.dih_t0 + r), out);
  return 4;
}

// the springs' and the half-springs' forces on atom a, added to f in
// order
template <typename T>
__device__ __forceinline__ void add_springs(const T* c, int a,
                                            const Terms<T>& t, T* f) {
  T out[2][3];
  if (t.ns) {
    const T k = *t.k_s;
    for (long long s = 0; s < t.ns; ++s) {
      const long long i = __ldg(t.springs + 2 * s);
      const long long j = __ldg(t.springs + 2 * s + 1);
      if (i != a && j != a) continue;
      pair_forces(c, i, j, SPRING, __ldg(t.spring_t + s), k, out);
      for (int r = 0; r < 2; ++r)
        if ((r ? j : i) == a)
          for (int x = 0; x < 3; ++x) f[x] += out[r][x];
    }
  }
  if (t.nh) {
    const T k = *t.k_h;
    for (long long s = 0; s < t.nh; ++s) {
      const long long i = __ldg(t.half + 2 * s);
      const long long j = __ldg(t.half + 2 * s + 1);
      if (i != a && j != a) continue;
      pair_forces(c, i, j, HALF, T(HALF_ONSET), k, out);
      for (int r = 0; r < 2; ++r)
        if ((r ? j : i) == a)
          for (int x = 0; x < 3; ++x) f[x] += out[r][x];
    }
  }
}

// the force on atom a, summed from zero in the fixed order, each term
// computed here (the per-atom form, for tables too large to stage)
template <typename T>
__device__ void atom_force(const T* c, int a, const Terms<T>& t, T* f) {
  f[0] = f[1] = f[2] = T(0);
  const int lo = __ldg(t.inc_off + a), hi = __ldg(t.inc_off + a + 1);
  T out[4][3];
  for (int e = lo; e < hi; ++e) {
    const int code = __ldg(t.inc_code + e);
    term_forces(c, code >> 2, t, out);
    for (int x = 0; x < 3; ++x) f[x] += out[code & 3][x];
  }
  add_springs(c, a, t, f);
}

// the force on atom a from the staged term forces (contrib, in CSR
// order), summed from zero in the same fixed order as atom_force
template <typename T>
__device__ void atom_force_staged(const T* c, int a, const Terms<T>& t,
                                  const T* contrib, T* f) {
  f[0] = f[1] = f[2] = T(0);
  const int lo = __ldg(t.inc_off + a), hi = __ldg(t.inc_off + a + 1);
  for (int e = lo; e < hi; ++e)
    for (int x = 0; x < 3; ++x) f[x] += contrib[3 * e + x];
  add_springs(c, a, t, f);
}

// sums of s0..s2 and the max of m3 over the block, the same bits in
// every thread: a butterfly in each warp, then the warps in order
template <typename T>
__device__ __forceinline__ void block_reduce(T& s0, T& s1, T& s2, T& m3,
                                             T (*buf)[MAX_WARPS]) {
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    m3 = tmax(m3, __shfl_xor_sync(0xffffffffu, m3, o));
  }
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    buf[0][w] = s0;
    buf[1][w] = s1;
    buf[2][w] = s2;
    buf[3][w] = m3;
  }
  __syncthreads();
  s0 = buf[0][0];
  s1 = buf[1][0];
  s2 = buf[2][0];
  m3 = buf[3][0];
  for (int k = 1; k < nw; ++k) {
    s0 += buf[0][k];
    s1 += buf[1][k];
    s2 += buf[2][k];
    m3 = tmax(m3, buf[3][k]);
  }
}

template <typename T>
__device__ __forceinline__ T block_max(T m, T* buf) {
  for (int o = 16; o > 0; o >>= 1)
    m = tmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = m;
  __syncthreads();
  m = buf[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k) m = tmax(m, buf[k]);
  return m;
}

template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
ff_fire_kernel(const T* __restrict__ coords, T* __restrict__ out,
               bool* __restrict__ done_out, int* __restrict__ steps_out,
               int N, const Terms<T> t,
               const unsigned char* __restrict__ freeze,
               long long freeze_stride, int n_steps, double dt0,
               double fmax, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[4][MAX_WARPS];
  __shared__ T red_disp[MAX_WARPS];
  T* c = reinterpret_cast<T*>(smem_raw);
  T* v = c + 3 * N;
  T* f = v + 3 * N;
  T* vs = f + 3 * N;
  T* contrib = vs + 3 * N;        // staged: each incidence entry's force
  const long long n_terms = t.nb + t.na + t.np + t.nd;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* cin = coords + b * 3 * N;
  for (int k = tid; k < 3 * N; k += nt) {
    c[k] = cin[k];
    v[k] = T(0);
  }
  const unsigned char* fr = freeze ? freeze + b * freeze_stride : nullptr;
  T dt = T(dt0), alpha = T(ALPHA0);
  const T dt_max = T(dt0 * DT_MAX_FACTOR), fmax_t = T(fmax);
  int n_pos = 0, steps = 0;
  bool done = false;
  __syncthreads();
  for (int step = 0; step < n_steps; ++step) {
    if (staged) {
      // each term once, by a thread of its own, its forces written to
      // the incidence entries of its atoms
      for (long long term = tid; term < n_terms; term += nt) {
        T o[4][3];
        const int w = term_forces(c, term, t, o);
        for (int r = 0; r < w; ++r) {
          const int e = __ldg(t.inc_pos + 4 * term + r);
          for (int x = 0; x < 3; ++x) contrib[3 * e + x] = o[r][x];
        }
      }
      __syncthreads();
    }
    T power = T(0), ff = T(0), vv = T(0), fm = T(0);
    for (int a = tid; a < N; a += nt) {
      T fa[3] = {T(0), T(0), T(0)};
      if (!(fr && fr[a])) {
        if (staged)
          atom_force_staged(c, a, t, contrib, fa);
        else
          atom_force(c, a, t, fa);
      }
      for (int x = 0; x < 3; ++x) f[3 * a + x] = fa[x];
      const T* va = v + 3 * a;
      power += fa[0] * va[0] + fa[1] * va[1] + fa[2] * va[2];
      ff += fa[0] * fa[0] + fa[1] * fa[1] + fa[2] * fa[2];
      vv += va[0] * va[0] + va[1] * va[1] + va[2] * va[2];
      fm = tmax(fm, fa[0] * fa[0] + fa[1] * fa[1] + fa[2] * fa[2]);
    }
    block_reduce(power, ff, vv, fm, red);
    ++steps;
    if (my_sqrt(fm) < fmax_t) {       // stopped: coordinates as they are
      done = true;
      break;
    }
    const T f_norm = my_sqrt(ff), v_norm = my_sqrt(vv);
    const bool uphill = power <= T(0);
    const int n_pos_new = uphill ? 0 : n_pos + 1;
    const bool grow = n_pos_new > N_MIN;
    const T dt_new = uphill ? dt * T(F_DEC)
                            : (grow ? tmin(dt * T(F_INC), dt_max) : dt);
    const T alpha_new = uphill ? T(ALPHA0) : (grow ? alpha * T(F_ALPHA)
                                                   : alpha);
    const T f_den = tmax(f_norm, T(FLOOR));
    T md = T(0);
    for (int a = tid; a < N; a += nt) {
      T sq = T(0);
      for (int x = 0; x < 3; ++x) {
        const int k = 3 * a + x;
        const T mixed = (T(1) - alpha) * v[k] + alpha * f[k] * v_norm / f_den;
        const T vk = (uphill ? T(0) : mixed) + dt_new * f[k];
        vs[k] = vk;
        const T st = dt_new * vk;
        sq += st * st;
      }
      md = tmax(md, sq);
    }
    const T max_disp = my_sqrt(block_max(md, red_disp));
    const T scale = tmin(T(MAX_DISP) / tmax(max_disp, T(FLOOR)), T(1));
    for (int a = tid; a < N; a += nt) {
      for (int x = 0; x < 3; ++x) {
        const int k = 3 * a + x;
        c[k] = c[k] + (dt_new * vs[k]) * scale;
        v[k] = vs[k] * scale;
      }
    }
    dt = dt_new;
    alpha = alpha_new;
    n_pos = n_pos_new;
    __syncthreads();
  }
  __syncthreads();
  T* o = out + b * 3 * N;
  for (int k = tid; k < 3 * N; k += nt) o[k] = c[k];
  if (tid == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
}

// raise the kernel's dynamic shared memory limit past 48 KB on the
// current card, once per (type, card, larger size)
template <typename T>
int opt_in_smem(long long bytes) {
  static long long done[MAX_DEVICES] = {0};
  if (bytes <= STATIC_SMEM) return 0;
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return 0;
  err = (int)cudaFuncSetAttribute(ff_fire_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes);
  if (!err) done[dev] = bytes;
  return err;
}

template <typename T>
int launch(const void* coords, void* out, void* done, void* steps,
           long long B, int N, const void* bonds, const void* bond_r0,
           long long nb, T bond_k, const void* angles, const void* angle_t0,
           long long na, const void* pairs, const void* pair_r0,
           long long np, const void* dih, const void* dih_t0, long long nd,
           const void* inc_off, const void* inc_code, const void* inc_pos,
           const void* springs, const void* spring_t, long long ns,
           const void* k_s, const void* half, long long nh, const void* k_h,
           const void* freeze, long long freeze_stride, int n_steps,
           double dt0, double fmax, int staged, int threads, long long smem,
           void* stream) {
  if (B <= 0) return 0;
  if (threads <= 0 || threads > MAX_WARPS * 32 || threads % 32)
    return (int)cudaErrorInvalidValue;
  int err = opt_in_smem<T>(smem);
  if (err) return err;
  Terms<T> t;
  t.bonds = static_cast<const long long*>(bonds);
  t.bond_r0 = static_cast<const T*>(bond_r0);
  t.nb = nb;
  t.bond_k = bond_k;
  t.angles = static_cast<const long long*>(angles);
  t.angle_t0 = static_cast<const T*>(angle_t0);
  t.na = na;
  t.pairs = static_cast<const long long*>(pairs);
  t.pair_r0 = static_cast<const T*>(pair_r0);
  t.np = np;
  t.dih = static_cast<const long long*>(dih);
  t.dih_t0 = static_cast<const T*>(dih_t0);
  t.nd = nd;
  t.inc_off = static_cast<const int*>(inc_off);
  t.inc_code = static_cast<const int*>(inc_code);
  t.inc_pos = static_cast<const int*>(inc_pos);
  t.springs = static_cast<const long long*>(springs);
  t.spring_t = static_cast<const T*>(spring_t);
  t.ns = ns;
  t.k_s = static_cast<const T*>(k_s);
  t.half = static_cast<const long long*>(half);
  t.nh = nh;
  t.k_h = static_cast<const T*>(k_h);
  ff_fire_kernel<T><<<(unsigned)B, threads, (size_t)smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coords), static_cast<T*>(out),
      static_cast<bool*>(done), static_cast<int*>(steps), N, t,
      static_cast<const unsigned char*>(freeze), freeze_stride, n_steps,
      dt0, fmax, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define FF_FIRE_ENTRY(NAME, T)                                              \
  int NAME(const void* coords, void* out, void* done, void* steps,         \
           long long B, int N, const void* bonds, const void* bond_r0,     \
           long long nb, T bond_k, const void* angles,                     \
           const void* angle_t0, long long na, const void* pairs,          \
           const void* pair_r0, long long np, const void* dih,             \
           const void* dih_t0, long long nd, const void* inc_off,          \
           const void* inc_code, const void* inc_pos, const void* springs, \
           const void* spring_t, long long ns, const void* k_s,            \
           const void* half, long long nh, const void* k_h,                \
           const void* freeze, long long freeze_stride, int n_steps,       \
           double dt0, double fmax, int staged, int threads,               \
           long long smem, void* stream) {                                 \
    return launch<T>(coords, out, done, steps, B, N, bonds, bond_r0, nb,   \
                     bond_k, angles, angle_t0, na, pairs, pair_r0, np,     \
                     dih, dih_t0, nd, inc_off, inc_code, inc_pos, springs, \
                     spring_t, ns, k_s, half, nh, k_h, freeze,             \
                     freeze_stride, n_steps, dt0, fmax, staged, threads,   \
                     smem, stream);                                        \
  }

FF_FIRE_ENTRY(ff_fire_f32, float)
FF_FIRE_ENTRY(ff_fire_f64, double)

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
