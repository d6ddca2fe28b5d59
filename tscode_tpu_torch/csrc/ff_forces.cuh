// The internal force field's analytic forces, and its term energies, as
// device functions: ff_energy's bonds, angles, repulsion pairs and E/Z
// dihedrals (tscode_tpu_torch/ff.py), and the springs and half-springs
// of ff.FireTerms.
//
// They hold no layout of their own. A caller hands them a term as a
// TermRec (its kind, its atoms as int32, its reference value) and the
// atoms' positions through a coordinate accessor (c(a, x) is
// coordinate x of atom a: SmemCoords, GlobalCoords below, or the
// caller's own). So the forms of the FIRE kernel (ff_fire.cu), the
// dimer kernel (dimer.cu) and any later kernel that evaluates the force
// field on the card include the same arithmetic (the NEB band kernel,
// neb_band.cu, also its energies). Each norm takes one reciprocal square
// root, multiplied into its components, where ff_energy's gradient
// takes a square root and divides each component.
//
// The force on an atom is summed from zero in one fixed order: its
// terms in ff.incidence order (term, then role), then the springs, then
// the half-springs. atom_force computes each term itself;
// atom_force_staged adds the forces that other threads computed and
// wrote to the atom's incidence entries. Both add the same values in
// the same order, and so does a caller that walks the terms in order
// and adds each term's forces to its atoms.

#pragma once

#include <cuda_runtime.h>

namespace ffk {

constexpr double FLOOR = 1e-12;
constexpr double COS_CLIP = 1.0 - 1e-9;
constexpr double K_ANGLE = 30.0;
constexpr double K_REP = 50.0;
constexpr double K_DIH = 30.0;
constexpr double HALF_ONSET = 2.5;

// term kinds, in the order ff.incidence numbers the terms
enum Kind : int { BOND = 0, ANGLE = 1, REPULSION = 2, DIHEDRAL = 3 };
// the energy of a pair term: harmonic, repulsive below its onset,
// harmonic above its onset
enum PairForm : int { HARMONIC = 0, BELOW = 1, ABOVE = 2 };

__device__ __forceinline__ double ksqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float ksqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double krsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float krsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double kacos(double x) { return acos(x); }
__device__ __forceinline__ float kacos(float x) { return acosf(x); }
__device__ __forceinline__ double katan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float katan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ void ksincos(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ void ksincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

template <typename T>
struct TermRec {
  int kind;     // Kind
  int a[4];     // its atoms in role order; roles it lacks hold atom 0
  T t0;         // bond length, repulsion onset, reference angle
};

// coordinates of one structure, (N, 3) row-major in shared memory
template <typename T>
struct SmemCoords {
  const T* p;
  __device__ __forceinline__ T operator()(int a, int x) const {
    return p[3 * a + x];
  }
};

// coordinates in device memory that other blocks write between
// cluster barriers: read through L2, never a stale L1 line
template <typename T>
struct GlobalCoords {
  const T* p;
  __device__ __forceinline__ T operator()(int a, int x) const {
    return __ldcg(p + 3 * a + x);
  }
};

template <typename T, typename C>
__device__ __forceinline__ void position(const C& c, int a, T* out) {
  out[0] = c(a, 0);
  out[1] = c(a, 1);
  out[2] = c(a, 2);
}

// the forces of a pair term with dE/dd = g(d) on its two atoms:
// out[0] = -g/d (x_i - x_j), out[1] = +g/d (x_i - x_j)
template <typename T>
__device__ __forceinline__ void pair_forces(const T* xi, const T* xj,
                                            int form, T p, T k,
                                            T (*out)[3]) {
  const T dx = xi[0] - xj[0];
  const T dy = xi[1] - xj[1];
  const T dz = xi[2] - xj[2];
  const T d2 = dx * dx + dy * dy + dz * dz;
  const T inv = d2 > T(0) ? krsqrt(d2) : T(0);    // 1 / d, 0 at d = 0
  const T d = d2 * inv;
  T g;
  if (form == BELOW) {
    const T o = p - d;
    g = o > T(0) ? -(T(2) * k) * o : T(0);
  } else if (form == ABOVE) {
    const T x = d - p;
    g = x > T(0) ? (T(2) * k) * x : T(0);
  } else {
    g = (T(2) * k) * (d - p);
  }
  const T coef = g * inv;
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
__device__ __forceinline__ void angle_forces(const T* xi, const T* xj,
                                             const T* xk, T t0,
                                             T (*out)[3]) {
  T v1[3], v2[3];
  for (int x = 0; x < 3; ++x) {
    v1[x] = xi[x] - xj[x];
    v2[x] = xk[x] - xj[x];
  }
  const T n1sq = v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2];
  const T n2sq = v2[0] * v2[0] + v2[1] * v2[1] + v2[2] * v2[2];
  // 1 / |v1|, 1 / |v2| and 1 / max(|v1| |v2|, 1e-12)
  const T i1 = krsqrt(n1sq), i2 = krsqrt(n2sq);
  const bool floored = !(i1 * i2 < T(1) / T(FLOOR));
  const T rden = floored ? T(1) / T(FLOOR) : i1 * i2;
  const T cs = (v1[0] * v2[0] + v1[1] * v2[1] + v1[2] * v2[2]) * rden;
  const bool outside = cs < -T(COS_CLIP) || cs > T(COS_CLIP);
  const T g = outside ? T(0)
                      : (T(2) * T(K_ANGLE)) * (kacos(cs) - t0) *
                            -krsqrt(T(1) - cs * cs);
  // floored: ff_energy's cosine has no n^-2 terms (and n may be 0)
  const T r1 = floored ? T(0) : i1 * i1;
  const T r2 = floored ? T(0) : i2 * i2;
  for (int x = 0; x < 3; ++x) {
    const T dc1 = v2[x] * rden - cs * v1[x] * r1;
    const T dc2 = v1[x] * rden - cs * v2[x] * r2;
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
__device__ __forceinline__ void dihedral_forces(const T* p0, const T* p1,
                                                const T* p2, const T* p3,
                                                T t0, T (*out)[3]) {
  T b0[3], b1[3], b2[3];
  for (int x = 0; x < 3; ++x) {
    b0[x] = p0[x] - p1[x];
    b1[x] = p2[x] - p1[x];
    b2[x] = p3[x] - p2[x];
  }
  T m[3], n[3];
  cross(b0, b1, m);
  cross(b2, b1, n);
  const T mm = dot3(m, m), nn = dot3(n, n);
  if (!(mm > T(0)) || !(nn > T(0))) {
    for (int r = 0; r < 4; ++r) out[r][0] = out[r][1] = out[r][2] = T(0);
    return;
  }
  const T nb1 = ksqrt(dot3(b1, b1));
  const T rb1 = T(1) / tmax(nb1, T(FLOOR));
  T b1n[3], v[3], w[3], bv[3];
  for (int x = 0; x < 3; ++x) b1n[x] = b1[x] * rb1;
  const T s0 = dot3(b0, b1n), s2 = dot3(b2, b1n);
  for (int x = 0; x < 3; ++x) {
    v[x] = b0[x] - s0 * b1n[x];
    w[x] = b2[x] - s2 * b1n[x];
  }
  cross(b1n, v, bv);
  const T phi = katan2(dot3(bv, w), dot3(v, w));
  T su, cu;
  ksincos(phi - t0, &su, &cu);
  const T g = (T(2) * T(K_DIH)) * katan2(su, cu);
  const T rsq = T(1) / (nb1 * nb1);
  const T a = dot3(b0, b1) * rsq;
  const T cc = -dot3(b2, b1) * rsq;
  const T q0 = nb1 / mm, q3 = -nb1 / nn;
  for (int x = 0; x < 3; ++x) {
    const T d0 = q0 * m[x];
    const T d3 = q3 * n[x];
    out[0][x] = -g * d0;
    out[1][x] = -g * ((a - T(1)) * d0 - cc * d3);
    out[2][x] = -g * ((cc - T(1)) * d3 - a * d0);
    out[3][x] = -g * d3;
  }
}

// the forces of one force-field term on its atoms, in role order;
// returns the number of atoms. Every role's position is read (the
// roles a term lacks read atom 0), so a warp whose lanes hold terms of
// several kinds loads without branching.
template <typename T, typename C>
__device__ __forceinline__ int term_forces(const C& c, const TermRec<T>& r,
                                           T bond_k, T (*out)[3]) {
  T p[4][3];
  for (int i = 0; i < 4; ++i) position(c, r.a[i], p[i]);
  if (r.kind == ANGLE) {
    angle_forces(p[0], p[1], p[2], r.t0, out);
    return 3;
  }
  if (r.kind == DIHEDRAL) {
    dihedral_forces(p[0], p[1], p[2], p[3], r.t0, out);
    return 4;
  }
  const bool bond = r.kind == BOND;
  pair_forces(p[0], p[1], bond ? HARMONIC : BELOW, r.t0,
              bond ? bond_k : T(K_REP), out);
  return 2;
}

// the springs k (d - t)^2 and half-springs k_h max(d - 2.5, 0)^2 of
// ff.FireTerms; k and k_h are read on the card
template <typename T>
struct Springs {
  const long long* pairs;   // (n, 2)
  const T* target;          // (n,)
  long long n;
  const T* k;
  const long long* half;    // (nh, 2)
  long long nh;
  const T* k_h;
};

// the springs' and then the half-springs' forces on atom a, added to f
// in order
template <typename T, typename C>
__device__ __forceinline__ void add_springs(const C& c, int a,
                                            const Springs<T>& s, T* f) {
  T out[2][3], xi[3], xj[3];
  for (int h = 0; h < 2; ++h) {
    const long long n = h ? s.nh : s.n;
    if (!n) continue;
    const long long* pairs = h ? s.half : s.pairs;
    const T k = h ? *s.k_h : *s.k;
    for (long long q = 0; q < n; ++q) {
      const int i = (int)__ldg(pairs + 2 * q);
      const int j = (int)__ldg(pairs + 2 * q + 1);
      if (i != a && j != a) continue;
      position(c, i, xi);
      position(c, j, xj);
      pair_forces(xi, xj, h ? ABOVE : HARMONIC,
                  h ? T(HALF_ONSET) : __ldg(s.target + q), k, out);
      for (int r = 0; r < 2; ++r)
        if ((r ? j : i) == a)
          for (int x = 0; x < 3; ++x) f[x] += out[r][x];
    }
  }
}

// the force on atom a, summed from zero in the fixed order, each of its
// terms computed here: its incidence entries lo..hi of the codes
// (4 term + role), load(term) giving each term's TermRec
template <typename T, typename C, typename L>
__device__ __forceinline__ void atom_force(const C& c, int a, int lo, int hi,
                                           const int* inc_code, const L& load,
                                           T bond_k, const Springs<T>& s,
                                           T* f) {
  f[0] = f[1] = f[2] = T(0);
  T out[4][3];
  for (int e = lo; e < hi; ++e) {
    const int code = __ldg(inc_code + e);
    term_forces(c, load(code >> 2), bond_k, out);
    const int r = code & 3;
    for (int x = 0; x < 3; ++x) f[x] += out[r][x];
  }
  add_springs(c, a, s, f);
}

// the force on atom a from its staged entries lo..hi (contrib: each
// incidence entry's force, 3 values an entry), summed from zero in the
// same fixed order as atom_force
template <typename T, typename C>
__device__ __forceinline__ void atom_force_staged(const C& c, int a, int lo,
                                                  int hi, const T* contrib,
                                                  const Springs<T>& s,
                                                  T* f) {
  f[0] = f[1] = f[2] = T(0);
  for (int e = lo; e < hi; ++e)
    for (int x = 0; x < 3; ++x) f[x] += contrib[3 * e + x];
  add_springs(c, a, s, f);
}

// ------------------------------------------------------- term energies
//
// Each term's energy, with ff_energy's arithmetic and clips (the norms
// by square roots, the quotients divided): bonds bond_k (d - r0)^2,
// angles K_ANGLE (acos(clip(cos)) - t0)^2 with the norm product floored
// at 1e-12, repulsion K_REP max(r0 - d, 0)^2, E/Z dihedrals K_DIH
// wrap(phi - t0)^2, springs k (d - t)^2 and half-springs k_h max(d -
// 2.5, 0)^2. A kernel that needs an image's energy sums these in its own
// fixed order; the force kernels above do not call them.

// a pair term's energy at distance |x_i - x_j|: k (d - p)^2 (HARMONIC),
// k max(p - d, 0)^2 (BELOW), k max(d - p, 0)^2 (ABOVE)
template <typename T>
__device__ __forceinline__ T pair_energy(const T* xi, const T* xj, int form,
                                         T p, T k) {
  const T dx = xi[0] - xj[0];
  const T dy = xi[1] - xj[1];
  const T dz = xi[2] - xj[2];
  const T d = ksqrt(dx * dx + dy * dy + dz * dz);
  const T x = form == BELOW   ? tmax(p - d, T(0))
              : form == ABOVE ? tmax(d - p, T(0))
                              : d - p;
  return k * (x * x);
}

template <typename T>
__device__ __forceinline__ T angle_energy(const T* xi, const T* xj,
                                          const T* xk, T t0) {
  T v1[3], v2[3];
  for (int x = 0; x < 3; ++x) {
    v1[x] = xi[x] - xj[x];
    v2[x] = xk[x] - xj[x];
  }
  const T den = tmax(ksqrt(dot3(v1, v1)) * ksqrt(dot3(v2, v2)), T(FLOOR));
  const T cs = tmin(tmax(dot3(v1, v2) / den, -T(COS_CLIP)), T(COS_CLIP));
  const T th = kacos(cs) - t0;
  return T(K_ANGLE) * (th * th);
}

template <typename T>
__device__ __forceinline__ T dihedral_energy(const T* p0, const T* p1,
                                             const T* p2, const T* p3,
                                             T t0) {
  T b0[3], b1[3], b2[3];
  for (int x = 0; x < 3; ++x) {
    b0[x] = p0[x] - p1[x];
    b1[x] = p2[x] - p1[x];
    b2[x] = p3[x] - p2[x];
  }
  const T nb1 = tmax(ksqrt(dot3(b1, b1)), T(FLOOR));
  T b1n[3], v[3], w[3], bv[3];
  for (int x = 0; x < 3; ++x) b1n[x] = b1[x] / nb1;
  const T s0 = dot3(b0, b1n), s2 = dot3(b2, b1n);
  for (int x = 0; x < 3; ++x) {
    v[x] = b0[x] - s0 * b1n[x];
    w[x] = b2[x] - s2 * b1n[x];
  }
  cross(b1n, v, bv);
  const T phi = katan2(dot3(bv, w), dot3(v, w));
  T su, cu;
  ksincos(phi - t0, &su, &cu);
  const T u = katan2(su, cu);
  return T(K_DIH) * (u * u);
}

// the energy of one force-field term (every role's position read, as
// term_forces reads them)
template <typename T, typename C>
__device__ __forceinline__ T term_energy(const C& c, const TermRec<T>& r,
                                         T bond_k) {
  T p[4][3];
  for (int i = 0; i < 4; ++i) position(c, r.a[i], p[i]);
  if (r.kind == ANGLE) return angle_energy(p[0], p[1], p[2], r.t0);
  if (r.kind == DIHEDRAL) return dihedral_energy(p[0], p[1], p[2], p[3], r.t0);
  const bool bond = r.kind == BOND;
  return pair_energy(p[0], p[1], bond ? HARMONIC : BELOW, r.t0,
                     bond ? bond_k : T(K_REP));
}

// spring q's energy, or (half) half-spring q's
template <typename T, typename C>
__device__ __forceinline__ T spring_energy(const C& c, const Springs<T>& s,
                                           long long q, bool half) {
  const long long* pairs = half ? s.half : s.pairs;
  T xi[3], xj[3];
  position(c, (int)__ldg(pairs + 2 * q), xi);
  position(c, (int)__ldg(pairs + 2 * q + 1), xj);
  return half ? pair_energy(xi, xj, ABOVE, T(HALF_ONSET), *s.k_h)
              : pair_energy(xi, xj, HARMONIC, __ldg(s.target + q), *s.k);
}

// ------------------------------------------------------- packed tables

// A topology's terms as ops/kernels/ff_fire.packed_terms packs them for
// the kernels that evaluate the force field (ff_fire.cu, dimer.cu),
// with ff.incidence's per-atom entries and the springs.
template <typename T>
struct Tables {
  int nb, na, np, nd;             // bonds, angles, repulsion pairs, dihedrals
  T bond_k;
  // packed once a topology (ops/kernels/ff_fire.packed_terms): each
  // term's atoms and incidence entries (rows of 4, -1 for a role it
  // lacks) and its reference value
  const int4* atoms;
  const int4* entries;
  const T* t0;
  // ff.incidence: each atom's entries, codes 4 term + role
  const int* inc_off;
  const int* inc_code;
  Springs<T> springs;
};

template <typename T>
__device__ __forceinline__ int kind_of(const Tables<T>& t, int term) {
  return term < t.nb ? BOND
         : term < t.nb + t.na ? ANGLE
         : term < t.nb + t.na + t.np ? REPULSION : DIHEDRAL;
}

template <typename T>
__device__ __forceinline__ TermRec<T> term_rec(int kind, int4 q, T t0) {
  TermRec<T> r;
  r.kind = kind;
  r.a[0] = q.x;
  r.a[1] = q.y;
  r.a[2] = q.z < 0 ? 0 : q.z;
  r.a[3] = q.w < 0 ? 0 : q.w;
  r.t0 = t0;
  return r;
}

// a term from the packed tables
template <typename T>
struct PackedLoad {
  const Tables<T>& t;
  __device__ __forceinline__ TermRec<T> operator()(int term) const {
    return term_rec(kind_of(t, term), __ldg(t.atoms + term),
                    __ldg(t.t0 + term));
  }
};

// a barrier over the `count` threads of one structure: the warp's own,
// or named barrier `id`
__device__ __forceinline__ void group_sync(int id, int count) {
  if (count == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// the slots of a term pass: kind k's terms at slots lo[k] ..
// lo[k] + count - 1 (packed: the terms in order; grouped by kind: each
// kind from a multiple of 32)
struct Slots {
  int lo[4];
  int n;
};

// the term at a slot, -1 for a slot that holds none
template <typename T>
__device__ __forceinline__ int slot_term(const Tables<T>& t, const Slots& s,
                                         int slot) {
  const int count[4] = {t.nb, t.na, t.np, t.nd};
  int base = 0;
  for (int k = 0; k < 4; ++k) {
    if (slot >= s.lo[k] && slot < s.lo[k] + count[k])
      return base + slot - s.lo[k];
    base += count[k];
  }
  return -1;
}

// write a term's forces o (w atoms) to its atoms' incidence entries
template <typename T>
__device__ __forceinline__ void stage(T* contrib, int4 e, int w,
                                      T (*o)[3]) {
  const int ent[4] = {e.x, e.y, e.z, e.w};
  for (int r = 0; r < 4; ++r)
    if (r < w)
      for (int x = 0; x < 3; ++x) contrib[3 * ent[r] + x] = o[r][x];
}

}  // namespace ffk
