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
// force and step) is taken in one fixed order: a thread's atoms in turn,
// a xor butterfly within each warp, then the warps' values in order,
// read by every thread. No atomics: two launches repeat their bits, and
// every thread holds the same sums, so the branches are uniform.
//
// Bound. A step evaluates the force field 37 times (18 Hessian actions
// of two displaced copies, and f): ~20 flops a pair term, ~60 an angle,
// ~110 a dihedral, on every term of the topology, plus ~60 flops an atom
// of vector algebra per action; the tables and coordinates are read once
// and the coordinates written once. So a call is bound by operations
// (at 34 TFLOP/s f64, microseconds for the scan's 27-atom ring), but a
// lone structure runs as a chain of 19 dependent force evaluations a
// step, each followed by block reductions: latency, not throughput,
// sets its pace.
//
// The forms (ops/kernels/dimer.launch_plan picks one; a block a
// structure in each, up to 512 threads):
//   staged  the state (c, v, u, the two displaced copies' forces) and
//           each incidence entry's force for both copies in shared
//           memory: a thread a (copy, term) slot writes the term's
//           forces to its atoms' entries, the first half of the slots
//           the copy at c + dr x, the second half the copy at c - dr x;
//           then a thread a (copy, atom) sums the atom's entries in
//           ff.incidence order (atom_force_staged).
//   atom    the state in shared memory, the entries not: a thread a
//           (copy, atom) computes the atom's terms itself in incidence
//           order (atom_force; the same values added in the same order).
//   device  the state in device memory (a slice of the work buffer a
//           structure), as the atom form otherwise: any N.
// Entries dimer_f32 / dimer_f64 return the cudaError_t of the launch;
// dimer_info reports a form's registers, local memory and resident
// blocks.

#include <cuda_runtime.h>

#include "ff_forces.cuh"

using namespace ffk;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr long long STATIC_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr int STATE = 5;               // c, v, u, fa, fb: 3 N values each

enum Form : int { FORM_STAGED = 0, FORM_ATOM = 1, FORM_DEVICE = 2 };
// the launch plan, a host array: ops/kernels/dimer.Plan.args
enum PlanField : int { P_FORM, P_THREADS, P_SMEM, P_ENTRIES };

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
                                             T* red) {
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
}

template <typename T>
__device__ __forceinline__ T block_sum(T s, T* red) {
  T z1 = T(0), z2 = T(0), z3 = T(0);
  block_reduce(s, z1, z2, z3, red);
  return s;
}

// the forces of `copies` copies, the first at c + (h x) into f0, the
// second at c - (h x) into f1 (x null: one copy at c). Opens with a
// barrier (x was just written) and closes with one.
template <typename T, bool STAGED>
__device__ __forceinline__ void copy_forces(const Tables<T>& t, int N, int E,
                                            const T* c, const T* x, T h,
                                            int copies, T* f0, T* f1,
                                            T* contrib) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  if (STAGED) {
    const int nterm = t.nb + t.na + t.np + t.nd;
    for (int s = tid; s < copies * nterm; s += nt) {
      const int copy = s >= nterm, term = s - copy * nterm;
      const Displaced<T> at{c, x, h, copy == 1};
      T o[4][3];
      stage(contrib + copy * 3LL * E, __ldg(t.entries + term),
            term_forces(at, PackedLoad<T>{t}(term), t.bond_k, o), o);
    }
    __syncthreads();
  }
  for (int s = tid; s < copies * N; s += nt) {
    const int copy = s >= N, a = s - copy * N;
    const Displaced<T> at{c, x, h, copy == 1};
    const int lo = __ldg(t.inc_off + a), hi = __ldg(t.inc_off + a + 1);
    T fa[3];
    if (STAGED)
      atom_force_staged(at, a, lo, hi, contrib + copy * 3LL * E, t.springs,
                        fa);
    else
      atom_force(at, a, lo, hi, t.inc_code, PackedLoad<T>{t}, t.bond_k,
                 t.springs, fa);
    T* f = (copy ? f1 : f0) + 3 * a;
    f[0] = fa[0];
    f[1] = fa[1];
    f[2] = fa[2];
  }
  __syncthreads();
}

// w (3 N, a thread's own atoms) <- normalize(project(w)), written to out
template <typename T>
__device__ __forceinline__ void project_normalize(T* w, T* out, int N,
                                                  T* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (N > 1) {
    T s0 = T(0), s1 = T(0), s2 = T(0), m = T(0);
    for (int a = tid; a < N; a += nt) {
      s0 = add(s0, w[3 * a]);
      s1 = add(s1, w[3 * a + 1]);
      s2 = add(s2, w[3 * a + 2]);
    }
    block_reduce(s0, s1, s2, m, red);
    const T n = T(N);
    const T mean[3] = {quot(s0, n), quot(s1, n), quot(s2, n)};
    for (int a = tid; a < N; a += nt)
      for (int k = 0; k < 3; ++k) w[3 * a + k] = sub(w[3 * a + k], mean[k]);
  }
  T q = T(0);
  for (int a = tid; a < N; a += nt) q = add(q, dot_atom(w + 3 * a, w + 3 * a));
  const T den = tmax(ksqrt(block_sum(q, red)), T(FLOOR));
  for (int a = tid; a < N; a += nt)
    for (int k = 0; k < 3; ++k) out[3 * a + k] = quot(w[3 * a + k], den);
}

// one structure a block; work (the device form): STATE x 3 N values a
// structure, else the state in dynamic shared memory, followed (staged)
// by the entries' forces of both copies, 2 x 3 E values
template <typename T, bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS)
dimer_kernel(const T* __restrict__ coords, const T* __restrict__ v0,
             T* __restrict__ out, bool* __restrict__ done_out,
             int* __restrict__ steps_out, T* work, int N, const Tables<T> t,
             int E, int n_steps, int n_rot, double dr_, double step_size_,
             double fmax_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[4 * MAX_WARPS];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long n3 = 3LL * N;
  T* c = work ? work + b * STATE * n3 : reinterpret_cast<T*>(smem_raw);
  T* v = c + n3;
  T* u = v + n3;
  T* fa = u + n3;
  T* fb = fa + n3;
  T* contrib = STAGED ? fb + n3 : nullptr;
  const T dr = T(dr_), two_dr = T(2.0 * dr_), step_size = T(step_size_);
  const T fmax = T(fmax_);
  for (long long k = tid; k < n3; k += nt) {
    c[k] = coords[b * n3 + k];
    v[k] = v0[k];
  }
  // the values were stored by component and are read by atom below
  __syncthreads();
  int steps = 0;
  bool done = false;
  // fa <- hv(x) = -(F(c + dr x) - F(c - dr x)) / (2 dr), a thread's atoms
  auto hv = [&](const T* x) {
    copy_forces<T, STAGED>(t, N, E, c, x, dr, 2, fa, fb, contrib);
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
    return block_sum(s, red);
  };
  while (steps < n_steps && !done) {
    // shifted power iteration: v <- normalize((sigma I - H) v) converges
    // to the most negative curvature mode for sigma above lambda_max,
    // which the power steps on u estimate
    for (int a = tid; a < N; a += nt)
      for (int k = 0; k < 3; ++k) u[3 * a + k] = v[3 * a + k];
    for (int i = 0; i < 4; ++i) {
      hv(u);
      project_normalize(fa, u, N, red);
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
      project_normalize(fa, v, N, red);
    }
    hv(v);
    const T curv = dot(v);
    copy_forces<T, STAGED>(t, N, E, c, nullptr, T(0), 1, fa, nullptr,
                           contrib);
    // f . v and the largest squared atomic force
    T along = T(0), z1 = T(0), z2 = T(0), fm = T(0);
    for (int a = tid; a < N; a += nt) {
      along = add(along, dot_atom(fa + 3 * a, v + 3 * a));
      fm = tmax(fm, dot_atom(fa + 3 * a, fa + 3 * a));
    }
    block_reduce(along, z1, z2, fm, red);
    const T fmax_now = ksqrt(fm);
    // negative curvature: the dimer translation (the force with its
    // mode component inverted); positive curvature near a stationary
    // point: climb the softest mode (reversed parallel force and a
    // kick); positive curvature under a large force: the inverted-force
    // step
    const bool climbing = curv >= T(0) && fmax_now < mul(T(10), fmax);
    done = fmax_now < fmax && curv < T(0);
    ++steps;
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
    block_reduce(y0, y1, y2, md, red);
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
}

// ---------------------------------------------------------------- launch

// raise a kernel's dynamic shared memory limit past 48 KB on the current
// card, once per (kernel, card, larger size)
int opt_in_smem(const void* fn, int id, long long bytes) {
  static long long done[4][MAX_DEVICES] = {{0}};
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
const void* form_kernel(int form, int* id) {
  const bool staged = form == FORM_STAGED;
  *id = 2 * (sizeof(T) == 8) + staged;
  return staged ? (const void*)dimer_kernel<T, true>
                : (const void*)dimer_kernel<T, false>;
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
  const long long smem = plan[P_SMEM];
  if (form < FORM_STAGED || form > FORM_DEVICE || threads <= 0 ||
      threads % 32 || threads > MAX_THREADS || N <= 0 ||
      (form == FORM_DEVICE) != (work != nullptr) ||
      (form == FORM_DEVICE && smem != 0))
    return (int)cudaErrorInvalidValue;
  int id = 0;
  const void* fn = form_kernel<T>(form, &id);
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
  using K = void (*)(const T*, const T*, T*, bool*, int*, T*, int,
                     const Tables<T>, int, int, int, double, double, double);
  const K kernel = reinterpret_cast<K>(const_cast<void*>(fn));
  kernel<<<(unsigned)B, threads, (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coords), static_cast<const T*>(v0),
      static_cast<T*>(out), static_cast<bool*>(done),
      static_cast<int*>(steps), static_cast<T*>(work), N, t,
      (int)plan[P_ENTRIES], n_steps, n_rot, dr, step_size, fmax);
  return (int)cudaGetLastError();
}

template <typename T>
int info(const long long* plan, int* out) {
  int id = 0;
  const void* fn = form_kernel<T>((int)plan[P_FORM], &id);
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
