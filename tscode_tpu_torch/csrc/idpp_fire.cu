// FIRE on the IDPP objective, every step of a band's images in one launch
// (I1).
//
// Replaces no Pallas kernel: the JAX package relaxes the IDPP starting
// band (tscode_tpu/neb.py:35 idpp_interpolate) as one jitted program,
// fire_minimize_batch (tscode_tpu/optimizers.py:41: a lax.scan over the
// steps whose body is jax.grad of _idpp_energy, neb.py:27, and the FIRE
// update) with the endpoints frozen. The port ran it as fire_run_graph,
// a captured autograd step replayed n_steps times from the host.
//
// What the kernel computes, a block an image, for at most n_steps steps:
//   the IDPP forces of the image, -dE/dx_a with E = sum over a, j of
//   w_aj (d_aj - t_aj)^2, d_aj = sqrt(|x_a - x_j|^2 + 1e-12), both
//   orderings of every pair (the tables' rows a and j), the diagonal
//   (weight 0) skipped; each atom sums its pairs in ascending j;
//   optimizers.fire_step on the image: power and norms over the image,
//   dt growing to at most 10 dt0, the step capped at 0.2 A, the image
//   stopped once its largest atomic force is under fmax (its loop ends
//   there: its coordinates no longer move, so the outputs equal the
//   scan's masked steps). The endpoints are frozen: their force is zero,
//   so they never move and stop at their first step (where 0 < fmax).
// Products, sums and quotients are rounded one at a time (no fused
// multiply-add), as PyTorch's elementwise ops round them. The image's
// sums: each 32-atom chunk by xor butterfly, the chunks in order; no
// atomics (two launches give the same bits).
//
// Bound: the function's work a step is ~30 flops an unordered pair of an
// interior image (both atoms' contributions from one distance); its own
// bytes are the interior images' rows of the tables read once. The kernel
// reads four values a pair (the pair's row and column) and evaluates each
// pair in both atoms' sums. The tables are read again every step (from L2 while they fit, at N = 2,500
// 100 MB an image from device memory); the coordinates sit in shared
// memory, the velocities and forces of a thread's own atoms in device
// memory.
// Entry idpp_fire_f64 returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr long long STATIC_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr double FLOOR = 1e-12;
constexpr double D_EPS = 1e-12;       // under the square root of d
constexpr double STEP_CAP = 0.2;      // A (optimizers._MAX_DISP)
constexpr double DT_GROW = 10.0;      // optimizers._DT_MAX_FACTOR

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

// The image's atoms in chunks of 32: chunk k on warp k mod W, atom 32 k +
// lane on that lane. reduce(): sums of s[0..2] and the max of s[3] over
// the atoms, each chunk by xor butterfly, the chunks in order, the same
// bits in every thread (two buffers of chunk values, so no closing
// barrier).
struct Atoms {
  int n, chunks, warp, warps, lane;
  double* red;     // 2 x 4 x chunks
  int parity;

  __device__ __forceinline__ Atoms(int n_, double* red_)
      : n(n_), red(red_), parity(0) {
    chunks = (n + 31) / 32;
    warp = threadIdx.x >> 5;
    warps = blockDim.x >> 5;
    lane = threadIdx.x & 31;
  }

  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    for (int k = warp; k < chunks; k += warps) {
      const int a = 32 * k + lane;
      if (a < n) f(a);
    }
  }

  template <typename F>
  __device__ __forceinline__ void reduce(F vals, double* out) {
    double* r = red + parity * 4 * chunks;
    for (int k = warp; k < chunks; k += warps) {
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      const int a = 32 * k + lane;
      if (a < n) vals(a, s);
      for (int o = 16; o > 0; o >>= 1) {
        s[0] = add(s[0], __shfl_xor_sync(0xffffffffu, s[0], o));
        s[1] = add(s[1], __shfl_xor_sync(0xffffffffu, s[1], o));
        s[2] = add(s[2], __shfl_xor_sync(0xffffffffu, s[2], o));
        s[3] = fmax(s[3], __shfl_xor_sync(0xffffffffu, s[3], o));
      }
      if (lane == 0)
        for (int j = 0; j < 4; ++j) r[j * chunks + k] = s[j];
    }
    __syncthreads();
    double s[4];
    for (int j = 0; j < 4; ++j) s[j] = r[j * chunks];
    for (int k = 1; k < chunks; ++k) {
      for (int j = 0; j < 3; ++j) s[j] = add(s[j], r[j * chunks + k]);
      s[3] = fmax(s[3], r[3 * chunks + k]);
    }
    for (int j = 0; j < 4; ++j) out[j] = s[j];
    parity ^= 1;
  }
};

// the shared values: the image's coordinates and the reductions' chunk
// values (ops/kernels/idpp.launch_plan)
__host__ __device__ __forceinline__ long long idpp_values(int N) {
  return 3LL * N + 8LL * ((N + 31) / 32);
}

__global__ void __launch_bounds__(MAX_THREADS)
idpp_fire_kernel(const double* __restrict__ chain,
                 const double* __restrict__ targets,
                 const double* __restrict__ weights, double* __restrict__ out,
                 bool* __restrict__ done_out, int* __restrict__ steps_out,
                 double* __restrict__ work, int I, int N, int n_steps,
                 double dt0, double fmax_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* c = reinterpret_cast<double*>(smem_raw);
  const int b = blockIdx.x;
  const long long n3 = 3LL * N;
  Atoms at(N, c + n3);
  const double* x0 = chain + b * n3;
  double* xo = out + b * n3;
  if (b == 0 || b == I - 1) {
    // a frozen endpoint: no force, so it never moves, and it stops at
    // its first step where 0 < fmax (fire_step's test), else takes them all
    for (long long k = threadIdx.x; k < n3; k += blockDim.x) xo[k] = x0[k];
    if (threadIdx.x == 0) {
      const bool stop = n_steps > 0 && 0.0 < fmax_;
      done_out[b] = stop;
      steps_out[b] = stop ? 1 : max(n_steps, 0);
    }
    return;
  }
  double* v = work + 2 * b * n3;
  double* f = v + n3;
  const double* W = weights + (long long)b * N * N;
  const double* Tg = targets + (long long)b * N * N;
  at.each([&](int a) {
    for (int k = 0; k < 3; ++k) {
      c[3 * a + k] = x0[3 * a + k];
      v[3 * a + k] = 0.0;
    }
  });
  __syncthreads();
  const double dt_cap = mul(dt0, DT_GROW);
  double dt = dt0, alpha = 0.1;
  int n_pos = 0, steps = 0;
  bool done = false;
  double s[4];
  while (steps < n_steps) {
    // the forces, and the image's power, norms and largest force
    at.reduce([&](int a, double* q) {
      const double xa[3] = {c[3 * a], c[3 * a + 1], c[3 * a + 2]};
      const double* wr = W + (long long)a * N;
      const double* tr = Tg + (long long)a * N;
      double fa[3] = {0.0, 0.0, 0.0};
      for (int j = 0; j < N; ++j) {
        if (j == a) continue;
        const double dx = sub(xa[0], c[3 * j]);
        const double dy = sub(xa[1], c[3 * j + 1]);
        const double dz = sub(xa[2], c[3 * j + 2]);
        const double d = sqrt(add(add(add(mul(dx, dx), mul(dy, dy)),
                                      mul(dz, dz)), D_EPS));
        const double wc = __ldg(W + (long long)j * N + a);
        const double tc = __ldg(Tg + (long long)j * N + a);
        const double g = quot(
            mul(2.0, add(mul(__ldg(wr + j), sub(d, __ldg(tr + j))),
                         mul(wc, sub(d, tc)))),
            d);
        fa[0] = sub(fa[0], mul(g, dx));
        fa[1] = sub(fa[1], mul(g, dy));
        fa[2] = sub(fa[2], mul(g, dz));
      }
      const double* va = v + 3 * a;
      for (int k = 0; k < 3; ++k) f[3 * a + k] = fa[k];
      q[0] = add(q[0], dot_atom(fa, va));
      q[1] = add(q[1], dot_atom(fa, fa));
      q[2] = add(q[2], dot_atom(va, va));
      q[3] = fmax(q[3], dot_atom(fa, fa));
    }, s);
    ++steps;
    if (sqrt(s[3]) < fmax_) {
      done = true;
      break;
    }
    const double power = s[0];
    const double f_norm = sqrt(s[1]), v_norm = sqrt(s[2]);
    const bool uphill = power <= 0.0;
    n_pos = uphill ? 0 : n_pos + 1;
    const bool grow = n_pos > 5;
    const double dt_new = uphill ? mul(dt, 0.5)
                          : grow ? fmin(mul(dt, 1.1), dt_cap) : dt;
    const double alpha_new = uphill ? 0.1 : grow ? mul(alpha, 0.99) : alpha;
    const double keep = sub(1.0, alpha);
    const double fden = fmax(f_norm, FLOOR);
    at.reduce([&](int a, double* q) {
      double st[3];
      for (int k = 0; k < 3; ++k) {
        const int x = 3 * a + k;
        const double mixed =
            add(mul(keep, v[x]), quot(mul(mul(alpha, f[x]), v_norm), fden));
        const double stepped = add(uphill ? 0.0 : mixed, mul(dt_new, f[x]));
        v[x] = stepped;
        st[k] = mul(dt_new, stepped);
      }
      q[3] = fmax(q[3], dot_atom(st, st));
    }, s);
    const double scale = fmin(quot(STEP_CAP, fmax(sqrt(s[3]), FLOOR)), 1.0);
    at.each([&](int a) {
      for (int k = 0; k < 3; ++k) {
        const int x = 3 * a + k;
        const double stepped = v[x];
        c[x] = add(c[x], mul(mul(dt_new, stepped), scale));
        v[x] = mul(stepped, scale);
      }
    });
    dt = dt_new;
    alpha = alpha_new;
    __syncthreads();
  }
  at.each([&](int a) {
    for (int k = 0; k < 3; ++k) xo[3 * a + k] = c[3 * a + k];
  });
  if (threadIdx.x == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
}

int opt_in_smem(long long bytes) {
  static long long done[MAX_DEVICES] = {0};
  if (bytes <= STATIC_SMEM) return 0;
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return 0;
  err = (int)cudaFuncSetAttribute(
      idpp_fire_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (!err) done[dev] = bytes;
  return err;
}

}  // namespace

extern "C" {

int idpp_fire_f64(const void* chain, const void* targets,
                  const void* weights, void* out, void* done, void* steps,
                  void* work, int I, int N, int threads, long long smem,
                  int n_steps, double dt0, double fmax, void* stream) {
  if (I <= 0) return 0;
  if (N <= 0 || threads <= 0 || threads % 32 || threads > MAX_THREADS ||
      smem != idpp_values(N) * 8)
    return (int)cudaErrorInvalidValue;
  int err = opt_in_smem(smem);
  if (err) return err;
  idpp_fire_kernel<<<(unsigned)I, threads, (size_t)smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(chain), static_cast<const double*>(targets),
      static_cast<const double*>(weights), static_cast<double*>(out),
      static_cast<bool*>(done), static_cast<int*>(steps),
      static_cast<double*>(work), I, N, n_steps, dt0, fmax);
  return (int)cudaGetLastError();
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
