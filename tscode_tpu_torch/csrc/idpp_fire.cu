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
// What the kernel computes, for each image, for at most n_steps steps:
//   the IDPP forces of the image, -dE/dx_a with E = sum over a, j of
//   w_aj (d_aj - t_aj)^2, d_aj = sqrt(|x_a - x_j|^2 + 1e-12), both
//   orderings of every pair, the diagonal (weight 0) skipped; each atom
//   sums its pairs in ascending j;
//   optimizers.fire_step on the image: power and norms over the image,
//   dt growing to at most 10 dt0, the step capped at 0.2 A, the image
//   stopped once its largest atomic force is under fmax (its loop ends
//   there: its coordinates no longer move, so the outputs equal the
//   scan's masked steps). The endpoints are frozen: their force is zero,
//   so they never move and stop at their first step (where 0 < fmax).
// The tables are symmetric (neb.idpp_tables builds them from distance
// matrices that are symmetric to the bit; ops/kernels/idpp refuses any
// other), so a pair's two orderings read one value of each table, the
// column W[j N + a], twice: w (d - t) + w (d - t), the bits of reading
// the row and the column. Products, sums and quotients are rounded one at
// a time (no fused multiply-add), as PyTorch's elementwise ops round
// them. The image's sums: each 32-atom chunk by xor butterfly, the chunks
// in order; no atomics (two launches give the same bits, and those of
// the first design, idpp_fire_v1.cu).
//
// Bound: the function's work a step is ~30 flops an unordered pair of an
// interior image; its own bytes are the interior images' tables read
// once. The forms (ops/kernels/idpp.launch_plan):
//   lone     an image of at most 32 atoms on one block of 4 warps: its
//            tables copied into shared memory once a launch, each
//            unordered pair evaluated once a step by one of the block's
//            threads (its distance and its scalar coefficient g, the
//            same for both orderings) into an N x N matrix; then warp 0,
//            a lane an atom, sums its atom's pairs in ascending order,
//            the velocities and forces in registers, the reductions by
//            shuffles alone; two block barriers a step. (One warp alone
//            spent 80% of a step on its lanes' ~11 dependent square
//            roots and divisions each; tools/kernel_phases.py --i1.)
//   cluster  an image on a thread-block cluster of cl blocks (past the
//            portable 8 by the non-portable attribute, up to 16), a
//            thread an atom; each block holds the image's coordinates in
//            shared memory, reads its atoms' columns of the tables from
//            device memory (neighbouring threads on neighbouring values)
//            and writes its atoms' new coordinates into every block's
//            copy (distributed shared memory); a reduction's chunk values
//            go into every block's shared memory, behind a cluster
//            barrier each block adds them in order. Three cluster
//            barriers a step.
// Entry idpp_fire_f64 returns the cudaError_t of the launch; idpp_info a
// form's registers, local memory and resident blocks. TT_PHASES builds
// (csrc/phases.cuh, tools/kernel_phases.py --i1): each image's record of
// its first thread's cycles by phase (Lap).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "phases.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;
constexpr long long STATIC_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_CLUSTER = 16;
constexpr int LONE_ATOMS = 32;        // the lone form: atoms an image at most
constexpr int LONE_WARPS = 4;         // the lone form: warps a block
constexpr int PAIR_BATCH = 8;         // pairs a lane takes at a time
constexpr double FLOOR = 1e-12;
constexpr double D_EPS = 1e-12;       // under the square root of d
constexpr double STEP_CAP = 0.2;      // A (optimizers._MAX_DISP)
constexpr double DT_GROW = 10.0;      // optimizers._DT_MAX_FACTOR

enum Form : int { FORM_LONE = 0, FORM_CLUSTER = 1 };
// TT_PHASES builds: an image's record, its first thread's cycles in the
// pair loop, the first reduction, the velocity update, the second
// reduction, the move (with its barrier) and set-up, then the steps
enum Lap : int { L_PAIRS, L_RED1, L_UPDATE, L_RED2, L_MOVE, L_SETUP,
                 L_STEPS, N_LAPS };
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

// a pair's distance from its difference (dx, dy, dz)
__device__ __forceinline__ double pair_d(double dx, double dy, double dz) {
  return sqrt(add(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)), D_EPS));
}
// a pair's coefficient g = 2 (w (d - t) + w (d - t)) / d from the column
// values w, t (the row's equal them)
__device__ __forceinline__ double pair_g(double d, double w, double t) {
  const double x = mul(w, sub(d, t));
  return quot(mul(2.0, add(x, x)), d);
}

// s[0..2] summed and s[3] maxed over a warp's lanes by xor butterfly
__device__ __forceinline__ void butterfly(double* s) {
  for (int o = 16; o > 0; o >>= 1) {
    s[0] = add(s[0], __shfl_xor_sync(0xffffffffu, s[0], o));
    s[1] = add(s[1], __shfl_xor_sync(0xffffffffu, s[1], o));
    s[2] = add(s[2], __shfl_xor_sync(0xffffffffu, s[2], o));
    s[3] = fmax(s[3], __shfl_xor_sync(0xffffffffu, s[3], o));
  }
}

// the FIRE controls of one step from the image's sums s (power, |f|^2,
// |v|^2): the new dt and alpha, the mixing weights, whether uphill
struct Fire {
  double dt, alpha, dt_cap;
  int n_pos;
  __device__ __forceinline__ void step(const double* s, bool& uphill,
                                       double& keep, double& v_norm,
                                       double& fden, double& dt_new,
                                       double& alpha_old) {
    const double power = s[0];
    const double f_norm = sqrt(s[1]);
    v_norm = sqrt(s[2]);
    uphill = power <= 0.0;
    n_pos = uphill ? 0 : n_pos + 1;
    const bool grow = n_pos > 5;
    dt_new = uphill ? mul(dt, 0.5) : grow ? fmin(mul(dt, 1.1), dt_cap) : dt;
    alpha_old = alpha;
    keep = sub(1.0, alpha);
    fden = fmax(f_norm, FLOOR);
    alpha = uphill ? 0.1 : grow ? mul(alpha, 0.99) : alpha;
    dt = dt_new;
  }
};

// an atom's new velocity and its step from its force f and velocity v
__device__ __forceinline__ void fire_velocity(const double* f, double* v,
                                              double* st, bool uphill,
                                              double keep, double alpha,
                                              double v_norm, double fden,
                                              double dt_new) {
  for (int k = 0; k < 3; ++k) {
    const double mixed =
        add(mul(keep, v[k]), quot(mul(mul(alpha, f[k]), v_norm), fden));
    const double stepped = add(uphill ? 0.0 : mixed, mul(dt_new, f[k]));
    v[k] = stepped;
    st[k] = mul(dt_new, stepped);
  }
}

// a frozen endpoint: no force, so it never moves; it stops at its first
// step where 0 < fmax (fire_step's test), else takes them all
__device__ __forceinline__ void endpoint(const double* x0, double* xo,
                                         long long n3, long long tid,
                                         long long nt, bool flags,
                                         bool* done_out, int* steps_out,
                                         int b, int n_steps, double fmax) {
  for (long long k = tid; k < n3; k += nt) xo[k] = x0[k];
  if (flags) {
    const bool stop = n_steps > 0 && 0.0 < fmax;
    done_out[b] = stop;
    steps_out[b] = stop ? 1 : max(n_steps, 0);
  }
}

// the lone form's shared values (ops/kernels/idpp.launch_plan): the
// coordinates, both tables, the pair coefficients, then the pair list and
// the stop flag
__host__ __device__ __forceinline__ long long lone_bytes(int N) {
  return 8LL * (3 * N + 3LL * N * N) + 4LL * (N * (N - 1) / 2 + 1);
}
// the cluster form's: the coordinates, the reductions' chunk values
__host__ __device__ __forceinline__ long long cluster_bytes(int N) {
  return 8LL * (3 * N + 8LL * ((N + 31) / 32));
}

// the lone form: image blockIdx.x on one block of LONE_WARPS warps. Every
// thread takes unordered pairs; warp 0, a lane an atom, the atoms' sums,
// the reductions (shuffles) and the FIRE update; two block barriers a
// step (the coefficients, then the move and the stop flag)
__global__ void __launch_bounds__(32 * LONE_WARPS)
idpp_lone_kernel(const double* __restrict__ chain,
                 const double* __restrict__ targets,
                 const double* __restrict__ weights, double* __restrict__ out,
                 bool* __restrict__ done_out, int* __restrict__ steps_out,
                 int I, int N, int n_steps, double dt0, double fmax_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* c = reinterpret_cast<double*>(smem_raw);
  double* W = c + 3 * N;
  double* Tg = W + N * N;
  double* gm = Tg + N * N;
  const int P = N * (N - 1) / 2;
  int* pairs = reinterpret_cast<int*>(gm + N * N);
  int* stop = pairs + P;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31;
  const bool lead = tid < 32;            // warp 0
  const long long n3 = 3LL * N, nn = (long long)N * N;
  const double* x0 = chain + b * n3;
  double* xo = out + b * n3;
  if (b == 0 || b == I - 1) {
    endpoint(x0, xo, n3, tid, nt, tid == 0, done_out, steps_out, b, n_steps,
             fmax_);
    return;
  }
  Laps laps;
  for (int k = tid; k < nn; k += nt) {
    W[k] = weights[b * nn + k];
    Tg[k] = targets[b * nn + k];
    const int a = k / N, j = k - a * N;
    if (a < j) pairs[a * N - a * (a + 1) / 2 + j - a - 1] = a | j << 16;
  }
  for (int k = tid; k < n3; k += nt) c[k] = x0[k];
  if (tid == 0) *stop = 0;
  const bool own = lead && lane < N;
  double v[3] = {0.0, 0.0, 0.0};
  Fire fire{dt0, 0.1, mul(dt0, DT_GROW), 0};
  int steps = 0;
  bool done = false;
  __syncthreads();
  laps.lap(L_SETUP);
  for (int it = 0; it < n_steps; ++it) {
    // each unordered pair once: its coefficient for both orderings, a
    // thread's pairs PAIR_BATCH at a time (independent chains)
    for (int p0 = tid; p0 < P; p0 += nt * PAIR_BATCH) {
#pragma unroll
      for (int u = 0; u < PAIR_BATCH; ++u) {
        const int p = p0 + nt * u;
        if (p < P) {
          const int a = pairs[p] & 0xffff, j = pairs[p] >> 16;
          const double d = pair_d(sub(c[3 * a], c[3 * j]),
                                  sub(c[3 * a + 1], c[3 * j + 1]),
                                  sub(c[3 * a + 2], c[3 * j + 2]));
          const double g = pair_g(d, W[j * N + a], Tg[j * N + a]);
          gm[a * N + j] = g;
          gm[j * N + a] = g;
        }
      }
    }
    __syncthreads();
    if (lead) {
      // the lane's atom: its pairs in ascending j, then the image's sums
      double f[3] = {0.0, 0.0, 0.0};
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      if (own) {
        const int a = lane;
        const double xa[3] = {c[3 * a], c[3 * a + 1], c[3 * a + 2]};
        for (int j = 0; j < N; ++j) {
          if (j == a) continue;
          const double g = gm[a * N + j];
          for (int k = 0; k < 3; ++k)
            f[k] = sub(f[k], mul(g, sub(xa[k], c[3 * j + k])));
        }
        s[0] = add(0.0, dot_atom(f, v));
        s[1] = add(0.0, dot_atom(f, f));
        s[2] = add(0.0, dot_atom(v, v));
        s[3] = fmax(0.0, dot_atom(f, f));
      }
      laps.lap(L_PAIRS);
      butterfly(s);
      laps.lap(L_RED1);
      ++steps;
      laps.add(L_STEPS, 1);
      if (sqrt(s[3]) < fmax_) {
        done = true;
        if (lane == 0) *stop = 1;
      } else {
        bool uphill;
        double keep, v_norm, fden, dt_new, alpha;
        fire.step(s, uphill, keep, v_norm, fden, dt_new, alpha);
        double st[3] = {0.0, 0.0, 0.0};
        if (own)
          fire_velocity(f, v, st, uphill, keep, alpha, v_norm, fden, dt_new);
        double q[4] = {0.0, 0.0, 0.0,
                       own ? fmax(0.0, dot_atom(st, st)) : 0.0};
        laps.lap(L_UPDATE);
        butterfly(q);
        laps.lap(L_RED2);
        const double scale =
            fmin(quot(STEP_CAP, fmax(sqrt(q[3]), FLOOR)), 1.0);
        if (own)
          for (int k = 0; k < 3; ++k) {
            const double stepped = v[k];
            c[3 * lane + k] =
                add(c[3 * lane + k], mul(mul(dt_new, stepped), scale));
            v[k] = mul(stepped, scale);
          }
      }
    }
    __syncthreads();
    laps.lap(L_MOVE);
    if (*stop) break;
  }
  for (int k = tid; k < n3; k += nt) xo[k] = c[k];
  if (tid == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
  laps.lap(L_SETUP);
  laps.flush(b, tid == 0);
}

// the cluster form: image blockIdx.x / cl on the cluster's blocks, block
// rank r on atoms r T .. r T + T - 1 (T threads a block)
__global__ void __launch_bounds__(MAX_THREADS)
idpp_cluster_kernel(const double* __restrict__ chain,
                    const double* __restrict__ targets,
                    const double* __restrict__ weights,
                    double* __restrict__ out, bool* __restrict__ done_out,
                    int* __restrict__ steps_out, int I, int N, int n_steps,
                    double dt0, double fmax_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cl = (int)cluster.num_blocks();
  const int b = blockIdx.x / cl, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long n3 = 3LL * N, nn = (long long)N * N;
  const int CH = (N + 31) / 32;
  double* c = reinterpret_cast<double*>(smem_raw);
  double* red = c + n3;                 // 2 x 4 x CH
  const double* x0 = chain + b * n3;
  double* xo = out + b * n3;
  if (b == 0 || b == I - 1) {
    endpoint(x0, xo, n3, (long long)rank * nt + tid, (long long)cl * nt,
             rank == 0 && tid == 0, done_out, steps_out, b, n_steps, fmax_);
    return;
  }
  Laps laps;
  const int a = rank * nt + tid;
  const bool own = a < N;
  const int chunk = rank * (nt / 32) + warp;   // this warp's 32 atoms
  const double* W = weights + b * nn;
  const double* Tg = targets + b * nn;
  for (long long k = tid; k < n3; k += nt) c[k] = x0[k];
  double v[3] = {0.0, 0.0, 0.0};
  Fire fire{dt0, 0.1, mul(dt0, DT_GROW), 0};
  int steps = 0, parity = 0;
  bool done = false;
  // every block has started before any writes into another's memory
  cluster.sync();
  laps.lap(L_SETUP);
  // the chunk sums s of this warp into every block, then behind the
  // cluster barrier the image's sums in chunk order
  auto reduce = [&](double* s) {
    double* r = red + parity * 4 * CH;
    if (lane == 0 && chunk < CH)
      for (int q = 0; q < cl; ++q) {
        double* rr = cluster.map_shared_rank(r, q);
        for (int j = 0; j < 4; ++j) rr[j * CH + chunk] = s[j];
      }
    cluster.sync();
    for (int j = 0; j < 4; ++j) s[j] = r[j * CH];
    for (int k = 1; k < CH; ++k) {
      for (int j = 0; j < 3; ++j) s[j] = add(s[j], r[j * CH + k]);
      s[3] = fmax(s[3], r[3 * CH + k]);
    }
    parity ^= 1;
  };
  while (steps < n_steps) {
    double f[3] = {0.0, 0.0, 0.0};
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    if (own) {
      const double xa[3] = {c[3 * a], c[3 * a + 1], c[3 * a + 2]};
      // the columns PAIR_BATCH rows at a time, the next batch's loads in
      // flight while this one's pairs are evaluated
      double w[PAIR_BATCH], t[PAIR_BATCH];
#pragma unroll
      for (int u = 0; u < PAIR_BATCH; ++u) {
        w[u] = u < N ? __ldg(W + (long long)u * N + a) : 0.0;
        t[u] = u < N ? __ldg(Tg + (long long)u * N + a) : 0.0;
      }
      for (int j0 = 0; j0 < N; j0 += PAIR_BATCH) {
        double wn[PAIR_BATCH], tn[PAIR_BATCH];
#pragma unroll
        for (int u = 0; u < PAIR_BATCH; ++u) {
          const int j = j0 + PAIR_BATCH + u;
          wn[u] = j < N ? __ldg(W + (long long)j * N + a) : 0.0;
          tn[u] = j < N ? __ldg(Tg + (long long)j * N + a) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < PAIR_BATCH; ++u) {
          const int j = j0 + u;
          if (j < N && j != a) {
            const double dx = sub(xa[0], c[3 * j]);
            const double dy = sub(xa[1], c[3 * j + 1]);
            const double dz = sub(xa[2], c[3 * j + 2]);
            const double g = pair_g(pair_d(dx, dy, dz), w[u], t[u]);
            f[0] = sub(f[0], mul(g, dx));
            f[1] = sub(f[1], mul(g, dy));
            f[2] = sub(f[2], mul(g, dz));
          }
          w[u] = wn[u];
          t[u] = tn[u];
        }
      }
      s[0] = add(0.0, dot_atom(f, v));
      s[1] = add(0.0, dot_atom(f, f));
      s[2] = add(0.0, dot_atom(v, v));
      s[3] = fmax(0.0, dot_atom(f, f));
    }
    laps.lap(L_PAIRS);
    butterfly(s);
    reduce(s);
    laps.lap(L_RED1);
    ++steps;
    laps.add(L_STEPS, 1);
    if (sqrt(s[3]) < fmax_) {
      done = true;
      break;
    }
    bool uphill;
    double keep, v_norm, fden, dt_new, alpha;
    fire.step(s, uphill, keep, v_norm, fden, dt_new, alpha);
    double st[3] = {0.0, 0.0, 0.0};
    if (own)
      fire_velocity(f, v, st, uphill, keep, alpha, v_norm, fden, dt_new);
    double q[4] = {0.0, 0.0, 0.0, own ? fmax(0.0, dot_atom(st, st)) : 0.0};
    laps.lap(L_UPDATE);
    butterfly(q);
    reduce(q);
    laps.lap(L_RED2);
    const double scale = fmin(quot(STEP_CAP, fmax(sqrt(q[3]), FLOOR)), 1.0);
    if (own)
      for (int k = 0; k < 3; ++k) {
        const double stepped = v[k];
        const double nx = add(c[3 * a + k], mul(mul(dt_new, stepped), scale));
        for (int r = 0; r < cl; ++r)
          cluster.map_shared_rank(c, r)[3 * a + k] = nx;
        v[k] = mul(stepped, scale);
      }
    cluster.sync();
    laps.lap(L_MOVE);
  }
  if (own)
    for (int k = 0; k < 3; ++k) xo[3 * a + k] = c[3 * a + k];
  if (rank == 0 && tid == 0) {
    done_out[b] = done;
    steps_out[b] = steps;
  }
  laps.lap(L_SETUP);
  laps.flush(b, rank == 0 && tid == 0);
  // no block leaves while another may still write into its memory
  cluster.sync();
}

const void* form_kernel(int form) {
  return form == FORM_LONE ? (const void*)idpp_lone_kernel
                           : (const void*)idpp_cluster_kernel;
}

int opt_in(int form, long long bytes, int cl) {
  static long long done[2][MAX_DEVICES] = {{0}};
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const void* fn = form_kernel(form);
  if (bytes > STATIC_SMEM && done[form][dev] < bytes) {
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err) return err;
    done[form][dev] = bytes;
  }
  if (form == FORM_CLUSTER && cl > PORTABLE_CLUSTER)
    err = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

}  // namespace

extern "C" {

int idpp_fire_f64(const void* chain, const void* targets,
                  const void* weights, void* out, void* done, void* steps,
                  int I, int N, int form, int threads, long long smem,
                  int cl, int n_steps, double dt0, double fmax,
                  void* stream) {
  if (I <= 0) return 0;
  if (N <= 0 || (form != FORM_LONE && form != FORM_CLUSTER) ||
      (form == FORM_LONE &&
       (N > LONE_ATOMS || threads != 32 * LONE_WARPS || cl != 1 ||
        smem != lone_bytes(N))) ||
      (form == FORM_CLUSTER &&
       (threads <= 0 || threads % 32 || threads > MAX_THREADS || cl < 1 ||
        cl > MAX_CLUSTER || (long long)threads * cl < N ||
        smem != cluster_bytes(N))))
    return (int)cudaErrorInvalidValue;
  int err = opt_in(form, smem, cl);
  if (err) return err;
  const double* c = static_cast<const double*>(chain);
  const double* tg = static_cast<const double*>(targets);
  const double* w = static_cast<const double*>(weights);
  double* o = static_cast<double*>(out);
  bool* d = static_cast<bool*>(done);
  int* s = static_cast<int*>(steps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == FORM_LONE) {
    idpp_lone_kernel<<<(unsigned)I, threads, (size_t)smem, st>>>(
        c, tg, w, o, d, s, I, N, n_steps, dt0, fmax);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(I * cl), 1, 1);
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
    err = (int)cudaLaunchKernelEx(&cfg, idpp_cluster_kernel, c, tg, w, o, d,
                                  s, I, N, n_steps, dt0, fmax);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}

// out: registers a thread, local (spilled) bytes a thread, resident
// blocks an SM of the form's kernel at `threads` threads and `smem`
// shared bytes
int idpp_info(int form, int threads, long long smem, int* out) {
  if (form != FORM_LONE && form != FORM_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const void* fn = form_kernel(form);
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, fn);
  if (err) return err;
  err = opt_in(form, smem, 1);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, threads, (size_t)smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  return err;
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
