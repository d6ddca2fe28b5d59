'''
FIRE on the IDPP objective in one launch: the hand-written CUDA kernel I1
of `csrc/idpp_fire.cu` and its plain PyTorch twin.

Replaces no Pallas kernel: the JAX package relaxes the IDPP starting band
(tscode_tpu/neb.py:35 idpp_interpolate) as one jitted program,
fire_minimize_batch (tscode_tpu/optimizers.py:41) on jax.grad of
_idpp_energy (neb.py:27) with the endpoints frozen. Here one launch runs
every step of every image, a block an image, in float64: the analytic
IDPP forces (both orderings of every pair, each atom's pairs in
ascending order) and optimizers.fire_step's per-image FIRE, each image
leaving its loop once it has stopped (its coordinates no longer move, so
the outputs equal the scan's masked steps); the endpoints are frozen.

`idpp_fire_plain` runs the same steps in plain PyTorch (idpp_forces_plain
in the kernel's order under optimizers.fire_step). On a CPU tensor
`idpp_fire` runs the twin; on a CUDA tensor it launches the kernel or
raises.
'''

import ctypes

import torch

from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double

KERNEL = CudaKernel('idpp_fire', {'idpp_fire_f64': (
    _P, _P, _P, _P,                # chain, targets, weights, out
    _P, _P, _P,                    # done, steps, work
    _I, _I, _I, _L,                # I, N, threads, shared bytes
    _I, _D, _D,                    # n_steps, dt0, fmax
    _P)})                          # stream

# a block's threads at most (csrc MAX_THREADS)
MAX_THREADS = 512
# the floor under the square root of a pair distance (neb._idpp_energy)
D_EPS = 1e-12


def launch_plan(n_atoms):
    '''(threads, shared bytes) of the kernel's block for images of
    n_atoms atoms: a thread an atom in whole warps up to MAX_THREADS;
    the image's coordinates and the reductions' chunk values, float64
    (csrc idpp_values).'''
    threads = min(MAX_THREADS, 32 * -(-n_atoms // 32))
    return threads, 8 * (3 * n_atoms + 8 * -(-n_atoms // 32))


def idpp_forces_plain(chain, targets, weights):
    '''The IDPP forces (I, N, 3) of chain (I, N, 3) on the tables
    (I, N, N), analytic, in the kernel's order: atom a's force minus the
    sum, in ascending j != a, of 2 (w_aj (d - t_aj) + w_ja (d - t_ja)) /
    d (x_a - x_j), d = sqrt(|x_a - x_j|^2 + 1e-12) (cumsum: sequential
    on the CPU).'''
    diff = chain[:, :, None, :] - chain[:, None, :, :]
    dx, dy, dz = diff.unbind(-1)
    d = torch.sqrt(dx * dx + dy * dy + dz * dz + D_EPS)
    wt, tt = weights.transpose(1, 2), targets.transpose(1, 2)
    g = 2 * (weights * (d - targets) + wt * (d - tt)) / d
    eye = torch.eye(chain.shape[1], dtype=torch.bool, device=chain.device)
    g = torch.where(eye, 0.0, g)
    return -torch.cumsum(g[..., None] * diff, dim=2)[:, :, -1]


def idpp_fire_plain(chain, targets, weights, n_steps=300, dt0=0.05,
                    fmax=0.05):
    '''Plain PyTorch twin of `idpp_fire`: optimizers.fire_step on
    idpp_forces_plain from rest, the endpoint images' forces zero, each
    image stopped once its largest atomic force is under fmax; the loop
    ends when every image has. Returns (chain, done (I,) bool, force
    evaluations (I,) int32).'''
    from tscode_tpu_torch.optimizers import fire_init, fire_step
    state = fire_init(chain, dt0)
    steps = torch.zeros(chain.shape[0], dtype=torch.int32,
                        device=chain.device)
    for _ in range(n_steps):
        if bool(state[5].all()):
            break
        steps += (~state[5]).to(torch.int32)
        f = idpp_forces_plain(state[0], targets, weights)
        f[0] = 0.0
        f[-1] = 0.0
        state = fire_step(state, f, dt0, fmax)
    return state[0], state[5], steps


def _check(chain, targets, weights):
    for name, t in (('chain', chain), ('targets', targets),
                    ('weights', weights)):
        if t.dtype != torch.float64:
            raise TypeError(f'idpp_fire takes float64, got {t.dtype} '
                            f'({name})')
    if chain.dim() != 3 or chain.shape[2] != 3 or chain.shape[1] == 0:
        raise ValueError(f'chain must be (I, N, 3) with N > 0, got '
                         f'{tuple(chain.shape)}')
    want = (chain.shape[0], chain.shape[1], chain.shape[1])
    if tuple(targets.shape) != want or tuple(weights.shape) != want:
        raise ValueError(f'targets and weights must be {want}, got '
                         f'{tuple(targets.shape)} and '
                         f'{tuple(weights.shape)}')


def launch(chain, targets, weights, n_steps=300, dt0=0.05, fmax=0.05):
    '''The kernel's launch on CUDA tensors: (chain, done (I,) bool, force
    evaluations (I,) int32).'''
    _check(chain, targets, weights)
    dev = chain.device
    chain, targets, weights = (t.contiguous()
                               for t in (chain, targets, weights))
    I, N = chain.shape[0], chain.shape[1]
    out = torch.empty_like(chain)
    done = torch.zeros(I, dtype=torch.bool, device=dev)
    steps = torch.zeros(I, dtype=torch.int32, device=dev)
    if I == 0:
        return out, done, steps
    threads, smem = launch_plan(N)
    # each image's velocities and forces
    work = torch.empty(2 * chain.numel(), dtype=torch.float64, device=dev)
    KERNEL.launch(
        'idpp_fire_f64', ptr(chain), ptr(targets), ptr(weights), ptr(out),
        ptr(done), ptr(steps), ptr(work), I, N, threads, smem, int(n_steps),
        float(dt0), float(fmax), stream_of(chain), device=dev,
        wrapper='idpp_fire')
    return out, done, steps


def idpp_fire(chain, targets, weights, n_steps=300, dt0=0.05, fmax=0.05):
    '''FIRE from rest on the IDPP objective of the tables targets,
    weights (I, N, N) for at most n_steps steps: chain (I, N, 3)
    float64, its first and last image frozen. Returns (chain, done (I,)
    bool, force evaluations (I,) int32), the coordinates and stop flags
    of the JAX package's fire_minimize_batch in idpp_interpolate. On a
    CUDA tensor one launch of the kernel, on a CPU tensor the plain
    twin.'''
    if chain.device.type == 'cpu':
        _check(chain, targets, weights)
        return idpp_fire_plain(chain, targets, weights, n_steps, dt0, fmax)
    return launch(chain, targets, weights, n_steps, dt0, fmax)
