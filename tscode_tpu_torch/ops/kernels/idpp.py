'''
FIRE on the IDPP objective in one launch: the hand-written CUDA kernel I1
of `csrc/idpp_fire.cu` and its plain PyTorch twin.

Replaces no Pallas kernel: the JAX package relaxes the IDPP starting band
(tscode_tpu/neb.py:35 idpp_interpolate) as one jitted program,
fire_minimize_batch (tscode_tpu/optimizers.py:41) on jax.grad of
_idpp_energy (neb.py:27) with the endpoints frozen. Here one launch runs
every step of every image in float64: the analytic IDPP forces (both
orderings of every pair, each atom's pairs in ascending order) and
optimizers.fire_step's per-image FIRE, each image leaving its loop once
it has stopped (its coordinates no longer move, so the outputs equal the
scan's masked steps); the endpoints are frozen.

The contract: the tables are symmetric, targets[i, a, j] ==
targets[i, j, a] and the same for the weights, to the bit (neb.idpp_tables
builds them so: from distance matrices whose (a, j) and (j, a) entries
are the same IEEE operations). The kernel and its twin read one value of
each table a pair, the column W[j, a], for both of its orderings, which
gives the bits of reading the row and the column; the wrappers refuse an
asymmetric table with ValueError (`check_symmetric`, one comparison of
each table with its transpose on the tables' device, once a table until
it is written to).

The kernel has two forms (`launch_plan`): 'lone' (an image of at most 32
atoms on one block of 4 warps, its tables in shared memory, each
unordered pair evaluated once a step, the atoms' sums and reductions on
one warp by shuffles) and 'cluster' (an image on a thread-block cluster
of up to 16 blocks, a thread an atom, the tables' columns from device
memory). I1's first design, `csrc/idpp_fire_v1.cu`
(a block an image, the row and the column read a pair), stays as the
yardstick: `launch_v1`, its own library; no route launches it.

`idpp_fire_plain` runs the same steps in plain PyTorch (idpp_forces_plain
in the kernel's order under optimizers.fire_step). On a CPU tensor
`idpp_fire` runs the twin; on a CUDA tensor it launches the kernel or
raises.
'''

import ctypes
from typing import NamedTuple

import torch

from tscode_tpu_torch.ops.kernels._build import (CudaKernel, device_guard,
                                                 ptr, stream_of)

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double

KERNEL = CudaKernel('idpp_fire', {'idpp_fire_f64': (
    _P, _P, _P, _P,                # chain, targets, weights, out
    _P, _P,                        # done, steps
    _I, _I, _I, _I, _L, _I,        # I, N, form, threads, shared bytes,
                                   # blocks an image
    _I, _D, _D,                    # n_steps, dt0, fmax
    _P)})                          # stream
# I1's first design (PR 22), kept as the yardstick: its own library
V1_KERNEL = CudaKernel('idpp_fire_v1', {'idpp_fire_f64': (
    _P, _P, _P, _P,                # chain, targets, weights, out
    _P, _P, _P,                    # done, steps, work
    _I, _I, _I, _L,                # I, N, threads, shared bytes
    _I, _D, _D,                    # n_steps, dt0, fmax
    _P)})                          # stream

FORMS = ('lone', 'cluster')
_FORM_ID = {'lone': 0, 'cluster': 1}
# a block's threads at most (csrc MAX_THREADS)
MAX_THREADS = 512
# the lone form: atoms an image at most, threads a block (csrc LONE_ATOMS,
# LONE_WARPS)
LONE_ATOMS = 32
LONE_THREADS = 128
# the cluster form: blocks an image at most (past the portable 8)
MAX_CLUSTER = 16
# the rule's cluster form: blocks enough for at most this many atoms a
# block
CLUSTER_ATOMS = 128
# the floor under the square root of a pair distance (neb._idpp_energy)
D_EPS = 1e-12


class Plan(NamedTuple):
    '''A launch of the kernel: its form, threads a block, dynamic shared
    bytes a block, blocks an image.'''
    form: str
    threads: int
    smem: int
    cluster: int = 1


def launch_plan(n_atoms, form=None, cluster=None):
    '''The kernel's Plan for images of n_atoms atoms. The rule: 'lone'
    up to LONE_ATOMS atoms (LONE_THREADS threads; the coordinates, both
    tables and the pair coefficients, float64, then the unordered pairs
    and a flag, int32, in shared memory), else 'cluster' on ceil(N /
    CLUSTER_ATOMS) blocks (at most MAX_CLUSTER, or `cluster`), each a
    thread an atom of its share in whole warps (the image's coordinates
    and two buffers of the reductions' chunk values, float64). `form`
    asks for one (ValueError where the lone form does not take the
    image).'''
    if form is not None and form not in FORMS:
        raise ValueError(f'idpp form {form!r}: one of {FORMS}')
    N = n_atoms
    if form == 'lone' or (form is None and cluster is None and
                          N <= LONE_ATOMS):
        if N > LONE_ATOMS:
            raise ValueError(f'idpp form \'lone\' takes at most '
                             f'{LONE_ATOMS} atoms, not {N}')
        return Plan('lone', LONE_THREADS, 8 * (3 * N + 3 * N * N) +
                    4 * (N * (N - 1) // 2 + 1))
    cl = min(MAX_CLUSTER, -(-N // CLUSTER_ATOMS)) if cluster is None \
        else cluster
    per = -(-N // cl) if cl >= 1 else 0          # atoms a block
    threads = 32 * -(-per // 32)
    if not 1 <= cl <= MAX_CLUSTER or threads > MAX_THREADS:
        raise ValueError(f'idpp cluster form: {cl} blocks an image of {N} '
                         f'atoms, not 1 to {MAX_CLUSTER} with at most '
                         f'{MAX_THREADS} atoms a block')
    return Plan('cluster', threads, 8 * (3 * N + 8 * -(-N // 32)), cl)


def launch_plan_v1(n_atoms):
    '''(threads, shared bytes) of the first design's block for images of
    n_atoms atoms: a thread an atom in whole warps up to MAX_THREADS;
    the image's coordinates and the reductions' chunk values, float64
    (csrc/idpp_fire_v1.cu idpp_values).'''
    threads = min(MAX_THREADS, 32 * -(-n_atoms // 32))
    return threads, 8 * (3 * n_atoms + 8 * -(-n_atoms // 32))


def idpp_forces_plain(chain, targets, weights):
    '''The IDPP forces (I, N, 3) of chain (I, N, 3) on the symmetric
    tables (I, N, N), analytic, in the kernel's order: atom a's force
    minus the sum, in ascending j != a, of 2 (x + x) / d (x_a - x_j), x =
    w_ja (d - t_ja) (the column's values, for both orderings of the
    pair), d = sqrt(|x_a - x_j|^2 + 1e-12) (cumsum: sequential on the
    CPU).'''
    diff = chain[:, :, None, :] - chain[:, None, :, :]
    dx, dy, dz = diff.unbind(-1)
    d = torch.sqrt(dx * dx + dy * dy + dz * dz + D_EPS)
    x = weights.transpose(1, 2) * (d - targets.transpose(1, 2))
    g = 2 * (x + x) / d
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


def check_symmetric(targets, weights):
    '''ValueError unless both tables equal their transposes to the bit
    (the kernel's contract: it reads one ordering of each pair). A
    table found symmetric is not compared again until it changes (its
    version, which PyTorch bumps on every in-place write).'''
    for name, t in (('targets', targets), ('weights', weights)):
        if t.__dict__.get('_idpp_symmetric') == t._version:
            continue
        if not torch.equal(t, t.transpose(1, 2)):
            raise ValueError(f'idpp_fire takes symmetric tables: {name} '
                             f'[i, a, j] and [i, j, a] differ')
        t.__dict__['_idpp_symmetric'] = t._version


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
    check_symmetric(targets, weights)


def _outputs(chain):
    I = chain.shape[0]
    return (torch.empty_like(chain),
            torch.zeros(I, dtype=torch.bool, device=chain.device),
            torch.zeros(I, dtype=torch.int32, device=chain.device))


def launch(chain, targets, weights, n_steps=300, dt0=0.05, fmax=0.05,
           form=None, plan=None):
    '''The kernel's launch on CUDA tensors: (chain, done (I,) bool, force
    evaluations (I,) int32), on `plan` or launch_plan's plan (in the form
    `form` names, or by the rule).'''
    _check(chain, targets, weights)
    dev = chain.device
    chain, targets, weights = (t.contiguous()
                               for t in (chain, targets, weights))
    I, N = chain.shape[0], chain.shape[1]
    out, done, steps = _outputs(chain)
    if I == 0:
        return out, done, steps
    if plan is None:
        plan = launch_plan(N, form)
    KERNEL.launch(
        'idpp_fire_f64', ptr(chain), ptr(targets), ptr(weights), ptr(out),
        ptr(done), ptr(steps), I, N, _FORM_ID[plan.form], plan.threads,
        plan.smem, plan.cluster, int(n_steps), float(dt0), float(fmax),
        stream_of(chain), device=dev, wrapper='idpp_fire')
    return out, done, steps


def launch_v1(chain, targets, weights, n_steps=300, dt0=0.05, fmax=0.05):
    '''I1's first design on CUDA tensors, the yardstick of the redesign
    (the same bits): (chain, done (I,) bool, force evaluations (I,)
    int32).'''
    _check(chain, targets, weights)
    dev = chain.device
    chain, targets, weights = (t.contiguous()
                               for t in (chain, targets, weights))
    I, N = chain.shape[0], chain.shape[1]
    out, done, steps = _outputs(chain)
    if I == 0:
        return out, done, steps
    threads, smem = launch_plan_v1(N)
    # each image's velocities and forces
    work = torch.empty(2 * chain.numel(), dtype=torch.float64, device=dev)
    V1_KERNEL.launch(
        'idpp_fire_f64', ptr(chain), ptr(targets), ptr(weights), ptr(out),
        ptr(done), ptr(steps), ptr(work), I, N, threads, smem, int(n_steps),
        float(dt0), float(fmax), stream_of(chain), device=dev,
        wrapper='idpp_fire_v1')
    return out, done, steps


def kernel_info(plan, device):
    '''{registers, local_bytes, blocks_per_sm, resident_warps} of the
    form's kernel at the plan's threads and shared bytes on the card
    `device`.'''
    got = (ctypes.c_int * 3)()
    lib = KERNEL.build()
    fn = lib.idpp_info
    fn.argtypes = [_I, _I, _L, _P]
    fn.restype = _I
    with device_guard(device):
        code = fn(_FORM_ID[plan.form], plan.threads, plan.smem, got)
    if code != 0:
        raise RuntimeError(f'idpp kernel_info: cudaError {code} '
                           f'({lib.tt_error_string(code).decode()})')
    return {'registers': got[0], 'local_bytes': got[1],
            'blocks_per_sm': got[2],
            'resident_warps': got[2] * plan.threads // 32}


def idpp_fire(chain, targets, weights, n_steps=300, dt0=0.05, fmax=0.05):
    '''FIRE from rest on the IDPP objective of the symmetric tables
    targets, weights (I, N, N) for at most n_steps steps: chain (I, N, 3)
    float64, its first and last image frozen. Returns (chain, done (I,)
    bool, force evaluations (I,) int32), the coordinates and stop flags
    of the JAX package's fire_minimize_batch in idpp_interpolate. On a
    CUDA tensor one launch of the kernel, on a CPU tensor the plain
    twin.'''
    if chain.device.type == 'cpu':
        _check(chain, targets, weights)
        return idpp_fire_plain(chain, targets, weights, n_steps, dt0, fmax)
    return launch(chain, targets, weights, n_steps, dt0, fmax)
