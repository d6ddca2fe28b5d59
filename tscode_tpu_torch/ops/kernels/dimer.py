'''
The dimer saddle search on the internal force field in one launch: the
hand-written CUDA kernel D1 of `csrc/dimer.cu` and its plain PyTorch
twin.

Replaces no Pallas kernel: the JAX package runs dimer_saddle
(tscode_tpu/saddle.py:21) as one jitted program, a lax.scan over the
steps whose body is the dimer step on jax.grad of the energy. Here one
launch runs every step of a batch of structures, a block a structure:
saddle._dimer_step's arithmetic (4 power steps, the shift sigma,
n_rot shifted power steps, the curvature, the force, the climbing rule,
the done latch, the step clipped to 0.1 A) on the analytic forces of
`csrc/ff_forces.cuh`, each finite-difference Hessian action the forces
of two displaced copies. A structure leaves its loop once `done` has
latched (its coordinates no longer move, so the outputs equal the
scan's full length). The terms are those of ff.FireTerms, the tables
kept on the bonds tensor (ff_fire.packed_terms, ff.incidence).

The kernel has three forms, one block a structure in each
(`launch_plan` picks one from the atoms, the terms and the entries):
'staged' (the state and each incidence entry's force in shared memory,
a thread a term slot), 'atom' (the state in shared memory, each atom's
terms computed by its thread) and 'device' (the state in device memory:
any N).

`dimer_plain` runs the same steps in plain PyTorch on
ff_fire.ff_forces_plain (analytic forces in the kernel's order) and
stops once every structure is done; `dimer_step_plain` is its step. On a
CPU tensor `dimer` runs the plain twin; on a CUDA tensor it launches the
kernel or raises.
'''

import ctypes
from typing import NamedTuple

import torch

from tscode_tpu_torch.ff import incidence
from tscode_tpu_torch.ops.kernels._build import (CudaKernel, device_guard,
                                                 ptr, stream_of)
from tscode_tpu_torch.ops.kernels.ff_fire import (SMEM_BYTES, _spring_args,
                                                  ff_forces_plain,
                                                  packed_terms)

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double


def _entry(real):
    return (_P, _P, _P, _P, _P, _P,        # coords, v0, out, done, steps, work
            _L, _I, _P,                    # B, N, the plan (host array)
            _I, _I, _I, _I, real,          # NB, NA, NP, ND, bond_k
            _P, _P, _P,                    # packed atoms, entries, t0
            _P, _P,                        # incidence offsets, codes
            _P, _P, _L, _P,                # springs, targets, C, k (0-dim)
            _P, _L, _P,                    # half-springs, H, k (0-dim)
            _I, _I, _D, _D, _D,            # n_steps, n_rot, dr, step, fmax
            _P)                            # stream


KERNEL = CudaKernel('dimer', {'dimer_f32': _entry(ctypes.c_float),
                              'dimer_f64': _entry(ctypes.c_double)})
_REAL = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}

FORMS = ('staged', 'atom', 'device')
_FORM_ID = {'staged': 0, 'atom': 1, 'device': 2}
# a block's threads at most (csrc MAX_THREADS)
MAX_THREADS = 512
# the state of a structure: c, v, u and the two copies' forces, 3 N
# values each (csrc STATE)
STATE = 5


class Plan(NamedTuple):
    '''A launch of the kernel: its form, threads a block and dynamic
    shared bytes a block.'''
    form: str
    threads: int
    smem: int

    def args(self, n_entries):
        '''The plan as the kernel's host array (csrc/dimer.cu
        PlanField).'''
        return (ctypes.c_longlong * 4)(_FORM_ID[self.form], self.threads,
                                       self.smem, n_entries)


def launch_plan(n_atoms, n_terms, n_entries, itemsize, form=None):
    '''The kernel's Plan for structures of n_atoms atoms under n_terms
    force-field terms with n_entries incidence entries, itemsize bytes
    a value. The rule: 'staged' where the state (STATE x 3 N values) and
    both copies' entry forces (2 x 3 E) fit a block's shared memory,
    threads for each (copy, term) slot and (copy, atom) up to
    MAX_THREADS; else 'atom' where the state fits, a thread for each
    (copy, atom); else 'device'. `form` asks for one form (ValueError
    where its shared memory does not fit).'''
    if form is not None and form not in FORMS:
        raise ValueError(f'dimer form {form!r}: one of {FORMS}')

    def threads(width):
        return min(MAX_THREADS, 32 * max(1, -(-width // 32)))

    state = STATE * 3 * n_atoms * itemsize
    plans = {
        'staged': Plan('staged', threads(2 * max(n_terms, n_atoms)),
                       state + 2 * 3 * n_entries * itemsize),
        'atom': Plan('atom', threads(2 * n_atoms), state),
        'device': Plan('device', threads(2 * n_atoms), 0)}
    if form is not None:
        plan = plans[form]
        if plan.smem > SMEM_BYTES:
            raise ValueError(
                f'dimer form {form!r} needs {plan.smem} shared bytes a block '
                f'for {n_atoms} atoms and {n_entries} entries, past '
                f'{SMEM_BYTES}')
        return plan
    for name in ('staged', 'atom'):
        if plans[name].smem <= SMEM_BYTES:
            return plans[name]
    return plans['device']


def plan_for(coords, terms, form=None):
    '''The Plan that launch takes for coords (B, N, 3) under ff.FireTerms
    `terms` (in the form `form` names, or by the rule).'''
    N = coords.shape[1]
    n_terms = sum(int(t.shape[0]) for t in terms.tables()[0::2])
    return launch_plan(N, n_terms, incidence(terms.params, N)[1].numel(),
                       coords.element_size(), form)


# ------------------------------------------------------------ plain twin


def _dot(a, b):
    '''(B,): the sum of a * b over each structure.'''
    return torch.sum(a * b, dim=(1, 2))


def _project(v):
    '''v less its mean over the atoms (not for one atom: a point on an
    analytic surface is not translation invariant).'''
    if v.shape[1] > 1:
        v = v - torch.mean(v, dim=1, keepdim=True)
    return v


def _normalize(v):
    n = torch.linalg.norm(v.flatten(1), dim=1)
    return v / torch.clamp(n, min=1e-12)[:, None, None]


def dimer_step_plain(state, terms, n_rot=12, dr=1e-3, step_size=0.02,
                     fmax=0.05):
    '''One dimer step of every structure, saddle._dimer_step's
    arithmetic on ff_forces_plain: state (c (B, N, 3), v (B, N, 3), done
    (B,) bool) -> the next state.'''
    c, v, done = state
    B = c.shape[0]

    def hv(x):
        f = ff_forces_plain(torch.cat([c + dr * x, c - dr * x]), terms)
        return -(f[:B] - f[B:]) / (2 * dr)

    u = v
    for _ in range(4):
        u = _normalize(_project(hv(u)))
    sigma = 1.1 * torch.abs(_dot(u, hv(u))) + 1.0
    for _ in range(n_rot):
        v = _normalize(_project(sigma[:, None, None] * v - hv(v)))
    curv = _dot(v, hv(v))

    f = ff_forces_plain(c, terms)
    f_par = _dot(f, v)[:, None, None] * v
    fmax_now = torch.amax(torch.linalg.norm(f, dim=-1), dim=-1)
    climbing = (curv >= 0.0) & (fmax_now < 10.0 * fmax)
    f_eff = torch.where(climbing[:, None, None], -f_par + fmax * v,
                        f - 2.0 * f_par)
    done_new = done | ((fmax_now < fmax) & (curv < 0.0))
    step = step_size * f_eff
    max_disp = torch.amax(torch.linalg.norm(step, dim=-1), dim=-1)
    step = step * torch.clamp(0.1 / torch.clamp(max_disp, min=1e-12),
                              max=1.0)[:, None, None]
    return torch.where(done_new[:, None, None], c, c + step), v, done_new


def dimer_start_batch(coords):
    '''saddle.dimer_start's initial mode (it depends on N alone) for
    every structure of coords (B, N, 3).'''
    from tscode_tpu_torch.saddle import dimer_start
    return dimer_start(coords[0]).expand(coords.shape)


def dimer_plain(coords, terms, n_steps=300, n_rot=12, dr=1e-3,
                step_size=0.02, fmax=0.05):
    '''Plain PyTorch twin of `dimer`: dimer_step_plain from
    saddle.dimer_start's mode, each structure's coordinates frozen once
    its `done` has latched; the loop ends when every structure is done.
    Returns (coords, done (B,) bool, steps taken (B,) int32, the step
    that latched `done` included).'''
    B = coords.shape[0]
    done = torch.zeros(B, dtype=torch.bool, device=coords.device)
    steps = torch.zeros(B, dtype=torch.int32, device=coords.device)
    if B == 0:
        return coords.clone(), done, steps
    state = (coords.clone(), dimer_start_batch(coords), done)
    for _ in range(n_steps):
        if bool(state[2].all()):
            break
        steps += (~state[2]).to(torch.int32)
        state = dimer_step_plain(state, terms, n_rot, dr, step_size, fmax)
    return state[0], state[2], steps


# ---------------------------------------------------------------- kernel


def launch(coords, terms, n_steps=300, n_rot=12, dr=1e-3, step_size=0.02,
           fmax=0.05, form=None):
    '''The kernel's launch on CUDA tensors: (coords, done (B,) bool, steps
    taken (B,) int32), on plan_for's plan for these shapes, in the form
    `form` names (one of FORMS: the checks that every form gives the
    same bits) or by the rule.'''
    if coords.dtype not in _REAL:
        raise TypeError(f'dimer takes float32/float64, got {coords.dtype}')
    if coords.dim() != 3 or coords.shape[2] != 3 or coords.shape[1] == 0:
        raise ValueError(f'coords must be (B, N, 3) with N > 0, got '
                         f'{tuple(coords.shape)}')
    dev, dtype = coords.device, coords.dtype
    coords = coords.contiguous()
    B, N = coords.shape[0], coords.shape[1]
    out = torch.empty_like(coords)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out, done, steps
    v0 = dimer_start_batch(coords)[0].contiguous()
    offsets, codes, _ = incidence(terms.params, N)
    kinds = tuple(int(t.shape[0]) for t in terms.tables()[0::2])
    plan = plan_for(coords, terms, form)
    atoms, entries, t0 = packed_terms(terms.params, N, dtype)
    work = torch.empty(B * STATE * 3 * N, dtype=dtype, device=dev) \
        if plan.form == 'device' else None
    springs, held = _spring_args(terms, coords)
    KERNEL.launch(
        f'dimer_{_SUFFIX[dtype]}', ptr(coords), ptr(v0), ptr(out), ptr(done),
        ptr(steps), ptr(work) if work is not None else None, B, N,
        plan.args(codes.numel()), *kinds, _REAL[dtype](terms.bond_k),
        ptr(atoms), ptr(entries), ptr(t0), ptr(offsets), ptr(codes),
        *springs, int(n_steps), int(n_rot), float(dr), float(step_size),
        float(fmax), stream_of(coords), device=dev, wrapper='dimer')
    return out, done, steps


def kernel_info(plan, dtype, device):
    '''{registers, local_bytes, blocks_per_sm, resident_warps} of the
    kernel that `plan` launches on the card `device`: registers and
    spilled bytes a thread, and the blocks and warps an SM holds at the
    plan's threads and shared bytes (cudaOccupancy...).'''
    got = (ctypes.c_int * 3)()
    lib = KERNEL.build()
    fn = lib.dimer_info
    fn.argtypes = [_P, _I, _P]
    fn.restype = _I
    with device_guard(device):
        code = fn(plan.args(0), int(dtype == torch.float64), got)
    if code != 0:
        raise RuntimeError(f'dimer kernel_info: cudaError {code} '
                           f'({lib.tt_error_string(code).decode()})')
    return {'registers': got[0], 'local_bytes': got[1],
            'blocks_per_sm': got[2],
            'resident_warps': got[2] * plan.threads // 32}


def dimer(coords, terms, n_steps=300, n_rot=12, dr=1e-3, step_size=0.02,
          fmax=0.05):
    '''The dimer saddle search from coords (B, N, 3) float32/float64 on
    the terms of ff.FireTerms `terms`, at most n_steps steps of n_rot
    shifted power steps each. Returns (coords, done (B,) bool, steps
    taken (B,) int32), the coordinates and flags of saddle.dimer_saddle.
    On a CUDA tensor one launch of the kernel, on a CPU tensor the plain
    twin.'''
    if coords.device.type == 'cpu':
        return dimer_plain(coords, terms, n_steps, n_rot, dr, step_size,
                           fmax)
    return launch(coords, terms, n_steps, n_rot, dr, step_size, fmax)
