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
kept on the bonds tensor (ff_fire.packed_terms, ff.incidence,
transposed_entries).

The kernel has three forms (`launch_plan` picks lone or large from the
atoms, the terms and the entries; `launch(..., form=...)` asks for one):
'lone' (a structure on 1 to 16 warps, all of it in shared memory, its
displaced copies written once an action, the force at c evaluated in
the last action's pass), 'large' (a thread-block cluster a structure,
the atoms split between its blocks, its coordinates and copies in each
block's shared memory while they fit, else in device memory: any N)
and 'staged' (the first design, a block a structure, kept as the
yardstick).

`dimer_plain` runs the same steps in plain PyTorch on
ff_fire.ff_forces_plain (analytic forces in the kernel's order) and
stops once every structure is done; `dimer_step_plain` is its step. On a
CPU tensor `dimer` runs the plain twin; on a CUDA tensor it launches the
kernel or raises.
'''

import ctypes
from typing import NamedTuple

import torch

from tscode_tpu_torch.ff import FireTerms, incidence
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

# the forms: the rule picks lone or large; staged (the first design, the
# yardstick) only on request
FORMS = ('lone', 'large', 'staged')
_FORM_ID = {'staged': 0, 'lone': 1, 'large': 2}
# a block's threads at most (csrc MAX_THREADS)
MAX_THREADS = 512
# the state of a structure in the staged form: c, v, u and the two
# copies' forces, 3 N values each
STATE = 5
# the lone form: W warps on one structure, one of LONE_WIDTHS
LONE_WIDTHS = (1, 2, 4, 8, 16)
# the large form: blocks a structure (a cluster), the rule's and the
# most: 16, past the portable 8 (the launch sets
# cudaFuncAttributeNonPortableClusterSizeAllowed). The sweep on the card
# (chip_smoke.py --dimer) found the most blocks fastest on every input
# past the lone form (2,500 atoms: 16 blocks 332 ms, 8 blocks 786; 150
# atoms: 16 and 8 blocks 72.9 ms, 4 84.3, 1 184.6)
MAX_CLUSTER = 16
# the large form's values of device memory a structure past shared
# memory: c, the two copies, and the mode, power, work and hv vectors
# (csrc dimer_large_kernel)
LARGE_WORK = 21


class Plan(NamedTuple):
    '''A launch of the kernel: its form, threads a block, dynamic shared
    bytes a block; the lone form's warps, its term slots (the first slot
    of each kind in a copy's range, then a copy's slots) and the largest
    degree (entries of one atom) its transposed entries are held at; the
    large form's blocks a structure (a cluster), lanes an atom and
    whether its coordinates sit in shared memory.'''
    form: str
    threads: int
    smem: int
    warps: int = 0
    slots: tuple = ((0, 0, 0, 0), 0)
    degree: int = 0
    cluster: int = 1
    lanes: int = 1
    shared: bool = False

    def args(self, n_entries):
        '''The plan as the kernel's host array (csrc/dimer.cu
        PlanField).'''
        lo, n = self.slots
        return (ctypes.c_longlong * 13)(
            _FORM_ID[self.form], self.threads, self.smem, n_entries,
            self.cluster, self.lanes, int(self.shared), n, *lo, self.degree)


def _slots(kinds):
    '''((first slot of each kind), slots) of a copy's term pass, each
    kind from a multiple of 32 so that a warp holds terms of one kind.'''
    lo, n = [], 0
    for count in kinds:
        lo.append(n)
        n += 32 * -(-count // 32)
    return tuple(lo), n


def _lone_plan(n_atoms, kinds, n_entries, itemsize, warps=None,
               degree=None):
    '''The lone form on `warps` warps, by default the rule's: the
    narrowest width of LONE_WIDTHS with a thread for each term slot of the
    two copies and each atom, else the widest. Its shared values (csrc
    lone_values): c, the two copies, the mode, power and work vectors (3
    N each), each entry's force for three copies held transposed (9 N x
    `degree`, the largest degree; by default n_entries / N rounded up,
    a table whose atoms have one degree), the three copies' entry sums
    (9 N), the reductions' chunk values.'''
    lo, n = _slots(kinds)
    if degree is None:
        degree = -(-n_entries // n_atoms)
    if warps is None:
        need = max(-(-2 * n // 32), -(-n_atoms // 32))
        warps = next((w for w in LONE_WIDTHS if w >= need), LONE_WIDTHS[-1])
    if warps not in LONE_WIDTHS:
        raise ValueError(f'dimer lone form: {warps} warps, not one of '
                         f'{LONE_WIDTHS}')
    values = 27 * n_atoms + 9 * degree * n_atoms + 8 * -(-n_atoms // 32)
    return Plan('lone', 32 * warps, values * itemsize, warps, (lo, n),
                degree)


def _large_plan(n_atoms, itemsize, cluster=None):
    '''The large form on `cluster` blocks, by default the rule's:
    MAX_CLUSTER (at most one a structure's atom). A block owns
    ceil(N / cluster) atoms, walked by the most lanes an atom (a power of
    two up to 32) that keep its threads within MAX_THREADS; its shared
    values (csrc large_values) the structure's coordinates and both
    copies and its atoms' four vectors where they fit, else the
    reductions' chunk values alone (the rest in device memory).'''
    if cluster is None:
        cluster = min(MAX_CLUSTER, n_atoms)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f'dimer large form: {cluster} blocks a structure, '
                         f'not 1 to {MAX_CLUSTER}')
    per = -(-n_atoms // cluster)
    lanes = 32
    while lanes > 1 and per * lanes > MAX_THREADS:
        lanes //= 2
    threads = min(MAX_THREADS, 32 * -(-per * lanes // 32))
    red = 8 * -(-per // 32)
    shared = (9 * n_atoms + 12 * per + red) * itemsize <= SMEM_BYTES
    values = 9 * n_atoms + 12 * per + red if shared else red
    return Plan('large', threads, values * itemsize, threads // 32,
                cluster=cluster, lanes=lanes, shared=shared)


def launch_plan(n_atoms, kinds, n_entries, itemsize, form=None,
                warps=None, cluster=None, degree=None):
    '''The kernel's Plan for structures of n_atoms atoms under the force
    field's terms, `kinds` = (bonds, angles, repulsion pairs, dihedrals),
    with n_entries incidence entries, itemsize bytes a value. The rule:
    'lone' where its shared memory fits, else 'large' (any N). `form`
    asks for one form (ValueError where its shared memory does not fit),
    'staged' among them (the state, STATE x 3 N values, and both copies'
    entry forces, 2 x 3 E, a thread for each (copy, term) and (copy,
    atom) up to MAX_THREADS); `warps` and `cluster` set the lone and the
    large form's widths, `degree` the largest number of entries of one
    atom (the lone form's transposed entries).'''
    if form is not None and form not in FORMS:
        raise ValueError(f'dimer form {form!r}: one of {FORMS}')

    def threads(width):
        return min(MAX_THREADS, 32 * max(1, -(-width // 32)))

    state = STATE * 3 * n_atoms * itemsize
    plans = {
        'lone': lambda: _lone_plan(n_atoms, kinds, n_entries, itemsize,
                                   warps, degree),
        'large': lambda: _large_plan(n_atoms, itemsize, cluster),
        'staged': lambda: Plan('staged', threads(2 * max(sum(kinds),
                                                         n_atoms)),
                               state + 2 * 3 * n_entries * itemsize)}
    if form is not None:
        plan = plans[form]()
        if plan.smem > SMEM_BYTES:
            raise ValueError(
                f'dimer form {form!r} needs {plan.smem} shared bytes a block '
                f'for {n_atoms} atoms and {n_entries} entries, past '
                f'{SMEM_BYTES}')
        return plan
    plan = plans['lone']()
    return plan if plan.smem <= SMEM_BYTES else plans['large']()


def transposed_entries(params, n_atoms):
    '''The lone form's staging table and the largest degree, kept on the
    tables' bonds tensor: each term role's position among the entries held
    transposed, atom a's k-th entry (ff.incidence order) at k N + a, (T,
    4) int32 (-1 in the roles a term lacks); and the most entries of one
    atom (one host read a table set).'''
    bonds = params[0]
    kept = bonds.__dict__.setdefault('_dimer_transposed', {})
    key = (n_atoms, len(params))
    if key not in kept:
        offsets, _, pos = incidence(params, n_atoms)
        atoms = torch.cat([torch.nn.functional.pad(t.to(torch.int32),
                                                   (0, 4 - t.shape[1]))
                           for t in FireTerms(tuple(params)).tables()[0::2]])
        pos = pos.view(-1, 4)
        k = pos - offsets[atoms.long()]
        kept[key] = (torch.where(pos >= 0, k * n_atoms + atoms,
                                 -1).to(torch.int32).contiguous(),
                     int((offsets[1:] - offsets[:-1]).max()))
    return kept[key]


def plan_for(coords, terms, form=None, **widths):
    '''The Plan that launch takes for coords (B, N, 3) under ff.FireTerms
    `terms` (in the form `form` names, or by the rule; `widths`: warps=,
    cluster=).'''
    N = coords.shape[1]
    kinds = tuple(int(t.shape[0]) for t in terms.tables()[0::2])
    return launch_plan(N, kinds, incidence(terms.params, N)[1].numel(),
                       coords.element_size(), form,
                       degree=transposed_entries(terms.params, N)[1],
                       **widths)


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
           fmax=0.05, form=None, plan=None):
    '''The kernel's launch on CUDA tensors: (coords, done (B,) bool, steps
    taken (B,) int32), on `plan` or plan_for's plan for these shapes, in
    the form `form` names (one of FORMS: the checks and timings of every
    form) or by the rule.'''
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
    if plan is None:
        plan = plan_for(coords, terms, form)
    atoms, entries, t0 = packed_terms(terms.params, N, dtype)
    if plan.form == 'lone':
        entries = transposed_entries(terms.params, N)[0]
    work = None
    if plan.form == 'large' and not plan.shared:
        work = torch.empty(B * LARGE_WORK * N, dtype=dtype, device=dev)
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
