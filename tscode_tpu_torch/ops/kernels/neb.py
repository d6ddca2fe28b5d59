'''
The nudged elastic band's relaxation on the internal force field in one
launch: the hand-written CUDA kernel N1 of `csrc/neb_band.cu` and its
plain PyTorch twin.

Replaces no Pallas kernel: the JAX package runs _neb_relax
(tscode_tpu/neb.py:219) as one jitted program, a lax.scan over the steps
whose body is neb_forces (the image energies, jax.grad of them and the
band composition) and _fire_band_update. Here one launch runs every step
of a band (I, N, 3) in float64: the interior images' energies (the
endpoints' once) and analytic forces (`csrc/ff_forces.cuh`), the upwind
tangents, the projection, the springs and the climbing image, and the
band's FIRE update with its scalar controls. The band leaves its loop
once `done` has latched (its chain no longer moves, so the output equals
the scan's full length). The terms are those of ff.FireTerms, the tables
kept on the bonds tensor (ff_fire.packed_terms, ff.incidence).

The kernel has three forms (`launch_plan` picks one from I, N and the
terms; `launch(..., form=...)` asks for one): 'lone' (one block a band,
all of it in shared memory), 'large' (a thread-block cluster a band, its
interior images dealt to the blocks in order, their arrays in shared
memory where they fit, else in device memory: any I and N) and 'grid'
(a cooperative grid a band: the term pass of every interior image spread
over all its blocks, grid barriers between the phases, every array in
device memory). The forms give the same bits.

`neb_relax_plain` runs the same steps in plain PyTorch: the image
energies by ff_fire.ff_energy_plain (the kernel's order), the forces by
ff_fire.ff_forces_plain, the band composition of neb.band_forces and
optimizers.fire_band_update; it stops once `done` latches and counts the
near ties of the energy comparisons that steer the band
(`band_near_ties`). On a CPU tensor `neb_band` runs the twin; on a CUDA
tensor it launches the kernel or raises.
'''

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tscode_tpu_torch.ff import incidence
from tscode_tpu_torch.ops.kernels._build import (CudaKernel, device_guard,
                                                 ptr, stream_of)
from tscode_tpu_torch.ops.kernels.ff_fire import (SMEM_BYTES, _spring_args,
                                                  ff_energy_plain,
                                                  ff_forces_plain,
                                                  packed_terms)

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double

KERNEL = CudaKernel('neb_band', {'neb_band_f64': (
    _P, _P, _P, _P, _P,            # chain, out, done, steps, work
    _I, _I, _P,                    # I, N, the plan (host array)
    _I, _I, _I, _I, _D,            # NB, NA, NP, ND, bond_k
    _P, _P, _P, _P,                # packed atoms, t0, incidence offsets, codes
    _P, _P, _L, _P,                # springs, targets, C, k (0-dim)
    _P, _L, _P,                    # half-springs, H, k (0-dim)
    _I, _D, _D, _D, _I,            # n_steps, k_spring, dt0, fmax, climbing
    _P)})                          # stream

FORMS = ('lone', 'large', 'grid')
_FORM_ID = {'lone': 0, 'large': 1, 'grid': 2}
# a block's threads (csrc MAX_THREADS)
MAX_THREADS = 512
# the large form: blocks a band at most (the portable cluster size)
MAX_CLUSTER = 8
# the rule's lone form at most this many interior atoms (I - 2) N: phase
# 19b's sweep on the card (chip_smoke.py --neb) found the lone form
# faster on HCOOH's band (25 interior atoms: 8.99 us a step, the large
# form 11.85 to 13.22) and the large form on 5 blocks faster from phase
# 19's band up (135: 14.86 against 22.00; 750, the 150-atom chain:
# 101.93 against 292.65)
LONE_MAX_ATOMS = 64
# the rule's grid form from this many interior atoms (I - 2) N: the sweep
# (chip_smoke.py --neb, neb_crossover) found the large form on 5 blocks
# faster at 500 (53.8 against 58.8 us a step) and the grid faster at 750
# (102 against 77 us), 1,000 (153 against 100), 2,500 (777 against 308)
# and 12,500 (27.5 against 6.5 ms)
GRID_MIN_ATOMS = 550
# the grid form: blocks a band where the card is not asked (an H100
# SXM's SMs, one block of 512 threads an SM)
GRID_BLOCKS = 132
# the energy slots' kinds: bonds, angles, repulsion pairs, dihedrals,
# springs, half-springs (csrc KINDS)
KINDS = 6
# the band partial sums of an image (csrc N_RED)
N_RED = 5
# |e_a - e_b| below this (kcal/mol) at a comparison that steers the band
# is a near tie: two summation orders may decide it differently
NEAR_TIE = 1e-9


class Plan(NamedTuple):
    '''A launch of the kernel: its form, threads a block, dynamic shared
    bytes a block, blocks a band (a cluster), lanes an atom of the force
    walk, whether the large form's arrays sit in shared memory, and the
    energy slots (the first slot of each kind, then the slots an
    image).'''
    form: str
    threads: int
    smem: int
    cluster: int = 1
    lanes: int = 1
    shared: bool = True
    slots: tuple = ((0,) * KINDS, 0)

    def args(self):
        '''The plan as the kernel's host array (csrc/neb_band.cu
        PlanField).'''
        lo, n = self.slots
        return (ctypes.c_longlong * (7 + KINDS))(
            _FORM_ID[self.form], self.threads, self.smem, self.cluster,
            self.lanes, int(self.shared), n, *lo)


def energy_slots(kinds):
    '''((first slot of each kind), slots an image) of the kernel's
    energy pass: each of the KINDS kinds from a multiple of 32.'''
    lo, n = [], 0
    for count in kinds:
        lo.append(n)
        n += 32 * -(-count // 32)
    return tuple(lo), n


def _lanes(items):
    '''The most lanes an atom (a power of two up to 32) that keep a
    block's `items` atoms within MAX_THREADS threads.'''
    g = 32
    while g > 1 and items * g > MAX_THREADS:
        g //= 2
    return g


def lone_values(n_images, n_atoms, n_chunks):
    '''The lone form's shared values (csrc lone_values).'''
    n3, M = 3 * n_atoms, n_images - 2
    return n_images * n3 + 3 * M * n3 + n_images * n_chunks + n_images + \
        N_RED * M


def large_values(n_images, n_atoms, cluster, shared):
    '''The large form's shared values a block (csrc large_values).'''
    M = n_images - 2
    per = -(-M // cluster)
    return (4 * per * 3 * n_atoms if shared else 0) + n_images + N_RED * M


def work_values(plan, n_images, n_atoms):
    '''The values in device memory (csrc neb_band_kernel's `work`) of
    the large form: the interior images' coordinates, velocities, forces
    and tangents and the energies' chunk sums; of the grid form also the
    energies and the band partial sums; none for the lone form.'''
    if plan.form == 'lone':
        return 0
    large = 4 * (n_images - 2) * 3 * n_atoms + n_images * plan.slots[1] // 32
    if plan.form == 'grid':
        return large + n_images + N_RED * (n_images - 2)
    return large


def _grid_shape(items, most):
    '''(blocks, lanes an atom) of the grid form for `items` interior
    atoms on at most `most` blocks: the most lanes (a power of two up to
    32) that keep the atoms within the blocks' threads, then the blocks
    those lanes need.'''
    g = 32
    while g > 1 and items * g > most * MAX_THREADS:
        g //= 2
    return max(1, min(most, -(-items * g // MAX_THREADS))), g


def launch_plan(n_images, n_atoms, kinds, form=None, cluster=None,
                grid_blocks=GRID_BLOCKS):
    '''The kernel's Plan for a band of n_images images of n_atoms atoms
    under the terms `kinds` (the counts of bonds, angles, repulsion
    pairs, dihedrals, springs, half-springs), float64. The rule: 'lone'
    (512 threads, the walk's lanes the most that keep the interior
    images' atoms within them) up to LONE_MAX_ATOMS interior atoms where
    its shared memory fits, 'grid' from GRID_MIN_ATOMS, else 'large' (a
    cluster of min(I - 2, MAX_CLUSTER) blocks, or `cluster`, each
    ceil((I - 2) / cluster) interior images; its four arrays in shared
    memory where they fit).
    `form` asks for one (ValueError where the lone form does not fit);
    'grid' on `cluster` blocks or those _grid_shape takes of the
    `grid_blocks` that stay resident on the card.'''
    if form is not None and form not in FORMS:
        raise ValueError(f'neb form {form!r}: one of {FORMS}')
    if n_images < 3 or n_atoms < 1:
        raise ValueError(f'neb band: {n_images} images of {n_atoms} atoms '
                         f'(at least 3 images of 1 atom)')
    if len(kinds) != KINDS:
        raise ValueError(f'neb band: {len(kinds)} term kinds, not {KINDS}')
    M = n_images - 2
    lo, n = energy_slots(kinds)
    lone = Plan('lone', MAX_THREADS,
                8 * lone_values(n_images, n_atoms, n // 32), 1,
                _lanes(M * n_atoms), True, (lo, n))
    if form == 'lone' or (form is None and cluster is None and
                          M * n_atoms <= LONE_MAX_ATOMS and
                          lone.smem <= SMEM_BYTES):
        if lone.smem > SMEM_BYTES:
            raise ValueError(
                f'neb form \'lone\' needs {lone.smem} shared bytes for '
                f'{n_images} images of {n_atoms} atoms, past {SMEM_BYTES}')
        return lone
    if form is None and cluster is None and M * n_atoms >= GRID_MIN_ATOMS:
        form = 'grid'
    if form == 'grid':
        most = grid_blocks if cluster is None else cluster
        if not 1 <= most <= grid_blocks:
            raise ValueError(f'neb grid form: {cluster} blocks a band, not '
                             f'1 to {grid_blocks}')
        blocks, lanes = _grid_shape(M * n_atoms, most)
        return Plan('grid', MAX_THREADS, 0,
                    blocks if cluster is None else cluster, lanes, False,
                    (lo, n))
    cl = min(M, MAX_CLUSTER) if cluster is None else cluster
    if not 1 <= cl <= min(M, MAX_CLUSTER):
        raise ValueError(f'neb large form: {cl} blocks a band, not 1 to '
                         f'{min(M, MAX_CLUSTER)}')
    per = -(-M // cl)
    shared = 8 * large_values(n_images, n_atoms, cl, True) <= SMEM_BYTES
    return Plan('large', MAX_THREADS,
                8 * large_values(n_images, n_atoms, cl, shared), cl,
                _lanes(per * n_atoms), shared, (lo, n))


def term_kinds(terms):
    '''The counts of the KINDS kinds of ff.FireTerms `terms`.'''
    def rows(t):
        return 0 if t is None else int(t.shape[0])
    return tuple(int(t.shape[0]) for t in terms.tables()[0::2]) + (
        rows(terms.spring_pairs), rows(terms.half_pairs))


_GRID_RESIDENT = {}


def grid_resident(device):
    '''The blocks of the grid form that stay resident together on the
    card `device` (its SMs times the blocks an SM holds), once a
    card.'''
    key = torch.device(device).index
    if key not in _GRID_RESIDENT:
        probe = Plan('grid', MAX_THREADS, 0)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _GRID_RESIDENT[key] = sms * kernel_info(probe, device)['blocks_per_sm']
    return _GRID_RESIDENT[key]


def plan_for(chain, terms, form=None, cluster=None):
    '''The Plan that launch takes for chain (I, N, 3) under ff.FireTerms
    `terms` (in the form `form` names, or by the rule); the grid form on
    the blocks that stay resident on a CUDA chain's card.'''
    args = (chain.shape[0], chain.shape[1], term_kinds(terms), form,
            cluster)
    plan = launch_plan(*args)
    if plan.form == 'grid' and chain.device.type == 'cuda':
        plan = launch_plan(*args, grid_resident(chain.device))
    return plan


# ------------------------------------------------------------ plain twin


def steering_pairs(n_images, energies, climbing):
    '''The image pairs (a, b), a < b, whose energies the step compares:
    each interior image against both neighbours and its neighbours
    against each other (the upwind tangent), and with `climbing` the
    first highest interior image against every other interior one.'''
    pairs = set()
    for i in range(1, n_images - 1):
        pairs.update({(i - 1, i), (i, i + 1), (i - 1, i + 1)})
    if climbing:
        top = 1 + int(np.argmax(energies[1:-1]))
        pairs.update((min(top, j), max(top, j))
                     for j in range(1, n_images - 1) if j != top)
    return pairs


def neb_relax_plain(chain, terms, n_steps, k_spring=1.0, dt0=0.01,
                    fmax=0.05, climbing=False):
    '''Plain PyTorch twin of `neb_band`: from rest, each step the image
    energies (ff_energy_plain) and the interior images' forces
    (ff_forces_plain), neb.band_forces and optimizers.fire_band_update;
    the loop ends once `done` has latched. Returns (chain, done 0-dim
    bool, steps taken 0-dim int32, the step that latched `done`
    included, band_near_ties: the image pairs whose energies lay within
    NEAR_TIE of each other at a comparison of some step).'''
    from tscode_tpu_torch.neb import band_forces
    from tscode_tpu_torch.optimizers import fire_band_init, fire_band_update
    dt0 = chain.new_tensor(dt0)
    state = fire_band_init(chain.clone(), dt0)
    steps, ties = 0, set()
    for _ in range(n_steps):
        c = state[0]
        energies = ff_energy_plain(c, terms)
        e = energies.cpu().numpy()
        ties.update(p for p in steering_pairs(len(e), e, climbing)
                    if abs(e[p[0]] - e[p[1]]) < NEAR_TIE)
        grad = torch.zeros_like(c)
        grad[1:-1] = -ff_forces_plain(c[1:-1], terms)
        f = band_forces(c, energies, grad, k_spring=k_spring,
                        climbing=climbing)
        state = fire_band_update(state, f, dt0, fmax)
        steps += 1
        if bool(state[5]):
            break
    return (state[0], state[5].clone(),
            torch.tensor(steps, dtype=torch.int32, device=chain.device),
            len(ties))


# ---------------------------------------------------------------- kernel


def _check(chain):
    if chain.dtype != torch.float64:
        raise TypeError(f'neb_band takes float64, got {chain.dtype}')
    if chain.dim() != 3 or chain.shape[2] != 3 or chain.shape[0] < 3 or \
            chain.shape[1] == 0:
        raise ValueError(f'chain must be (I, N, 3) with I >= 3 and N > 0, '
                         f'got {tuple(chain.shape)}')


def launch(chain, terms, n_steps, k_spring=1.0, dt0=0.01, fmax=0.05,
           climbing=False, form=None, plan=None):
    '''The kernel's launch on a CUDA chain: (chain, done 0-dim bool,
    steps taken 0-dim int32), on `plan` or plan_for's plan for these
    shapes, in the form `form` names (one of FORMS: the checks and
    timings of every form) or by the rule.'''
    _check(chain)
    dev = chain.device
    chain = chain.contiguous()
    I, N = chain.shape[0], chain.shape[1]
    out = torch.empty_like(chain)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    if plan is None:
        plan = plan_for(chain, terms, form)
    offsets, codes, _ = incidence(terms.params, N)
    atoms, _, t0 = packed_terms(terms.params, N, torch.float64)
    kinds = term_kinds(terms)[:4]
    n_work = work_values(plan, I, N)
    work = torch.empty(n_work, dtype=torch.float64, device=dev) \
        if n_work else None
    springs, held = _spring_args(terms, chain)
    KERNEL.launch(
        'neb_band_f64', ptr(chain), ptr(out), ptr(done), ptr(steps),
        ptr(work) if work is not None else None, I, N, plan.args(), *kinds,
        ctypes.c_double(terms.bond_k), ptr(atoms), ptr(t0), ptr(offsets),
        ptr(codes), *springs, int(n_steps), float(k_spring), float(dt0),
        float(fmax), int(bool(climbing)), stream_of(chain), device=dev,
        wrapper='neb_band')
    return out, done, steps


def kernel_info(plan, device):
    '''{registers, local_bytes, blocks_per_sm, resident_warps} of the
    kernel that `plan` launches on the card `device`.'''
    got = (ctypes.c_int * 3)()
    lib = KERNEL.build()
    fn = lib.neb_info
    fn.argtypes = [_P, _P]
    fn.restype = _I
    with device_guard(device):
        code = fn(plan.args(), got)
    if code != 0:
        raise RuntimeError(f'neb kernel_info: cudaError {code} '
                           f'({lib.tt_error_string(code).decode()})')
    return {'registers': got[0], 'local_bytes': got[1],
            'blocks_per_sm': got[2],
            'resident_warps': got[2] * plan.threads // 32}


def neb_band(chain, terms, n_steps, k_spring=1.0, dt0=0.01, fmax=0.05,
             climbing=False):
    '''At most n_steps FIRE steps of the band chain (I, N, 3) float64 from
    rest on the terms of ff.FireTerms `terms`, its endpoints fixed, the
    first highest interior image climbing when `climbing`. Returns
    (chain, done 0-dim bool, steps taken 0-dim int32): the chain of the
    JAX package's _neb_relax. On a CUDA tensor one launch of the kernel,
    on a CPU tensor the plain twin.'''
    if chain.device.type == 'cpu':
        _check(chain)
        return neb_relax_plain(chain, terms, n_steps, k_spring, dt0, fmax,
                               climbing)[:3]
    return launch(chain, terms, n_steps, k_spring, dt0, fmax, climbing)
