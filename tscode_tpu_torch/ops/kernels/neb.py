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

A step evaluates each term of an interior image once, for its energy and
its forces: the forces go to the image's entry array, term-major (a pair
term's force on its first atom only, the second's being its exact
negation), and each atom adds its entries in incidence order
(`entry_sources`: each incidence entry's vector and sign), then its
springs; `entry_forces_plain` is that sum in plain PyTorch and gives
ff_fire.ff_forces_plain's bits.

The kernel has three forms (`launch_plan` picks one from I, N and the
terms; `launch(..., form=...)` asks for one): 'lone' (one block a band,
its arrays in shared memory, its entry arrays and the force field's
tables beside them where they fit), 'large' (a
thread-block cluster a band, its interior images dealt to the blocks in
order, their arrays, entry arrays and the tables in shared memory where
they fit, else in device memory: any I and N) and 'grid' (a cooperative
grid a band: the term pass and the atoms' sums of every interior image
spread over all its blocks, grid barriers between the phases, every
array in device memory). The forms give the same bits, and those of
N1's first design, `csrc/neb_band_v1.cu` (its own library, the
yardstick: `launch_v1` on `launch_plan_v1`'s plans; no route launches
it).

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
                                                  packed_terms, term_forces)

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_D = ctypes.c_double

KERNEL = CudaKernel('neb_band', {'neb_band_f64': (
    _P, _P, _P, _P, _P, _L,        # chain, out, done, steps, work, its values
    _I, _I, _P,                    # I, N, the plan (host array)
    _I, _I, _I, _I, _D,            # NB, NA, NP, ND, bond_k
    _P, _P, _P, _P, _L,            # packed atoms, t0, incidence offsets,
                                   # entry sources, entries
    _P, _P, _L, _P,                # springs, targets, C, k (0-dim)
    _P, _L, _P,                    # half-springs, H, k (0-dim)
    _I, _D, _D, _D, _I,            # n_steps, k_spring, dt0, fmax, climbing
    _P)})                          # stream
# N1's first design (PR 22), kept as the yardstick: its own library
V1_KERNEL = CudaKernel('neb_band_v1', {'neb_band_f64': (
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
# the band algebra's groups of warps a block at most (csrc MAX_GROUPS)
MAX_GROUPS = 8
# the rule's lone form at most this many interior atoms (I - 2) N: phase
# 19b's crossover (chip_smoke.py --neb; NVIDIA H100 80GB HBM3, 700 W)
# found the lone form faster at 50 and 100 interior atoms (10- and
# 20-atom chains: 8.1 and 11.1 us a step, the large form on 5 blocks 11.0
# and 11.5), the large form from 135 (phase 19's ring: 10.1 against
# 12.1; 150, the 30-atom chain: 11.9 against 14.4)
LONE_MAX_ATOMS = 120
# the rule's grid form from this many interior atoms (I - 2) N: the same
# crossover found the large form faster at 300 (18.2 against 27.8 us a
# step) and the grid from 500 (29.6 against 32.0; 750, the 150-atom
# chain: 38.3 against 55.3)
GRID_MIN_ATOMS = 400
# PR 22's rule for its kernel (launch_plan_v1)
LONE_MAX_ATOMS_V1 = 64
GRID_MIN_ATOMS_V1 = 550
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
# the vectors an image's entry array holds for a term of each kind (a
# pair term: its force on its first atom alone; csrc kind_width)
KIND_WIDTH = (1, 3, 1, 4)


class Plan(NamedTuple):
    '''A launch of the kernel: its form, threads a block, dynamic shared
    bytes a block, blocks a band (a cluster, or the grid's blocks),
    whether the large form's arrays and its entry arrays and tables sit
    in shared memory, the energy slots (the first slot of each kind,
    then the slots an image) and the values in device memory.'''
    form: str
    threads: int
    smem: int
    cluster: int = 1
    shared: bool = True
    staged: bool = True
    slots: tuple = ((0,) * KINDS, 0)
    work: int = 0

    def args(self):
        '''The plan as the kernel's host array (csrc/neb_band.cu
        PlanField).'''
        lo, n = self.slots
        return (ctypes.c_longlong * (7 + KINDS))(
            _FORM_ID[self.form], self.threads, self.smem, self.cluster,
            int(self.shared), int(self.staged), n, *lo)


def energy_slots(kinds):
    '''((first slot of each kind), slots an image) of the kernel's
    energy pass: each of the KINDS kinds from a multiple of 32.'''
    lo, n = [], 0
    for count in kinds:
        lo.append(n)
        n += 32 * -(-count // 32)
    return tuple(lo), n


def layout(form, threads, n_images, n_atoms, kinds, n_entries, cluster=1,
           shared=True, staged=True):
    '''(shared bytes a block, values in device memory, groups, warps a
    group) of the form's layout (csrc make_layout). Shared memory: the
    arrays ('lone': every image's coordinates and the interior images'
    velocities, forces and tangents; 'large' where `shared`: its own
    images' four and the images either side of them), I energies and 5
    partial sums an interior image (the grid's: copies of those in device
    memory), the
    groups' two reduction buffers of 4 values a chunk, and where `staged`
    (not 'grid'; 'large' only with its arrays) the energies' chunk sums,
    the images' entry arrays (3 values a vector) and the tables (t0; then,
    from a 16-byte boundary, 4 int32 atoms a term, I + 1 offsets, an entry
    source each); 'lone' holds the chunk sums either way. Device memory:
    the rest, and for 'large' and 'grid' the interior images' coordinates.'''
    I, N, M = n_images, n_atoms, n_images - 2
    n3 = 3 * N
    K = energy_slots(kinds)[1] // 32
    nb, na, np_, nd = kinds[:4]
    T, V = nb + na + np_ + nd, nb + 3 * na + np_ + 4 * nd
    nw, CH = threads // 32, -(-N // 32)
    per = M if form == 'lone' else -(-M // cluster)
    groups = max(1, min(per, nw, MAX_GROUPS))
    gw = 1 if CH == 1 else max(1, min(nw // groups, CH))
    lone, grid = form == 'lone', form == 'grid'
    arrays = lone or (form == 'large' and shared)
    tables = not grid and arrays and staged
    imgs = M if lone else per
    values = 8 * CH * groups
    if arrays:
        values += ((I if lone else per + 2) + 3 * imgs) * n3
    if lone or tables:
        values += I * K
    values += I + N_RED * M
    if tables:
        values += imgs * 3 * V + T
    smem = 8 * values
    if tables:
        smem = 16 * -(-smem // 16) + 16 * T + 4 * (N + 1) + 4 * n_entries
    work = (0 if lone else M * n3) + (0 if arrays else 3 * M * n3) + \
        (0 if lone or tables else I * K) + (0 if tables else M * 3 * V) + \
        (I + N_RED * M if grid else 0)
    return smem, work, groups, gw


def n_entries(kinds):
    '''The incidence entries of the terms `kinds` (each term's atoms).'''
    return 2 * kinds[0] + 3 * kinds[1] + 2 * kinds[2] + 4 * kinds[3]


def launch_plan(n_images, n_atoms, kinds, form=None, cluster=None,
                grid_blocks=GRID_BLOCKS):
    '''The kernel's Plan for a band of n_images images of n_atoms atoms
    under the terms `kinds` (the counts of bonds, angles, repulsion pairs,
    dihedrals, springs, half-springs), float64. The rule: 'lone' (512
    threads; its entry arrays and tables in shared memory where they fit
    beside its arrays, else in device memory) up to LONE_MAX_ATOMS interior
    atoms where its shared memory fits, 'grid' from GRID_MIN_ATOMS, else
    'large' (a cluster of min(I - 2, MAX_CLUSTER) blocks, or `cluster`,
    each ceil((I - 2) / cluster) interior images; its arrays, entry arrays
    and tables in shared memory where they fit, else its arrays alone, else
    neither). `form` asks for one (ValueError where the lone form does not
    fit); 'grid' on `cluster` blocks or, of the `grid_blocks` that stay
    resident on the card, those that give each slot of every interior image
    a thread (at least one).'''
    if form is not None and form not in FORMS:
        raise ValueError(f'neb form {form!r}: one of {FORMS}')
    if n_images < 3 or n_atoms < 1:
        raise ValueError(f'neb band: {n_images} images of {n_atoms} atoms '
                         f'(at least 3 images of 1 atom)')
    if len(kinds) != KINDS:
        raise ValueError(f'neb band: {len(kinds)} term kinds, not {KINDS}')
    M, E = n_images - 2, n_entries(kinds)
    slots = energy_slots(kinds)

    def plan(f, cl=1, shared=True, staged=True):
        smem, work, _, _ = layout(f, MAX_THREADS, n_images, n_atoms, kinds,
                                  E, cl, shared, staged)
        return Plan(f, MAX_THREADS, smem, cl, shared, staged, slots, work)
    lone = plan('lone')
    if lone.smem > SMEM_BYTES:
        lone = plan('lone', staged=False)
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
        blocks = cluster if cluster is not None else \
            max(1, min(most, -(-M * slots[1] // MAX_THREADS)))
        return plan('grid', blocks, False, False)
    cl = min(M, MAX_CLUSTER) if cluster is None else cluster
    if not 1 <= cl <= min(M, MAX_CLUSTER):
        raise ValueError(f'neb large form: {cl} blocks a band, not 1 to '
                         f'{min(M, MAX_CLUSTER)}')
    for shared, staged in ((True, True), (True, False), (False, False)):
        got = plan('large', cl, shared, staged)
        if got.smem <= SMEM_BYTES:
            return got
    return got


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


def entry_sources(params, n_atoms):
    '''Each incidence entry's vector in an image's entry array and its
    sign, as one int32 (E,) on the tables' device: 2 v + 1 where the
    entry is the second atom of a pair term (its force the negation of
    vector v, the first atom's), else 2 v; the vectors term-major, each
    kind's from the last kind's end, KIND_WIDTH a term. Built with device
    ops once per table set and atom count, kept on the tables' bonds
    tensor beside the incidence.'''
    bonds = params[0]
    kept = bonds.__dict__.setdefault('_neb_sources', {})
    key = (n_atoms, len(params))
    if key not in kept:
        codes = incidence(params, n_atoms)[1].long()
        counts = [int(t.shape[0]) for t in params[0:len(params):2]]
        counts += [0] * (4 - len(counts))
        term, role = codes >> 2, codes & 3
        first = torch.tensor(np.cumsum([0] + counts[:3]), device=codes.device)
        vfirst = torch.tensor(np.cumsum(
            [0] + [c * w for c, w in zip(counts[:3], KIND_WIDTH)]),
            device=codes.device)
        width = torch.tensor(KIND_WIDTH, device=codes.device)
        kind = torch.bucketize(term, first[1:], right=True)
        pair = (kind == 0) | (kind == 2)
        vec = vfirst[kind] + (term - first[kind]) * width[kind] + \
            torch.where(pair, 0, role)
        kept[key] = (2 * vec + (pair & (role == 1))).to(torch.int32)
    return kept[key]


def entry_vectors_plain(coords, terms):
    '''The entry arrays (B, V, 3) of coords (B, N, 3): each term's
    forces (ff_fire.term_forces) term-major, a pair term's on its first
    atom alone, an angle's three and a dihedral's four in role order.'''
    G = term_forces(coords, terms)
    B, kinds = coords.shape[0], term_kinds(terms)[:4]
    parts, row = [], 0
    for count, w in zip(kinds, KIND_WIDTH):
        rows = G[:, 4 * row:4 * (row + count)].reshape(B, count, 4, 3)
        parts.append(rows[:, :, :w].reshape(B, count * w, 3))
        row += count
    return torch.cat(parts, dim=1) if parts else G


def entry_forces_plain(coords, terms):
    '''The term forces (B, N, 3) on each atom as N1 adds them: its
    incidence entries' vectors of entry_vectors_plain in order, negated
    where entry_sources says so, from zero (ff_fire.ff_forces_plain's
    sums before the springs, bit for bit).'''
    N = coords.shape[1]
    offsets, _, _ = incidence(terms.params, N)
    src = entry_sources(terms.params, N).long()
    ent = entry_vectors_plain(coords, terms)
    f = torch.zeros_like(coords)
    if not src.numel():
        return f
    vals = ent[:, src >> 1] * torch.where(src & 1 == 1, -1.0, 1.0)[:, None]
    counts = (offsets[1:] - offsets[:-1]).long()
    k = torch.arange(int(counts.max()), device=coords.device)
    pos = torch.clamp(offsets[:-1, None].long() + k, max=src.numel() - 1)
    idx = torch.where(k < counts[:, None], pos, src.numel()).t()
    vals = torch.cat([vals, vals.new_zeros(vals.shape[0], 1, 3)], dim=1)
    for row in idx:
        f = f + vals[:, row]
    return f


# ------------------------------------------------- the first design (PR 22)


class PlanV1(NamedTuple):
    '''A launch of N1's first design (csrc/neb_band_v1.cu): its form,
    threads a block, dynamic shared bytes a block, blocks a band (a
    cluster), lanes an atom of the force walk, whether the large form's
    arrays sit in shared memory, and the energy slots (the first slot of
    each kind, then the slots an image).'''
    form: str
    threads: int
    smem: int
    cluster: int = 1
    lanes: int = 1
    shared: bool = True
    slots: tuple = ((0,) * KINDS, 0)

    def args(self):
        '''The plan as the kernel's host array (csrc/neb_band_v1.cu
        PlanField).'''
        lo, n = self.slots
        return (ctypes.c_longlong * (7 + KINDS))(
            _FORM_ID[self.form], self.threads, self.smem, self.cluster,
            self.lanes, int(self.shared), n, *lo)


def _lanes(items):
    '''The most lanes an atom (a power of two up to 32) that keep a
    block's `items` atoms within MAX_THREADS threads.'''
    g = 32
    while g > 1 and items * g > MAX_THREADS:
        g //= 2
    return g


def lone_values_v1(n_images, n_atoms, n_chunks):
    '''The first design's lone form's shared values (csrc/neb_band_v1.cu
    lone_values).'''
    n3, M = 3 * n_atoms, n_images - 2
    return n_images * n3 + 3 * M * n3 + n_images * n_chunks + n_images + \
        N_RED * M


def large_values_v1(n_images, n_atoms, cluster, shared):
    '''The first design's large form's shared values a block
    (csrc/neb_band_v1.cu large_values).'''
    M = n_images - 2
    per = -(-M // cluster)
    return (4 * per * 3 * n_atoms if shared else 0) + n_images + N_RED * M


def work_values_v1(plan, n_images, n_atoms):
    '''The values in device memory (csrc/neb_band_v1.cu's `work`) of
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


def launch_plan_v1(n_images, n_atoms, kinds, form=None, cluster=None,
                   grid_blocks=GRID_BLOCKS):
    '''The first design's PlanV1 (PR 22's rule) for a band of n_images
    images of n_atoms atoms under the terms `kinds` (the counts of bonds,
    angles, repulsion pairs, dihedrals, springs, half-springs), float64.
    The rule: 'lone' (512 threads, the walk's lanes the most that keep the
    interior images' atoms within them) up to LONE_MAX_ATOMS_V1 interior
    atoms where its shared memory fits, 'grid' from GRID_MIN_ATOMS_V1, else
    'large' (a cluster of min(I - 2, MAX_CLUSTER) blocks, or `cluster`,
    each ceil((I - 2) / cluster) interior images; its four arrays in shared
    memory where they fit). `form` asks for one (ValueError where the lone
    form does not fit); 'grid' on `cluster` blocks or those _grid_shape
    takes of the `grid_blocks` that stay resident on the card.'''
    if form is not None and form not in FORMS:
        raise ValueError(f'neb form {form!r}: one of {FORMS}')
    if n_images < 3 or n_atoms < 1:
        raise ValueError(f'neb band: {n_images} images of {n_atoms} atoms '
                         f'(at least 3 images of 1 atom)')
    if len(kinds) != KINDS:
        raise ValueError(f'neb band: {len(kinds)} term kinds, not {KINDS}')
    M = n_images - 2
    lo, n = energy_slots(kinds)
    lone = PlanV1('lone', MAX_THREADS,
                  8 * lone_values_v1(n_images, n_atoms, n // 32), 1,
                  _lanes(M * n_atoms), True, (lo, n))
    if form == 'lone' or (form is None and cluster is None and
                          M * n_atoms <= LONE_MAX_ATOMS_V1 and
                          lone.smem <= SMEM_BYTES):
        if lone.smem > SMEM_BYTES:
            raise ValueError(
                f'neb form \'lone\' needs {lone.smem} shared bytes for '
                f'{n_images} images of {n_atoms} atoms, past {SMEM_BYTES}')
        return lone
    if form is None and cluster is None and \
            M * n_atoms >= GRID_MIN_ATOMS_V1:
        form = 'grid'
    if form == 'grid':
        most = grid_blocks if cluster is None else cluster
        if not 1 <= most <= grid_blocks:
            raise ValueError(f'neb grid form: {cluster} blocks a band, not '
                             f'1 to {grid_blocks}')
        blocks, lanes = _grid_shape(M * n_atoms, most)
        return PlanV1('grid', MAX_THREADS, 0,
                      blocks if cluster is None else cluster, lanes, False,
                      (lo, n))
    cl = min(M, MAX_CLUSTER) if cluster is None else cluster
    if not 1 <= cl <= min(M, MAX_CLUSTER):
        raise ValueError(f'neb large form: {cl} blocks a band, not 1 to '
                         f'{min(M, MAX_CLUSTER)}')
    per = -(-M // cl)
    shared = 8 * large_values_v1(n_images, n_atoms, cl, True) <= SMEM_BYTES
    return PlanV1('large', MAX_THREADS,
                  8 * large_values_v1(n_images, n_atoms, cl, shared), cl,
                  _lanes(per * n_atoms), shared, (lo, n))


def plan_for_v1(chain, terms, form=None, cluster=None):
    '''The PlanV1 that launch_v1 takes for chain (I, N, 3) under
    ff.FireTerms `terms` (in the form `form` names, or by PR 22's rule);
    the grid form on the blocks of it that stay resident on a CUDA
    chain's card.'''
    args = (chain.shape[0], chain.shape[1], term_kinds(terms), form,
            cluster)
    plan = launch_plan_v1(*args)
    if plan.form == 'grid' and chain.device.type == 'cuda':
        probe = PlanV1('grid', MAX_THREADS, 0)
        sms = torch.cuda.get_device_properties(
            chain.device).multi_processor_count
        most = sms * kernel_info_v1(probe, chain.device)['blocks_per_sm']
        plan = launch_plan_v1(*args, most)
    return plan


def launch_v1(chain, terms, n_steps, k_spring=1.0, dt0=0.01, fmax=0.05,
              climbing=False, form=None, plan=None):
    '''N1's first design on a CUDA chain: (chain, done 0-dim bool, steps
    taken 0-dim int32), on `plan` or plan_for_v1's plan, the yardstick
    of the redesign (the same bits).'''
    _check(chain)
    dev = chain.device
    chain = chain.contiguous()
    I, N = chain.shape[0], chain.shape[1]
    out = torch.empty_like(chain)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    if plan is None:
        plan = plan_for_v1(chain, terms, form)
    offsets, codes, _ = incidence(terms.params, N)
    atoms, _, t0 = packed_terms(terms.params, N, torch.float64)
    kinds = term_kinds(terms)[:4]
    n_work = work_values_v1(plan, I, N)
    work = torch.empty(n_work, dtype=torch.float64, device=dev) \
        if n_work else None
    springs, held = _spring_args(terms, chain)
    V1_KERNEL.launch(
        'neb_band_f64', ptr(chain), ptr(out), ptr(done), ptr(steps),
        ptr(work) if work is not None else None, I, N, plan.args(), *kinds,
        ctypes.c_double(terms.bond_k), ptr(atoms), ptr(t0), ptr(offsets),
        ptr(codes), *springs, int(n_steps), float(k_spring), float(dt0),
        float(fmax), int(bool(climbing)), stream_of(chain), device=dev,
        wrapper='neb_band_v1')
    return out, done, steps


def kernel_info_v1(plan, device):
    '''kernel_info of the first design's kernel that `plan` (a PlanV1)
    launches.'''
    return _info(V1_KERNEL, plan, device)


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
    offsets, _, _ = incidence(terms.params, N)
    src = entry_sources(terms.params, N)
    atoms, _, t0 = packed_terms(terms.params, N, torch.float64)
    kinds = term_kinds(terms)[:4]
    work = torch.empty(plan.work, dtype=torch.float64, device=dev) \
        if plan.work else None
    springs, held = _spring_args(terms, chain)
    KERNEL.launch(
        'neb_band_f64', ptr(chain), ptr(out), ptr(done), ptr(steps),
        ptr(work) if work is not None else None, plan.work, I, N,
        plan.args(), *kinds, ctypes.c_double(terms.bond_k), ptr(atoms),
        ptr(t0), ptr(offsets), ptr(src), src.numel(), *springs,
        int(n_steps), float(k_spring), float(dt0), float(fmax),
        int(bool(climbing)), stream_of(chain), device=dev,
        wrapper='neb_band')
    return out, done, steps


def _info(kernel, plan, device):
    got = (ctypes.c_int * 3)()
    lib = kernel.build()
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


def kernel_info(plan, device):
    '''{registers, local_bytes, blocks_per_sm, resident_warps} of the
    kernel that `plan` launches on the card `device`.'''
    return _info(KERNEL, plan, device)


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
