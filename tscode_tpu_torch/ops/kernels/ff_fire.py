'''
FIRE on the internal force field in one launch: the hand-written CUDA
kernel of `csrc/ff_fire.cu` and its plain PyTorch twin.

Replaces no Pallas kernel: the JAX package runs fire_minimize_batch
(tscode_tpu/optimizers.py:41) as one jitted program, a lax.scan over the
steps whose body is jax.grad of ff_energy (tscode_tpu/ff.py:126) and the
FIRE update. Here one launch relaxes a whole batch for all its steps,
the forces analytic (`csrc/ff_forces.cuh`), each step fire_step's
arithmetic (optimizers.py), a structure leaving its loop once it has
stopped (its coordinates no longer move, so the outputs equal the scan's
masked steps). The terms are those of ff.FireTerms: the force field with
a bond constant, springs and half-springs (the energies ff_energy,
bending._bend_energy, scans._ff_spring_energy and
optimization._spacing_energy register theirs).

The kernel has three forms, one layout each (`launch_plan` picks one
from the batch, the atoms, the terms and the entries; `launch(...,
regime=...)` asks for one): 'lone' (one structure on warps that each
hold terms of one kind), 'warp' (a warp a structure, several a block)
and 'large' (a thread-block cluster a structure, its arrays in device
memory: any N). 'block' asks for the first design, a block a structure
(`csrc/ff_fire_block.cu`), kept as the yardstick; no rule picks it.

`ff_forces_plain` computes the same analytic forces in plain PyTorch in
the kernel's order (each atom's terms in the order of ff.incidence, then
the springs, then the half-springs), `ff_fire_plain` the same relaxation
step by step with optimizers.fire_step. On a CPU tensor `ff_fire` runs
the plain twin; on a CUDA tensor it launches the kernel or raises.
'''

import ctypes
from typing import NamedTuple

import torch

from tscode_tpu_torch.ff import (HALF_SPRING_ONSET, K_ANGLE, K_DIH, K_REP,
                                 FireTerms, incidence)
from tscode_tpu_torch.ops.kernels._build import (CudaKernel, device_guard,
                                                 ptr, stream_of)

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int


def _entry(real):
    return (_P, _P, _P, _P, _P,            # coords, out, done, steps, work
            _L, _I, _P,                    # B, N, the plan (host array)
            _I, _I, _I, _I, real,          # NB, NA, NP, ND, bond_k
            _P, _P, _P,                    # packed atoms, entries, t0
            _P, _P,                        # incidence offsets, codes
            _P, _P, _L, _P,                # springs, targets, C, k (0-dim)
            _P, _L, _P,                    # half-springs, H, k (0-dim)
            _P, _L,                        # freeze mask, its row stride
            _I, ctypes.c_double, ctypes.c_double,   # n_steps, dt0, fmax
            _P)                            # stream


def _block_entry(real):
    return (_P, _P, _P, _P, _L, _I,        # coords, out, done, steps, B, N
            _P, _P, _L, real,              # bonds, bond_r0, NB, bond_k
            _P, _P, _L,                    # angles, angle_t0, NA
            _P, _P, _L,                    # repulsion pairs, onsets, NP
            _P, _P, _L,                    # dihedrals, dihedral_t0, ND
            _P, _P, _P,                    # incidence offsets, codes, pos
            _P, _P, _L, _P,                # springs, targets, C, k (0-dim)
            _P, _L, _P,                    # half-springs, H, k (0-dim)
            _P, _L,                        # freeze mask, its row stride
            _I, ctypes.c_double, ctypes.c_double,   # n_steps, dt0, fmax
            _I, _I, _L, _P)       # staged, threads, shared bytes, stream


KERNEL = CudaKernel('ff_fire', {'ff_fire_f32': _entry(ctypes.c_float),
                                'ff_fire_f64': _entry(ctypes.c_double)})
# the first design, the forms' yardstick (launch(..., regime='block'))
BLOCK_KERNEL = CudaKernel(
    'ff_fire_block', {'ff_fire_block_f32': _block_entry(ctypes.c_float),
                      'ff_fire_block_f64': _block_entry(ctypes.c_double)})
_REAL = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}
_SUFFIX = {torch.float32: 'f32', torch.float64: 'f64'}

FORMS = ('lone', 'warp', 'large', 'block')
_FORM_ID = {'lone': 0, 'warp': 1, 'large': 2}
# a block's shared memory: the card's opt-in limit less the kernels'
# static slots
SMEM_BYTES = 232448 - 1024
# the block form's threads a block (csrc/ff_fire_block.cu MAX_WARPS x
# 32): one an atom (or, staged, one a term) in whole warps up to it
MAX_THREADS = 256
# the lone form: at most this many warps on one structure (csrc
# GROUP_THREADS / 32)
LONE_WARPS = 16
# the warp form: structures (warps) a block (csrc WARP_THREADS / 32)
WARP_GROUPS = 8
# the large form: at most this many blocks a structure (the portable
# cluster size), a block from each ATOMS_A_BLOCK atoms, a thread an atom
# up to LARGE_THREADS (csrc LARGE_THREADS) a block
MAX_CLUSTER = 8
ATOMS_A_BLOCK = 256
LARGE_THREADS = 512
# the plan rule, from phase 13's sweeps on the card (chip_smoke.py
# fire_sweep: B in 1 .. 24,417 on the 15-atom topology; fire_size_sweep:
# chains of 24 to 200 atoms; both types): below BATCH_MIN_ROWS structures
# the lone form at its full width; from it the lone form at the narrowest
# width of LONE_WIDTHS whose blocks keep LONE_RESIDENT_WARPS warps
# resident an SM (past that, more structures in flight beat more warps
# on each), else at the width that keeps the most; the warp form instead
# where a block holds WARP_GROUPS structures and keeps more warps
# resident than that
BATCH_MIN_ROWS = 1024
LONE_WIDTHS = (1, 2, 4, 8, 16)
LONE_RESIDENT_WARPS = 16
# the norm floor of fire_step and of the force field
_FLOOR = 1e-12
# the cosine clip of ff_energy's angles
_COS_CLIP = 1.0 - 1e-9


class Plan(NamedTuple):
    '''A launch of the kernel: its form, threads a block, structures a
    block, warps a structure, blocks a structure (a cluster), dynamic
    shared bytes a block, `staged` (the block form: the term forces
    staged in shared memory; the large form: the coordinates there),
    and the group forms' term slots (the first slot of each kind, then
    the slots in all).'''
    form: str
    threads: int
    groups: int
    warps: int
    cluster: int
    smem: int
    staged: bool
    slots: tuple

    def args(self, n_entries):
        '''The plan as the kernel's host array (csrc/ff_fire.cu
        PlanField).'''
        lo, n = self.slots
        return (ctypes.c_longlong * 13)(
            _FORM_ID[self.form], self.threads, self.groups, self.warps,
            self.cluster, self.smem, int(self.staged), n, *lo, n_entries)


def _slots(kinds, grouped):
    '''((first slot of each kind), slots) of the term pass: the terms
    in order, or (grouped) each kind from a multiple of 32, so that a
    warp holds terms of one kind.'''
    lo, n = [], 0
    for count in kinds:
        lo.append(n)
        n += 32 * -(-count // 32) if grouped else count
    return tuple(lo), n


def _block_plan(n_atoms, n_terms, n_entries, itemsize):
    '''The block form's plan: shared memory holds the structure's
    coordinates, velocities, forces and stepped velocities and, staged,
    each entry's force, written by a thread a term and summed by a thread
    an atom; a thread an atom computing its terms where the entries do
    not fit.'''
    base = 4 * 3 * n_atoms * itemsize
    staged = base + 3 * n_entries * itemsize <= SMEM_BYTES
    width = max(n_atoms, n_terms) if staged else n_atoms
    threads = min(32 * max(1, -(-width // 32)), MAX_THREADS)
    return Plan('block', threads, 1, threads // 32, 1,
                base + (3 * n_entries * itemsize if staged else 0), staged,
                ((0, 0, 0, 0), 0))


def _group_plan(form, n_rows, n_atoms, kinds, n_entries, itemsize,
                warps=None):
    '''The lone or warp form's plan; the lone form on `warps` warps, by
    default its full width (a warp for each 32 term slots or atoms, up
    to LONE_WARPS). A structure's shared values: its coordinates and
    each entry's force; past 32 atoms also its velocities, forces,
    stepped velocities and reduction slots (csrc/ff_fire.cu
    group_values).'''
    lo, n = _slots(kinds, form == 'lone')
    if form == 'warp':
        warps = 1
    elif warps is None:
        warps = min(max(1, -(-n // 32), -(-n_atoms // 32)), LONE_WARPS)
    values = 3 * n_atoms + 3 * n_entries if n_atoms <= 32 else \
        12 * n_atoms + 3 * n_entries + 5 * warps
    # the warp form: as many structures a block as fit, up to WARP_GROUPS
    groups = 1 if form == 'lone' else max(1, min(
        WARP_GROUPS, n_rows, SMEM_BYTES // (values * itemsize)))
    return Plan(form, 32 * warps * groups, groups, warps, 1,
                groups * values * itemsize, True, (lo, n))


def _large_plan(n_atoms, itemsize):
    '''The large form's plan: a cluster of up to MAX_CLUSTER blocks a
    structure, a block from each ATOMS_A_BLOCK atoms, a thread for each
    of a block's atoms up to LARGE_THREADS (a thread's atoms run in
    sequence, each over all its terms); each block holds all the
    coordinates in shared memory where they fit, else they stay in
    device memory.'''
    cluster = min(MAX_CLUSTER, max(1, -(-n_atoms // ATOMS_A_BLOCK)))
    per_block = -(-n_atoms // cluster)
    threads = min(32 * -(-per_block // 32), LARGE_THREADS)
    coords = 3 * n_atoms * itemsize
    shared = coords <= SMEM_BYTES
    return Plan('large', threads, 1, threads // 32, cluster,
                coords if shared else 0, shared, ((0, 0, 0, 0), 0))


def lone_widths(n_atoms, kinds, n_entries, itemsize):
    '''The lone form's plans that a batch's rule weighs: its full width
    and each narrower width of LONE_WIDTHS.'''
    full = _group_plan('lone', 1, n_atoms, kinds, n_entries, itemsize)
    return [_group_plan('lone', 1, n_atoms, kinds, n_entries, itemsize, w)
            for w in LONE_WIDTHS if w < full.warps] + [full]


def launch_plan(n_rows, n_atoms, kinds, n_entries, itemsize, form=None,
                resident=None):
    '''The kernel's Plan for n_rows structures of n_atoms atoms under
    the force field's terms, `kinds` = (bonds, angles, repulsion pairs,
    dihedrals), with n_entries incidence entries, itemsize bytes a value;
    resident(plan) gives the warps an SM keeps resident under a plan (the
    card's occupancy, plan_for), None where no card is asked. The rule:
    the lone form (below BATCH_MIN_ROWS structures at its full width,
    from it at the narrowest width of lone_widths that keeps
    LONE_RESIDENT_WARPS warps resident, else the one that keeps the
    most); from BATCH_MIN_ROWS the warp form instead where a block holds
    WARP_GROUPS structures and keeps more warps resident; the large form,
    which takes any size, where the lone form's shared memory does not
    fit. `form` asks for one form, the lone form
    at the rule's width (ValueError where its shared memory does not
    fit).'''
    if form is not None and form not in FORMS:
        raise ValueError(f'ff_fire form {form!r}: one of {FORMS}')
    n_terms = sum(kinds)

    def lone():
        plans = lone_widths(n_atoms, kinds, n_entries, itemsize)
        if n_rows < BATCH_MIN_ROWS or resident is None or \
                plans[-1].smem > SMEM_BYTES:
            return plans[-1]
        return max(plans, key=lambda p: (
            min(resident(p), LONE_RESIDENT_WARPS), -p.warps))

    plans = {
        'block': lambda: _block_plan(n_atoms, n_terms, n_entries, itemsize),
        'lone': lone,
        'warp': lambda: _group_plan('warp', n_rows, n_atoms, kinds,
                                    n_entries, itemsize),
        'large': lambda: _large_plan(n_atoms, itemsize)}
    if form is not None:
        plan = plans[form]()
        if plan.smem > SMEM_BYTES:
            raise ValueError(
                f'ff_fire form {form!r} needs {plan.smem} shared bytes a '
                f'block for {n_atoms} atoms and {n_entries} entries, past '
                f'{SMEM_BYTES}')
        return plan
    plan = lone()
    if plan.smem > SMEM_BYTES:
        return plans['large']()
    if n_rows >= BATCH_MIN_ROWS:
        warp = plans['warp']()
        if warp.groups == WARP_GROUPS and (
                resident is None or resident(warp) > resident(plan)):
            return warp
    return plan


def packed_terms(params, n_atoms, dtype):
    '''The kernel's term tables, on the tables' device: each term's
    atoms (T, 4) int32 (bonds, angles, repulsion pairs, dihedrals in
    table order, 0 in the roles a term lacks), its incidence entries
    (T, 4) int32 (ff.incidence's positions, -1 in those roles) and its
    reference value (T,) in dtype. Built with device ops once per table
    set and type, kept on the tables' bonds tensor beside the
    incidence.'''
    bonds = params[0]
    kept = bonds.__dict__.setdefault('_fire_packed', {})
    key = (len(params), dtype)
    if key not in kept:
        tables = FireTerms(tuple(params)).tables()
        atoms = [torch.nn.functional.pad(t.to(torch.int32),
                                         (0, 4 - t.shape[1]))
                 for t in tables[0::2]]
        kept[key] = (torch.cat(atoms).contiguous(),
                     torch.cat([t.to(dtype) for t in tables[1::2]]))
    atoms, t0 = kept[key]
    return atoms, incidence(params, n_atoms)[2].view(-1, 4), t0


# ------------------------------------------------------------ plain twin


def _pair_rows(coords, pairs, g_of_d):
    '''(B, P, 4, 3) forces of pair terms with dE/dd = g_of_d(d) on their
    two atoms (roles 0 and 1; roles 2 and 3 zero).'''
    diff = coords[:, pairs[:, 0]] - coords[:, pairs[:, 1]]
    dx, dy, dz = diff.unbind(-1)
    d = torch.sqrt(dx * dx + dy * dy + dz * dz)
    coef = torch.where(d > 0, g_of_d(d) / d, 0.0)[..., None]
    zero = torch.zeros_like(diff)
    return torch.stack([-coef * diff, coef * diff, zero, zero], dim=2)


def _angle_rows(coords, angles, t0):
    '''(B, NA, 4, 3) forces of the angle terms on (i, j, k), j central:
    K_ANGLE (acos(cos) - t0)^2 with the cosine's clips of ff_energy (no
    force outside +-(1 - 1e-9), the norm product floored at 1e-12).'''
    xj = coords[:, angles[:, 1]]
    v1 = coords[:, angles[:, 0]] - xj
    v2 = coords[:, angles[:, 2]] - xj
    n1sq = torch.sum(v1 * v1, dim=-1)
    n2sq = torch.sum(v2 * v2, dim=-1)
    den = torch.sqrt(n1sq) * torch.sqrt(n2sq)
    floored = den < _FLOOR
    den = torch.clamp(den, min=_FLOOR)
    cos = torch.sum(v1 * v2, dim=-1) / den
    inside = (cos >= -_COS_CLIP) & (cos <= _COS_CLIP)
    c = torch.where(inside, cos, 0.0)
    g = (2 * K_ANGLE) * (torch.arccos(c) - t0) * (
        -1.0 / torch.sqrt(1.0 - c * c))
    g = torch.where(inside, g, 0.0)[..., None]
    den, cos = den[..., None], cos[..., None]
    dc1 = torch.where(floored[..., None], v2 / den,
                      v2 / den - cos * v1 / n1sq[..., None])
    dc2 = torch.where(floored[..., None], v1 / den,
                      v1 / den - cos * v2 / n2sq[..., None])
    fi, fk = -g * dc1, -g * dc2
    return torch.stack([fi, -(fi + fk), fk, torch.zeros_like(fi)], dim=2)


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _dihedral_rows(coords, quads, t0):
    '''(B, ND, 4, 3) forces of the E/Z dihedral terms K_DIH wrap(phi -
    t0)^2: phi as ff_energy takes it (praxeolitic, b1 normalised with a
    1e-12 floor), its gradient in the closed form of Bekker (d wrap /
    d phi = 1); no force from a quadruplet with a collinear end.'''
    p0, p1, p2, p3 = (coords[:, quads[:, k]] for k in range(4))
    b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
    nb1 = torch.sqrt(torch.sum(b1 * b1, dim=-1, keepdim=True))
    b1n = b1 / torch.clamp(nb1, min=_FLOOR)
    v = b0 - torch.sum(b0 * b1n, dim=-1, keepdim=True) * b1n
    w = b2 - torch.sum(b2 * b1n, dim=-1, keepdim=True) * b1n
    phi = torch.atan2(torch.sum(_cross(b1n, v) * w, dim=-1),
                      torch.sum(v * w, dim=-1))
    u = phi - t0
    g = ((2 * K_DIH) * torch.atan2(torch.sin(u), torch.cos(u)))[..., None]
    m, n = _cross(b0, b1), _cross(b2, b1)
    mm = torch.sum(m * m, dim=-1, keepdim=True)
    nn = torch.sum(n * n, dim=-1, keepdim=True)
    ok = (mm > 0) & (nn > 0)
    nb1sq = nb1 * nb1
    d0 = nb1 / mm * m
    d3 = -nb1 / nn * n
    a = torch.sum(b0 * b1, dim=-1, keepdim=True) / nb1sq
    c = -torch.sum(b2 * b1, dim=-1, keepdim=True) / nb1sq
    d1 = (a - 1.0) * d0 - c * d3
    d2 = (c - 1.0) * d3 - a * d0
    return torch.stack([torch.where(ok, -g * d, 0.0)
                        for d in (d0, d1, d2, d3)], dim=2)


def term_forces(coords, terms):
    '''(B, 4 T, 3): row 4 term + role holds the force of the force
    field's term `term` (numbered as in ff.incidence) on its role-th
    atom, coords (B, N, 3).'''
    bonds, r0, angles, a0, nb, nb0, dih, d0 = (
        t.to(coords.device) for t in terms.tables())
    dtype = coords.dtype
    k_bond = 2 * terms.bond_k
    rows = [
        _pair_rows(coords, bonds, lambda d: k_bond * (d - r0.to(dtype))),
        _angle_rows(coords, angles, a0.to(dtype)),
        _pair_rows(coords, nb, lambda d: torch.where(
            nb0.to(dtype) - d > 0, -(2 * K_REP) * (nb0.to(dtype) - d), 0.0)),
        _dihedral_rows(coords, dih, d0.to(dtype))]
    return torch.cat(rows, dim=1).reshape(coords.shape[0], -1, 3)


def _k(k, like):
    '''A spring constant as a 0-dim tensor of like's dtype and device.'''
    if torch.is_tensor(k):
        return k.to(device=like.device, dtype=like.dtype).reshape(())
    return torch.full((), float(k), dtype=like.dtype, device=like.device)


def _springs(terms, device):
    '''((C, 2) pairs, targets or None, k, onset or None) of the springs
    and the half-springs that are there.'''
    out = []
    if terms.spring_pairs is not None and terms.spring_pairs.shape[0]:
        out.append((terms.spring_pairs.to(device), terms.spring_targets,
                    terms.spring_k))
    if terms.half_pairs is not None and terms.half_pairs.shape[0]:
        out.append((terms.half_pairs.to(device), None, terms.half_k))
    return out


def _freeze(freeze_mask, coords):
    if freeze_mask is None:
        return None
    return torch.as_tensor(freeze_mask, dtype=torch.bool,
                           device=coords.device)


def ff_forces_plain(coords, terms, freeze_mask=None):
    '''The forces (B, N, 3) of ff.FireTerms `terms` on coords (B, N, 3),
    analytic, in the kernel's order: each atom's force-field terms in
    the order of ff.incidence, then the springs, then the half-springs,
    summed from zero; zero on the atoms of freeze_mask ((N,) or (B, N)
    bool).'''
    B, N = coords.shape[0], coords.shape[1]
    offsets, codes, _ = incidence(terms.params, N)
    offsets, codes = offsets.long(), codes.long()
    G = term_forces(coords, terms)
    f = torch.zeros_like(coords)
    counts = offsets[1:] - offsets[:-1]
    for k in range(int(counts.max()) if codes.numel() else 0):
        live = (k < counts)[:, None]
        idx = codes[torch.clamp(offsets[:-1] + k, max=codes.numel() - 1)]
        f = f + torch.where(live, G[:, idx], 0.0)
    for pairs, targets, k in _springs(terms, coords.device):
        k2 = 2 * _k(k, coords)
        if targets is None:
            rows = _pair_rows(coords, pairs, lambda d: torch.where(
                d - HALF_SPRING_ONSET > 0, k2 * (d - HALF_SPRING_ONSET),
                0.0))
        else:
            t = targets.to(coords.device, coords.dtype)
            rows = _pair_rows(coords, pairs, lambda d: k2 * (d - t))
        for s in range(pairs.shape[0]):
            for role in (0, 1):
                f = f.index_add(1, pairs[s, role:role + 1],
                                rows[:, s, role][:, None])
    freeze = _freeze(freeze_mask, coords)
    if freeze is not None:
        f = f.masked_fill(freeze[..., None], 0.0)
    return f


def ff_fire_plain(coords, terms, n_steps, dt0=0.05, fmax=0.05,
                  freeze_mask=None):
    '''Plain PyTorch twin of `ff_fire`: optimizers.fire_step on
    ff_forces_plain from rest, each structure stopped once its largest
    atomic force is under fmax; the loop ends when every structure has.
    Returns (coords, done (B,) bool, force evaluations (B,) int32).'''
    from tscode_tpu_torch.optimizers import fire_init, fire_step
    state = fire_init(coords, dt0)
    steps = torch.zeros(coords.shape[0], dtype=torch.int32,
                        device=coords.device)
    for _ in range(n_steps):
        if bool(state[5].all()):
            break
        steps += (~state[5]).to(torch.int32)
        f = ff_forces_plain(state[0], terms, freeze_mask)
        state = fire_step(state, f, dt0, fmax)
    return state[0], state[5], steps


# ---------------------------------------------------------------- kernel


def _table(t, device, dtype):
    return t.to(device=device, dtype=dtype).contiguous()


def _spring_args(terms, coords):
    '''The kernels' spring and half-spring arguments (pointers, counts,
    0-dim constants) and the tensors behind them, which live until the
    launch is queued (later allocations on the stream are ordered after
    the kernel).'''
    dev, dtype = coords.device, coords.dtype
    springs, half, held = [None, None, 0, None], [None, 0, None], []
    if terms.spring_pairs is not None and terms.spring_pairs.shape[0]:
        sp = _table(terms.spring_pairs, dev, torch.int64)
        st = _table(terms.spring_targets, dev, dtype)
        ks = _k(terms.spring_k, coords)
        springs, held = [ptr(sp), ptr(st), sp.shape[0], ptr(ks)], [sp, st, ks]
    if terms.half_pairs is not None and terms.half_pairs.shape[0]:
        hp = _table(terms.half_pairs, dev, torch.int64)
        kh = _k(terms.half_k, coords)
        half, held = [ptr(hp), hp.shape[0], ptr(kh)], held + [hp, kh]
    return springs + half, held


def _freeze_arg(freeze_mask, coords):
    '''(the freeze mask as (B, N) or (N,) bytes or None, its row
    stride).'''
    freeze, stride = _freeze(freeze_mask, coords), 0
    if freeze is not None:
        if freeze.dim() == 2:
            freeze, stride = freeze.expand(coords.shape[0],
                                           coords.shape[1]), coords.shape[1]
        freeze = freeze.contiguous()
    return freeze, stride


def _launch_block(coords, out, done, steps, terms, n_steps, dt0, fmax,
                  freeze_mask, plan):
    '''The first design's launch (csrc/ff_fire_block.cu) on `plan`.'''
    dev, dtype = coords.device, coords.dtype
    B, N = coords.shape[0], coords.shape[1]
    bonds, r0, angles, a0, nb, nb0, dih, d0 = terms.tables()
    idx = [_table(t, dev, torch.int64) for t in (bonds, angles, nb, dih)]
    val = [_table(t, dev, dtype) for t in (r0, a0, nb0, d0)]
    offsets, codes, pos = incidence(terms.params, N)
    springs, held = _spring_args(terms, coords)
    freeze, stride = _freeze_arg(freeze_mask, coords)
    tables = []
    for i, v in zip(idx, val):
        tables += [ptr(i), ptr(v), i.shape[0]]
    BLOCK_KERNEL.launch(
        f'ff_fire_block_{_SUFFIX[dtype]}', ptr(coords), ptr(out), ptr(done),
        ptr(steps), B, N, *tables[:3], _REAL[dtype](terms.bond_k),
        *tables[3:], ptr(offsets), ptr(codes), ptr(pos), *springs,
        ptr(freeze) if freeze is not None else None, stride, int(n_steps),
        float(dt0), float(fmax), int(plan.staged), plan.threads, plan.smem,
        stream_of(coords), device=dev, wrapper='ff_fire')


_RESIDENT = {}


def _resident(plan, n_atoms, dtype, device):
    '''The warps an SM keeps resident under `plan` on the card `device`
    (kernel_info), asked once a kernel, launch shape and card.'''
    key = (plan.form, n_atoms <= 32, plan.staged, plan.threads, plan.smem,
           dtype, str(device))
    if key not in _RESIDENT:
        _RESIDENT[key] = kernel_info(plan, n_atoms, dtype,
                                     device)['resident_warps']
    return _RESIDENT[key]


def plan_for(coords, terms, regime=None):
    '''The Plan that launch takes for coords (B, N, 3) under ff.FireTerms
    `terms` (in the form `regime` names, or by the rule): launch_plan
    with the card's occupancy on a CUDA tensor, without it otherwise.'''
    N = coords.shape[1]
    kinds = tuple(int(t.shape[0]) for t in terms.tables()[0::2])
    resident = None
    if coords.device.type == 'cuda':
        def resident(plan):
            return _resident(plan, N, coords.dtype, coords.device)
    return launch_plan(coords.shape[0], N, kinds,
                       incidence(terms.params, N)[1].numel(),
                       coords.element_size(), regime, resident)


def launch(coords, terms, n_steps, dt0=0.05, fmax=0.05, freeze_mask=None,
           regime=None, plan=None):
    '''The kernel's launch on CUDA tensors: (coords, done (B,) bool,
    force evaluations (B,) int32), on plan_for's plan for these shapes,
    in the form `regime` names (one of FORMS: the yardstick timings, the
    sweeps behind the plan rule), or on the Plan `plan` as given.'''
    if coords.dtype not in _REAL:
        raise TypeError(f'ff_fire takes float32/float64, got {coords.dtype}')
    if coords.dim() != 3 or coords.shape[2] != 3:
        raise ValueError(f'coords must be (B, N, 3), got '
                         f'{tuple(coords.shape)}')
    dev, dtype = coords.device, coords.dtype
    coords = coords.contiguous()
    B, N = coords.shape[0], coords.shape[1]
    out = torch.empty_like(coords)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out, done, steps
    offsets, codes, _ = incidence(terms.params, N)
    kinds = tuple(int(t.shape[0]) for t in terms.tables()[0::2])
    if plan is None:
        plan = plan_for(coords, terms, regime)
    if plan.form == 'block':
        _launch_block(coords, out, done, steps, terms, n_steps, dt0, fmax,
                      freeze_mask, plan)
        return out, done, steps
    atoms, entries, t0 = packed_terms(terms.params, N, dtype)
    # the large form's velocities, forces and stepped velocities
    work = torch.empty(3 * B * N * 3, dtype=dtype, device=dev) \
        if plan.form == 'large' else None
    springs, held = _spring_args(terms, coords)
    freeze, stride = _freeze_arg(freeze_mask, coords)
    KERNEL.launch(
        f'ff_fire_{_SUFFIX[dtype]}', ptr(coords), ptr(out), ptr(done),
        ptr(steps), ptr(work) if work is not None else None, B, N,
        plan.args(codes.numel()), *kinds, _REAL[dtype](terms.bond_k),
        ptr(atoms), ptr(entries), ptr(t0), ptr(offsets), ptr(codes),
        *springs, ptr(freeze) if freeze is not None else None, stride,
        int(n_steps), float(dt0), float(fmax), stream_of(coords),
        device=dev, wrapper='ff_fire')
    return out, done, steps


def kernel_info(plan, n_atoms, dtype, device):
    '''{registers, local_bytes, blocks_per_sm, resident_warps} of the
    kernel that `plan` launches on the card `device`: registers and
    spilled bytes a thread, and the blocks and warps an SM holds at the
    plan's threads and shared bytes (cudaOccupancy...).'''
    got = (ctypes.c_int * 3)()
    f64 = int(dtype == torch.float64)
    if plan.form == 'block':
        lib = BLOCK_KERNEL.build()
        fn, args = lib.ff_fire_block_info, (plan.threads, plan.smem, f64)
        fn.argtypes = [_I, _L, _I, _P]
    else:
        lib = KERNEL.build()
        fn, args = lib.ff_fire_info, (plan.args(0), int(n_atoms), f64)
        fn.argtypes = [_P, _I, _I, _P]
    fn.restype = _I
    with device_guard(device):
        code = fn(*args, got)
    if code != 0:
        raise RuntimeError(f'ff_fire kernel_info: cudaError {code} '
                           f'({lib.tt_error_string(code).decode()})')
    return {'registers': got[0], 'local_bytes': got[1],
            'blocks_per_sm': got[2],
            'resident_warps': got[2] * plan.threads // 32}


def ff_fire(coords, terms, n_steps, dt0=0.05, fmax=0.05, freeze_mask=None):
    '''FIRE from rest on the terms of ff.FireTerms `terms` for at most
    n_steps steps: coords (B, N, 3) float32/float64, freeze_mask None,
    (N,) or (B, N) bool (True atoms do not move). Returns (coords, done
    (B,) bool, force evaluations a structure (B,) int32), as
    optimizers.fire_minimize_batch's coordinates and stop flags. On a
    CUDA tensor one launch of the kernel, on a CPU tensor the plain
    twin.'''
    if coords.device.type == 'cpu':
        return ff_fire_plain(coords, terms, n_steps, dt0, fmax, freeze_mask)
    return launch(coords, terms, n_steps, dt0, fmax, freeze_mask)
