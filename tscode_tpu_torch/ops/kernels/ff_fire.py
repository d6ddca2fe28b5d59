'''
FIRE on the internal force field in one launch: the hand-written CUDA
kernel of `csrc/ff_fire.cu` and its plain PyTorch twin.

Replaces no Pallas kernel: the JAX package runs fire_minimize_batch
(tscode_tpu/optimizers.py:41) as one jitted program, a lax.scan over the
steps whose body is jax.grad of ff_energy (tscode_tpu/ff.py:126) and the
FIRE update. Here one launch relaxes a whole batch for all its steps: a
thread block a structure, the forces analytic, each step fire_step's
arithmetic (optimizers.py), a structure's block leaving its loop once
the structure has stopped (its coordinates no longer move, so the
outputs equal the scan's masked steps). The terms are those of
ff.FireTerms: the force field with a bond constant, springs and
half-springs (the energies ff_energy, bending._bend_energy,
scans._ff_spring_energy and optimization._spacing_energy register
theirs).

`ff_forces_plain` computes the same analytic forces in plain PyTorch in
the kernel's order (each atom's terms in the order of ff.incidence, then
the springs, then the half-springs), `ff_fire_plain` the same relaxation
step by step with optimizers.fire_step. On a CPU tensor `ff_fire` runs
the plain twin; on a CUDA tensor it launches the kernel or raises.
'''

import ctypes

import torch

from tscode_tpu_torch.ff import (HALF_SPRING_ONSET, K_ANGLE, K_DIH, K_REP,
                                 incidence)
from tscode_tpu_torch.ops.kernels._build import CudaKernel, ptr, stream_of

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int


def _entry(real):
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
_SYMBOL = {torch.float32: ('ff_fire_f32', ctypes.c_float),
           torch.float64: ('ff_fire_f64', ctypes.c_double)}

# threads a block: one an atom (and, staged, one a term) in whole warps,
# at most MAX_THREADS (a thread then walks several); csrc/ff_fire.cu holds
# MAX_THREADS / 32 warp slots of its reductions
MAX_THREADS = 256
# a block's shared memory: the card's opt-in limit less the kernel's
# static reduction slots
SMEM_BYTES = 232448 - 1024
# the norm floor of fire_step and of the force field
_FLOOR = 1e-12
# the cosine clip of ff_energy's angles
_COS_CLIP = 1.0 - 1e-9


def launch_plan(n_atoms, n_terms, n_entries, itemsize, staged=None):
    '''(staged, threads, shared bytes) of the kernel's block for
    structures of n_atoms atoms under n_terms force-field terms with
    n_entries incidence entries. Shared memory holds the structure's
    coordinates, velocities, forces and stepped velocities; staged, also
    each entry's force, written by a thread a term and summed by a
    thread an atom. The per-atom form (each atom's thread computing its
    terms) where the entries do not fit, or where staged is False.'''
    base = 4 * 3 * n_atoms * itemsize
    fits = base + 3 * n_entries * itemsize <= SMEM_BYTES
    staged = fits if staged is None else (staged and fits)
    width = max(n_atoms, n_terms) if staged else n_atoms
    threads = min(32 * max(1, -(-width // 32)), MAX_THREADS)
    return staged, threads, base + (3 * n_entries * itemsize if staged
                                    else 0)


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


def launch(coords, terms, n_steps, dt0=0.05, fmax=0.05, freeze_mask=None,
           staged=None):
    '''The kernel's launch on CUDA tensors: (coords, done (B,) bool,
    force evaluations (B,) int32), on launch_plan's plan for these shapes
    (staged=False asks for the per-atom form, the staged form's
    yardstick).'''
    if coords.dtype not in _SYMBOL:
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
    bonds, r0, angles, a0, nb, nb0, dih, d0 = terms.tables()
    idx = [_table(t, dev, torch.int64) for t in (bonds, angles, nb, dih)]
    val = [_table(t, dev, dtype) for t in (r0, a0, nb0, d0)]
    offsets, codes, pos = incidence(terms.params, N)
    tables = (ptr(idx[0]), ptr(val[0]), idx[0].shape[0])
    staged, threads, smem = launch_plan(
        N, sum(t.shape[0] for t in idx), codes.numel(),
        coords.element_size(), staged)
    # the tensors behind these pointers live until the launch is queued
    # (later allocations on the stream are ordered after the kernel)
    springs, half = [None, None, 0, None], [None, 0, None]
    if terms.spring_pairs is not None and terms.spring_pairs.shape[0]:
        sp = _table(terms.spring_pairs, dev, torch.int64)
        st = _table(terms.spring_targets, dev, dtype)
        ks = _k(terms.spring_k, coords)
        springs = [ptr(sp), ptr(st), sp.shape[0], ptr(ks)]
    if terms.half_pairs is not None and terms.half_pairs.shape[0]:
        hp = _table(terms.half_pairs, dev, torch.int64)
        kh = _k(terms.half_k, coords)
        half = [ptr(hp), hp.shape[0], ptr(kh)]
    freeze, stride = _freeze(freeze_mask, coords), 0
    if freeze is not None:
        if freeze.dim() == 2:
            freeze, stride = freeze.expand(B, N), N
        freeze = freeze.contiguous()
    symbol, real = _SYMBOL[dtype]
    KERNEL.launch(
        symbol, ptr(coords), ptr(out), ptr(done), ptr(steps), B, N,
        *tables, real(terms.bond_k),
        ptr(idx[1]), ptr(val[1]), idx[1].shape[0],
        ptr(idx[2]), ptr(val[2]), idx[2].shape[0],
        ptr(idx[3]), ptr(val[3]), idx[3].shape[0],
        ptr(offsets), ptr(codes), ptr(pos), *springs, *half,
        ptr(freeze) if freeze is not None else None, stride,
        int(n_steps), float(dt0), float(fmax), int(staged), threads, smem,
        stream_of(coords), device=dev, wrapper='ff_fire')
    return out, done, steps


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
