'''
Internal harmonic force field, batched (counterpart of tscode_tpu/ff.py).

A graph-derived force field keeps molecules physical while they are
bent: bonds and angles restrained to their input geometry, a soft
repulsion between atoms three or more bonds apart and, on request, a
restraint on one dihedral across every double bond. `build_ff_params`
derives the tables on the host from one geometry and the bond graph;
`params_to_device` carries them to a device; `ff_energy` evaluates a
whole batch of structures, and torch.autograd supplies the forces
(optimizers.fire_minimize_batch).

The energy is plain PyTorch: the JAX package's is a jitted function
under jax.grad, not a Pallas kernel.
'''

from dataclasses import dataclass

import networkx as nx
import numpy as np
import torch

from tscode_tpu_torch.graphs import neighbors
from tscode_tpu_torch.pt import COVALENT_RADII

K_BOND = 100.0      # kcal/mol/A^2
K_ANGLE = 30.0      # kcal/mol/rad^2
K_REP = 50.0        # kcal/mol at full overlap
K_DIH = 30.0        # kcal/mol/rad^2 (double-bond E/Z protection)
REP_SCALE = 0.85    # fraction of summed covalent radii where repulsion starts
HALF_SPRING_ONSET = 2.5   # A: a half-spring pulls only beyond it


@dataclass
class FFParams:
    '''Static parameter set for one topology.'''
    bonds: np.ndarray           # (NB, 2) int
    bond_r0: np.ndarray         # (NB,)
    angles: np.ndarray          # (NA, 3) int (i-j-k, j central)
    angle_t0: np.ndarray        # (NA,) radians
    nb_pairs: np.ndarray        # (NP, 2) int, nonbonded (>= 1-3 separated)
    nb_r0: np.ndarray           # (NP,) repulsion onset distances
    dihedrals: np.ndarray = None   # (ND, 4) int (E/Z-protected quads)
    dihedral_t0: np.ndarray = None  # (ND,) radians

    def __post_init__(self):
        if self.dihedrals is None:
            # fresh per instance: a shared module-level empty array
            # would alias every FFParams against in-place mutation
            self.dihedrals = np.zeros((0, 4), dtype=int)
            self.dihedral_t0 = np.zeros(0)


def build_ff_params(coords0, atomnos, graph, protect_double_bonds=False):
    '''Derive harmonic reference values from the input geometry and the
    bond graph; nonbonded pairs are all pairs at graph distance >= 3.

    protect_double_bonds adds a restraint on one dihedral across every
    double bond (EZPROT keyword).'''
    coords0 = np.asarray(coords0)
    atomnos = np.asarray(atomnos)
    n = len(atomnos)

    bonds = np.array([(a, b) for a, b in graph.edges if a != b],
                     dtype=int).reshape(-1, 2)   # (0, 2) when bond-less
    bond_r0 = np.linalg.norm(coords0[bonds[:, 0]] - coords0[bonds[:, 1]],
                             axis=1) if len(bonds) else np.zeros(0)

    angles = []
    for j in range(n):
        nbs = neighbors(graph, j)
        for a in range(len(nbs)):
            for b in range(a + 1, len(nbs)):
                angles.append((nbs[a], j, nbs[b]))
    angles = np.array(angles, dtype=int) if angles else \
        np.zeros((0, 3), dtype=int)

    def _angle(i, j, k):
        v1 = coords0[i] - coords0[j]
        v2 = coords0[k] - coords0[j]
        cos = np.clip(v1 @ v2 / np.linalg.norm(v1) / np.linalg.norm(v2),
                      -1, 1)
        return np.arccos(cos)

    angle_t0 = np.array([_angle(*a) for a in angles]) if len(angles) \
        else np.zeros(0)

    # nonbonded: pairs at topological distance >= 3
    dist = dict(nx.all_pairs_shortest_path_length(graph, cutoff=2))
    nb_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                if j not in dist.get(i, {})]
    nb_pairs = np.array(nb_pairs, dtype=int) if nb_pairs else \
        np.zeros((0, 2), dtype=int)
    radii = COVALENT_RADII[atomnos]
    nb_r0 = REP_SCALE * (radii[nb_pairs[:, 0]] + radii[nb_pairs[:, 1]]) \
        if len(nb_pairs) else np.zeros(0)

    dihedrals, dihedral_t0 = np.zeros((0, 4), dtype=int), np.zeros(0)
    if protect_double_bonds:
        from tscode_tpu_torch.torsions import get_double_bonds_indices
        quads = []
        for a, b in get_double_bonds_indices(coords0, atomnos):
            n_a = [n for n in neighbors(graph, a) if n != b]
            n_b = [n for n in neighbors(graph, b) if n != a]
            if n_a and n_b:
                quads.append((n_a[0], a, b, n_b[0]))
        if quads:
            dihedrals = np.array(quads, dtype=int)
            dihedral_t0 = np.array([_dihedral_np(coords0[list(q)])
                                    for q in quads])

    return FFParams(bonds=bonds, bond_r0=bond_r0, angles=angles,
                    angle_t0=angle_t0, nb_pairs=nb_pairs, nb_r0=nb_r0,
                    dihedrals=dihedrals, dihedral_t0=dihedral_t0)


def _dihedral_np(p):
    '''Praxeolitic dihedral of 4 points, radians (host-side).'''
    b0, b1, b2 = p[0] - p[1], p[2] - p[1], p[3] - p[2]
    b1 = b1 / np.linalg.norm(b1)
    v = b0 - np.dot(b0, b1) * b1
    w = b2 - np.dot(b2, b1) * b1
    return np.arctan2(np.dot(np.cross(b1, v), w), np.dot(v, w))


def pair_distances(coords, pairs):
    '''Distances of the atom couples `pairs` (C, 2) int64 in every
    structure: coords (..., N, 3) -> (..., C).'''
    return torch.linalg.norm(coords.index_select(-2, pairs[:, 0])
                             - coords.index_select(-2, pairs[:, 1]), dim=-1)


def ff_energy(coords, params_arrays):
    '''Batched FF energy: coords (..., N, 3) -> (...).
    params_arrays: tuple of tensors (bonds, bond_r0, angles, angle_t0,
    nb_pairs, nb_r0[, dihedrals, dihedral_t0]) as params_to_device gives
    them, static per topology. A term whose table is empty is skipped.

    At its clips the gradient is a choice: where the cosine of an angle
    lies outside +-(1 - 1e-9) (a linear angle) the angle takes the
    clipped value and sends no force, as in the JAX package; exactly at
    a clip's edge torch.clamp passes the whole gradient where jax.grad
    of maximum passes half.'''
    if len(params_arrays) == 8:
        (bonds, bond_r0, angles, angle_t0, nb_pairs, nb_r0,
         dihedrals, dihedral_t0) = params_arrays
    else:
        bonds, bond_r0, angles, angle_t0, nb_pairs, nb_r0 = params_arrays
        dihedrals = None
    e = coords.new_zeros(coords.shape[:-2])

    if bonds.shape[0]:
        d = pair_distances(coords, bonds)
        e = e + K_BOND * torch.sum((d - bond_r0) ** 2, dim=-1)

    if angles.shape[0]:
        centre = coords.index_select(-2, angles[:, 1])
        v1 = coords.index_select(-2, angles[:, 0]) - centre
        v2 = coords.index_select(-2, angles[:, 2]) - centre
        cos = torch.sum(v1 * v2, dim=-1) / torch.clamp(
            torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1),
            min=1e-12)
        theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-9, 1.0 - 1e-9))
        e = e + K_ANGLE * torch.sum((theta - angle_t0) ** 2, dim=-1)

    if nb_pairs.shape[0]:
        d = pair_distances(coords, nb_pairs)
        overlap = torch.clamp(nb_r0 - d, min=0.0)
        e = e + K_REP * torch.sum(overlap ** 2, dim=-1)

    if dihedrals is not None and dihedrals.shape[0]:
        p0, p1, p2, p3 = (coords.index_select(-2, dihedrals[:, k])
                          for k in range(4))
        b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
        b1 = b1 / torch.clamp(
            torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-12)
        v = b0 - torch.sum(b0 * b1, dim=-1, keepdim=True) * b1
        w = b2 - torch.sum(b2 * b1, dim=-1, keepdim=True) * b1
        phi = torch.atan2(
            torch.sum(torch.linalg.cross(b1, v, dim=-1) * w, dim=-1),
            torch.sum(v * w, dim=-1))
        # wrapped deviation so +pi/-pi do not fight each other
        delta = torch.atan2(torch.sin(phi - dihedral_t0),
                            torch.cos(phi - dihedral_t0))
        e = e + K_DIH * torch.sum(delta ** 2, dim=-1)

    return e


@dataclass
class FireTerms:
    '''The terms ops/kernels/ff_fire relaxes a batch on: the force field
    of `params` (params_to_device's tuple of 6 or 8 tensors) with its
    bond constant `bond_k`, harmonic springs spring_k (d - t)^2 on the
    (C, 2) int64 pairs `spring_pairs` with targets `spring_targets`
    (C,), and half-springs half_k max(d - HALF_SPRING_ONSET, 0)^2 on the
    (H, 2) int64 pairs `half_pairs`. spring_k and half_k are numbers or
    0-dim tensors on the tables' device (read there, never on the host).
    Empty or missing spring tables are no terms. The per-atom incidence
    of the force field's terms is `incidence(params, N)`, kept beside the
    tables.'''
    params: tuple
    bond_k: float = K_BOND
    spring_pairs: torch.Tensor = None
    spring_targets: torch.Tensor = None
    spring_k: object = 0.0
    half_pairs: torch.Tensor = None
    half_k: object = 0.0

    def tables(self):
        '''(bonds, bond_r0, angles, angle_t0, nb_pairs, nb_r0, dihedrals,
        dihedral_t0), empty dihedral tables for a 6-table set.'''
        p = self.params
        if len(p) == 8:
            return tuple(p)
        return tuple(p) + (p[0].new_zeros((0, 4)), p[1].new_zeros(0))


def incidence(params, n_atoms):
    '''Each atom's force-field terms, as CSR on the tables' device:
    offsets (n_atoms + 1,) int32 and codes (E,) int32 with code = 4 term
    + role, the terms numbered bonds, angles, repulsion pairs, dihedrals
    in table order, the role the atom's column in its term's row; an
    atom's codes in increasing order; and positions (4 T,) int32, the
    entry of each code (-1 for a role a term does not have). Built with
    device ops (no host read) once per table set and atom count, and
    kept on the tables' bonds tensor.'''
    bonds = params[0]
    kept = bonds.__dict__.setdefault('_fire_incidence', {})
    key = (n_atoms, len(params))
    if key not in kept:
        dev = bonds.device
        atoms, codes, base = [], [], 0
        for table in params[0:len(params):2]:
            n, width = table.shape
            term = torch.arange(base, base + n, device=dev)
            atoms.append(table.reshape(-1))
            codes.append((4 * term[:, None] + torch.arange(
                width, device=dev)).reshape(-1))
            base += n
        atoms, codes = torch.cat(atoms), torch.cat(codes)
        order = torch.sort(atoms, stable=True)[1]
        counts = torch.zeros(n_atoms + 1, dtype=torch.int64,
                             device=dev).index_add_(
            0, atoms + 1, torch.ones_like(atoms))
        codes = codes[order].to(torch.int32)
        pos = torch.full((4 * base,), -1, dtype=torch.int32, device=dev)
        pos[codes.long()] = torch.arange(len(codes), dtype=torch.int32,
                                         device=dev)
        kept[key] = (torch.cumsum(counts, 0).to(torch.int32), codes, pos)
    return kept[key]


# ff_energy(coords, params) is FireTerms(params): the kernel's terms
ff_energy.fire_terms = FireTerms


def params_to_device(params, device, dtype):
    '''FFParams -> the tuple of tensors ff_energy takes, on `device`:
    index tables int64, reference values in `dtype`.'''
    def index(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def value(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    return (index(params.bonds), value(params.bond_r0),
            index(params.angles), value(params.angle_t0),
            index(params.nb_pairs), value(params.nb_r0),
            index(params.dihedrals), value(params.dihedral_t0))


def molecule_params(mol, device):
    '''The force-field tables of a Molecule's topology, from its first
    conformer, float64 on `device` (params_to_device's tuple), built
    once and kept on the molecule: the scan points, the NEB of a
    sub-peak and the neb> operator share them.'''
    params = getattr(mol, '_ff_params_dev', None)
    if params is None or params[0].device.type != torch.device(device).type:
        params = params_to_device(build_ff_params(
            mol.atomcoords[0], mol.atomnos, mol.graph), device, torch.float64)
        mol._ff_params_dev = params
    return params


def merge_ff_params(params_list, offsets):
    '''Concatenate per-molecule FF params into one multimolecular set
    (indices shifted by each molecule's atom offset).'''
    def cat(field, shift_cols=None):
        parts = []
        for p, off in zip(params_list, offsets):
            arr = getattr(p, field)
            if shift_cols and len(arr):
                arr = arr + off
            parts.append(arr)
        return np.concatenate(parts) if any(len(p) for p in parts) else \
            parts[0]

    return FFParams(
        bonds=cat('bonds', True), bond_r0=cat('bond_r0'),
        angles=cat('angles', True), angle_t0=cat('angle_t0'),
        nb_pairs=cat('nb_pairs', True), nb_r0=cat('nb_r0'),
        dihedrals=cat('dihedrals', True), dihedral_t0=cat('dihedral_t0'))
