'''
Reactive-atom pseudo-orbital builders (host-side geometry).

Re-design of the reference's eight mutable orbital classes
(TSCoDe's reactive_atoms_classes.py:29-576) as pure
builder functions returning an immutable `ReactiveAtom` record. The
geometric constructions (lobe counts, angles, orb_dim lookups) follow the
reference exactly; construction happens once per (molecule, conformer)
on the host and only the resulting lobe-center arrays feed the device
sweeps.

Deliberate behavioral deviations (each noted inline):
 * the 'sp' orbital frame uses a deterministic reference vector instead
   of np.random.rand (reference reactive_atoms_classes.py:495) so runs
   are reproducible;
 * ambiguous sp3 leaving groups raise NoOrbitalError instead of opening
   an interactive ASE GUI prompt (reference :147-170), since this
   framework is headless;
 * an sp3 atom whose single heteroneighbor is nitrogen falls through to
   the other inference branches instead of crashing (the reference
   counts N as a leaving-group marker but omits it from the selection
   list, reactive_atoms_classes.py:141-142, which raises IndexError).
'''

from dataclasses import dataclass, field

import numpy as np

from tscode_tpu_torch.errors import NoOrbitalError
from tscode_tpu_torch.graphs import neighbors
from tscode_tpu_torch.parameters import ORB_DIM_DICT
from tscode_tpu_torch.pt import SYMBOLS


def _norm(v):
    return v / np.linalg.norm(v)


def _rot_about(axis, angle_deg):
    '''Axis-angle rotation matrix (host numpy).'''
    axis = _norm(np.asarray(axis, dtype=float))
    half = np.radians(angle_deg) / 2.0
    s, c = np.sin(half), np.cos(half)
    x, y, z, w = s * axis[0], s * axis[1], s * axis[2], c
    return np.array([
        [2 * (w * w + x * x) - 1, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 2 * (w * w + y * y) - 1, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 2 * (w * w + z * z) - 1],
    ])


@dataclass
class ReactiveAtom:
    '''One reactive atom's orbital geometry for one conformer.'''
    index: int
    symbol: str
    type_name: str                 # matches the reference repr ('sp2', 'Ketone (sp2)', ...)
    coord: np.ndarray              # (3,) atom position
    orb_vecs: np.ndarray           # (K, 3) lobe direction vectors
    center: np.ndarray             # (K, 3) absolute lobe centers
    neighbors_symbols: list = field(default_factory=list)
    subtype: str = ''
    leaving_group_index: int | None = None

    def __repr__(self):
        return self.type_name

    @property
    def base_name(self):
        '''Type name without the parenthesized subtype (orb_dim key part).'''
        return self.type_name.split(' (')[0]


def _orb_dim_for(symbol, base_name, orb_dim, bond_fallback=None):
    '''Resolve the orbital half-length from ORB_DIM_DICT unless given.'''
    if orb_dim is not None:
        return orb_dim
    key = f'{symbol} {base_name}'
    dim = ORB_DIM_DICT.get(key)
    if dim is None:
        if bond_fallback is not None:
            print(f'ATTENTION: no orbital parameters for {key}. '
                  f'Using the bonding distance ({round(bond_fallback, 3)} A).')
            return bond_fallback
        dim = ORB_DIM_DICT['Fallback']
        print(f'ATTENTION: no orbital parameters for {key}. Using {dim} A.')
    return dim


def _staggered_triplet(pivot, ref_vec):
    '''Three orbital vectors staggered about `pivot` starting 60 deg from
    the projection of ref_vec (shared by Single/Sp3 sigma-star paths,
    reference reactive_atoms_classes.py:65-66, 192-193).'''
    return np.array([_rot_about(pivot, angle + 60) @ ref_vec
                     for angle in range(0, 360, 120)])


# ------------------------------------------------------------- builders
# each takes (mol, i, conf, orb_dim) where mol provides atomcoords,
# atomnos, graph, reactive_indices, sigmatropic (per conf), sp3_sigmastar


def build_single(mol, i, conf=0, orb_dim=None):
    '''Terminal single-bond atom: one lobe opposite the only neighbor, or
    a staggered sigma-star triplet when vicinal
    (reference reactive_atoms_classes.py:29-80).'''
    nbs = neighbors(mol.graph, i)
    symbol = SYMBOLS[int(mol.atomnos[i])]
    coord = mol.atomcoords[conf][i]
    other = mol.atomcoords[conf][nbs][0]

    if not mol.sp3_sigmastar:
        orb_vecs = np.array([_norm(coord - other)])
    else:
        partner_index = next(idx for idx in mol.reactive_indices
                             if idx != i and idx in nbs)
        partner = mol.atomcoords[conf][partner_index]
        pivot = _norm(partner - coord)
        nb_partner = [n for n in neighbors(mol.graph, partner_index) if n != i]
        orb_vec = _norm(mol.atomcoords[conf][nb_partner[0]] - partner)
        orb_vec = orb_vec - (orb_vec @ pivot) * pivot
        orb_vecs = _staggered_triplet(pivot, orb_vec)

    dim = _orb_dim_for(symbol, 'Single Bond', orb_dim,
                       bond_fallback=float(np.linalg.norm(coord - other)))
    return ReactiveAtom(index=i, symbol=symbol, type_name='Single Bond',
                        coord=coord, orb_vecs=orb_vecs,
                        center=dim * orb_vecs + coord,
                        neighbors_symbols=[SYMBOLS[int(mol.atomnos[n])] for n in nbs])


def build_sp2(mol, i, conf=0, orb_dim=None):
    '''Planar atom: two p lobes along the mean normal of the three
    neighbor-plane cross products (reference reactive_atoms_classes.py:83-119).'''
    nbs = neighbors(mol.graph, i)
    symbol = SYMBOLS[int(mol.atomnos[i])]
    coord = mol.atomcoords[conf][i]
    others = mol.atomcoords[conf][nbs]

    v = others - coord
    n0, n1, n2 = _norm(v[0]), _norm(v[1]), _norm(v[2])
    orb_vec = _norm(np.mean([np.cross(n0, n1), np.cross(n1, n2),
                             np.cross(n2, n0)], axis=0))
    orb_vecs = np.vstack((orb_vec, -orb_vec))

    dim = _orb_dim_for(symbol, 'sp2', orb_dim)
    return ReactiveAtom(index=i, symbol=symbol, type_name='sp2',
                        coord=coord, orb_vecs=orb_vecs,
                        center=dim * orb_vecs + coord,
                        neighbors_symbols=[SYMBOLS[int(mol.atomnos[n])] for n in nbs])


_LG_MARKERS = ('O', 'N', 'Cl', 'Br', 'I')
_LG_CHOICES = ('O', 'Cl', 'Br', 'I')


def build_sp3(mol, i, conf=0, orb_dim=None, leaving_group_index=None):
    '''Tetrahedral atom: one lobe opposite the leaving group, or a
    staggered sigma-star triplet when vicinal
    (reference reactive_atoms_classes.py:122-207).'''
    nbs = neighbors(mol.graph, i)
    symbol = SYMBOLS[int(mol.atomnos[i])]
    coord = mol.atomcoords[conf][i]
    others = mol.atomcoords[conf][nbs]
    nb_symbols = [SYMBOLS[int(mol.atomnos[n])] for n in nbs]

    if not mol.sp3_sigmastar:
        lg_coords = None
        if leaving_group_index is not None:
            lg_coords = others[nbs.index(leaving_group_index)]
        else:
            markers = [s for s in nb_symbols if s in _LG_MARKERS]
            choices = [s for s in nb_symbols if s in _LG_CHOICES]
            if len(markers) == 1 and choices:
                lg_coords = others[nb_symbols.index(choices[0])]
            else:
                non_h = [s for s in nb_symbols if s != 'H']
                if len(non_h) == 1:
                    lg_coords = others[nb_symbols.index(non_h[0])]
        if lg_coords is None:
            raise NoOrbitalError(
                f'Cannot infer the leaving group for sp3 atom {i} '
                f'({symbol}, neighbors {nb_symbols}). Specify it with the '
                f'molecule-line attribute lg=<index>.')

        orb_vecs = np.array([coord - lg_coords])
        dim = _orb_dim_for(symbol, 'sp3', orb_dim)
        center = np.array([dim * _norm(v) + coord for v in orb_vecs])

    else:
        partner_index = next(idx for idx in mol.reactive_indices
                             if idx != i and idx in nbs)
        pivot = _norm(mol.atomcoords[conf][partner_index] - coord)
        other_nbs = [n for n in nbs if n != partner_index]
        orb_vec = _norm(mol.atomcoords[conf][other_nbs[0]] - coord)
        orb_vec = orb_vec - (orb_vec @ pivot) * pivot
        orb_vecs = _staggered_triplet(pivot, orb_vec)
        dim = _orb_dim_for(symbol, 'sp3', orb_dim)
        center = np.array([dim * _norm(v) + coord for v in orb_vecs])

    return ReactiveAtom(index=i, symbol=symbol, type_name='sp3',
                        coord=coord, orb_vecs=orb_vecs, center=center,
                        neighbors_symbols=nb_symbols,
                        leaving_group_index=leaving_group_index)


def build_ether(mol, i, conf=0, orb_dim=None):
    '''Divalent O/S: the two substituent vectors, rotated into the lone
    pair plane (90 deg about their mean after a 180 deg flip about their
    normal; reference reactive_atoms_classes.py:248-285).'''
    nbs = neighbors(mol.graph, i)
    symbol = SYMBOLS[int(mol.atomnos[i])]
    coord = mol.atomcoords[conf][i]
    others = mol.atomcoords[conf][nbs]

    raw = others - coord
    dim = _orb_dim_for(symbol, 'Ether', orb_dim)
    orb_vecs = dim * np.array([_norm(v) for v in raw])
    orb_mat = _rot_about(np.mean(orb_vecs, axis=0), 90) @ \
        _rot_about(np.cross(orb_vecs[0], orb_vecs[1]), 180)
    orb_vecs = (orb_mat @ orb_vecs.T).T

    return ReactiveAtom(index=i, symbol=symbol, type_name='Ether',
                        coord=coord, orb_vecs=orb_vecs,
                        center=orb_vecs + coord,
                        neighbors_symbols=[SYMBOLS[int(mol.atomnos[n])] for n in nbs])


def build_ketone(mol, i, conf=0, orb_dim=None):
    '''Terminal O/S on a carbon: subtype by the carbon's other neighbor
    count — ketene 'p+p' (4 lobes), ketone 'sp2'/'p' (2 lobes), alkoxide
    'trilobe' (3 lobes). (reference reactive_atoms_classes.py:288-375)

    NOTE on sigmatropic 'p' lobes: in the reference, sigmatropic
    detection happens while Ketone atoms still repr as 'Ketone
    (pre-init)', which never matches its sp2-type name list
    (graph_manipulations.py:246-258) — so mol.sigmatropic is always
    False when a Ketone is a reactive atom and the 'p' branch
    (reactive_atoms_classes.py:350-353) is unreachable. We keep the
    branch for API completeness; parity holds because the flag is
    computed the same way.'''
    nbs = neighbors(mol.graph, i)
    symbol = SYMBOLS[int(mol.atomnos[i])]
    coord = mol.atomcoords[conf][i]
    other = mol.atomcoords[conf][nbs][0]

    dim = _orb_dim_for(symbol, 'Ketone', orb_dim)
    vector = _norm(other - coord) * dim

    nb_of_nb = [n for n in neighbors(mol.graph, nbs[0]) if n != i]

    if len(nb_of_nb) == 1:
        # ketene: 4 p+p lobes in the plane orthogonal to the C=C axis
        ketene_subs = [n for n in neighbors(mol.graph, nb_of_nb[0]) if n != nbs[0]]
        v = mol.atomcoords[conf][ketene_subs[0]] - mol.atomcoords[conf][nb_of_nb[0]]
        pointer = v - (v @ _norm(vector)) * vector
        pointer = _norm(pointer) * dim
        center = np.array([_rot_about(vector, 90 * step) @ pointer
                           for step in range(4)])
        subtype = 'p+p'

    elif len(nb_of_nb) == 2:
        a1 = mol.atomcoords[conf][nb_of_nb[0]]
        a2 = mol.atomcoords[conf][nb_of_nb[1]]
        pivot = _norm(np.cross(a1 - coord, a2 - coord))
        if mol.sigmatropic[conf]:
            center = np.concatenate(([pivot * dim], [-pivot * dim]))
            subtype = 'p'
        else:
            center = np.array([_rot_about(pivot, angle) @ vector
                               for angle in (120, 240)])
            subtype = 'sp2'

    elif len(nb_of_nb) == 3:
        vs = [dim * _norm(mol.atomcoords[conf][n] - coord) for n in nb_of_nb]
        pivot = _norm(np.cross(vector, vs[0]))
        center = np.array([_rot_about(pivot, 180) @ v for v in vs])
        subtype = 'trilobe'

    else:
        raise NoOrbitalError(
            f'Unsupported Ketone substitution at atom {i} '
            f'({len(nb_of_nb)} neighbors of neighbor).')

    orb_vecs = np.array([_norm(c) for c in center])
    return ReactiveAtom(index=i, symbol=symbol,
                        type_name=f'Ketone ({subtype})', subtype=subtype,
                        coord=coord, orb_vecs=orb_vecs,
                        center=center + coord,
                        neighbors_symbols=[SYMBOLS[int(mol.atomnos[n])] for n in nbs])


def build_imine(mol, i, conf=0, orb_dim=None):
    '''Divalent N/P: one lone-pair lobe opposite the substituent mean, or
    two p lobes when sigmatropic (reference reactive_atoms_classes.py:378-417).'''
    nbs = neighbors(mol.graph, i)
    symbol = SYMBOLS[int(mol.atomnos[i])]
    coord = mol.atomcoords[conf][i]
    others = mol.atomcoords[conf][nbs]
    vectors = others - coord

    dim = _orb_dim_for(symbol, 'Imine', orb_dim)

    if mol.sigmatropic[conf]:
        p_lobe = _norm(np.cross(vectors[0], vectors[1])) * dim
        orb_vecs = np.concatenate(([p_lobe], [-p_lobe]))
    else:
        orb_vecs = np.array([-_norm(np.mean([_norm(v) for v in vectors],
                                            axis=0)) * dim])

    return ReactiveAtom(index=i, symbol=symbol, type_name='Imine',
                        coord=coord, orb_vecs=orb_vecs,
                        center=orb_vecs + coord,
                        neighbors_symbols=[SYMBOLS[int(mol.atomnos[n])] for n in nbs])


def _least_aligned_axis(v):
    '''Deterministic vector least aligned with v (replaces the reference's
    np.random.rand seed vector, reactive_atoms_classes.py:495, so the sp
    orbital frame is reproducible run to run).'''
    v = _norm(v)
    axes = np.eye(3)
    return axes[int(np.argmin(np.abs(axes @ v)))]


def build_sp_or_carbene(mol, i, conf=0, orb_dim=None):
    '''Divalent carbon/nitrogen: 'sp' (4 ring lobes orthogonal to the
    axis) when the neighbor angle is within 5 deg of linear, else
    'bent carbene' (sp2 lone pair + two p lobes)
    (reference reactive_atoms_classes.py:420-538).'''
    nbs = neighbors(mol.graph, i)
    symbol = SYMBOLS[int(mol.atomnos[i])]
    coord = mol.atomcoords[conf][i]
    others = mol.atomcoords[conf][nbs]
    vectors = others - coord
    nb_symbols = [SYMBOLS[int(mol.atomnos[n])] for n in nbs]

    v0, v1 = _norm(others[0] - coord), _norm(others[1] - coord)
    angle = np.degrees(np.arccos(np.clip(v0 @ v1, -1, 1)))
    type_name = 'sp' if abs(angle - 180) < 5 else 'bent carbene'

    # allene/ketene special frames: the reference's allene test is a
    # generator expression that is always truthy
    # (reactive_atoms_classes.py:458), so every all-carbon sp atom is
    # treated as an allene — reproduced here for parity
    allene = type_name == 'sp' and all(s == 'C' for s in nb_symbols)
    ketene_ref = None
    if type_name == 'sp' and sorted(nb_symbols) in (['C', 'O'], ['C', 'S']):
        nb_of_nb = ([n for n in neighbors(mol.graph, nbs[0]) if n != i],
                    [n for n in neighbors(mol.graph, nbs[1]) if n != i])
        if len(nb_of_nb[0]) == 2:
            ketene_ref = (mol.atomcoords[conf][nb_of_nb[0][0]]
                          - mol.atomcoords[conf][nbs[0]])
        elif len(nb_of_nb[1]) == 2:
            ketene_ref = (mol.atomcoords[conf][nb_of_nb[1][0]]
                          - mol.atomcoords[conf][nbs[1]])

    dim = _orb_dim_for(symbol, type_name, orb_dim)

    if type_name == 'sp':
        if allene:
            nb_of_first = [n for n in neighbors(mol.graph, nbs[0]) if n != i]
            ref = (mol.atomcoords[conf][nb_of_first[0]]
                   - mol.atomcoords[conf][nbs[0]])
            axis = _norm(others[0] - others[1])
            pivot1 = ref - (ref @ axis) * axis
        elif ketene_ref is not None:
            axis = _norm(others[0] - others[1])
            pivot1 = ketene_ref - (ketene_ref @ axis) * axis
        else:
            v = _least_aligned_axis(vectors[0])
            pivot1 = v - (v @ _norm(vectors[0])) * vectors[0]

        pivot2 = _norm(np.cross(pivot1, vectors[0]))
        orb_vecs = np.array([
            _rot_about(pivot2, 90) @ _rot_about(pivot1, a) @ _norm(vectors[0])
            for a in (0, 90, 180, 270)]) * dim
    else:
        sp2_lobe = -_norm(np.mean([_norm(v) for v in vectors], axis=0)) * dim
        p_vec = np.cross(_norm(vectors[0]), _norm(vectors[1]))
        orb_vecs = np.vstack([[sp2_lobe],
                              [_norm(p_vec) * dim], [-_norm(p_vec) * dim]])

    return ReactiveAtom(index=i, symbol=symbol, type_name=type_name,
                        coord=coord, orb_vecs=orb_vecs,
                        center=orb_vecs + coord,
                        neighbors_symbols=nb_symbols)


def build_metal(mol, i, conf=0, orb_dim=None):
    '''Metal center: 4 lobes ringed about the first ligand bond, phased
    120 deg from the ligand's first neighbor
    (reference reactive_atoms_classes.py:541-576).'''
    nbs = neighbors(mol.graph, i)
    symbol = SYMBOLS[int(mol.atomnos[i])]
    coord = mol.atomcoords[conf][i]
    others = mol.atomcoords[conf][nbs]
    v1 = others[0] - coord

    # neighbor-of-neighbor EXCLUDING the metal itself: the reference
    # takes neighbors(ligand)[0] blindly (reactive_atoms_classes.py:561),
    # which can be the metal and makes v2 parallel to v1 (NaN lobes) —
    # a latent reference bug, fixed here. A terminal ligand (no other
    # neighbor) falls back to an arbitrary perpendicular.
    nb_nbs = [n for n in neighbors(mol.graph, nbs[0]) if n != i]
    if nb_nbs:
        v2 = mol.atomcoords[conf][nb_nbs[0]] - coord
    else:
        helper = np.array([1.0, 0.0, 0.0]) if abs(v1[0]) < 0.9 * \
            np.linalg.norm(v1) else np.array([0.0, 1.0, 0.0])
        v2 = np.cross(v1, helper)
    orb_vec = _norm(_rot_about(np.cross(v1, v2), 120) @ v1)

    orb_vecs = np.array([_rot_about(v1, angle) @ orb_vec
                         for angle in range(0, 360, 90)])
    dim = orb_dim if orb_dim is not None else ORB_DIM_DICT['Metal']

    return ReactiveAtom(index=i, symbol=symbol, type_name='Metal',
                        coord=coord, orb_vecs=orb_vecs,
                        center=orb_vecs * dim + coord,
                        neighbors_symbols=[SYMBOLS[int(mol.atomnos[n])] for n in nbs])


# --------------------------------------------------------- type dispatch

# keyed by element symbol + bond count (reference reactive_atoms_classes.py:579-624)
ATOM_TYPE_TABLE = {
    'H1': build_single,

    'B3': build_sp2,
    'B4': build_sp3,

    'C1': build_single,
    'C2': build_sp_or_carbene,
    'C3': build_sp2,
    'C4': build_sp3,

    'N1': build_single,
    'N2': build_imine,
    'N3': build_sp2,
    'N4': build_sp3,

    'O1': build_ketone,
    'O2': build_ether,

    'P2': build_imine,
    'P3': build_sp2,
    'P4': build_sp3,

    'S1': build_ketone,
    'S2': build_ether,
    'S3': build_sp2,

    'F1': build_single,
    'Cl1': build_single,
    'Br1': build_single,
    'I1': build_single,

    # name associations for override= on the molecule line
    'Single': build_single,
    'Sp2': build_sp2,
    'Sp3': build_sp3,
    'Ether': build_ether,
    'Ketone': build_ketone,
    'Imine': build_imine,
    'Sp_or_carbene': build_sp_or_carbene,
    'Metal': build_metal,
}

METALS = ('Li', 'Na', 'Mg', 'K', 'Ca', 'Ti', 'Rb', 'Sr', 'Cs', 'Ba', 'Zn')

for _metal in METALS:
    for _bonds in range(1, 9):
        ATOM_TYPE_TABLE[f'{_metal}{_bonds}'] = build_metal


# names used by the classifier phase BEFORE orbitals are built; Ketone
# deliberately reports its pre-init repr (see build_ketone docstring)
_PRE_INIT_NAMES = {
    build_single: 'Single Bond',
    build_sp2: 'sp2',
    build_sp3: 'sp3',
    build_ether: 'Ether',
    build_ketone: 'Ketone (pre-init)',
    build_imine: 'Imine',
    build_metal: 'Metal',
}


def get_atom_builder(graph, index, override=None):
    '''Builder function for the atom's symbol+bond-count code
    (reference get_atom_type, reactive_atoms_classes.py:645-661).'''
    if override is not None:
        return ATOM_TYPE_TABLE[override]
    code = SYMBOLS[int(graph.nodes[index]['atomnos'])] + \
        str(len(neighbors(graph, index)))
    try:
        return ATOM_TYPE_TABLE[code]
    except KeyError:
        raise KeyError(f'Orbital type {code} not known (index {index})')


def pre_init_type_name(mol, builder, index, conf=0):
    '''Type name as the reference would repr it before orbital update —
    used by the sigmatropic/vicinal classifiers. Sp-or-carbene resolves
    its geometry-dependent name immediately (like the reference init).'''
    if builder is build_sp_or_carbene:
        nbs = neighbors(mol.graph, index)
        coord = mol.atomcoords[conf][index]
        others = mol.atomcoords[conf][nbs]
        v0, v1 = (_norm(others[0] - coord), _norm(others[1] - coord))
        angle = np.degrees(np.arccos(np.clip(v0 @ v1, -1, 1)))
        return 'sp' if abs(angle - 180) < 5 else 'bent carbene'
    return _PRE_INIT_NAMES[builder]
