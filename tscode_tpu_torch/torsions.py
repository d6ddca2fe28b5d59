'''
Rotable-bond discovery on the molecular graph (the graph part of
tscode_tpu/torsions.py, numpy and networkx only): double bonds, the
Torsion class, the free/dummy-rotor rules, hydrogen bonds, rotation
masks and get_torsions. The symmetry-corrected RMSD prune (rot_rmsd)
uses them. The torsional conformer search of that module is ROADMAP.md
item 14 and is not ported.
'''

import networkx as nx
import numpy as np

from tscode_tpu_torch.graphs import (get_phenyl_ids, get_quadruplets,
                                     get_sp_n, is_amide_n, is_ester_o,
                                     is_sp_n, neighbors)
from tscode_tpu_torch.pt import SYMBOLS

# --------------------------------------------------------- double bonds

# bond-length thresholds below which a bond counts as double (pair tag in
# alphabetical order). DELIBERATE EXTENSION of the reference table
# (utils.py:288-291 lists only CC and CN): the extra entries stop
# csearch from driving azo/carbonyl/thiocarbonyl and other pi bonds the
# reference would wrongly treat as rotable single bonds.
DOUBLE_BONDS_THRESHOLDS = {
    'CC': 1.4,
    'CN': 1.3,
    'CO': 1.29,
    'NN': 1.3,
    'NO': 1.25,
    'OO': 1.24,
    'CS': 1.6,
    'OS': 1.5,
    'NS': 1.58,
    'SS': 1.9,
}


def get_double_bonds_indices(coords, atomnos):
    '''Pairs of atom indices bonded more tightly than the double-bond
    threshold for their element pair (heavy atoms only).'''
    atomnos = np.asarray(atomnos)
    mask = atomnos != 1
    numbering = np.arange(len(atomnos))[mask]
    sub_coords = np.asarray(coords)[mask]
    sub_nos = atomnos[mask]

    out = []
    for a in range(len(sub_coords)):
        for b in range(a + 1, len(sub_coords)):
            tag = ''.join(sorted((SYMBOLS[int(sub_nos[a])],
                                  SYMBOLS[int(sub_nos[b])])))
            thr = DOUBLE_BONDS_THRESHOLDS.get(tag)
            if thr is not None and \
                    np.linalg.norm(sub_coords[a] - sub_coords[b]) < thr:
                out.append((int(numbering[a]), int(numbering[b])))
    return out


# -------------------------------------------------------------- Torsion

class Torsion:
    '''A rotable-bond candidate (reference torsion_module.py:41-132).'''

    def __init__(self, i1, i2, i3, i4):
        self.i1, self.i2, self.i3, self.i4 = i1, i2, i3, i4
        self.torsion = (i1, i2, i3, i4)

    def __repr__(self):
        if hasattr(self, 'n_fold'):
            return f'Torsion{self.torsion} {self.n_fold}-fold'
        return f'Torsion{self.torsion}'

    def in_cycle(self, graph):
        graph.remove_edge(self.i2, self.i3)
        cyclical = nx.has_path(graph, self.i1, self.i4)
        graph.add_edge(self.i2, self.i3)
        return cyclical

    def is_rotable(self, graph, hydrogen_bonds, keepdummy=False):
        if sorted((self.i2, self.i3)) in hydrogen_bonds:
            return False
        if _is_free(self.i2, graph) or _is_free(self.i3, graph):
            if keepdummy or (_is_nondummy(self.i2, self.i3, graph) and
                             _is_nondummy(self.i3, self.i2, graph)):
                self.n_fold = self.get_n_fold(graph)
                return True
        return False

    def get_n_fold(self, graph):
        nums = (graph.nodes[self.i2]['atomnos'],
                graph.nodes[self.i3]['atomnos'])
        if 1 in nums:
            return 6                      # H-N / H-O hydrogen-bond rotors
        if is_amide_n(self.i2, graph, mode=2) or \
                is_amide_n(self.i3, graph, mode=2):
            return 2                      # tertiary amides
        if 6 in nums or 7 in nums or 16 in nums:
            sp2 = get_sp_n(self.i2, graph)
            sp3 = get_sp_n(self.i3, graph)
            if 3 in (sp2, sp3):
                return 3
            if 2 in (sp2, sp3):
                return 2
        return 4

    def get_angles(self):
        return {2: (0, 180),
                3: (0, 120, 240),
                4: (0, 90, 180, 270),
                6: (0, 60, 120, 180, 240, 300)}[self.n_fold]

    def sort_torsion(self, graph, constrained_indices):
        '''Orient the quadruplet so rotation moves the side NOT containing
        constrained atoms (reference torsion_module.py:120-132).'''
        graph.remove_edge(self.i2, self.i3)
        for d in np.asarray(constrained_indices).flatten():
            if nx.has_path(graph, self.i2, int(d)):
                self.torsion = tuple(reversed(self.torsion))
        graph.add_edge(self.i2, self.i3)


def _is_free(index, graph):
    '''Whether a torsion hinged on this atom is conformationally free:
    conjugation locks carbonyl carbons, ester sp3 oxygens and
    secondary-amide nitrogens (reference torsion_module.py:134-156).'''
    carbonyl_like = (graph.nodes[index]['atomnos'] == 6
                     and is_sp_n(index, graph, 2)
                     and any(graph.nodes[n]['atomnos'] == 8
                             for n in neighbors(graph, index)))
    return not (carbonyl_like
                or is_amide_n(index, graph, mode=1)
                or is_ester_o(index, graph))


def _elements_match(n1, n2):
    return n1['atomnos'] == n2['atomnos']


def _is_nondummy(i, root, graph):
    '''A rotation about the (root, i) bond is "dummy" when every
    substituent branch on the far side of i is equivalent up to
    element-labeled isomorphism: spinning a methyl/CF3/tBu group or a
    symmetric flat ring (phenyl, N-pyrrolyl) yields no new conformer.
    Returns True when the rotation is worth sampling. Pinned to
    reference torsion_module.py:158-231, including its documented
    blind spots: only C/N hinge atoms are screened, and stereocenters
    are ignored (branches differing only by chirality count as equal,
    over-pruning in principle).'''
    if graph.nodes[i]['atomnos'] not in (6, 7):
        return True

    branches = [n for n in neighbors(graph, i) if n != root]

    # single linear continuation (that atom bonds only back to i and
    # one more): an alkyne/H-bond-like axis whose freedom some other
    # torsion already owns
    if len(branches) == 1 and len(neighbors(graph, branches[0])) == 2:
        return False

    if len(branches) == 2:
        ring = get_phenyl_ids(i, graph)
        if ring is not None:
            # cut the aromatic 6-ring along its para axis and compare
            # the ortho/meta halves (substituents included)
            r1, r2, r3, r4, r5, r6 = ring
            split = nx.restricted_view(
                graph, [], [(r3, r4), (r4, r5), (r1, r2), (r1, r6)])
            halves = [split.subgraph(c)
                      for c in nx.connected_components(split)
                      if r2 in c or r6 in c]
            if len(halves) == 2:
                return not nx.is_isomorphic(halves[0], halves[1],
                                            node_match=_elements_match)
            return True      # unexpected ring topology: keep sampling

    # general case: detach every branch from i and compare the
    # root-free components to each other
    pruned = nx.restricted_view(graph, [], [(i, n) for n in branches])
    detached = [c for c in nx.connected_components(pruned) if root not in c]
    if len(detached) == 1:
        # the branches reconnect away from i (e.g. tetramethylguanidyl
        # alanine's C(beta)-N bond): rotable
        return True
    parts = [pruned.subgraph(c) for c in detached]
    return not all(nx.is_isomorphic(parts[0], p,
                                    node_match=_elements_match)
                   for p in parts[1:])


def get_hydrogen_bonds(coords, atomnos, graph, d_min=2.5, d_max=3.3,
                       max_angle=45, fragments=None):
    '''Pairs of hydrogen-bonded atom indices
    (reference torsion_module.py:233-299).'''
    coords = np.asarray(coords)
    hbs = []
    het_idx = np.array([i for i, a in enumerate(atomnos) if a in (7, 8)],
                       dtype=int)

    def _angle(u, w):
        cos = np.clip(u @ w / np.linalg.norm(u) / np.linalg.norm(w), -1, 1)
        return np.degrees(np.arccos(cos))

    for a, i1 in enumerate(het_idx):
        for i2 in het_idx[a + 1:]:
            if fragments is not None:
                if any((i1 in f and i2 in f) for f in fragments):
                    continue
            d = np.linalg.norm(coords[i1] - coords[i2])
            if d_min < d < d_max:
                Hs = [i for i in (neighbors(graph, int(i1))
                                  + neighbors(graph, int(i2)))
                      if graph.nodes[i]['atomnos'] == 1]
                versor = (coords[i2] - coords[i1]) / d
                for iH in Hs:
                    v1 = coords[iH] - coords[i1]
                    v2 = coords[iH] - coords[i2]
                    d1, d2 = np.linalg.norm(v1), np.linalg.norm(v2)
                    l1 = v1 @ versor
                    l2 = v2 @ -versor
                    alfa = _angle(v1, versor) if l1 < l2 else _angle(v2, -versor)
                    if alfa < max_angle:
                        hbs.append(sorted((int(iH), int(i2 if d1 < d2 else i1))))
                        break
    return hbs


def get_rotation_mask(graph, torsion):
    '''Bool mask of atoms to move when rotating about the i2-i3 bond
    (reference torsion_module.py:301-325).'''
    i1, i2, i3, _ = torsion
    graph.remove_edge(i2, i3)
    reachable = nx.shortest_path(graph, i1).keys()
    graph.add_edge(i2, i3)
    mask = np.array([i in reachable for i in graph.nodes], dtype=bool)
    if np.count_nonzero(mask) > len(mask) // 2:
        mask = ~mask
    mask[i2] = False
    return mask


def get_torsions(graph, hydrogen_bonds, double_bonds, keepdummy=False):
    '''Rotable Torsion objects (reference torsion_module.py:352-371).'''
    torsions = []
    db_set = {tuple(sorted(db)) for db in double_bonds}
    for path in get_quadruplets(graph):
        _, i2, i3, _ = path
        if tuple(sorted((i2, i3))) in db_set:
            continue
        t = Torsion(*(int(x) for x in path))
        if (not t.in_cycle(graph)) and \
                t.is_rotable(graph, hydrogen_bonds, keepdummy=keepdummy):
            torsions.append(t)
    return torsions
