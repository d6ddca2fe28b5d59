'''
Molecular graph model (host-side).

Bond inference and the graph classifiers the embed/torsion layers rely on.
Mirrors the behavior of the reference's graph utilities
(TSCoDe's graph_manipulations.py) with one structural
difference: bond inference is a single vectorized distance-matrix pass
(numpy) instead of a per-pair Python loop, so graph construction is
O(N^2) array work rather than O(N^2) interpreter work.

Graphs stay host-side NetworkX objects: they are tiny (~100 nodes), built
once per molecule, and only their *derived masks* (rotation masks,
fragment ids, torsion quadruplets) travel to the TPU.
'''

from copy import deepcopy
from itertools import combinations

import networkx as nx
import numpy as np

from tscode_tpu_torch.pt import COVALENT_RADII


def d_min_bond(z1, z2):
    '''Max bonding distance for two atomic numbers (covalent radii x 1.2,
    reference graph_manipulations.py:28-31).'''
    return 1.2 * (COVALENT_RADII[z1] + COVALENT_RADII[z2])


def bond_matrix(coords, atomnos, mask=None):
    '''
    Vectorized bond inference: (N, N) upper-triangular-or-diagonal bool
    adjacency where d(i, j) < 1.2 * (r_i + r_j). The diagonal is True
    (zero distance), faithfully reproducing the reference's self-loop
    quirk (graphize evaluates j >= i including j == i,
    graph_manipulations.py:46-50); `neighbors` filters self out.
    '''
    coords = np.asarray(coords)
    atomnos = np.asarray(atomnos)
    radii = COVALENT_RADII[atomnos]
    thresh = 1.2 * (radii[:, None] + radii[None, :])
    diff = coords[:, None, :] - coords[None, :, :]
    d = np.sqrt((diff * diff).sum(-1))
    adj = d < thresh
    adj &= np.triu(np.ones_like(adj, dtype=bool))
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        adj &= mask[:, None] & mask[None, :]
    return adj


def graphize(coords, atomnos, mask=None):
    '''Connectivity graph with 'atomnos' node attributes
    (reference graph_manipulations.py:33-55).'''
    adj = bond_matrix(coords, atomnos, mask=mask)
    graph = nx.from_numpy_array(adj.astype(float))
    nx.set_node_attributes(graph, dict(enumerate(np.asarray(atomnos))), 'atomnos')
    return graph


def neighbors(graph, index):
    '''Bonded neighbors of a node, excluding itself (self-loops exist).'''
    nbs = list(graph.neighbors(index))
    if index in nbs:
        nbs.remove(index)
    return nbs


def get_sp_n(index, graph):
    '''
    Apex n of sp^n hybridization for C/N/O/P/S by neighbor count
    (reference graph_manipulations.py:73-94). None when not applicable.
    '''
    element = graph.nodes[index]['atomnos']
    table = {
        6: {2: 1, 3: 2, 4: 3},
        7: {2: 2, 3: None, 4: 3},
        8: {1: 2, 2: 3, 3: 3, 4: 3},
        15: {2: 2, 3: 3, 4: 3},
        16: {2: 2, 3: 3, 4: 3},
    }
    if element not in table:
        return None
    return table[element].get(len(neighbors(graph, index)))


def is_sp_n(index, graph, n):
    return get_sp_n(index, graph) == n


def is_amide_n(index, graph, mode=-1):
    '''
    True when `index` is an amide nitrogen (carbamates/ureas count).
    mode: -1 any, 0 primary (2 H), 1 secondary (1 H), 2 tertiary (0 H).
    (reference graph_manipulations.py:96-131)
    '''
    if graph.nodes[index]['atomnos'] != 7:
        return False
    nbs = neighbors(graph, index)
    nb_atomnos = [graph.nodes[j]['atomnos'] for j in nbs]

    if mode != -1 and nb_atomnos.count(1) != (2, 1, 0)[mode]:
        return False

    for n in nbs:
        if graph.nodes[n]['atomnos'] == 6:
            nb_nb = neighbors(graph, n)
            if len(nb_nb) == 3:
                if 8 in (graph.nodes[i]['atomnos'] for i in nb_nb):
                    return True
    return False


def is_ester_o(index, graph):
    '''
    True when `index` is an ester-type oxygen (carbamates/carbonates yes,
    carboxylic acids no). (reference graph_manipulations.py:133-150)
    '''
    if graph.nodes[index]['atomnos'] != 8:
        return False
    nbs = neighbors(graph, index)
    if any(graph.nodes[n]['atomnos'] == 1 for n in nbs):
        # hydrogen-bearing O = acid/alcohol, not ester. The reference
        # tests `1 in neighbors`, i.e. node INDEX 1 rather than element
        # H (graph_manipulations.py:142) — a bug (acid OH oxygens would
        # classify as ester unless the H happens to sit at index 1),
        # fixed here per the project convention.
        return False
    for n in nbs:
        if graph.nodes[n]['atomnos'] == 6:
            nb_nb = neighbors(graph, n)
            if len(nb_nb) == 3:
                if sum(graph.nodes[i]['atomnos'] == 8 for i in nb_nb) > 1:
                    return True
    return False


def _dihedral_np(p):
    '''Praxeolitic dihedral (degrees), numpy host version.'''
    p0, p1, p2, p3 = p
    b0 = -(p1 - p0)
    b1 = p2 - p1
    b1 = b1 / np.linalg.norm(b1)
    b2 = p3 - p2
    v = b0 - (b0 @ b1) * b1
    w = b2 - (b2 @ b1) * b1
    return np.degrees(np.arctan2(np.cross(b1, v) @ w, v @ w))


def is_phenyl(coords):
    '''
    True when six C/N coordinates look like an aromatic ring: all pairs
    within 3 A and the 0-1-2-3 dihedral within 10 degrees of planar
    (reference graph_manipulations.py:152-174).
    '''
    coords = np.asarray(coords)
    diff = coords[:, None, :] - coords[None, :, :]
    if np.sqrt((diff * diff).sum(-1)).max() > 3:
        return False
    threshold_delta = 1 - np.cos(np.radians(10))
    flat_delta = 1 - np.abs(np.cos(np.radians(_dihedral_np(coords[[0, 1, 2, 3]]))))
    return bool(flat_delta < threshold_delta)


def get_phenyls(coords, atomnos):
    '''All 6-atom C/N combinations that look aromatic: (n, 6, 3)
    (reference graph_manipulations.py:176-195).'''
    atomnos = np.asarray(atomnos)
    if len(atomnos) < 6:
        return np.array([])
    out = []
    c_n = [i for i, a in enumerate(atomnos) if a in (6, 7)]
    for c in combinations(c_n, 6):
        sub = np.asarray(coords)[list(c)]
        if is_phenyl(sub):
            out.append(sub)
    return np.array(out)


def get_phenyl_ids(i, graph):
    '''Six heavy-atom ring indices through node i, or None
    (reference graph_manipulations.py:197-210).'''
    for n in neighbors(graph, i):
        for path in nx.all_simple_paths(graph, source=i, target=n, cutoff=6):
            if len(path) == 6:
                if all(graph.nodes[p]['atomnos'] != 1 for p in path):
                    if all(len(neighbors(graph, p)) == 3 for p in path):
                        return path
    return None


def find_paths(graph, u, n, exclude_set=None):
    '''All simple paths of length n starting at u
    (reference graph_manipulations.py:212-229).'''
    if exclude_set is None:
        exclude_set = {u}
    else:
        exclude_set.add(u)
    if n == 0:
        return [[u]]
    paths = [[u] + path
             for neighbor in graph.neighbors(u) if neighbor not in exclude_set
             for path in find_paths(graph, neighbor, n - 1, exclude_set)]
    exclude_set.remove(u)
    return paths


def get_quadruplets(graph):
    '''
    Non-redundant torsion quadruplets: one 4-path per central bond, the
    first found in node-iteration order (reference torsion_module.py:327-350
    — the kept representative depends on that order, which we reproduce).
    Returns (Q, 4) int array.
    '''
    allpaths = []
    for node in graph:
        allpaths.extend(find_paths(graph, node, 3))

    quadruplets, seen = [], set()
    for path in allpaths:
        _, i2, i3, _ = path
        q_id = tuple(sorted((i2, i3)))
        if q_id not in seen:
            quadruplets.append(path)
            seen.add(q_id)
    return np.array(quadruplets)


_SP2_TYPE_NAMES = ('Ketone', 'Imine', 'sp2', 'sp', 'bent carbene')
_VICINAL_TYPE_NAMES = ('sp3', 'Single Bond')


def is_sigmatropic_names(type_names, coords, reactive_indices, graph):
    '''
    Sigmatropic classification from reactive-atom type NAMES: 2 reactive
    atoms, both sp2-like, < 3 A apart, joined by a path of atoms each
    making <= 3 bonds (reference graph_manipulations.py:231-273).
    `type_names`: str per reactive index, order matching reactive_indices.
    '''
    if len(reactive_indices) != 2:
        return False
    i1, i2 = reactive_indices
    if np.linalg.norm(np.asarray(coords)[i1] - np.asarray(coords)[i2]) >= 3:
        return False
    if not all(name in _SP2_TYPE_NAMES for name in type_names):
        return False
    for path in nx.all_simple_paths(graph, i1, i2):
        if all(len(neighbors(graph, idx)) - 2 <= 1 for idx in path[1:-1]):
            return True
    return False


def is_vicinal_names(type_names, reactive_indices, graph):
    '''
    Vicinal (sigma-star) classification from type NAMES: 2 reactive atoms,
    both sp3/single-bond type, directly bonded
    (reference graph_manipulations.py:275-298).
    '''
    if len(reactive_indices) != 2:
        return False
    if not all(name in _VICINAL_TYPE_NAMES for name in type_names):
        return False
    i1, i2 = reactive_indices
    return i1 in neighbors(graph, i2)


def get_sum_graph(graph_list, extra_edges=None):
    '''
    Disjoint union of graphs with cumulative numbering, plus optional
    extra edges; sets .is_single_molecule
    (reference graph_manipulations.py:300-326).
    '''
    first, *extra = graph_list
    out = deepcopy(first)
    cum_atomnos = list(nx.get_node_attributes(first, 'atomnos').values())

    for g in extra:
        n = len(out.nodes())
        for e1, e2 in g.edges():
            out.add_edge(e1 + n, e2 + n)
        cum_atomnos += list(nx.get_node_attributes(g, 'atomnos').values())

    out.is_single_molecule = len(list(nx.connected_components(out))) == 1

    if extra_edges is not None:
        for e1, e2 in extra_edges:
            out.add_edge(e1, e2)

    nx.set_node_attributes(out, dict(enumerate(cum_atomnos)), 'atomnos')
    return out
