'''
Symmetry-corrected RMSD pruning.

For torsions that are "dummy" (locally symmetric rotors: phenyl, tBu,
CF3...), plain RMSD overestimates dissimilarity: two structures that
differ only by a symmetric-rotor twist are chemically identical. This
pruner finds, per dummy torsion, the n-fold rotation minimizing the
LOCAL heavy-atom RMSD, applies all optimal corrections, and then prunes
on the globally corrected RMSD.
(reference torsion_module.py:953-1161; counterpart of
tscode_tpu/rot_rmsd.py, the same host numpy)

The ensemble size is capped at 750 by the reference's own envelope, so
this stage is host-side numpy; candidate rotations per torsion are
evaluated with closed-form Kabsch on small heavy-atom slices.
'''

import networkx as nx
import numpy as np

from tscode_tpu_torch.torsions import (get_double_bonds_indices,
                                       get_hydrogen_bonds, get_rotation_mask,
                                       get_torsions, _is_nondummy)

K_SCHEDULE = (5e5, 2e5, 1e5, 5e4, 2e4, 1e4,
              5000, 2000, 1000, 500, 200, 100,
              50, 20, 10, 5, 2, 1)


def _kabsch_rmsd(P, Q):
    '''RMSD after optimal rotation, NO centering (rmsd-package
    kabsch_rmsd semantics used by the reference at :989, :1011).'''
    C = P.T @ Q
    V, _, W = np.linalg.svd(C)
    if np.linalg.det(V) * np.linalg.det(W) < 0:
        V = V.copy()
        V[:, -1] = -V[:, -1]
    diff = P @ (V @ W) - Q
    return np.sqrt((diff * diff).sum() / len(P))


def _rotate(coords, torsion, angle, mask):
    '''Functional dihedral rotation about the torsion's central bond.'''
    i2, i3 = torsion[1], torsion[2]
    axis = coords[i2] - coords[i3]
    axis = axis / np.linalg.norm(axis)
    half = np.radians(angle) / 2
    s, c = np.sin(half), np.cos(half)
    x, y, z, w = s * axis[0], s * axis[1], s * axis[2], c
    R = np.array([
        [2 * (w * w + x * x) - 1, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 2 * (w * w + y * y) - 1, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 2 * (w * w + z * z) - 1]])
    center = coords[i3]
    out = coords.copy()
    out[mask] = (R @ (coords[mask] - center).T).T + center
    return out


def _dummy_torsion_setup(structures, atomnos, graph):
    '''Discover dummy torsions, their angle sets, rotation masks and
    local heavy subgraphs (reference :1026-1049, hoisted out of the
    pair loop since they depend only on the graph).'''
    ref = structures[0]
    hydrogen_bonds = get_hydrogen_bonds(ref, atomnos, graph)
    for hb in hydrogen_bonds:
        graph.add_edge(*hb)

    torsions = get_torsions(
        graph, hydrogen_bonds=get_hydrogen_bonds(ref, atomnos, graph),
        double_bonds=get_double_bonds_indices(ref, atomnos),
        keepdummy=True)

    torsions = [t for t in torsions
                if not (_is_nondummy(t.i2, t.i3, graph) and
                        _is_nondummy(t.i3, t.i2, graph))]
    torsions = [t for t in torsions
                if 1 not in [atomnos[i] for i in t.torsion]]

    angles = [t.get_angles() for t in torsions]
    quads = [t.torsion if _is_nondummy(t.i2, t.i3, graph)
             else tuple(reversed(t.torsion)) for t in torsions]

    masks, local_nodes = [], []
    for i, quad in enumerate(quads):
        # chop the graph along all OTHER dummy torsions and take the
        # heavy atoms of the component containing this torsion's i2
        for j, other in enumerate(quads):
            if j != i:
                graph.remove_edge(other[1], other[2])
        comp = next(s for s in nx.connected_components(graph)
                    if quad[1] in s)
        local_nodes.append([n for n in comp if atomnos[n] != 1])
        for j, other in enumerate(quads):
            if j != i:
                graph.add_edge(other[1], other[2])
        masks.append(get_rotation_mask(graph, quad))

    return quads, angles, masks, local_nodes, hydrogen_bonds


def rotationally_corrected_rmsd(ref, coord, atomnos, quads, angles,
                                masks, local_nodes):
    '''Globally corrected heavy-atom RMSD after per-dummy-torsion
    optimal rotations (reference :953-1011).'''
    corrections = [0] * len(quads)
    for i, quad in enumerate(quads):
        best = 1e10
        for angle in angles[i]:
            cand = _rotate(coord, quad, angle, masks[i])
            local = _kabsch_rmsd(ref[local_nodes[i]], cand[local_nodes[i]])
            if local < best:
                best = local
                corrections[i] = angle

    for quad, opt_angle, mask in zip(quads, corrections, masks):
        coord = _rotate(coord, quad, opt_angle, mask)

    heavy = atomnos != 1
    return _kabsch_rmsd(ref[heavy], coord[heavy])


def prune_conformers_rmsd_rot_corr(structures, atomnos, graph,
                                   max_rmsd=0.25, verbose=False,
                                   logfunction=None):
    '''Bucketed symmetry-corrected pruning; returns (pruned, keep_mask).
    Skipped for >750 structures or when no dummy rotors exist
    (reference :1013-1161).'''
    structures = np.array([s - s.mean(axis=0) for s in structures])
    atomnos = np.asarray(atomnos)
    n = len(structures)
    final_mask = np.ones(n, dtype=bool)

    if n > 750:
        return structures[final_mask], final_mask

    quads, angles, masks, local_nodes, hydrogen_bonds = \
        _dummy_torsion_setup(structures, atomnos, graph)

    if len(quads) == 0:
        for hb in hydrogen_bonds:
            if graph.has_edge(*hb):
                graph.remove_edge(*hb)
        return structures[final_mask], final_mask

    if logfunction is not None:
        logfunction('\n >> Dihedrals considered for subsymmetry corrections:')
        for i, (quad, angle) in enumerate(zip(quads, angles)):
            logfunction(f' {i:2} - {str(quad):21s} : {len(angle)}-fold')
        logfunction('\n')

    cache_set = set()
    for k in K_SCHEDULE:
        num_active = int(np.count_nonzero(final_mask))
        if not (k == 1 or 5 * k < num_active):
            continue
        d = int(n // k)
        for step in range(int(k)):
            lo = d * step
            hi = num_active if step == k - 1 else int(d * (step + 1))
            _l = hi - lo
            matches = set()
            for i_rel in range(_l):
                for j_rel in range(i_rel + 1, _l):
                    i_abs, j_abs = i_rel + lo, j_rel + lo
                    if (i_abs, j_abs) in cache_set:
                        continue
                    rmsd = rotationally_corrected_rmsd(
                        structures[i_abs], structures[j_abs], atomnos,
                        quads, angles, masks, local_nodes)
                    if rmsd < max_rmsd:
                        matches.add((i_rel, j_rel))
                        break
                    cache_set.add((i_abs, j_abs))

            g = nx.Graph(matches)
            for c in nx.connected_components(g):
                nodes = tuple(g.subgraph(c).nodes)
                for i in set(nodes) - {nodes[0]}:
                    final_mask[i + lo] = False

    for hb in hydrogen_bonds:
        if graph.has_edge(*hb):
            graph.remove_edge(*hb)

    return structures[final_mask], final_mask
