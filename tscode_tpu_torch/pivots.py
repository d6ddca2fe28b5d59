'''
Pivot construction for cyclical embeds (counterpart of
tscode_tpu/pivots.py, whose only jax dependency is cartesian_product).

Builds, per conformer, every vector connecting two orbital lobes (on the
two reactive atoms, or on the single reactive atom for chelotropic
embeds) and applies the suprafacial / sigmastar filters (reference
embedder.py:542-621).
'''

import numpy as np

from tscode_tpu_torch.molecule import Pivot
from tscode_tpu_torch.ops.linalg import cartesian_product


def _pivots_for_conf(mol, c):
    '''One conformer's raw pivot list.'''
    r_atoms = mol.get_r_atoms(c)
    out = []

    if len(r_atoms) == 2:
        a1, a2 = r_atoms
        indices = cartesian_product(np.arange(len(a1.center)),
                                    np.arange(len(a2.center)))
        for i, j in indices:
            out.append(Pivot(a1.center[i], a2.center[j], a1, a2, i, j))

    elif len(r_atoms) == 1:
        # chelotropic: pivots connect two lobes of the same atom,
        # keeping only ordered index pairs (i < j)
        a1 = r_atoms[0]
        indices = cartesian_product(np.arange(len(a1.center)),
                                    np.arange(len(a1.center)))
        for i, j in indices:
            if i < j:
                out.append(Pivot(a1.center[i], a1.center[j], a1, a1, i, j))

    return out


def get_pivots(mol):
    '''List (per conformer) of np.arrays of Pivot objects.'''
    if not mol.reactive_atoms:
        return []
    return [np.array(_pivots_for_conf(mol, c), dtype=object)
            for c in range(mol.n_confs)]


def set_pivots(mol, suprafacial=False, confs=None):
    '''
    Attach mol.pivots with the embedder's filters:
     * suprafacial: of 4 pivots (2 lobes x 2 lobes), keep the 2 shortest
     * sigmastar molecules keep only the shortest pivot length
    (reference embedder.py:542-573)
    confs: optional conformer ids to rebuild; other conformers keep
    their current pivots (the list container is copied first, so a
    scoped rebuild never mutates a molecule sharing it). Used by the
    bending loop.
    '''
    if confs is None or not getattr(mol, 'pivots', None):
        mol.pivots = get_pivots(mol)
        confs = None
    else:
        mol.pivots = list(mol.pivots)
        for c in confs:
            mol.pivots[c] = np.array(_pivots_for_conf(mol, c),
                                     dtype=object)

    for c in (range(mol.n_confs) if confs is None else confs):
        if suprafacial and len(mol.pivots[c]) == 4:
            norms = np.array([np.linalg.norm(p.pivot) for p in mol.pivots[c]])
            # keep the two shortest (the reference scans samples until a
            # threshold keeps exactly 2, embedder.py:557-563)
            for sample in norms:
                to_keep = [n for n in norms if sample >= n]
                if len(to_keep) == 2:
                    mask = np.array([n in to_keep for n in norms])
                    mol.pivots[c] = mol.pivots[c][mask]
                    break

        if getattr(mol, 'sp3_sigmastar', False) and len(mol.pivots[c]):
            lengths = [np.linalg.norm(p.pivot) for p in mol.pivots[c]]
            shortest = min(lengths)
            mask = np.array([(l - shortest) < 1e-5 for l in lengths])
            mol.pivots[c] = mol.pivots[c][mask]

    return mol.pivots
