'''
Shared embed machinery (the part of tscode_tpu/embeds/common.py that the
slice runs; copied because that module imports jax).
'''

import numpy as np


def stacked_lobes(mol, atom_position=0):
    '''Per-conformer lobe centers and orbital vectors of the
    `atom_position`-th reactive atom, stacked to (n_confs, K, 3) numpy
    arrays. Lobe counts must be conformer-invariant.'''
    centers, vecs = [], []
    for c in range(mol.n_confs):
        atom = mol.get_r_atoms(c)[atom_position]
        centers.append(atom.center)
        vecs.append(atom.orb_vecs)
    k = {len(c) for c in centers}
    if len(k) != 1:
        raise ValueError(
            f'{mol.name}: lobe count varies across conformers ({k}); '
            f'pad or restrict conformers first.')
    return np.array(centers), np.array(vecs)
