'''
Shared embed machinery: lobe stacking, the two-molecule grid inputs on
the device, grid index arrays and the device-resident survivor
accumulator (counterpart of the parts of tscode_tpu/embeds/common.py
that the ported routes run; copied because that module imports jax).
'''

from dataclasses import dataclass

import numpy as np
import torch

from tscode_tpu_torch.backend import get_device
from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask, static_pairs


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


def flat_grid(*sizes):
    '''Index arrays for a nested loop over `sizes`, the FIRST size
    outermost: one (prod(sizes),) int32 array per size, in C order
    (last index fastest), the reference's generation order.'''
    grids = np.indices(sizes).reshape(len(sizes), -1)
    return [g.astype(np.int32) for g in grids]


@dataclass
class GridInputs:
    '''Two molecules' conformer ensembles and reactive-atom lobes on the
    device: what the string-embed pose grid is built from.'''
    coords1: torch.Tensor     # (n1c, N1, 3)
    coords2: torch.Tensor     # (n2c, N2, 3)
    centers1: torch.Tensor    # (n1c, k1, 3)
    vecs1: torch.Tensor       # (n1c, k1, 3)
    centers2: torch.Tensor    # (n2c, k2, 3)
    vecs2: torch.Tensor       # (n2c, k2, 3)
    pair_mask: torch.Tensor   # (N, N) bool, cross-fragment pairs
    pairs: torch.Tensor       # (P, 2) int32, the same pairs listed
    heavy_idx: torch.Tensor   # (H,) int64, non-hydrogen atoms

    @property
    def n_poses_per_c2(self):
        '''Grid rows per conformer of molecule 2, per spin angle.'''
        return (self.centers1.shape[0] * self.centers1.shape[1]
                * self.centers2.shape[1])

    @property
    def n_atoms(self):
        return self.coords1.shape[1] + self.coords2.shape[1]


def inputs_from_numpy(mol1, mol2, device, dtype):
    '''The host arrays of two Molecules (atomcoords, stacked lobe
    centers and vectors, atomnos, the cross-fragment pair mask) as
    GridInputs on `device` in `dtype`.'''
    dev = get_device(device)
    centers1, vecs1 = stacked_lobes(mol1)
    centers2, vecs2 = stacked_lobes(mol2)
    pair_mask = cross_fragment_pair_mask((mol1.n_atoms, mol2.n_atoms))
    atomnos = np.concatenate([mol1.atomnos, mol2.atomnos])

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return GridInputs(
        coords1=t(mol1.atomcoords), coords2=t(mol2.atomcoords),
        centers1=t(centers1), vecs1=t(vecs1),
        centers2=t(centers2), vecs2=t(vecs2),
        pair_mask=torch.as_tensor(pair_mask, device=dev),
        pairs=torch.as_tensor(static_pairs(pair_mask), device=dev),
        heavy_idx=torch.as_tensor(np.flatnonzero(atomnos != 1), device=dev))


class DeviceSurvivors:
    '''Counterpart of MaskedPullAccumulator(pull=False): per screened
    tile, the rows of each field that pass the mask are compacted on the
    device (one nonzero and one gather per field), in generation order;
    the full tiles are not kept. finish() returns the compacted fields,
    still on the device, and the whole mask as a host array: the mask is
    the only thing that reaches the host.'''

    def __init__(self):
        self._masks = []
        self._parts = []

    def add(self, fields, mask):
        idx = torch.nonzero(mask).squeeze(1)
        self._parts.append(tuple(f[idx] for f in fields))
        self._masks.append(mask)

    def finish(self):
        '''(fields tuple of (S, ...) device tensors, mask (B,) numpy).'''
        if not self._masks:
            return (), np.zeros(0, dtype=bool)
        mask = torch.cat(self._masks).cpu().numpy()
        fields = tuple(torch.cat([p[f] for p in self._parts])
                       for f in range(len(self._parts[0])))
        return fields, mask
