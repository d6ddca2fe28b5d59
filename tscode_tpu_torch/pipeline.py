'''
The headline slice end to end: string-embed pose grid -> cross-fragment
clash screen -> survivor compaction (heavy atoms) -> exact bucketed RMSD
prune. Counterpart of bench.run_device_pipeline and its device programs
(bench._embed_clash_all, _embed_clash_all_mapped, _pipeline_fused).

The grid is the cartesian product over (c2, c1, l2, l1, ai): conformer
of molecule 2, conformer of molecule 1, lobe of 2, lobe of 1, spin
angle. Its C-order flattening is the generation order, and the prune's
chunk boundaries follow it, so the order is part of the semantics.
Grid math is plain PyTorch; the clash screen and the prune's pair math
are the hand-written kernels on CUDA (plain twins on the CPU).
'''

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from tscode_tpu_torch.backend import default_dtype, get_device, synchronize
from tscode_tpu_torch.embeds.common import stacked_lobes
from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask, static_pairs
from tscode_tpu_torch.ops.kernels.clash import clash_ok
from tscode_tpu_torch.ops.linalg import (rot_mat_from_pointer,
                                         rotation_matrix_from_vectors)
from tscode_tpu_torch.ops.rmsd_prune import prune_conformers_rmsd_device

N_CONFS = 76          # noisy conformers per molecule in the headline
N_ANGLES = 36
NOISE = 0.35          # A of per-conformer jitter
SEED = 2026
FIXTURES = ('C2H4.xyz', 'CH3Cl.xyz')
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tests', 'fixtures')

# above this many poses the grid is built in tiles of whole c2 values,
# each about _GRID_TILE poses, compacting survivors tile by tile so live
# memory stays at one tile's intermediates
WHOLE_GRID_MAX = 1 << 21
_GRID_TILE = 1 << 18


def build_workload(n_confs=N_CONFS):
    '''Two fixture molecules, each tiled to `n_confs` noisy conformers
    (seed 2026, 0.35 A noise): the same rng calls as
    bench.build_workload, so the molecules are bit for bit the same.
    76 conformers give the 76*76*2*36 = 415,872-pose headline grid.'''
    from tscode_tpu.molecule import Molecule

    rng = np.random.default_rng(SEED)
    mols = []
    for name in FIXTURES:
        mol = Molecule(os.path.join(FIXTURE_DIR, name), reactive_indices=[0])
        base = mol.atomcoords[0]
        mol.atomcoords = base[None] + rng.normal(
            size=(n_confs,) + base.shape) * NOISE
        mol.compute_orbitals()
        mols.append(mol)
    return mols


@dataclass
class PipelineInputs:
    '''The slice's state on the device: conformer ensembles and lobes.'''
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
        return (self.centers1.shape[0] * self.centers1.shape[1]
                * self.centers2.shape[1])

    @property
    def n_atoms(self):
        return self.coords1.shape[1] + self.coords2.shape[1]


def inputs_from_numpy(mol1, mol2, device, dtype):
    '''The JAX package's host arrays (Molecule.atomcoords, stacked_lobes
    centers and vectors, atomnos, the cross-fragment pair mask) as the
    port's tensors on `device` in `dtype`.'''
    dev = get_device(device)
    centers1, vecs1 = stacked_lobes(mol1)
    centers2, vecs2 = stacked_lobes(mol2)
    pair_mask = cross_fragment_pair_mask((mol1.n_atoms, mol2.n_atoms))
    atomnos = np.concatenate([mol1.atomnos, mol2.atomnos])

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return PipelineInputs(
        coords1=t(mol1.atomcoords), coords2=t(mol2.atomcoords),
        centers1=t(centers1), vecs1=t(vecs1),
        centers2=t(centers2), vecs2=t(vecs2),
        pair_mask=torch.as_tensor(pair_mask, device=dev),
        pairs=torch.as_tensor(static_pairs(pair_mask), device=dev),
        heavy_idx=torch.as_tensor(np.flatnonzero(atomnos != 1), device=dev))


def spin_angles(n_angles, dtype, device):
    '''Spin angles 0, 360/n, ..., 360 - 360/n in degrees.'''
    return torch.as_tensor(
        np.linspace(0.0, 360.0 - 360.0 / n_angles, n_angles),
        dtype=dtype, device=device)


def _embed_clash_block(inp, angles, c2_lo, c2_hi, clash_thresh):
    '''Poses and clash accept mask for the grid rows of c2 values
    [c2_lo, c2_hi), by broadcasting over (c2, c1, l2, l1, ai).'''
    coords2 = inp.coords2[c2_lo:c2_hi]
    n1c, k1 = inp.centers1.shape[0], inp.centers1.shape[1]
    g, k2 = c2_hi - c2_lo, inp.centers2.shape[1]
    A = angles.shape[0]

    p1 = inp.centers1[None, :, None, :, None]           # (1, n1c, 1, k1, 1, 3)
    ref_vec = inp.vecs1[None, :, None, :, None]
    p2 = inp.centers2[c2_lo:c2_hi, None, :, None, None]  # (g, 1, k2, 1, 1, 3)
    mol_vec = inp.vecs2[c2_lo:c2_hi, None, :, None, None]

    align = rotation_matrix_from_vectors(mol_vec, -ref_vec)
    spin = rot_mat_from_pointer(ref_vec.expand(1, n1c, 1, k1, A, 3),
                                angles.expand(1, n1c, 1, k1, A))
    R = spin @ align                                    # (g, n1c, k2, k1, A, 3, 3)
    t = p1 - (R @ p2.unsqueeze(-1)).squeeze(-1)

    f2 = coords2[:, None, None, None, None] @ R.transpose(-1, -2) \
        + t[..., None, :]
    shape5 = (g, n1c, k2, k1, A)
    f1 = inp.coords1[None, :, None, None, None].expand(
        shape5 + inp.coords1.shape[1:])
    f2 = f2.expand(shape5 + f2.shape[-2:])
    poses = torch.cat([f1, f2], dim=-2).reshape(-1, inp.n_atoms, 3)
    return poses, clash_ok(poses, inp.pairs, clash_thresh)


def embed_clash_all(inp, n_angles=N_ANGLES, clash_thresh=1.5):
    '''Whole-grid embed + clash screen: (poses (B, N, 3), ok (B,)).'''
    angles = spin_angles(n_angles, inp.coords1.dtype, inp.coords1.device)
    return _embed_clash_block(inp, angles, 0, inp.coords2.shape[0],
                              clash_thresh)


def embed_clash_tiles(inp, n_angles=N_ANGLES, clash_thresh=1.5,
                      c2_per_tile=None):
    '''The grid in tiles of `c2_per_tile` whole c2 values (default: about
    _GRID_TILE poses a tile), in grid order: yields (poses, ok) per tile
    (the c2-tiled form of the grid).'''
    angles = spin_angles(n_angles, inp.coords1.dtype, inp.coords1.device)
    g = c2_per_tile or max(1, _GRID_TILE // (inp.n_poses_per_c2 * n_angles))
    n2c = inp.coords2.shape[0]
    for c2_lo in range(0, n2c, g):
        yield _embed_clash_block(inp, angles, c2_lo, min(n2c, c2_lo + g),
                                 clash_thresh)


def clash_survivors(inp, n_angles=N_ANGLES, clash_thresh=1.5):
    '''Embed + clash + compaction: (ok (B,) bool, hs (S, H, 3)), the
    heavy atoms of the clash survivors in grid order. Heavy atoms are
    sliced in the same gather that picks the survivor rows. Grids past
    WHOLE_GRID_MAX poses are built and compacted tile by tile.'''
    B = inp.n_poses_per_c2 * n_angles * inp.coords2.shape[0]
    tiles = ([embed_clash_all(inp, n_angles, clash_thresh)]
             if B <= WHOLE_GRID_MAX
             else embed_clash_tiles(inp, n_angles, clash_thresh))
    oks, parts = [], []
    for poses, ok in tiles:
        idx = torch.nonzero(ok).squeeze(1)
        parts.append(poses[idx[:, None], inp.heavy_idx[None, :]])
        oks.append(ok)
    return torch.cat(oks), torch.cat(parts).contiguous()


def run_pipeline(mol1, mol2, *, device, dtype=None, n_angles=N_ANGLES,
                 clash_thresh=1.5, rmsd_thr=0.5, return_masks=False):
    '''Embed + clash + RMSD prune on `device` (mirrors
    bench.run_device_pipeline). Inputs go to the device before the
    clock starts; the clock stops after the keep mask is on the host.
    Returns (n_poses, seconds, n_clash_ok, n_final); with
    return_masks=True a fifth element, a dict with the clash accept
    mask `clash_ok` (B,), the keep mask `keep` over the clash survivors
    (S,), and the stage times `embed_clash_s` and `prune_s`.'''
    dev = get_device(device)
    dtype = dtype or default_dtype(dev)
    inp = inputs_from_numpy(mol1, mol2, dev, dtype)

    synchronize(dev)
    t0 = time.perf_counter()
    ok, hs = clash_survivors(inp, n_angles, clash_thresh)
    synchronize(dev)
    t1 = time.perf_counter()
    keep = prune_conformers_rmsd_device(hs, rmsd_thr=rmsd_thr)
    t2 = time.perf_counter()

    n_poses, n_ok, n_final = ok.shape[0], hs.shape[0], int(keep.sum())
    if not return_masks:
        return n_poses, t2 - t0, n_ok, n_final
    return n_poses, t2 - t0, n_ok, n_final, {
        'clash_ok': ok.cpu().numpy(), 'keep': keep,
        'embed_clash_s': t1 - t0, 'prune_s': t2 - t1}
