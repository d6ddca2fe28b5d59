'''
The headline slice end to end: string-embed pose grid -> cross-fragment
clash screen -> survivor compaction (heavy atoms) -> exact bucketed RMSD
prune. Counterpart of bench.run_device_pipeline and its device programs
(bench._embed_clash_all, _embed_clash_all_mapped, _pipeline_fused).

The grid is the cartesian product over (c2, c1, l2, l1, ai): conformer
of molecule 2, conformer of molecule 1, lobe of 2, lobe of 1, spin
angle. Its C-order flattening is the generation order, and the prune's
chunk boundaries follow it, so the order is part of the semantics.
The grid is the string embed's broadcast block (embeds/string.py). Grid
math is plain PyTorch; the clash screen and the prune's pair math are
the hand-written kernels on CUDA (plain twins on the CPU).
'''

import os
import time

import numpy as np
import torch

from tscode_tpu_torch.backend import default_dtype, get_device, synchronize
from tscode_tpu_torch.embeds.common import inputs_from_numpy
from tscode_tpu_torch.embeds.string import (bcast_block, bcast_tiles,
                                            spin_angles)
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
    from tscode_tpu_torch.molecule import Molecule

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


def embed_clash_all(inp, n_angles=N_ANGLES, clash_thresh=1.5):
    '''Whole-grid embed + clash screen: (poses (B, N, 3), ok (B,)).'''
    angles = spin_angles(n_angles, inp.coords1.dtype, inp.coords1.device)
    return bcast_block(inp, angles, 0, inp.coords2.shape[0], clash_thresh)


def embed_clash_tiles(inp, n_angles=N_ANGLES, clash_thresh=1.5,
                      c2_per_tile=None):
    '''The grid in tiles of `c2_per_tile` whole c2 values (default: about
    _GRID_TILE poses a tile), in grid order: yields (poses, ok) per tile
    (the c2-tiled form of the grid).'''
    angles = spin_angles(n_angles, inp.coords1.dtype, inp.coords1.device)
    g = c2_per_tile or max(1, _GRID_TILE // (inp.n_poses_per_c2 * n_angles))
    return bcast_tiles(inp, angles, clash_thresh, g)


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
