'''
String embed: two molecules, one reactive atom each (counterpart of
tscode_tpu/embeds/string.py, production form).

The (c2, c1, l2, l1, angle) grid (conformer of molecule 2, conformer of
molecule 1, lobe of 2, lobe of 1, spin angle) is built by broadcasting,
with no per-pose gathers, in tiles of whole c2 values; the C-order
flattening is the reference's generation order, on which the novelty
filter depends. Per tile: the poses, the clash screen (kernel K1 on
CUDA, its plain twin on the CPU), survivor compaction on the device and
the survivors' torsion fingerprints. The clash survivors and their
fingerprints stay on the device; the order-dependent TFD novelty filter
runs on the device on CUDA and as the host replay on the CPU (and after
a cache overflow), so only the novelty mask reaches the host; then only
the novel rows are pulled.

Set TSCODE_EMBED_TRACE=1 to print the split of sweep, compaction,
novelty filter and pose pull to stderr.
'''

import os
import sys
import time

import numpy as np
import torch

from tscode_tpu_torch.errors import ZeroCandidatesError
from tscode_tpu_torch.graphs import get_quadruplets, get_sum_graph
from tscode_tpu_torch.backend import default_dtype, get_device, synchronize
from tscode_tpu_torch.embeds.common import (DeviceSurvivors,
                                            inputs_from_numpy)
from tscode_tpu_torch.ops.kernels.clash import clash_ok
from tscode_tpu_torch.ops.linalg import (rot_mat_from_pointer,
                                         rotation_matrix_from_vectors)
from tscode_tpu_torch.ops.tfd import (is_new_structure_lru,
                                      tfd_novelty_device,
                                      torsion_fingerprints)

# grid rows per tile of whole c2 values: bounds the live intermediates
TILE_ROWS = 1 << 18


def spin_angles(angles, dtype, device):
    '''Spin angles in degrees as a tensor; an int n gives the n evenly
    spaced angles 0, 360/n, ..., 360 - 360/n.'''
    if isinstance(angles, int):
        angles = np.linspace(0.0, 360.0 - 360.0 / angles, angles)
    return torch.as_tensor(np.asarray(angles, dtype=np.float64),
                           dtype=dtype, device=device)


def bcast_block(inp, angles, c2_lo, c2_hi, clash_thresh):
    '''Poses and clash accept mask of the grid rows of c2 values
    [c2_lo, c2_hi): (poses (B, N1+N2, 3), ok (B,) bool), built by
    broadcasting over the (c2, c1, l2, l1, angle) axes.'''
    coords2 = inp.coords2[c2_lo:c2_hi]
    n1c, k1 = inp.centers1.shape[0], inp.centers1.shape[1]
    g = c2_hi - c2_lo
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
    shape5 = (g, n1c, inp.centers2.shape[1], k1, A)
    f1 = inp.coords1[None, :, None, None, None].expand(
        shape5 + inp.coords1.shape[1:])
    f2 = f2.expand(shape5 + f2.shape[-2:])
    poses = torch.cat([f1, f2], dim=-2).reshape(-1, inp.n_atoms, 3)
    return poses, clash_ok(poses, inp.pairs, clash_thresh)


def bcast_tiles(inp, angles, clash_thresh, c2_per_tile=None):
    '''The whole grid in tiles of `c2_per_tile` whole c2 values (default:
    about TILE_ROWS rows a tile), in generation order: yields
    (poses, ok) per tile.'''
    n2c = inp.coords2.shape[0]
    g = c2_per_tile or max(1, min(
        n2c, TILE_ROWS // (inp.n_poses_per_c2 * angles.shape[0])))
    for c2_lo in range(0, n2c, g):
        yield bcast_block(inp, angles, c2_lo, min(n2c, c2_lo + g),
                          clash_thresh)


def string_embed(mol1, mol2, angles, clash_thresh=1.5, tfd_thresh=10,
                 log=print, *, device, dtype=None, device_novelty=None,
                 info=None):
    '''String-embed poses of two single-reactive-atom molecules.

    angles: spin angles in degrees (the embedder's systematic_angles).
    device / dtype: where and in what the grid is built (dtype defaults
    to float32 on CUDA, float64 on the CPU). device_novelty: run the
    device novelty filter (default: on CUDA only, the JAX package's
    backend policy). info: a dict that, when given, receives the
    counts, the novelty lane and the stage times.
    Returns (poses (S, N1+N2, 3) float64 numpy, constrained_indices
    (S, 1, 2)). Raises ZeroCandidatesError when no pose survives the
    clash screen, or none is novel.'''
    dev = get_device(device)
    dtype = dtype or default_dtype(dev)
    ids = (mol1.n_atoms, mol2.n_atoms)
    r1 = int(mol1.reactive_indices[0])
    r2 = int(mol2.reactive_indices[0]) + ids[0]
    quadruplets = get_quadruplets(
        get_sum_graph((mol1.graph, mol2.graph), [[r1, r2]]))

    inp = inputs_from_numpy(mol1, mol2, dev, dtype)
    ang = spin_angles(angles, dtype, dev)
    total = inp.n_poses_per_c2 * ang.shape[0] * inp.coords2.shape[0]
    log(f'--> Performing string embed ({total} candidates)')

    trace = os.environ.get('TSCODE_EMBED_TRACE') == '1'

    def clock():
        if trace:
            synchronize(dev)
        return time.perf_counter()

    t_0 = clock()
    acc = DeviceSurvivors()
    for poses, ok in bcast_tiles(inp, ang, clash_thresh):
        acc.add((poses,), ok)
    t_sweep = clock()
    fields, ok_all = acc.finish()
    if not ok_all.any():
        raise ZeroCandidatesError(
            '--> String embed did not find any suitable disposition of '
            'molecules.\n    Try expanding the conformational space with '
            'the csearch> operator or see the SHRINK keyword.')
    kept_poses = fields[0]
    kept_tfps = torsion_fingerprints(kept_poses, quadruplets)
    t_finish = clock()

    # order-dependent TFD novelty filter: on the device, only the mask
    # reaches the host; the host replay on the CPU and after a cache
    # overflow (or with no torsions)
    if device_novelty is None:
        device_novelty = dev.type == 'cuda'
    novel, lane, stats = None, 'host', {}
    if device_novelty:
        novel_dev, dev_ok = tfd_novelty_device(kept_tfps, thresh=tfd_thresh,
                                               stats=stats)
        if dev_ok:
            novel, lane = novel_dev, 'device'
    if novel is None:
        fps = kept_tfps.cpu().numpy()
        novel = is_new_structure_lru(fps, np.ones(len(fps), dtype=bool),
                                     thresh=tfd_thresh)
    novel_idx = np.nonzero(novel)[0]
    t_lru = clock()
    log(f'--> TFD novelty filter ran on the {lane} lane: '
        f'{len(novel_idx)} novel of {kept_poses.shape[0]} clash survivors')

    if len(novel_idx) == 0:
        raise ZeroCandidatesError(
            '--> String embed did not find any suitable disposition of '
            'molecules (all poses torsionally redundant).')

    # the one pose pull of the embed: the novel survivor rows only
    final = kept_poses[torch.as_tensor(novel_idx, device=dev)].cpu() \
        .to(torch.float64).numpy()
    t_end = time.perf_counter()

    split = {'sweep_s': t_sweep - t_0, 'compaction_s': t_finish - t_sweep,
             'novelty_s': t_lru - t_finish, 'pull_s': t_end - t_lru}
    if trace:
        print(f'[embed trace] sweep {split["sweep_s"]:.3f}s, '
              f'survivor compaction {split["compaction_s"]:.3f}s, '
              f'tfd filter ({lane}) {split["novelty_s"]:.3f}s '
              f'({kept_poses.shape[0]} survivor rows), '
              f'novel pose pull {split["pull_s"]:.3f}s '
              f'({len(novel_idx)} rows)', file=sys.stderr, flush=True)
    if info is not None:
        info.update(candidates=int(total), clash_ok=int(kept_poses.shape[0]),
                    novel=int(len(novel_idx)), tfd_lane=lane,
                    novelty_stats=stats, dtype=str(dtype).split('.')[-1],
                    device=str(dev), trace=trace, **split)

    constrained = np.array([[[r1, r2]]] * len(final))
    return final, constrained
