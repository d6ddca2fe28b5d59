'''
Cyclical embeds: two or three molecules docked across all their
pairings at once, as in a Diels-Alder transition state (counterpart of
tscode_tpu/embeds/cyclical.py; the chelotropic embed and every
arrangement of a multiembed are two-molecule cases).

The sweep is cut into blocks,

  block = (conformer tuple) x (pivot tuple passing the norm-delta or
          triangle gate and the pairing gate) x (polygon orientation),

built on the host in the reference's generation order. Each block is
expanded over the A angle tuples of the grid on the device, a chunk of
block rows at a time: the block's alignment (two-vector Kabsch, in
PyTorch), its A poses, the clash screen and the greedy angular dedup
(keep an angle that passed the screen and is unlike every angle kept
before it in its block). On CUDA the poses, the screen and the dedup
are kernel B1 a chunk (ops/kernels/block_screen): one launch that gates
only the pose pairs the greedy rule reads and writes the keep bits,
then one that writes only the kept poses, compacted; on the CPU the
plain twin runs: block_poses (the clash screen with K1's plain twin),
then the block-local (A, A) rmsd and maxdev matrices and the greedy
scan, and its poses are compacted by the keep mask. The dedup is
block-local, so chunking changes nothing. The survivors stay on the
device; only the keep mask and the survivor rows reach the host.

Three molecules sit on the sides of a triangle, and each block's facing
directions are first corrected by a grid search over 343 angle triples
(`adjust_chain`), chained from one kept orientation to the next within
a (conformer, pivot) combination; the chain runs in float64 whatever
the sweep's dtype, since its argmin decides whole poses.

The non-rigid embed (the program's default) walks the same
combinations on the host and, where the pivot lengths of a combination
close no digon or triangle, first BENDS the offending molecule
(bending.bend_molecule, float64). A bend replaces the molecule for every
later combination, so the block rows fall into groups by the coordinate
arrays they were built from, and each group is swept with its own
coordinates.

Set TSCODE_EMBED_TRACE=1 to print the split of block building, bends,
adjustment, screen, dedup and assembly to stderr.
'''

import os
import sys
import time

import numpy as np
import torch

from tscode_tpu_torch.backend import (default_dtype, get_device, synchronize,
                                      traced)
from tscode_tpu_torch.embeds.common import DeviceSurvivors
from tscode_tpu_torch.errors import ZeroCandidatesError
from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask, static_pairs
from tscode_tpu_torch.ops.kernels import block_screen as b1
from tscode_tpu_torch.ops.kernels.clash import clash_ok, clash_ok_plain
from tscode_tpu_torch.ops.linalg import (align_vec_pair, polygonize,
                                         rot_mat_from_pointer)
from tscode_tpu_torch.ops.rmsd_prune import pair_gate_matrices
from tscode_tpu_torch.parallel.sharding import gather, mesh_wants, \
    shard_slices

_DIRECTIONS = np.array([[0., 1., 0.], [0., -1., 0.]])

# a chunk's (rows, A, A, N, 3) maxdev intermediate (the plain twin) or
# its inputs, keep mask and scratch (B1 on the card) stay under this
GATE_BYTES = 1 << 30
# the angular dedup's gates: rmsd and maxdev of a pose pair, in A
DEDUP_RMSD = 1.0
DEDUP_MAXDEV = 2.0


def _auto_chunk(n_rows, n_angles, n_atoms, itemsize):
    '''Block rows per chunk of the plain twin: as many as keep the
    (rows, A, A, N, 3) maxdev intermediate within GATE_BYTES, at least
    one, at most all.'''
    per_row = n_angles * n_angles * n_atoms * 3 * itemsize
    return int(max(1, min(n_rows, GATE_BYTES // per_row)))


def _card_chunk(n_rows, n_angles, n_mols, itemsize):
    '''Block rows per chunk of B1 on the card, which writes no pose but
    the survivors: as many as keep what a chunk holds for its rows
    within GATE_BYTES beside the screen's largest scratch
    (b1.SCRATCH_BYTES): per row the keep bytes, its count and offset,
    the conformer ids (int32 and int64) and block_geometry's inputs,
    outputs and packed copy (3 x 24 values a molecule); at least one
    row, at most all.'''
    per_row = n_angles + 4 + 8 + 12 * n_mols + 72 * n_mols * itemsize
    return int(max(1, min(n_rows, (GATE_BYTES - b1.SCRATCH_BYTES)
                          // per_row)))


def _cyclical_ids_bimol(pivots, orientation, offsets):
    '''Constrained atom-index couples of a two-molecule arrangement:
    orientation 1 reverses the second pivot's ends.'''
    swaps = [(0, 0), (0, 1)]
    cumnums = []
    for m, p in enumerate(pivots):
        ids = [p.start_atom.index + offsets[m], p.end_atom.index + offsets[m]]
        if swaps[orientation][m]:
            ids = list(reversed(ids))
        cumnums.append(ids)
    return [[cumnums[0][0], cumnums[1][0]], [cumnums[0][1], cumnums[1][1]]]


def _pivot_tensors(mol, offset):
    '''(pv (nc, Q, 3), mp (nc, Q, 3), start atoms (Q,), end atoms (Q,))
    of a molecule's pivots, or None when its conformers disagree on the
    pivot count or atoms (the fast form needs a grid).'''
    pivs = mol.pivots
    Q = len(pivs[0])
    if Q == 0 or any(len(pl) != Q for pl in pivs):
        return None
    sa = [p.start_atom.index for p in pivs[0]]
    ea = [p.end_atom.index for p in pivs[0]]
    for pl in pivs[1:]:
        if [p.start_atom.index for p in pl] != sa \
                or [p.end_atom.index for p in pl] != ea:
            return None
    pv = np.array([[p.pivot for p in pl] for pl in pivs], dtype=float)
    mp = np.array([[p.meanpoint for p in pl] for pl in pivs], dtype=float)
    return pv, mp, np.asarray(sa) + offset, np.asarray(ea) + offset


def _mol_tables(mol, pv, mp):
    '''Per (conformer, pivot) of a molecule with pivot tensors pv, mp
    (nc, Q, 3): the reactive atoms' mean apm (nc, 3), the pivot
    meanpoint's displacement from it md (nc, Q, 3) (the meanpoint itself
    where that is zero) and the rotation axis rca (nc, Q, 3): the
    reactive atoms' difference, or the pivot of a single reactive
    atom.'''
    apm = mol.atomcoords[:, mol.reactive_indices].mean(axis=1)
    md = mp - apm[:, None]
    md = np.where(np.all(md == 0., axis=-1)[..., None], mp, md)
    if len(mol.reactive_indices) == 2:
        rca = np.broadcast_to(
            (mol.atomcoords[:, mol.reactive_indices[0]]
             - mol.atomcoords[:, mol.reactive_indices[1]])[:, None],
            pv.shape)
    else:
        rca = pv
    return apm, md, rca


def bimol_rigid_blocks(mol1, mol2, max_norm_delta=10, pairing_ok=None):
    '''The blocks of the rigid bimolecular embed in generation order
    (conformer pairs with c1 fastest, pivot pairs with q1 fastest,
    orientation last), as a dict of numpy arrays: the per-block fields
    (starts, ends, dirs, pvs, mds, apms, mps, rc_axes (Bb, 2, 3), c1, c2
    (Bb,), ids (Bb, 2, 2)) and, from the fast form, the compact form
    (tab1, tab2 (n_confs * Q, 5, 3) per-(conformer, pivot) tables,
    tidx (Bb, 5) int32 rows [t1, t2, c1, c2, orientation]). None when no
    block passes the gates. The scalar loop runs when the pivot grid is
    ragged.'''
    for mol in (mol1, mol2):
        if not hasattr(mol, 'pivots'):
            raise ValueError(f'{mol.name}: call set_pivots() before embedding')
    fast = bimol_rigid_blocks_fast(mol1, mol2, max_norm_delta, pairing_ok)
    if fast is not NotImplemented:
        return fast
    return bimol_rigid_blocks_loop(mol1, mol2, max_norm_delta, pairing_ok)


def bimol_rigid_blocks_fast(mol1, mol2, max_norm_delta, pairing_ok):
    '''Vectorised block construction: the (c2, c1, q2, q1, v) grid evaluated
    with array ops and compacted by one nonzero, whose C order is the
    generation order. NotImplemented when the pivot grid is ragged.'''
    t1 = _pivot_tensors(mol1, 0)
    t2 = _pivot_tensors(mol2, mol1.n_atoms)
    if t1 is None or t2 is None:
        return NotImplemented
    pv1, mp1, sa1, ea1 = t1
    pv2, mp2, sa2, ea2 = t2
    Q1, Q2 = pv1.shape[1], pv2.shape[1]
    N1 = np.sqrt((pv1 * pv1).sum(-1))          # (n1c, Q1)
    N2 = np.sqrt((pv2 * pv2).sum(-1))          # (n2c, Q2)

    # conformer-independent pairing gate and constraint ids per
    # (q2, q1, v); v = 1 reverses mol2's pivot ends
    pair_ok = np.ones((Q2, Q1, 2), dtype=bool)
    ids_grid = np.empty((Q2, Q1, 2, 2, 2), dtype=np.int64)
    for q2 in range(Q2):
        for q1 in range(Q1):
            for v in range(2):
                s2, e2 = (sa2[q2], ea2[q2]) if v == 0 \
                    else (ea2[q2], sa2[q2])
                arr_ids = [[int(sa1[q1]), int(s2)],
                           [int(ea1[q1]), int(e2)]]
                ids_grid[q2, q1, v] = arr_ids
                if pairing_ok is not None and not pairing_ok(arr_ids):
                    pair_ok[q2, q1, v] = False

    norm_ok = (np.abs(N1[None, :, None, :] - N2[:, None, :, None])
               <= max_norm_delta)              # (n2c, n1c, Q2, Q1)
    mask = norm_ok[..., None] & pair_ok[None, None]
    flat = np.nonzero(mask.reshape(-1))[0]
    if flat.size == 0:
        return None
    c2g, c1g, q2g, q1g, vg = np.unravel_index(flat, mask.shape)

    Bb = flat.size
    L1 = N1[c1g, q1g]
    L2 = N2[c2g, q2g]
    starts = np.zeros((Bb, 2, 3))
    ends = np.zeros((Bb, 2, 3))
    starts[:, 0, 0] = -L1 / 2
    ends[:, 0, 0] = +L1 / 2
    s2x = np.where(vg == 0, -1.0, 1.0) * L2 / 2    # polygonize orientation
    starts[:, 1, 0] = s2x
    ends[:, 1, 0] = -s2x

    apm1, md1, rca1 = _mol_tables(mol1, pv1, mp1)
    apm2, md2, rca2 = _mol_tables(mol2, pv2, mp2)

    # compact form: the five per-row vectors of a molecule depend on
    # (conformer, pivot) alone, so the device gathers them from a
    # (n_confs * Q, 5, 3) table through the (Bb, 5) index
    tab1 = np.stack([pv1, md1, np.broadcast_to(apm1[:, None], mp1.shape),
                     mp1, rca1], axis=2).reshape(-1, 5, 3)
    tab2 = np.stack([pv2, md2, np.broadcast_to(apm2[:, None], mp2.shape),
                     mp2, rca2], axis=2).reshape(-1, 5, 3)
    tidx = np.stack([c1g * Q1 + q1g, c2g * Q2 + q2g,
                     c1g, c2g, vg], axis=1).astype(np.int32)

    return {
        'starts': starts,
        'ends': ends,
        'pvs': np.stack([pv1[c1g, q1g], pv2[c2g, q2g]], axis=1),
        'mds': np.stack([md1[c1g, q1g], md2[c2g, q2g]], axis=1),
        'apms': np.stack([apm1[c1g], apm2[c2g]], axis=1),
        'mps': np.stack([mp1[c1g, q1g], mp2[c2g, q2g]], axis=1),
        'rc_axes': np.stack([rca1[c1g, q1g], rca2[c2g, q2g]], axis=1),
        'c1': c1g.astype(np.int32),
        'c2': c2g.astype(np.int32),
        'ids': ids_grid[q2g, q1g, vg],
        'dirs': np.broadcast_to(_DIRECTIONS, (Bb, 2, 3)).copy(),
        'tab1': tab1,
        'tab2': tab2,
        'tidx': tidx,
    }


def bimol_rigid_blocks_loop(mol1, mol2, max_norm_delta=10,
                            pairing_ok=None):
    '''Scalar-loop block construction: the fallback for ragged pivot lists and
    the oracle of the fast form (per-block fields only, no compact
    tables).'''
    offsets = (0, mol1.n_atoms)
    blocks = []      # (c1, c2, piv1, piv2, orientation, polygon, ids)
    for c2 in range(mol2.n_confs):
        for c1 in range(mol1.n_confs):
            p1l, p2l = mol1.pivots[c1], mol2.pivots[c2]
            for q2 in range(len(p2l)):
                for q1 in range(len(p1l)):
                    piv1, piv2 = p1l[q1], p2l[q2]
                    # explicit sum of squares, as the fast form
                    n1 = np.sqrt((piv1.pivot * piv1.pivot).sum())
                    n2 = np.sqrt((piv2.pivot * piv2.pivot).sum())
                    if abs(n1 - n2) > max_norm_delta:
                        continue
                    polygon = polygonize([n1, n2])
                    for v in range(2):
                        arr_ids = _cyclical_ids_bimol((piv1, piv2), v,
                                                      offsets)
                        if pairing_ok is not None and \
                                not pairing_ok(arr_ids):
                            continue
                        blocks.append((c1, c2, piv1, piv2, v, polygon[v],
                                       arr_ids))
    if not blocks:
        return None

    Bb = len(blocks)
    blk = {k: np.zeros((Bb, 2, 3)) for k in
           ('starts', 'ends', 'pvs', 'mds', 'apms', 'mps', 'rc_axes')}
    blk['c1'] = np.zeros(Bb, dtype=np.int32)
    blk['c2'] = np.zeros(Bb, dtype=np.int32)
    blk['ids'] = np.zeros((Bb, 2, 2), dtype=np.int64)
    for b, (c1, c2, piv1, piv2, v, polygon, arr_ids) in enumerate(blocks):
        blk['c1'][b], blk['c2'][b] = c1, c2
        blk['ids'][b] = arr_ids
        for m, (mol, piv, conf) in enumerate(((mol1, piv1, c1),
                                              (mol2, piv2, c2))):
            blk['starts'][b, m] = polygon[m][0]
            blk['ends'][b, m] = polygon[m][1]
            blk['pvs'][b, m] = piv.pivot
            blk['mps'][b, m] = piv.meanpoint
            rc = mol.atomcoords[conf][mol.reactive_indices]
            apm = rc.mean(axis=0)
            blk['apms'][b, m] = apm
            md = piv.meanpoint - apm
            if np.all(md == 0.):
                md = piv.meanpoint
            blk['mds'][b, m] = md
            blk['rc_axes'][b, m] = (rc[0] - rc[1]) if len(rc) == 2 \
                else piv.pivot
    blk['dirs'] = np.broadcast_to(_DIRECTIONS, (Bb, 2, 3)).copy()
    return blk


# ---------------------------------------------------------------- device


def block_geometry(starts, ends, dirs, pvs, mds, apms, mps, rc_axes):
    '''Per-(block, molecule) alignment: every argument (Bb, M, 3).
    Returns R_align (Bb, M, 3, 3), the rotation axis, the centre of
    rotation and the translation (Bb, M, 3) each.'''
    ref = torch.stack([ends - starts, dirs], dim=-2)       # (Bb, M, 2, 3)
    tgt = torch.stack([pvs, mds], dim=-2)
    R_align = align_vec_pair(ref, tgt)
    axis = torch.einsum('bmij,bmj->bmi', R_align, rc_axes)
    cor = torch.einsum('bmij,bmj->bmi', R_align, apms)
    pos0 = (starts + ends) / 2.0 - torch.einsum('bmij,bmj->bmi', R_align,
                                                mps)
    return R_align, axis, cor, pos0


@traced
def block_poses(coords, confs, R_align, axis, cor, pos0, angle_grid, pairs,
                clash_thresh, clash=clash_ok):
    '''Each block expanded over the angle grid (A, M) in degrees, and
    the clash screen of every pose with `clash` (K1's entry, or its
    plain twin to compare with). coords: the M molecules' conformer
    ensembles (n_confs, N_m, 3); confs: each molecule's conformer per
    block row (Bb,). Returns poses (Bb, A, N, 3) and ok (Bb, A) bool.'''
    R_step = rot_mat_from_pointer(axis[:, None, :, :],
                                  angle_grid[None, :, :])   # (Bb, A, M, 3, 3)
    R = torch.einsum('bamij,bmjk->bamik', R_step, R_align)
    t = cor[:, None] - torch.einsum('bamij,bmj->bami', R_step, cor) \
        + pos0[:, None]
    poses = torch.cat(
        [torch.einsum('baij,bnj->bani', R[:, :, m], xyz[cm])
         + t[:, :, m][:, :, None]
         for m, (xyz, cm) in enumerate(zip(coords, confs))], dim=2)
    Bb, A, N = poses.shape[:3]
    ok = clash(poses.reshape(Bb * A, N, 3), pairs, clash_thresh)
    return poses, ok.reshape(Bb, A)


@traced
def greedy_keep_device(clash_ok, similar):
    '''The greedy angular dedup as a scan over the A angles, vectorised
    over blocks: angle t is kept when it passed the screen and is unlike
    every angle kept before it. clash_ok (B, A), similar (B, A, A) bool
    -> keep (B, A) bool.'''
    kept = torch.zeros_like(clash_ok)
    for t in range(clash_ok.shape[1]):
        sim_prev = torch.any(similar[:, t, :] & kept, dim=1)
        kept[:, t] = clash_ok[:, t] & ~sim_prev
    return kept


def greedy_angular_keep(clash_ok, similar):
    '''Host oracle of greedy_keep_device (numpy bool arrays): the native
    scan where it is built, else the Python loop.'''
    from tscode_tpu_torch import native
    if native.tfd_available():
        return native.greedy_angular_dedup(clash_ok, similar)
    keep = np.zeros_like(clash_ok, dtype=bool)
    for b in range(len(clash_ok)):
        kept = []
        for t in range(clash_ok.shape[1]):
            if clash_ok[b, t] and not any(similar[b, t, t0] for t0 in kept):
                kept.append(t)
                keep[b, t] = True
    return keep


@traced
def angular_dedup(poses, ok):
    '''The block-local gates (rmsd < DEDUP_RMSD and maxdev <
    DEDUP_MAXDEV over the whole pose) and the greedy keep: poses
    (Bb, A, N, 3), ok (Bb, A) -> keep (Bb, A).'''
    rmsd, maxdev = pair_gate_matrices(poses, poses.shape[2])
    return greedy_keep_device(ok, (rmsd < DEDUP_RMSD) &
                              (maxdev < DEDUP_MAXDEV))


def compact_rows(tab1, tab2, ti):
    '''The per-row geometry of block_geometry gathered from the compact
    tables by the index rows ti (rows, 5) [t1, t2, c1, c2, v], the digon
    ends rebuilt from the pivot norms as the host code lays them out.
    Returns ((c1, c2), starts, ends, dirs, pvs, mds, apms, mps,
    rc_axes).'''
    r1 = tab1[ti[:, 0]]                                   # (rows, 5, 3)
    r2 = tab2[ti[:, 1]]
    c1, c2, v = ti[:, 2], ti[:, 3], ti[:, 4]
    pv1, pv2 = r1[:, 0], r2[:, 0]
    # the host code's add order, so float64 parity is bitwise
    L1 = torch.sqrt(pv1[:, 0] * pv1[:, 0] + pv1[:, 1] * pv1[:, 1]
                    + pv1[:, 2] * pv1[:, 2])
    L2 = torch.sqrt(pv2[:, 0] * pv2[:, 0] + pv2[:, 1] * pv2[:, 1]
                    + pv2[:, 2] * pv2[:, 2])
    zero = torch.zeros_like(L1)
    sign = torch.where(v == 0, -1.0, 1.0).to(L2.dtype)
    s2x = sign * L2 / 2
    starts = torch.stack([torch.stack([-L1 / 2, zero, zero], dim=-1),
                          torch.stack([s2x, zero, zero], dim=-1)], dim=1)
    ends = torch.stack([torch.stack([L1 / 2, zero, zero], dim=-1),
                        torch.stack([-s2x, zero, zero], dim=-1)], dim=1)
    dirs = torch.as_tensor(_DIRECTIONS, dtype=starts.dtype,
                           device=starts.device).expand(starts.shape)

    def pair(k):
        return torch.stack([r1[:, k], r2[:, k]], dim=1)

    return ((c1, c2), starts, ends, dirs, pair(0), pair(1), pair(2),
            pair(3), pair(4))


def block_screen_plain(coords, confs, geo, angle_grid, pairs,
                       clash_thresh, lap=None):
    '''B1's plain twin, on any device: block_poses with K1's plain twin,
    then angular_dedup. lap, when given, is called between the screen
    and the dedup. Returns every pose (rows, A, N, 3) and keep (rows,
    A); block_screen compacts them.'''
    poses, ok = block_poses(coords, confs, *block_geometry(*geo), angle_grid,
                            pairs, clash_thresh, clash=clash_ok_plain)
    if lap is not None:
        lap()
    return poses, angular_dedup(poses, ok)


def block_screen_queued(coords, confs, geo, angle_grid, pairs, clash_thresh,
                        half_angles=None, lap=None):
    '''block_screen in two steps: returns (keep (rows, A), finish), where
    finish() gives the survivors. On a CUDA tensor B1's screen is queued
    and finish reads its total and launches the write, so the screens of
    several shards can be queued before any read; on a CPU tensor the
    twin has run and finish compacts its poses.'''
    if angle_grid.is_cuda:
        if half_angles is None:
            half_angles = b1.half_angles(angle_grid)
        s = b1.screen(coords, confs, block_geometry(*geo), half_angles,
                      pairs, clash_thresh, (DEDUP_RMSD, DEDUP_MAXDEV))
        return s.keep, lambda: b1.survivors(s)
    if angle_grid.device.type != 'cpu':
        raise ValueError(f'block_screen: unsupported device '
                         f'{angle_grid.device}')
    poses, keep = block_screen_plain(coords, confs, geo, angle_grid, pairs,
                                     clash_thresh, lap=lap)
    return keep, lambda: poses[keep]


def block_screen(coords, confs, geo, angle_grid, pairs, clash_thresh,
                 half_angles=None, lap=None):
    '''One chunk of the sweep: geometry, poses, clash screen and angular
    dedup of the block rows whose conformers `confs` and geometry `geo`
    (block_geometry's eight inputs) are given, as sweep_inputs' rows()
    or compact_rows give them. Returns (survivors (S, N, 3), the kept
    poses row by row and angle by angle, keep (rows, A)). On a CUDA
    tensor block_geometry and B1's two launches (ops/kernels/
    block_screen; half_angles, b1.half_angles of the grid, may be given
    once a sweep): no pose but a survivor is written; on a CPU tensor
    the plain twin block_screen_plain, calling lap between its screen
    and its dedup, then its poses compacted by keep.'''
    keep, finish = block_screen_queued(coords, confs, geo, angle_grid, pairs,
                                       clash_thresh, half_angles, lap)
    return finish(), keep


_GEOMETRY = ('starts', 'ends', 'dirs', 'pvs', 'mds', 'apms', 'mps',
             'rc_axes')


def sweep_inputs(blk, mols, angles, device, dtype, uploaded=None):
    '''The device inputs of a sweep over the molecules `mols`: (coords,
    one (n_confs, N_m, 3) tensor per molecule; angle grid (A, M); pairs
    (P, 2) int32, the cross-fragment pair list; rows) where rows(lo, hi)
    gives, for block rows [lo, hi), their conformer ids per molecule and
    block_geometry's eight inputs: gathered from the compact tables when
    `blk` has them, else sliced from its per-block fields (the loop
    form's ragged case, and three molecules). uploaded: a dict that,
    when given, keeps each coordinate array's tensor under the array's
    id, so sweeps that share molecules upload them once (the caller
    keeps the arrays alive).'''
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    def ensemble(a):
        if uploaded is None:
            return t(a)
        if id(a) not in uploaded:
            uploaded[id(a)] = t(a)
        return uploaded[id(a)]

    if 'tidx' in blk:
        tab1, tab2 = t(blk['tab1']), t(blk['tab2'])
        tidx = torch.as_tensor(blk['tidx'], device=device).long()

        def rows(lo, hi):
            return compact_rows(tab1, tab2, tidx[lo:hi])
    else:
        # a (Bb, M) table, or (c1, c2) of a two-molecule dict
        confs = [torch.as_tensor(c, device=device).long()
                 for c in (np.asarray(blk['confs']).T if 'confs' in blk
                           else (blk['c1'], blk['c2']))]
        geo = [t(blk[k]) for k in _GEOMETRY]

        def rows(lo, hi):
            return (tuple(c[lo:hi] for c in confs),
                    *(g[lo:hi] for g in geo))

    pairs = torch.as_tensor(static_pairs(cross_fragment_pair_mask(
        tuple(mol.n_atoms for mol in mols))), device=device)
    return [ensemble(mol.atomcoords) for mol in mols], t(angles), pairs, rows


def screen_chunk(inputs, lo, hi, clash_thresh, clock, half_angles=None):
    '''One chunk of a sweep, block rows [lo, hi) of sweep_inputs'
    `inputs`, through block_screen_queued: (finish, keep (rows * A,),
    seconds of the screen, seconds of the dedup), finish() the chunk's
    survivors (S, N, 3). On CUDA B1's screen queued (half_angles: of the
    grid, once a sweep), whose seconds are all the screen's (the dedup
    reads 0.0); on the CPU the plain twin, screen and dedup apart.'''
    coords, grid, pairs, rows = inputs
    t0 = clock()
    laps = []
    confs, *geo = rows(lo, hi)
    keep, finish = block_screen_queued(coords, confs, geo, grid, pairs,
                                       clash_thresh, half_angles,
                                       lap=lambda: laps.append(clock()))
    t2 = clock()
    t1 = laps[0] if laps else t2
    return finish, keep.reshape(-1), t1 - t0, t2 - t1


def screen_survivors(blk, mols, angles, clash_thresh, *, device, dtype,
                     block_chunk=None, clock=time.perf_counter, split=None,
                     uploaded=None, mesh=None):
    '''The whole sweep over the block rows of `blk`, chunk by chunk:
    returns (survivor poses (S, N, 3) on the device in generation order,
    keep (Bb, A) numpy bool). Chunks on CUDA follow _card_chunk, on the
    CPU _auto_chunk, unless block_chunk is given. split, when given, gets
    the seconds of the screen (geometry, poses, clash and compaction; on
    CUDA the whole of B1, its host read of the survivor count and its
    write) and of the dedup (0.0 on CUDA), the chunking and the form
    that ran (sweep_kernel: 'B1' or 'plain'). uploaded: sweep_inputs'
    cache of coordinate tensors. mesh: a parallel.sharding Mesh; with Bb
    * A candidates that clear mesh_wants, the block rows are cut into
    contiguous slices, one per device, each swept in chunks of chunk /
    mesh.size rows on its own inputs into its own survivor accumulator
    (the dedup is block-local: no collective), and the survivors are
    joined in block order on the mesh's first device (the JAX package's
    _block_program_sharded).'''
    Bb, A = len(blk['ids']), len(angles)
    if mesh is not None and mesh_wants(Bb * A):
        inputs = {dev: sweep_inputs(blk, mols, angles, dev, dtype)
                  for dev in dict.fromkeys(mesh.devices)}
        slices = shard_slices(Bb, mesh)
    else:
        inputs = {device: sweep_inputs(blk, mols, angles, device, dtype,
                                       uploaded)}
        slices = [(device, 0, Bb)]
    coords = inputs[slices[0][0]][0]
    on_card = coords[0].is_cuda
    chunk = block_chunk or (
        _card_chunk(Bb, A, len(coords), coords[0].element_size()) if on_card
        else _auto_chunk(Bb, A, sum(c.shape[1] for c in coords),
                         coords[0].element_size()))
    half = {dev: b1.half_angles(inp[1]) for dev, inp in inputs.items()
            if on_card}
    chunk = -(-chunk // len(slices))
    accs = [DeviceSurvivors() for _ in slices]
    t_screen = t_dedup = 0.0
    n_chunks = 0
    for r0 in range(0, max(hi - lo for _, lo, hi in slices), chunk):
        # every slice's screen queued before their writes read a count
        out = []
        for dev, lo, hi in slices:
            a, b = lo + r0, min(hi, lo + r0 + chunk)
            out.append(screen_chunk(inputs[dev], a, b, clash_thresh, clock,
                                    half.get(dev)) if a < b else None)
        t0 = clock()
        for acc, o in zip(accs, out):
            if o is not None:
                acc.append((o[0](),), o[1])
                t_screen += o[2]
                t_dedup += o[3]
                n_chunks += 1
        t_screen += clock() - t0
    parts = [acc.finish() for acc in accs]
    if split is not None:
        split.update(screen_s=t_screen, dedup_s=t_dedup, chunk_rows=chunk,
                     chunks=n_chunks, shards=len(slices),
                     sweep_kernel='B1' if on_card else 'plain')
    surv = parts[0][0][0] if len(parts) == 1 else \
        gather([f[0] for f, _ in parts], mesh.devices[0])
    return surv, np.concatenate([m for _, m in parts]).reshape(Bb, A)


def assemble_survivors(surv_poses, keep, ids_arr):
    '''Survivor poses pulled to the host as float64 numpy (S, N, 3), and
    each one's constraint ids (S, M, 2): the survivors sit in block
    order, so the ids are one repeat of the block ids by the per-block
    keep counts.'''
    counts = np.asarray(keep).sum(axis=1).astype(np.int64)
    cons = np.repeat(np.asarray(ids_arr), counts, axis=0)
    return surv_poses.cpu().to(torch.float64).numpy(), cons


def embed_clock(device):
    '''(trace, clock): whether TSCODE_EMBED_TRACE=1 asks for the split,
    and a clock that then waits for `device` before it reads the time,
    so the split's seconds are the phases' own.'''
    trace = os.environ.get('TSCODE_EMBED_TRACE') == '1'

    def clock():
        if trace:
            synchronize(device)
        return time.perf_counter()

    return trace, clock


def finish_embed(surv, keep, ids, split, A, dev, dtype, trace, info):
    '''The end of a cyclical embed: the swept survivors `surv` (device)
    and keep mask (Bb, A) become (poses (S, N, 3) float64 numpy,
    constrained_indices (S, M, 2)); the split (a dict of seconds and
    counts) is printed to stderr under TSCODE_EMBED_TRACE=1 and handed
    to `info`. Raises ZeroCandidatesError when nothing survived.'''
    if surv.shape[0] == 0:
        raise ZeroCandidatesError(
            '--> Cyclical embed did not find any suitable disposition of '
            'molecules.\n    This is probably because one molecule has two '
            'reactive centers at a great distance,\n    preventing the '
            'other two molecules from forming a closed, cyclical structure.')
    t0 = time.perf_counter()
    poses, cons = assemble_survivors(surv, keep, ids)
    split['assemble_s'] = time.perf_counter() - t0
    Bb = len(ids)
    if trace:
        adjust = f'adjust {split["adjust_s"]:.3f}s ' \
            f'({split["adjust_near_ties"]} near ties), ' \
            if 'adjust_s' in split else ''
        bends = f'bends {split["bends_s"]:.3f}s ({split["bends"]} bends, ' \
            f'{split["bend_relaxations"]} relaxations, ' \
            f'{split["bend_hits"]} cache hits, {split["bend_reverts"]} ' \
            f'reverts, {split["groups"]} groups), ' \
            if 'bends_s' in split else ''
        print(f'[cyc trace] blocks {split["blocks_s"]:.3f}s, {bends}{adjust}'
              f'screen {split["screen_s"]:.3f}s, dedup '
              f'{split["dedup_s"]:.3f}s ({split["sweep_kernel"]}), assemble '
              f'{split["assemble_s"]:.3f}s ({Bb} blocks in '
              f'{split["chunks"]} chunks of {split["chunk_rows"]}, '
              f'{len(poses)} survivors)',
              file=sys.stderr, flush=True)
    if info is not None:
        info.update(candidates=int(Bb * A), blocks=int(Bb),
                    survivors=int(len(poses)),
                    dtype=str(dtype).split('.')[-1], device=str(dev),
                    trace=trace, **split)
    return poses, cons


def rigid_embed(mols, make_blocks, no_blocks, systematic_angles,
                clash_thresh, block_chunk, device, dtype, info, mesh=None):
    '''The frame of a rigid cyclical embed: build the blocks with
    make_blocks(device, clock, A), which returns (block dict or None,
    its own entries for the split), sweep them, pull the survivors and report.
    `no_blocks` ends the message raised when no block passes.
    TSCODE_EMBED_TRACE=1 synchronises at the phase boundaries and
    prints the split to stderr. mesh: screen_survivors' mesh. Returns
    (poses (S, N, 3) float64 numpy, constrained_indices (S, M, 2)).'''
    dev = get_device(device)
    dtype = dtype or default_dtype(dev)
    trace, clock = embed_clock(dev)
    angles = np.asarray(systematic_angles, dtype=float)
    blk, split = make_blocks(dev, clock, len(angles))
    if blk is None:
        raise ZeroCandidatesError(
            '--> Cyclical embed did not find any suitable disposition of '
            f'molecules ({no_blocks}).')
    surv, keep = screen_survivors(blk, mols, angles, clash_thresh,
                                  device=dev, dtype=dtype,
                                  block_chunk=block_chunk, clock=clock,
                                  split=split, mesh=mesh)
    clock()
    return finish_embed(surv, keep, blk['ids'], split, len(angles), dev,
                        dtype, trace, info)


def cyclical_embed_bimol_rigid(mol1, mol2, systematic_angles,
                               clash_thresh=1.5, max_norm_delta=10,
                               pairing_ok=None, log=print, block_chunk=None,
                               *, device, dtype=None, info=None, mesh=None):
    '''Rigid bimolecular cyclical embed.

    systematic_angles: (A, 2) per-molecule step angles in degrees (the
    embedder's angle grid). pairing_ok: optional callable(ids) -> bool
    enforcing the user's pairings. device / dtype: where and in what the
    sweep runs (dtype defaults to float32 on CUDA, float64 on the CPU).
    info: a dict that, when given, receives the counts and the split.
    mesh: the sweep's mesh (screen_survivors). Returns (poses (S, N, 3)
    float64 numpy, constrained_indices (S, 2, 2)). Raises
    ZeroCandidatesError when no block or no pose survives.'''
    def make_blocks(dev, clock, A):
        t0 = clock()
        blk = bimol_rigid_blocks(mol1, mol2, max_norm_delta=max_norm_delta,
                                 pairing_ok=pairing_ok)
        if blk is not None:
            log(f'--> Performing cyclical embed ({len(blk["ids"]) * A} '
                f'candidates, {len(blk["ids"])} blocks)')
        return blk, {'blocks_s': clock() - t0}

    return rigid_embed((mol1, mol2), make_blocks, 'no compatible pivot pairs',
                       systematic_angles, clash_thresh, block_chunk, device,
                       dtype, info, mesh)


_COMPACT = ('tab1', 'tab2', 'tidx')


def concat_blocks(blks):
    '''Row-wise union of block dicts (multiembed sweeps every
    arrangement's rows at once). The per-block fields concatenate as
    they are; the compact form is kept only when every dict has it, each
    dict's table indices (tidx[:, 0] and tidx[:, 1]) offset into the
    concatenated tables.'''
    out = {k: np.concatenate([b[k] for b in blks])
           for k in blks[0] if k not in _COMPACT}
    if all('tidx' in b for b in blks):
        tidxs, off1, off2 = [], 0, 0
        for b in blks:
            t = b['tidx'].copy()
            t[:, 0] += off1
            t[:, 1] += off2
            tidxs.append(t)
            off1 += len(b['tab1'])
            off2 += len(b['tab2'])
        out['tab1'] = np.concatenate([b['tab1'] for b in blks])
        out['tab2'] = np.concatenate([b['tab2'] for b in blks])
        out['tidx'] = np.concatenate(tidxs)
    return out


# ------------------------------------------------------- three molecules

# the direction adjustment's grid: 7 angles per molecule over +-30 degrees
ADJ_STEPS = 6
ADJ_RANGE = 30
# two angle triples whose costs lie this close (degrees) are a near tie
ADJ_TIE = 1e-9
# blocks per call of the adjustment's grid search (343 x 3 rotations each)
ADJ_CHUNK = 2048


def get_directions(norms):
    '''Facing directions of 2 or 3 molecules, toward the polygon's
    centre: for a triangle from its circumcentre, with the sign fixed
    where an obtuse angle puts the circumcentre outside, and a 1e-5 A
    perturbation of the first side where a right angle puts it on a
    side. norms (M,) -> (M, 3).'''
    norms = np.array(norms, dtype=float)
    if len(norms) == 2:
        return _DIRECTIONS.copy()

    vertices = np.zeros((3, 2))
    vertices[1] = np.array([norms[0], 0])
    a, b, c = norms[0] ** 2, norms[1] ** 2, norms[2] ** 2
    x = (a - b + c) / (2 * a ** 0.5)
    y = (c - x ** 2) ** 0.5
    vertices[2] = np.array([x, y])

    a = vertices[1, 0]
    b = vertices[2, 0]
    c = vertices[2, 1]
    cc = np.array([a / 2, (b ** 2 + c ** 2 - a * b) / (2 * c)])

    v0, v1, v2 = vertices
    dirs = [cc - (v0 + v1) / 2, cc - (v1 + v2) / 2, cc - (v2 + v0) / 2]

    if any(np.all(d == 0) for d in dirs):
        norms[0] += 1e-5
        return get_directions(norms)

    def angle(u, w):
        cosv = np.clip(u @ w / np.linalg.norm(u) / np.linalg.norm(w), -1, 1)
        return np.degrees(np.arccos(cosv))

    if angle(v0 - v2, v1 - v2) > 90:
        dirs[0] = -dirs[0]
    if angle(v1 - v0, v2 - v0) > 90:
        dirs[1] = -dirs[1]
    if angle(v0 - v1, v2 - v1) > 90:
        dirs[2] = -dirs[2]

    out = np.zeros((3, 3))
    for i, d in enumerate(dirs):
        d3 = np.concatenate([d, [0.]])
        out[i] = d3 / np.linalg.norm(d3)
    return out


def cyclical_ids_trimol(pivots, orientation, offsets):
    '''Constrained atom-index couples of a three-molecule arrangement,
    each couple sorted: the orientation says which pivots are taken
    end first.'''
    swaps = [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
             (1, 0, 0), (1, 1, 0), (1, 0, 1), (1, 1, 1)]
    cums = []
    for m, p in enumerate(pivots):
        ids = [p.start_atom.index + offsets[m], p.end_atom.index + offsets[m]]
        if swaps[orientation][m]:
            ids = list(reversed(ids))
        cums.append(ids)
    return [sorted(c) for c in ([cums[0][1], cums[1][0]],
                                [cums[1][1], cums[2][0]],
                                [cums[2][1], cums[0][0]])]


def facing_matrix(arr_ids, offsets):
    '''r[m, partner]: the local index of molecule m's reactive atom that
    faces `partner`, from the arrangement's constrained couples.'''
    r = np.zeros((3, 3), dtype=int)
    for pair in arr_ids:
        sides = []
        for cum in pair:
            m = 2 if cum >= offsets[2] else (1 if cum >= offsets[1] else 0)
            sides.append((m, cum - offsets[m]))
        (m1, i1), (m2, i2) = sides
        r[m1, m2] = i1
        r[m2, m1] = i2
    return r


def adjust_core(p_axes, p_means, a_pts, verts, angle_grid):
    '''The grid search of the direction adjustment, a batch of blocks at
    once: each molecule is turned about its triangle side by each angle
    triple of the grid, and the triple with the least orbital
    misalignment (the first such, as argmin takes it) gives the
    block's directions, the displacements from each side's midpoint to
    the mean of its molecule's two turned reactive atoms.
    p_axes, p_means, verts (n, 3, 3); a_pts (n, 6, 3), the embedded
    reactive atoms a01, a02, a10, a12, a20, a21; angle_grid (G, 3).
    Returns (directions (n, 3, 3), gap (n,): second-least cost minus the
    least).'''
    R = rot_mat_from_pointer(p_axes[:, None, :, :],
                             angle_grid[None, :, :])       # (n, G, 3, 3, 3)
    new = [torch.einsum('ngij,nj->ngi', R[:, :, k // 2], a_pts[:, k])
           for k in range(6)]                              # 6 x (n, G, 3)
    a01, a02, a10, a12, a20, a21 = new
    d = [p_means[:, None, 0] - (a01 + a02) / 2,
         p_means[:, None, 1] - (a10 + a12) / 2,
         p_means[:, None, 2] - (a20 + a21) / 2]

    def ang(u, w):
        cosv = torch.sum(u * w, dim=-1) / torch.clamp(
            torch.linalg.norm(u, dim=-1) * torch.linalg.norm(w, dim=-1),
            min=1e-30)
        return torch.rad2deg(torch.arccos(torch.clamp(cosv, -1.0, 1.0)))

    v0, v1, v2 = verts[:, None, 0], verts[:, None, 1], verts[:, None, 2]
    cost = (ang(v0 - a02, a20 - v0) + ang(v1 - a01, a10 - v1)
            + ang(v2 - a21, a12 - v2))                     # (n, G)
    best = torch.argmin(cost, dim=1)
    two = torch.topk(cost, 2, dim=1, largest=False).values
    pick = best[:, None, None].expand(-1, 1, 3)
    return (torch.stack([x.gather(1, pick)[:, 0] for x in d], dim=1),
            two[:, 1] - two[:, 0])


def adjust_step(starts, ends, pvs, mds, mps, rc_src, verts, dirs_in,
                angle_grid):
    '''One link of the adjustment chain for a batch of blocks: align
    each molecule with the incoming directions, embed the reactive atoms
    `rc_src` (n, 6, 3) and search the grid. Returns adjust_core's
    (directions, gap).'''
    owner = [0, 0, 1, 1, 2, 2]
    ref = torch.stack([ends - starts, dirs_in], dim=-2)     # (n, 3, 2, 3)
    tgt = torch.stack([pvs, mds], dim=-2)
    R = align_vec_pair(ref, tgt)                            # (n, 3, 3, 3)
    mid = (starts + ends) / 2
    pos = mid - torch.einsum('nmij,nmj->nmi', R, mps)
    a_pts = torch.einsum('nkij,nkj->nki', R[:, owner], rc_src) \
        + pos[:, owner]
    return adjust_core(ends - starts, mid, a_pts, verts, angle_grid)


def adjust_grid():
    '''(343, 3) angle triples of the adjustment, in numpy's three-array
    meshgrid order.'''
    return np.stack(np.meshgrid(*[np.arange(ADJ_STEPS + 1)] * 3),
                    -1).reshape(-1, 3) * (2 * ADJ_RANGE / ADJ_STEPS) \
        - ADJ_RANGE


@traced
def adjust_chain(starts, ends, pvs, mds, mps, rc_src, verts, reset, dirs0,
                 *, device, chunk=ADJ_CHUNK):
    '''The chained direction adjustment over a block sequence (numpy
    arrays, a row per block). A block with reset set (the first kept
    orientation of a (conformer, pivot) combination) starts from its
    combination's estimate dirs0; every other block starts from the
    block before it, the previous kept orientation of its combination.
    So a block's place in its chain is its rank among the kept
    orientations, chains are at most 8 long, and link k of every chain
    runs at once. Float64 on `device`. Returns (directions (B, 3, 3)
    numpy, gap (B,) numpy: each block's second-least grid cost minus
    its least).'''
    reset = np.asarray(reset, dtype=bool)
    B = len(reset)
    if B and not reset[0]:
        raise ValueError('the first block of a sequence must reset')
    idx = np.arange(B)
    rank = idx - np.maximum.accumulate(np.where(reset, idx, 0))

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

    cols = [t(a) for a in (starts, ends, pvs, mds, mps, rc_src, verts)]
    dirs0, grid = t(dirs0), t(adjust_grid())
    out = torch.zeros((B, 3, 3), dtype=torch.float64, device=device)
    gap = torch.zeros(B, dtype=torch.float64, device=device)
    for k in range(int(rank.max()) + 1 if B else 0):
        rows = torch.as_tensor(np.flatnonzero(rank == k), device=device)
        for lo in range(0, rows.numel(), chunk):
            r = rows[lo:lo + chunk]
            dirs_in = dirs0[r] if k == 0 else out[r - 1]
            out[r], gap[r] = adjust_step(*(c[r] for c in cols), dirs_in,
                                         grid)
    return out.cpu().numpy(), gap.cpu().numpy()


_ADJUST = ('starts', 'ends', 'pvs', 'mds', 'mps', 'rc_src', 'verts', 'reset',
           'dirs0')


# which sides each of polygonize's 8 oriented triangles takes end first
_FLIPS = np.array([[side in flips for side in range(3)] for flips in
                   ((), (2,), (1,), (1, 2), (0,), (0, 1), (0, 2), (0, 1, 2))])
# rc_src's rows: (molecule, partner it faces)
_FACES = ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1))


def triangle_sides(norms):
    '''polygonize's triangle for rows of side lengths (T, 3): the sides'
    vertex couples (T, 3, 2, 3), base along +x and apex above it.'''
    base, flank, closing = norms.T
    apex_x = (base * base - flank * flank + closing * closing) / (2 * base)
    vertices = np.zeros((len(norms), 3, 3))
    vertices[:, 1, 0] = base
    vertices[:, 2, 0] = apex_x
    vertices[:, 2, 1] = np.sqrt(closing * closing - apex_x * apex_x)
    return vertices[:, [[0, 1], [1, 2], [2, 0]]]


def get_directions_rows(norms):
    '''get_directions for rows of triangle side lengths: (T, 3) ->
    (T, 3, 3).'''
    norms = np.array(norms, dtype=float)
    T = len(norms)
    out = np.zeros((T, 3, 3))
    todo = np.arange(T)
    while todo.size:
        n = norms[todo]
        a, b, c = n[:, 0] ** 2, n[:, 1] ** 2, n[:, 2] ** 2
        x = (a - b + c) / (2 * a ** 0.5)
        y = (c - x ** 2) ** 0.5
        v = np.zeros((len(n), 3, 2))
        v[:, 1, 0] = n[:, 0]
        v[:, 2, 0], v[:, 2, 1] = x, y
        cc = np.stack([n[:, 0] / 2,
                       (x ** 2 + y ** 2 - n[:, 0] * x) / (2 * y)], axis=1)
        d = cc[:, None] - (v + np.roll(v, -1, axis=1)) / 2   # sides 01 12 20
        right = np.all(d == 0, axis=2).any(axis=1)

        def obtuse(at, p, q):
            u, w = v[:, p] - v[:, at], v[:, q] - v[:, at]
            cosv = np.clip((u * w).sum(1) / np.sqrt((u * u).sum(1))
                           / np.sqrt((w * w).sum(1)), -1, 1)
            return np.degrees(np.arccos(cosv)) > 90

        # the side facing an obtuse angle has the circumcentre behind it
        for side, at in ((0, 2), (1, 0), (2, 1)):
            flip = obtuse(at, (at + 1) % 3, (at + 2) % 3)
            d[flip, side] = -d[flip, side]
        d3 = np.concatenate([d, np.zeros((len(n), 3, 1))], axis=2)
        with np.errstate(invalid='ignore', divide='ignore'):
            d3 = d3 / np.sqrt((d3 * d3).sum(-1))[..., None]
        out[todo[~right]] = d3[~right]
        todo = todo[right]
        norms[todo, 0] += 1e-5
    return out


def trimol_rigid_blocks(mols, pairing_ok=None):
    '''The blocks of the rigid three-molecule embed in generation order:
    conformer triples and pivot triples in numpy's three-array meshgrid
    order (second index slowest, third fastest), the triples whose pivot
    norms close a triangle, then the 8 orientations that pass the
    pairing gate. A dict of numpy arrays: block_geometry's fields but
    dirs (Bb, 3, 3), confs (Bb, 3), ids (Bb, 3, 2), and the adjustment
    chain's inputs (rc_src (Bb, 6, 3): the reactive atoms' coordinates
    in conformer 0 of each molecule, as the reference takes them,
    whatever the block's conformers; verts (Bb, 3, 3); reset (Bb,);
    dirs0 (Bb, 3, 3)). None when no block passes. For each conformer of
    the second molecule the (c1, c3, q2, q1, q3, v) grid is evaluated
    with array ops and compacted by one nonzero, whose C order is the
    generation order; so every conformer of a molecule must hold the
    same pivots (ValueError otherwise).'''
    for mol in mols:
        if not hasattr(mol, 'pivots'):
            raise ValueError(f'{mol.name}: call set_pivots() before embedding')
    if any(all(len(pl) == 0 for pl in mol.pivots) for mol in mols):
        return None
    n_at = [m.n_atoms for m in mols]
    offsets = (0, n_at[0], n_at[0] + n_at[1])
    tens = [_pivot_tensors(m, off) for m, off in zip(mols, offsets)]
    for mol, t in zip(mols, tens):
        if t is None:
            raise ValueError(
                f'{mol.name}: its conformers hold different pivots; the '
                f'rigid three-molecule embed needs the same pivot atoms '
                f'and count in every conformer')
    pv, mp = [t[0] for t in tens], [t[1] for t in tens]
    Q = [p.shape[1] for p in pv]
    # np.linalg.norm of each pivot on its own, as the scalar loop takes it
    L = [np.array([[np.linalg.norm(p.pivot) for p in pl] for pl in m.pivots])
         for m in mols]

    # conformer-independent: the pairing gate, constraint ids and the
    # adjustment's conformer-0 atoms per (q2, q1, q3, v)
    pair_ok = np.ones((Q[1], Q[0], Q[2], 8), dtype=bool)
    ids_grid = np.empty((Q[1], Q[0], Q[2], 8, 3, 2), dtype=np.int64)
    src_grid = np.empty((Q[1], Q[0], Q[2], 8, 6, 3))
    for q2 in range(Q[1]):
        for q1 in range(Q[0]):
            for q3 in range(Q[2]):
                pivots = [mols[0].pivots[0][q1], mols[1].pivots[0][q2],
                          mols[2].pivots[0][q3]]
                for v in range(8):
                    arr_ids = cyclical_ids_trimol(pivots, v, offsets)
                    ids_grid[q2, q1, q3, v] = arr_ids
                    if pairing_ok is not None and not pairing_ok(arr_ids):
                        pair_ok[q2, q1, q3, v] = False
                    r = facing_matrix(arr_ids, offsets)
                    for k, (m, partner) in enumerate(_FACES):
                        src_grid[q2, q1, q3, v, k] = \
                            mols[m].atomcoords[0][r[m, partner]]

    idx = []
    for c2 in range(mols[1].n_confs):
        n0 = L[0][:, None, None, :, None]          # (n1c, 1, 1, Q1, 1)
        n1 = L[1][c2][None, None, :, None, None]   # (1, 1, Q2, 1, 1)
        n2 = L[2][None, :, None, None, :]          # (1, n3c, 1, 1, Q3)
        closes = (n0 < n2 + n1) & (n1 < n0 + n2) & (n2 < n1 + n0)
        mask = closes[..., None] & pair_ok[None, None]
        flat = np.nonzero(mask.reshape(-1))[0]
        c1, c3, q2, q1, q3, v = np.unravel_index(flat, mask.shape)
        idx.append(np.stack([c1, np.full_like(c1, c2), c3, q1, q2, q3, v]))
    c1, c2, c3, q1, q2, q3, v = np.concatenate(idx, axis=1)
    Bb = len(v)
    if Bb == 0:
        return None
    cs, qs = (c1, c2, c3), (q1, q2, q3)

    norms = np.stack([L[m][cs[m], qs[m]] for m in range(3)], axis=1)
    sides = triangle_sides(norms)                          # (Bb, 3, 2, 3)
    flip = _FLIPS[v][..., None]
    combo = np.stack([c1, c2, c3, q1, q2, q3], axis=1)
    a, b, c = norms[:, 0] ** 2, norms[:, 1] ** 2, norms[:, 2] ** 2
    x = (a - b + c) / (2 * a ** 0.5)
    verts = np.zeros((Bb, 3, 3))
    verts[:, 1, 0] = norms[:, 0]
    verts[:, 2, 0], verts[:, 2, 1] = x, (c - x ** 2) ** 0.5

    def per_mol(m):
        apm, md, rca = _mol_tables(mols[m], pv[m], mp[m])
        c, q = cs[m], qs[m]
        return pv[m][c, q], md[c, q], apm[c], mp[m][c, q], rca[c, q]

    cols = [np.stack(f, axis=1) for f in zip(*(per_mol(m) for m in range(3)))]
    return {
        'starts': np.where(flip, sides[:, :, 1], sides[:, :, 0]),
        'ends': np.where(flip, sides[:, :, 0], sides[:, :, 1]),
        'pvs': cols[0], 'mds': cols[1], 'apms': cols[2], 'mps': cols[3],
        'rc_axes': cols[4], 'verts': verts,
        'dirs0': get_directions_rows(norms),
        'rc_src': src_grid[q2, q1, q3, v],
        'reset': np.concatenate([[True],
                                 np.any(combo[1:] != combo[:-1], axis=1)]),
        'confs': np.stack(cs, axis=1).astype(np.int32),
        'ids': ids_grid[q2, q1, q3, v],
    }


def cyclical_embed_trimol_rigid(mols, systematic_angles, clash_thresh=1.5,
                                pairing_ok=None, log=print, block_chunk=None,
                                *, device, dtype=None, info=None, mesh=None):
    '''Rigid three-molecule cyclical embed: the molecules on the sides
    of the triangle their pivot norms close, 8 oriented triangles, the
    chained direction adjustment (float64), then the block sweep of the
    two-molecule embed over the (A, 3) angle grid, K1 screening the
    cross-fragment pairs of the three fragments. Arguments and returns
    as cyclical_embed_bimol_rigid, the constraint ids (S, 3, 2); info
    also receives the adjustment's seconds and near ties.'''
    def make_blocks(dev, clock, A):
        t0 = clock()
        blk = trimol_rigid_blocks(mols, pairing_ok)
        if blk is None:
            return None, {}
        log(f'--> Performing cyclical embed ({len(blk["ids"]) * A} '
            f'candidates, {len(blk["ids"])} blocks)')
        t1 = clock()
        blk['dirs'], gap = adjust_chain(*(blk[k] for k in _ADJUST),
                                        device=dev)
        return blk, {'blocks_s': t1 - t0, 'adjust_s': clock() - t1,
                     'adjust_near_ties': int((gap < ADJ_TIE).sum())}

    return rigid_embed(mols, make_blocks, 'no valid pivot triangles',
                       systematic_angles, clash_thresh, block_chunk, device,
                       dtype, info, mesh)


# ------------------------------------------------------------ non-rigid


def _bend_blocked_by_bonded_pair(mol):
    '''True when the molecule's two reactive atoms are directly bonded,
    which makes bending it toward a pivot target meaningless. False for
    a molecule with one reactive atom, which does NOT mean bendable: the
    digon branch also requires two reactive atoms before it bends, and
    that guard at its call site is load-bearing.'''
    return (len(mol.reactive_indices) > 1
            and mol.graph.has_edge(*sorted(
                int(x) for x in mol.reactive_indices[:2])))


_ROW_FIELDS = ('starts', 'ends', 'pvs', 'mds', 'apms', 'mps', 'rc_axes',
               'confs', 'ids')
_ROW_ADJUST = ('rc_src', 'verts', 'reset', 'dirs0')


def nonrigid_rows(embedder, max_norm_delta, bend):
    '''Phase 1 of the non-rigid embed, host-sequential: walk the
    conformer and pivot combinations in the reference's order, bend
    where the pivot lengths ask for it with bend(mol, conf, pivot,
    target) (a bend replaces the molecule in the working list for every
    later combination), and emit one row per kept orientation.

    Two molecules: a combination whose pivot norms differ by
    max_norm_delta or more bends every bendable molecule toward a shared
    length (the shorter norm for a chelotropic embed, else 0.8 of the
    shorter plus 0.2 of the longer) and embeds whatever the bends
    achieved. Three molecules: a combination that closes no triangle is
    skipped when a side exceeds the other two by 20% of its length or
    more; else the worst side's molecule is bent to 0.9 of the other
    two's sum, and the combination is kept if it closes a triangle then.

    Returns the groups: a list of {'mols': the working list when the
    rows were made, 'rows': [dict of _ROW_FIELDS (and _ROW_ADJUST for
    three molecules) per row]}; a group ends where a bend, or a cache
    hit that returns an earlier bent molecule, changes the identity of a
    molecule's coordinate array.'''
    mols = list(embedder.objects)
    n_mols = len(mols)
    offsets = tuple(int(x) for x in np.concatenate(
        [[0], np.cumsum([m.n_atoms for m in mols])[:-1]]))
    pairing_ok = embedder.pairing_ok_fn()

    # conformer combos in the reference cartesian order
    if n_mols == 2:
        conf_combos = [(i1, i2) for i2 in range(mols[1].n_confs)
                       for i1 in range(mols[0].n_confs)]
    else:
        conf_combos = [(i1, i2, i3)
                       for i2 in range(mols[1].n_confs)
                       for i1 in range(mols[0].n_confs)
                       for i3 in range(mols[2].n_confs)]

    total = sum(int(np.prod([len(m.pivots[c[i]])
                             for i, m in enumerate(mols)]))
                for c in conf_combos)
    embedder.log(f'--> Performing {embedder.embed} embed '
                 f'(non-rigid, {total} pivot combinations)')

    groups = []

    def row_group():
        key = tuple(id(m.atomcoords) for m in mols)
        if not groups or groups[-1]['key'] != key:
            groups.append({'key': key, 'mols': list(mols), 'rows': []})
        return groups[-1]['rows']

    def pivots_of(conf_ids, qi):
        return [mols[m].pivots[conf_ids[m]][qi[m]] for m in range(n_mols)]

    for conf_ids in conf_combos:
        if n_mols == 2:
            piv_combos = [(q1, q2)
                          for q2 in range(len(mols[1].pivots[conf_ids[1]]))
                          for q1 in range(len(mols[0].pivots[conf_ids[0]]))]
        else:
            piv_combos = [(q1, q2, q3)
                          for q2 in range(len(mols[1].pivots[conf_ids[1]]))
                          for q1 in range(len(mols[0].pivots[conf_ids[0]]))
                          for q3 in range(len(mols[2].pivots[conf_ids[2]]))]

        for qi in piv_combos:
            try:
                pivots = pivots_of(conf_ids, qi)
            except IndexError:
                continue   # a bend reduced this molecule's pivot count
            norms = np.array([np.linalg.norm(p.pivot) for p in pivots])

            if n_mols == 2:
                if abs(norms[0] - norms[1]) >= max_norm_delta:
                    if embedder.embed == 'chelotropic':
                        target = float(min(norms))
                    else:
                        r = 0.8
                        target = float(min(norms) * r + max(norms) * (1 - r))
                    for i, mol in enumerate(mols):
                        if len(mol.reactive_indices) > 1 and not \
                                _bend_blocked_by_bonded_pair(mol):
                            mols[i] = bend(mol, conf_ids[i], pivots[i],
                                           target)
                    try:
                        pivots = pivots_of(conf_ids, qi)
                    except IndexError:
                        continue
                    norms = np.array([np.linalg.norm(p.pivot)
                                      for p in pivots])
            else:
                if not all(norms[i] < norms[i - 1] + norms[i - 2]
                           for i in (0, 1, 2)):
                    deltas = [norms[i] - (norms[i - 1] + norms[i - 2])
                              for i in range(3)]
                    rel_delta = max(deltas[i] / norms[i] for i in range(3))
                    if rel_delta >= 0.2:
                        continue
                    index = int(np.argmax(deltas))
                    mol = mols[index]
                    if _bend_blocked_by_bonded_pair(mol):
                        continue
                    maxval = norms[index - 1] + norms[index - 2]
                    mols[index] = bend(mol, conf_ids[index], pivots[index],
                                       0.9 * float(maxval))
                    try:
                        pivots = pivots_of(conf_ids, qi)
                    except IndexError:
                        continue
                    norms = np.array([np.linalg.norm(p.pivot)
                                      for p in pivots])
                    if not all(norms[i] < norms[i - 1] + norms[i - 2]
                               for i in (0, 1, 2)):
                        continue

            try:
                polygon = polygonize(norms)
            except Exception:
                continue

            # per-combination block values (constant across orientations)
            pvs_c = np.array([p.pivot for p in pivots])
            mps_c = np.array([p.meanpoint for p in pivots])
            apms_c = np.zeros((n_mols, 3))
            mds_c = np.zeros((n_mols, 3))
            rc_axes_c = np.zeros((n_mols, 3))
            for m in range(n_mols):
                rc = mols[m].atomcoords[conf_ids[m]][mols[m].reactive_indices]
                apm = rc.mean(axis=0)
                md = pivots[m].meanpoint - apm
                if np.all(md == 0.):
                    md = pivots[m].meanpoint
                apms_c[m] = apm
                mds_c[m] = md
                rc_axes_c[m] = (rc[0] - rc[1]) if len(rc) == 2 \
                    else pivots[m].pivot

            if n_mols == 3:
                directions0 = get_directions(norms)
                verts3 = np.zeros((3, 3))
                verts3[1, 0] = norms[0]
                a_, b_, c_ = norms ** 2
                x_ = (a_ - b_ + c_) / (2 * a_ ** 0.5)
                verts3[2, :2] = [x_, (c_ - x_ ** 2) ** 0.5]

            rows = None
            first_of_combo = True
            for v in range(polygon.shape[0]):
                arr_ids = (_cyclical_ids_bimol(pivots, v, offsets)
                           if n_mols == 2 else
                           cyclical_ids_trimol(pivots, v, offsets))
                if pairing_ok is not None and not pairing_ok(arr_ids):
                    continue
                if rows is None:
                    rows = row_group()
                row = {'starts': np.array([polygon[v][m][0]
                                           for m in range(n_mols)]),
                       'ends': np.array([polygon[v][m][1]
                                         for m in range(n_mols)]),
                       'pvs': pvs_c, 'mps': mps_c, 'apms': apms_c,
                       'mds': mds_c, 'rc_axes': rc_axes_c,
                       'confs': np.array(conf_ids, dtype=np.int32),
                       'ids': np.array(arr_ids)}
                if n_mols == 3:
                    # the adjustment chain restarts (reset) at each
                    # combination's first kept row; its reactive-atom
                    # coordinates are those of conformer 0 of each
                    # molecule, whatever the row's conformers, as the
                    # reference takes them
                    r = facing_matrix(arr_ids, offsets)
                    row.update(
                        rc_src=np.array([mols[m].atomcoords[0][r[m, partner]]
                                         for m, partner in _FACES]),
                        verts=verts3, dirs0=directions0,
                        reset=first_of_combo)
                rows.append(row)
                first_of_combo = False
    return [g for g in groups if g['rows']]


def nonrigid_blocks(groups, device):
    '''The block dict of each of nonrigid_rows' groups (the fields of
    trimol_rigid_blocks' dict, `dirs` among them), and the adjustment's
    gap per row, None for two molecules. Three molecules' directions
    come from ONE chained adjustment over every row: the chain restarts
    at reset rows, so concatenating the groups changes nothing.'''
    trimol = 'reset' in groups[0]['rows'][0]
    fields = _ROW_FIELDS + (_ROW_ADJUST if trimol else ())
    blks = [{k: np.array([row[k] for row in g['rows']]) for k in fields}
            for g in groups]
    if not trimol:
        for b in blks:
            b['dirs'] = np.tile(_DIRECTIONS, (len(b['ids']), 1, 1))
        return blks, None
    dirs, gap = adjust_chain(
        *(np.concatenate([b[k] for b in blks]) for k in _ADJUST),
        device=device)
    lo = 0
    for b in blks:
        b['dirs'] = dirs[lo:lo + len(b['ids'])]
        lo += len(b['ids'])
    return blks, gap


def cyclical_embed_nonrigid(embedder, max_norm_delta=5):
    '''
    General (non-rigid) cyclical embed for 2-3 molecules: pivot-length
    mismatches that prevent a digon or triangle are corrected by BENDING
    the offending molecules (nonrigid_rows; the bends run in float64 on
    the embedder's device and are cached on the embedder). Then one
    chained direction adjustment over all rows (three molecules), and
    per group of rows that share their molecules' coordinates the block
    sweep of the rigid embeds: geometry, poses, K1, angular dedup, a
    chunk at a time. embedder.embed_info receives the counts and the
    split, the bends among them. Returns (poses (S, N, 3) float64 numpy,
    constrained_indices (S, M, 2)).
    '''
    from tscode_tpu_torch.bending import bend_molecule
    from tscode_tpu_torch.operators import qm_gradient_source

    dev, dtype = embedder.device, embedder.dtype
    trace, clock = embed_clock(dev)
    angles = np.asarray(embedder.systematic_angles, dtype=float)
    cache = getattr(embedder, 'bent_mols_cache', None)
    if cache is None:
        cache = embedder.bent_mols_cache = {}
    stats = {'bends': 0, 'relaxations': 0, 'hits': 0, 'reverts': 0}
    bends_s = 0.0

    def bend(mol, conf, pivot, target):
        nonlocal bends_s
        t0 = clock()
        bent = bend_molecule(
            mol, conf, pivot, target, cache=cache,
            suprafacial=embedder.options.suprafacial,
            protect_double_bonds=embedder.options.double_bond_protection,
            logfunction=embedder.log,
            gradient_fn=qm_gradient_source(embedder, mol), stats=stats,
            device=dev)
        bends_s += clock() - t0
        return bent

    t0 = clock()
    groups = nonrigid_rows(embedder, max_norm_delta, bend)
    if not groups:
        raise ZeroCandidatesError(
            '--> Cyclical embed did not find any suitable disposition of '
            'molecules.')
    t1 = clock()
    split = {'blocks_s': t1 - t0 - bends_s, 'bends_s': bends_s,
             'bends': stats['bends'],
             'bend_relaxations': stats['relaxations'],
             'bend_hits': stats['hits'], 'bend_reverts': stats['reverts'],
             'groups': len(groups)}

    blks, gap = nonrigid_blocks(groups, dev)
    if gap is not None:
        split.update(adjust_s=clock() - t1,
                     adjust_near_ties=int((gap < ADJ_TIE).sum()))

    survs, keeps, uploaded = [], [], {}
    totals = {'screen_s': 0.0, 'dedup_s': 0.0, 'chunks': 0, 'chunk_rows': 0}
    for g, blk in zip(groups, blks):
        part = {}
        surv, keep = screen_survivors(
            blk, g['mols'], angles, embedder.options.clash_thresh,
            device=dev, dtype=dtype, clock=clock, split=part,
            uploaded=uploaded)
        survs.append(surv)
        keeps.append(keep)
        for k in ('screen_s', 'dedup_s', 'chunks'):
            totals[k] += part[k]
        totals['chunk_rows'] = max(totals['chunk_rows'], part['chunk_rows'])
        totals['sweep_kernel'] = part['sweep_kernel']
    split.update(totals)
    clock()
    return finish_embed(torch.cat(survs), np.concatenate(keeps),
                        np.concatenate([b['ids'] for b in blks]), split,
                        len(angles), dev, dtype, trace,
                        getattr(embedder, 'embed_info', None))


def cyclical_embed(embedder, max_norm_delta=5):
    '''Dispatcher of the cyclical embeds: the non-rigid one unless RIGID
    is set, else the rigid two-molecule one (with max_norm_delta=5, as
    the reference calls it from here) or the rigid three-molecule one.
    Sets embedder.constrained_indices and returns the poses.'''
    mols = embedder.objects
    if not embedder.options.rigid:
        poses, cons = cyclical_embed_nonrigid(embedder, max_norm_delta)
        embedder.constrained_indices = cons
        return poses
    common = dict(clash_thresh=embedder.options.clash_thresh,
                  pairing_ok=embedder.pairing_ok_fn(), log=embedder.log,
                  device=embedder.device, dtype=embedder.dtype,
                  info=embedder.embed_info, mesh=embedder._mesh())
    if len(mols) == 2:
        poses, cons = cyclical_embed_bimol_rigid(
            mols[0], mols[1], embedder.systematic_angles,
            max_norm_delta=max_norm_delta, **common)
    else:
        poses, cons = cyclical_embed_trimol_rigid(
            mols, embedder.systematic_angles, **common)
    embedder.constrained_indices = cons
    return poses
