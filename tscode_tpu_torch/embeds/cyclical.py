'''
Rigid bimolecular cyclical embed: two molecules with two reactive atoms
each, docked across both pairings at once, as in a Diels-Alder
transition state (counterpart of the two-molecule rigid part of
tscode_tpu/embeds/cyclical.py).

The sweep is cut into blocks,

  block = (conformer pair) x (pivot pair passing the norm-delta and
          pairing gates) x (polygon orientation),

built on the host in the reference's generation order. Each block is
expanded over the A angle pairs of the grid on the device, a chunk of
block rows at a time: the block's alignment (two-vector Kabsch), its A
poses, the clash screen (kernel K1 on CUDA, its plain twin on the CPU),
the block-local (A, A) rmsd and maxdev matrices and the greedy angular
dedup (keep an angle that passed the screen and is unlike every angle
kept before it in its block). The dedup is block-local, so chunking
changes nothing. The survivors are compacted on the device; only the
keep mask and the survivor rows reach the host.

The trimolecular and the non-rigid (bending) cyclical embeds are not
ported (ROADMAP.md items 12 and 13). Set TSCODE_EMBED_TRACE=1 to print
the split of block building, screen, dedup and assembly to stderr.
'''

import os
import sys
import time

import numpy as np
import torch

from tscode_tpu_torch.backend import default_dtype, get_device, synchronize
from tscode_tpu_torch.embeds.common import DeviceSurvivors
from tscode_tpu_torch.errors import ZeroCandidatesError
from tscode_tpu_torch.ops.clash import cross_fragment_pair_mask, static_pairs
from tscode_tpu_torch.ops.kernels.clash import clash_ok
from tscode_tpu_torch.ops.linalg import (align_vec_pair, polygonize,
                                         rot_mat_from_pointer)
from tscode_tpu_torch.ops.rmsd_prune import pair_gate_matrices

_DIRECTIONS = np.array([[0., 1., 0.], [0., -1., 0.]])

# a chunk's (rows, A, A, N, 3) maxdev intermediate stays under this
GATE_BYTES = 1 << 30
# the angular dedup's gates: rmsd and maxdev of a pose pair, in A
DEDUP_RMSD = 1.0
DEDUP_MAXDEV = 2.0


def _auto_chunk(n_rows, n_angles, n_atoms, itemsize):
    '''Block rows per chunk: as many as keep the (rows, A, A, N, 3)
    maxdev intermediate within GATE_BYTES, at least one, at most all.'''
    per_row = n_angles * n_angles * n_atoms * 3 * itemsize
    return int(max(1, min(n_rows, GATE_BYTES // per_row)))


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

    def mol_tables(mol, pv, mp):
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

    apm1, md1, rca1 = mol_tables(mol1, pv1, mp1)
    apm2, md2, rca2 = mol_tables(mol2, pv2, mp2)

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


def block_poses(coords1, coords2, c1, c2, R_align, axis, cor, pos0,
                angle_grid, pairs, clash_thresh, clash=clash_ok):
    '''Each block expanded over the angle grid (A, 2) in degrees, and
    the clash screen of every pose with `clash` (K1's entry, or its
    plain twin to compare with). Returns poses (Bb, A, N, 3) and
    ok (Bb, A) bool.'''
    R_step = rot_mat_from_pointer(axis[:, None, :, :],
                                  angle_grid[None, :, :])   # (Bb, A, 2, 3, 3)
    R = torch.einsum('bamij,bmjk->bamik', R_step, R_align)
    t = cor[:, None] - torch.einsum('bamij,bmj->bami', R_step, cor) \
        + pos0[:, None]
    f1 = torch.einsum('baij,bnj->bani', R[:, :, 0], coords1[c1]) \
        + t[:, :, 0][:, :, None]
    f2 = torch.einsum('baij,bnj->bani', R[:, :, 1], coords2[c2]) \
        + t[:, :, 1][:, :, None]
    poses = torch.cat([f1, f2], dim=2)
    Bb, A, N = poses.shape[:3]
    ok = clash(poses.reshape(Bb * A, N, 3), pairs, clash_thresh)
    return poses, ok.reshape(Bb, A)


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
    Returns (c1, c2, starts, ends, dirs, pvs, mds, apms, mps, rc_axes).'''
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

    return (c1, c2, starts, ends, dirs, pair(0), pair(1), pair(2), pair(3),
            pair(4))


def block_screen(coords1, coords2, tab1, tab2, ti, angle_grid, pairs,
                 clash_thresh, clash=clash_ok):
    '''One chunk of the sweep from the compact form: geometry, poses,
    clash screen and angular dedup. ti (rows, 5) index rows on the
    device. Returns (poses (rows, A, N, 3), keep (rows, A)).'''
    c1, c2, *geo = compact_rows(tab1, tab2, ti)
    poses, ok = block_poses(coords1, coords2, c1, c2, *block_geometry(*geo),
                            angle_grid, pairs, clash_thresh, clash=clash)
    return poses, angular_dedup(poses, ok)


_GEOMETRY = ('starts', 'ends', 'dirs', 'pvs', 'mds', 'apms', 'mps',
             'rc_axes')


def sweep_inputs(blk, mol1, mol2, angles, device, dtype):
    '''The device inputs of a sweep: (coords1, coords2, angle grid (A, 2),
    pairs (P, 2) int32, rows) where rows(lo, hi) gives block_geometry's
    inputs for block rows [lo, hi), prefixed by their conformer ids:
    gathered from the compact tables when `blk` has them, else sliced
    from its per-block fields (the loop form's ragged case).'''
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)

    if 'tidx' in blk:
        tab1, tab2 = t(blk['tab1']), t(blk['tab2'])
        tidx = torch.as_tensor(blk['tidx'], device=device).long()

        def rows(lo, hi):
            return compact_rows(tab1, tab2, tidx[lo:hi])
    else:
        cols = [torch.as_tensor(blk[k], device=device).long()
                for k in ('c1', 'c2')] + [t(blk[k]) for k in _GEOMETRY]

        def rows(lo, hi):
            return tuple(c[lo:hi] for c in cols)

    pairs = torch.as_tensor(static_pairs(cross_fragment_pair_mask(
        (mol1.n_atoms, mol2.n_atoms))), device=device)
    return t(mol1.atomcoords), t(mol2.atomcoords), t(angles), pairs, rows


def screen_survivors(blk, mol1, mol2, angles, clash_thresh, *, device,
                     dtype, block_chunk=None, clock=time.perf_counter,
                     split=None):
    '''The whole sweep over the block rows of `blk`, chunk by chunk:
    returns (survivor poses (S, N, 3) on the device in generation order,
    keep (Bb, A) numpy bool). split, when given, gets the seconds of the
    screen (geometry, poses, clash and compaction) and of the dedup.'''
    coords1, coords2, grid, pairs, rows = sweep_inputs(
        blk, mol1, mol2, angles, device, dtype)
    Bb, A = len(blk['c1']), grid.shape[0]
    N = coords1.shape[1] + coords2.shape[1]
    chunk = block_chunk or _auto_chunk(Bb, A, N, coords1.element_size())
    acc = DeviceSurvivors()
    t_screen = t_dedup = 0.0
    for lo in range(0, Bb, chunk):
        t0 = clock()
        c1, c2, *geo = rows(lo, lo + chunk)
        poses, ok = block_poses(coords1, coords2, c1, c2,
                                *block_geometry(*geo), grid, pairs,
                                clash_thresh)
        t1 = clock()
        keep = angular_dedup(poses, ok)
        t2 = clock()
        acc.add((poses.reshape(-1, N, 3),), keep.reshape(-1))
        t_screen += t1 - t0 + clock() - t2
        t_dedup += t2 - t1
    fields, keep = acc.finish()
    if split is not None:
        split.update(screen_s=t_screen, dedup_s=t_dedup, chunk_rows=chunk,
                     chunks=-(-Bb // chunk))
    return fields[0], keep.reshape(Bb, A)


def assemble_survivors(surv_poses, keep, ids_arr):
    '''Survivor poses pulled to the host as float64 numpy (S, N, 3), and
    each one's constraint ids (S, 2, 2): the survivors sit in block
    order, so the ids are one repeat of the block ids by the per-block
    keep counts.'''
    counts = np.asarray(keep).sum(axis=1).astype(np.int64)
    cons = np.repeat(np.asarray(ids_arr), counts, axis=0)
    return surv_poses.cpu().to(torch.float64).numpy(), cons


def cyclical_embed_bimol_rigid(mol1, mol2, systematic_angles,
                               clash_thresh=1.5, max_norm_delta=10,
                               pairing_ok=None, log=print, block_chunk=None,
                               *, device, dtype=None, info=None):
    '''Rigid bimolecular cyclical embed.

    systematic_angles: (A, 2) per-molecule step angles in degrees (the
    embedder's angle grid). pairing_ok: optional callable(ids) -> bool
    enforcing the user's pairings. device / dtype: where and in what the
    sweep runs (dtype defaults to float32 on CUDA, float64 on the CPU).
    info: a dict that, when given, receives the counts and the split.
    Returns (poses (S, N, 3) float64 numpy, constrained_indices
    (S, 2, 2)). Raises ZeroCandidatesError when no block or no pose
    survives.'''
    dev = get_device(device)
    dtype = dtype or default_dtype(dev)
    trace = os.environ.get('TSCODE_EMBED_TRACE') == '1'

    def clock():
        if trace:
            synchronize(dev)
        return time.perf_counter()

    t0 = clock()
    angles = np.asarray(systematic_angles, dtype=float)
    A = len(angles)
    blk = bimol_rigid_blocks(mol1, mol2, max_norm_delta=max_norm_delta,
                             pairing_ok=pairing_ok)
    if blk is None:
        raise ZeroCandidatesError(
            '--> Cyclical embed did not find any suitable disposition of '
            'molecules (no compatible pivot pairs).')
    Bb = len(blk['c1'])
    log(f'--> Performing cyclical embed ({Bb * A} candidates, {Bb} blocks)')
    t1 = clock()

    split = {}
    surv, keep = screen_survivors(blk, mol1, mol2, angles, clash_thresh,
                                  device=dev, dtype=dtype,
                                  block_chunk=block_chunk, clock=clock,
                                  split=split)
    t2 = clock()
    if surv.shape[0] == 0:
        raise ZeroCandidatesError(
            '--> Cyclical embed did not find any suitable disposition of '
            'molecules.\n    This is probably because one molecule has two '
            'reactive centers at a great distance,\n    preventing the '
            'other two molecules from forming a closed, cyclical structure.')
    poses, cons = assemble_survivors(surv, keep, blk['ids'])
    t3 = time.perf_counter()

    split.update(blocks_s=t1 - t0, assemble_s=t3 - t2)
    if trace:
        print(f'[cyc trace] blocks {split["blocks_s"]:.3f}s, screen '
              f'{split["screen_s"]:.3f}s, dedup {split["dedup_s"]:.3f}s, '
              f'assemble {split["assemble_s"]:.3f}s ({Bb} blocks in '
              f'{split["chunks"]} chunks of {split["chunk_rows"]}, '
              f'{len(poses)} survivors)', file=sys.stderr, flush=True)
    if info is not None:
        info.update(candidates=int(Bb * A), blocks=int(Bb),
                    survivors=int(len(poses)),
                    dtype=str(dtype).split('.')[-1], device=str(dev),
                    trace=trace, **split)
    return poses, cons


def cyclical_embed(embedder, max_norm_delta=5):
    '''Dispatcher of the cyclical embeds: the rigid bimolecular one runs
    (with max_norm_delta=5, as the reference calls it from here); the
    trimolecular and non-rigid ones raise NotImplementedError. Sets
    embedder.constrained_indices and returns the poses.'''
    from tscode_tpu_torch.embedder import not_ported
    mols = embedder.objects
    if not embedder.options.rigid:
        raise not_ported('The non-rigid cyclical embed (bending)',
                         '12 and 13')
    if len(mols) != 2:
        raise not_ported('The trimolecular cyclical embed', 12)
    poses, cons = cyclical_embed_bimol_rigid(
        mols[0], mols[1], embedder.systematic_angles,
        clash_thresh=embedder.options.clash_thresh,
        max_norm_delta=max_norm_delta,
        pairing_ok=embedder.pairing_ok_fn(), log=embedder.log,
        device=embedder.device, dtype=embedder.dtype,
        info=embedder.embed_info)
    embedder.constrained_indices = cons
    return poses
