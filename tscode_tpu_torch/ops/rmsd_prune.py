'''
All-pairs Kabsch-RMSD ensemble pruning with the exact bucketed schedule
(counterpart of tscode_tpu/ops/rmsd_prune.py).

Semantics, as in the JAX package and its CPU reference: for each k of
K_SCHEDULE whose gate `k == 1 or 20*k < active` holds at pass start, the
first n rows are cut into k chunks of n // k rows (the last chunk takes
the remainder), and an active row dies when a LATER row of its chunk,
active at pass start, has rmsd < thr and maxdev < 2*thr.

Design on the card: one pair-kernel launch per pass, launched from the
host. The pass's active rows and chunk ends are computed on the device
(nonzero + searchsorted), and the kill bits are written back by a plain
scatter (no boolean index, so no sync); only the active count crosses
to the host, to evaluate the next gate. The JAX package's single-program tiers
(in-place, mid, mid2, finish) are TPU optimisations of these same
semantics and are not ported.
'''

import numpy as np
import torch

from tscode_tpu_torch.ops.kernels.qcp import qcp_kill

K_SCHEDULE = (5e5, 2e5, 1e5, 5e4, 2e4, 1e4,
              5000, 2000, 1000, 500, 200, 100,
              50, 20, 10, 5, 2, 1)


def pass_chunks(mask, n, k):
    '''Active rows of one pass and their chunk ends.
    mask (n_pool,) bool; chunks of n // k rows over the first n rows.
    Returns act (M,) int64 pool rows in order and end (M,) int64: the
    exclusive end, as a position in act, of each position's chunk.'''
    act = torch.nonzero(mask).squeeze(1)
    bounds = torch.arange(1, k, device=mask.device) * (n // k)
    chunk = torch.searchsorted(bounds, act, right=True)
    end = torch.searchsorted(chunk, chunk, right=True)
    return act, end


def prune_conformers_rmsd_device(heavy_structures, rmsd_thr=0.5,
                                 init_mask=None, n_real=None,
                                 pair_kill=qcp_kill):
    '''Bucketed RMSD prune of a device-resident pool. heavy_structures
    (n_pool, N, 3) tensor (or array, taken to a CPU tensor); the
    schedule follows the first n_real rows (default all), rows past it
    start dead, and init_mask (n_pool,) marks rows dead from the start.
    pair_kill is the per-pass engine (the CUDA kernel's wrapper, or its
    plain twin to compare with). Returns the (n_pool,) bool keep mask
    as a numpy array.'''
    hs = torch.as_tensor(heavy_structures)
    n_pool = hs.shape[0]
    n = int(n_real) if n_real is not None else n_pool
    if init_mask is None:
        mask = torch.ones(n_pool, dtype=torch.bool, device=hs.device)
    else:
        mask = torch.tensor(np.array(init_mask, dtype=bool),
                            device=hs.device)
    mask[n:] = False
    if n <= 1:
        return mask.cpu().numpy()

    hs = hs.contiguous()
    active = int(mask.sum())
    for k in K_SCHEDULE:
        if not (k == 1 or 20 * k < active):
            continue
        act, end = pass_chunks(mask, n, int(k))
        kill = pair_kill(hs, act, end, rmsd_thr)
        mask[act] = ~kill     # every act row is active at pass start
        active = int(mask.sum())
    return mask.cpu().numpy()


def prune_conformers_rmsd(structures, atomnos, rmsd_thr=0.5):
    '''Remove similar structures; returns (pruned, keep_mask) with the
    bucketed keep/kill semantics above, over heavy atoms only.
    structures (n, N_atoms, 3) tensor or array; keep_mask numpy bool.'''
    structures = torch.as_tensor(structures)
    n = structures.shape[0]
    if n <= 1:
        return structures, np.ones(n, dtype=bool)
    heavy = torch.as_tensor(np.flatnonzero(np.asarray(atomnos) != 1),
                            device=structures.device)
    mask = prune_conformers_rmsd_device(
        structures[:, heavy].contiguous(), rmsd_thr=rmsd_thr)
    return structures[torch.as_tensor(mask, device=structures.device)], mask
