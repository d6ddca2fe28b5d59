'''
All-pairs Kabsch-RMSD ensemble pruning with the exact bucketed schedule
(counterpart of tscode_tpu/ops/rmsd_prune.py).

Semantics, as in the JAX package and its CPU reference: for each k of
K_SCHEDULE whose gate `k == 1 or 20*k < active` holds at pass start, the
first n rows are cut into k chunks of n // k rows (the last chunk takes
the remainder), and an active row dies when a LATER row of its chunk,
active at pass start, has rmsd < thr and maxdev < 2*thr.

Two forms on the card, with the same survivors. The host loop
(host_schedule): one pair-kernel launch per pass, launched from the host.
The pass's active rows and chunk ends are computed on the device
(nonzero + searchsorted), and the kill bits are written back by a plain
scatter (no boolean index, so no sync); only the active count crosses
to the host, to evaluate the next gate. With a mesh, each pass's
positions are cut into contiguous slices of about equal pair work, one
per device (parallel/prune.py). The one-program form (device_schedule,
the JAX package's _device_schedule): every pass that can run on n rows,
each compacted into fixed-length buffers on the device
(pass_chunks_fixed) and launched as K3's device-count entry, which opens
the pass's gate on the card; on a CUDA device it is captured once as a
CUDA graph (schedule_call). warmup_prune_kernels captures it for a pool
shape, and prune_conformers_rmsd_device then prunes such a pool in one
replay. The JAX package's in-place, banded and finish tiers are TPU
memory designs of the same semantics and are not ported.
'''

import numpy as np
import torch

from tscode_tpu_torch.backend import get_device, span, traced
from tscode_tpu_torch.capture import graph_loop
from tscode_tpu_torch.ops.kernels import qcp
from tscode_tpu_torch.ops.kernels.qcp import qcp_kill, qcp_kill_dev
from tscode_tpu_torch.ops.linalg import (_qcp_lambda_max, rmsd_and_max,
                                         rotation_from_key)

K_SCHEDULE = (5e5, 2e5, 1e5, 5e4, 2e4, 1e4,
              5000, 2000, 1000, 500, 200, 100,
              50, 20, 10, 5, 2, 1)


def rmsd_matrix_lambda_only(P, Q, n_atoms):
    '''Pairwise Kabsch RMSD without centering, from QCP's lambda_max
    alone: P (A, N, 3), Q (B, N, 3) -> (A, B).'''
    S = torch.einsum('ani,bnk->abik', P, Q)
    GA = torch.sum(P * P, dim=(-2, -1))[:, None]
    GB = torch.sum(Q * Q, dim=(-2, -1))[None, :]
    lam = _qcp_lambda_max(S, GA, GB)
    msd = (GA + GB - 2.0 * lam) / n_atoms
    return torch.sqrt(torch.clamp(msd, min=0.0))


def maxdev_pairs(P, Q):
    '''Largest per-atom deviation after Kabsch superposition of each
    explicit pair: P, Q (K, N, 3) -> (K,).'''
    S = torch.einsum('kni,knj->kij', P, Q)
    GA = torch.sum(P * P, dim=(-2, -1))
    GB = torch.sum(Q * Q, dim=(-2, -1))
    R = rotation_from_key(S, _qcp_lambda_max(S, GA, GB))
    diff = torch.einsum('kij,knj->kni', R, P) - Q
    return torch.amax(torch.sqrt(torch.sum(diff * diff, dim=-1)), dim=-1)


def pair_gate_matrices(P, n_atoms):
    '''Pairwise rmsd and maxdev matrices within each pose block, from one
    correlation pass: P (..., A, N, 3) -> (rmsd (..., A, A), maxdev
    (..., A, A)); entry (a, b) superposes pose a onto pose b.'''
    S = torch.einsum('...ani,...bnk->...abik', P, P)
    G = torch.sum(P * P, dim=(-2, -1))
    GA, GB = G[..., :, None], G[..., None, :]
    lam = _qcp_lambda_max(S, GA, GB)
    msd = (GA + GB - 2.0 * lam) / n_atoms
    rmsd = torch.sqrt(torch.clamp(msd, min=0.0))
    R = rotation_from_key(S, lam)
    diff = torch.einsum('...abij,...anj->...abni', R, P) - P[..., None, :, :, :]
    maxdev = torch.amax(torch.sqrt(torch.sum(diff * diff, dim=-1)), dim=-1)
    return rmsd, maxdev


def rmsd_similarity_sequential(ref_pose, poses, rmsd_thr):
    '''True when ref_pose (N, 3) passes both gates (rmsd < thr and
    maxdev < 2*thr) against ANY pose of poses (B, N, 3): the
    reference's _rmsd_similarity, batched. Tensors or arrays, float64
    on the CPU for arrays.'''
    if len(poses) == 0:
        return False
    rmsd, maxdev = rmsd_and_max(torch.as_tensor(poses),
                                torch.as_tensor(ref_pose)[None])
    return bool(((rmsd < rmsd_thr) & (maxdev < 2 * rmsd_thr)).any())


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


def pass_chunks_fixed(mask, n, k):
    '''pass_chunks with no host sync, in buffers of n entries: act (n,)
    int32, the active rows among the first n in order, then zeros; end
    (n,) int32, each real position's chunk end, as pass_chunks gives
    them (padded positions take a chunk id past every real one, so real
    ends stay as they are); m (1,) int32, the count M of real positions.
    act is a cumsum-and-scatter compaction; n >= 1.'''
    dev = mask.device
    live = mask[:n]
    pos = torch.cumsum(live, 0)
    m = pos[-1:]
    idx = torch.arange(n, device=dev)
    act = torch.zeros(n + 1, dtype=torch.long, device=dev).scatter_(
        0, torch.where(live, pos - 1, n), idx)[:n]   # entry n: the dead
    bounds = torch.arange(1, k, device=dev) * (n // k)
    chunk = torch.where(idx < m, torch.searchsorted(bounds, act, right=True),
                        k)
    end = torch.searchsorted(chunk, chunk, right=True)
    return act.int(), end.int(), m.int()


def schedule_ks(n):
    '''The values of K_SCHEDULE whose pass can run on n rows: k == 1 or
    20 k < n (a pass never starts with more than n active rows); none
    for n <= 1.'''
    return tuple(int(k) for k in K_SCHEDULE
                 if n > 1 and (k == 1 or 20 * k < n))


@traced
def device_schedule(hs, alive, rmsd_thr, n):
    '''The whole bucketed schedule over the first n rows of hs (n_pool,
    N, 3) with no host sync (counterpart of the JAX package's
    _device_schedule): each pass of schedule_ks(n) is compacted on the
    device (pass_chunks_fixed) and launched as K3's device-count entry
    (qcp_kill_dev), which opens the pass's gate, k == 1 or 20 k < active,
    on the card from the count the compaction wrote. alive (n_pool,)
    bool, rows past n taken as dead. Returns (alive, n_active, finished)
    as tensors. The JAX package's in-place, banded and finish tiers are
    TPU memory designs and are not copied; its keep/kill semantics are,
    exactly, so the schedule always finishes: finished is always True,
    kept for the JAX contract.'''
    alive = alive.clone()
    alive[n:] = False
    for k in schedule_ks(n):
        act, end, m = pass_chunks_fixed(alive, n, k)
        qcp_kill_dev(hs, act, end, m, k, rmsd_thr, alive)
    return alive, alive.sum(), torch.ones((), dtype=torch.bool,
                                          device=alive.device)


def schedule_call(hs, alive, rmsd_thr, n):
    '''device_schedule as one call: on a CUDA device one replay of its
    CUDA graph (graph_loop captures it at the first call for each n,
    rmsd_thr, pool shape, dtype and device, and keeps it), eagerly on
    the CPU. hs contiguous.'''
    if hs.device.type != 'cuda':
        return device_schedule(hs, alive, rmsd_thr, n)
    thr = float(rmsd_thr)

    def body(state, args):
        return device_schedule(args[0], state[0], thr, n)

    state = (alive, torch.zeros((), dtype=torch.long, device=hs.device),
             torch.zeros((), dtype=torch.bool, device=hs.device))
    return graph_loop(body, state, (hs,), 1)


# (n, pool shape, dtype, device) of the pools whose schedule
# warmup_prune_kernels captured: prune_conformers_rmsd_device prunes
# them in one call
_SCHEDULE_WARMED = set()


def _schedule_key(hs, n):
    return (n, tuple(hs.shape), hs.dtype, str(hs.device))


def warmup_prune_kernels(n_atoms, dtype=torch.float32, n_pool=4,
                         n_real=None, *, device='cuda'):
    '''Counterpart of the JAX package's warmup_prune_kernels. With
    n_real > 1: the whole schedule for an (n_pool, n_atoms, 3) pool of
    `dtype` on `device` that follows min(n_real, n_pool) rows is run once
    on zeros with every row dead through schedule_call (on a CUDA device
    that captures its graph, at the default threshold 0.5; a prune at
    another threshold captures its own at its first call), and the
    pool's key is recorded, so prune_conformers_rmsd_device then prunes
    such a pool in one call. Without it: K3's library is built on a CUDA
    device (the JAX package compiles its per-pass executables there).
    No route of the port warms a pool (run_pipeline captures the
    schedule in its own program): this is the JAX API's counterpart.'''
    dev = get_device(device)
    if n_real is None or n_real <= 1:
        if dev.type == 'cuda':
            qcp.KERNEL.build()
        return
    hs = torch.zeros((n_pool, n_atoms, 3), dtype=dtype, device=dev)
    n_eff = int(min(n_real, n_pool))
    schedule_call(hs, torch.zeros(n_pool, dtype=torch.bool, device=dev),
                  0.5, n_eff)
    _SCHEDULE_WARMED.add(_schedule_key(hs, n_eff))


@traced
def prune_conformers_rmsd_device(heavy_structures, rmsd_thr=0.5,
                                 init_mask=None, n_real=None,
                                 pair_kill=qcp_kill, mesh=None):
    '''Bucketed RMSD prune of a device-resident pool. heavy_structures
    (n_pool, N, 3) tensor (or array, taken to a CPU tensor); the
    schedule follows the first n_real rows (default all), rows past it
    start dead, and init_mask (n_pool,) marks rows dead from the start.
    A pool whose schedule warmup_prune_kernels captured is pruned in one
    call (schedule_call) when pair_kill is K3's and no mesh is given;
    any other by the host loop (host_schedule). pair_kill is the
    per-pass engine (the CUDA kernel's wrapper, or its plain twin to
    compare with). mesh: a parallel.sharding Mesh: the pool is copied to
    each of its devices once, and each pass's positions are split over
    them (the same survivors; parallel.prune.sharded_pass_kill). Returns
    the (n_pool,) bool keep mask as a numpy array.'''
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
    if mesh is None and pair_kill is qcp_kill and \
            _schedule_key(hs, n) in _SCHEDULE_WARMED:
        alive, _, _ = schedule_call(hs, mask, rmsd_thr, n)
        return alive.cpu().numpy()
    return host_schedule(hs, mask, n, rmsd_thr, pair_kill, mesh)


def host_schedule(hs, mask, n, rmsd_thr, pair_kill=qcp_kill, mesh=None):
    '''The host loop of prune_conformers_rmsd_device: each pass's gate
    evaluated on the host from the active count, one pair_kill call per
    pass that runs. hs contiguous, mask (n_pool,) bool on hs's device,
    updated in place; returns it as a numpy array.'''
    pools = None
    if mesh is not None:
        from tscode_tpu_torch.parallel.prune import sharded_pass_kill
        from tscode_tpu_torch.parallel.sharding import replicated
        pools = replicated(hs, mesh)
    active = int(mask.sum())
    for k in K_SCHEDULE:
        if not (k == 1 or 20 * k < active):
            continue
        with span(f'rmsd_pass k={int(k)}'):
            act, end = pass_chunks(mask, n, int(k))
            if pools is None:
                kill = pair_kill(hs, act, end, rmsd_thr)
            else:
                kill = sharded_pass_kill(pools, act, end, rmsd_thr, mesh,
                                         pair_kill)
            mask[act] = ~kill     # every act row is active at pass start
            active = int(mask.sum())
    return mask.cpu().numpy()


def prune_conformers_rmsd(structures, atomnos, rmsd_thr=0.5, *, device,
                          dtype=None, mesh=None):
    '''Remove similar structures; returns (pruned, keep_mask) with the
    bucketed keep/kill semantics above, over heavy atoms only.
    structures (n, N_atoms, 3) tensor or array, moved to `device` (and
    cast to `dtype` when given), so a host ensemble with device='cuda'
    is pruned by the pair kernel; pruned is a tensor there, keep_mask
    numpy bool. mesh: a Mesh splits every pass over its devices
    (prune_conformers_rmsd_device), the same survivors.'''
    device = get_device(device)
    if not torch.is_tensor(structures):
        structures = np.asarray(structures)
    structures = torch.as_tensor(structures, device=device, dtype=dtype)
    n = structures.shape[0]
    if n <= 1:
        return structures, np.ones(n, dtype=bool)
    heavy = torch.as_tensor(np.flatnonzero(np.asarray(atomnos) != 1),
                            device=device)
    mask = prune_conformers_rmsd_device(
        structures[:, heavy].contiguous(), rmsd_thr=rmsd_thr, mesh=mesh)
    return structures[torch.as_tensor(mask, device=device)], mask
