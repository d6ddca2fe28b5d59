'''
Multi-device RMSD prune with the exact reference semantics (the port's
counterpart of tscode_tpu/parallel/prune.py, to its own design).

The port prunes with one K3 launch per pass from the host
(ops/rmsd_prune.prune_conformers_rmsd_device), not with the JAX
package's single-program tiers, so the mesh form shards each pass:

 * the pool is copied to every device of the mesh once, at prune entry;
 * a pass's positions (its active rows in order, `pass_chunks`) are cut
   into mesh.size contiguous slices of about equal pair work, the sum of
   each position's walk length end[p] - p - 1. A slice may end inside a
   chunk, which is what spreads a k = 1 pass, whose one chunk is the
   whole pool;
 * slice [lo, hi) launches K3 on its device with act[lo:], end[lo:hi] -
   lo and M = hi - lo: the kernel decides the positions p < M and reads
   act up to end[p];
 * the kill bits are gathered in order on the first device and the mask
   is updated as on one device. A row's kill depends only on the mask at
   pass start, so the survivors are exactly the unsharded ones.

`prune_collective_model` is the analytic copy-and-compute model of this
design, in the JAX function's signature and (rows, totals) shape.
'''

import torch

from tscode_tpu_torch.ops.kernels.qcp import qcp_kill
from tscode_tpu_torch.ops.rmsd_prune import (K_SCHEDULE,
                                             prune_conformers_rmsd_device)
from tscode_tpu_torch.parallel.sharding import gather

# pass-start survivor counts of the JAX package's tier-2 configuration
# (1,663,488 poses -> 884,401 clash survivors -> 29; BASELINE.md): counts
# of the exact semantics, the same on any device. {pass k: actives at
# its start}; passes in between carry the last value.
TIER2_SURVIVORS = {20000: 884401, 10000: 37246, 500: 4347, 100: 1626,
                   1: 29}

# K3's candidate-pair rate on the H100 at N = 4 heavy atoms: the
# headline's first pass (202,362 rows, k = 10,000: 9,999 chunks of 20
# rows and a last one of 2,382, 4,735,581 candidate pairs) took 0.0285
# ms in float32 (PERF.md section 6). The walks end at their first hit,
# so this is a rate of candidate pairs, not of pairs evaluated.
PAIR_RATE_N4 = 4735581 / 0.0285e-3
# bytes a second from one card to the others over NVLink (450 GB/s each
# way, NVIDIA's H100 data sheet)
LINK_BYTES_PER_S = 450e9


def split_pass(act, end, size):
    '''Cut one pass's M positions into `size` contiguous slices of about
    equal pair work. Returns host lists (bounds, ends): slice s is
    [bounds[s], bounds[s + 1]) and reads act up to ends[s], its largest
    chunk end. One host read.'''
    M = act.numel()
    pos = torch.arange(M, device=end.device)
    cum = torch.cumsum(torch.clamp(end - pos - 1, min=0), 0)
    total = cum[-1]
    targets = total * torch.arange(1, size, device=end.device) // size
    cuts = torch.searchsorted(cum, targets, right=True)
    bounds_t = torch.cat([cuts, cuts.new_tensor([M])])
    ends_t = end[torch.clamp(bounds_t - 1, min=0)]
    host = torch.cat([bounds_t, ends_t.to(bounds_t.dtype)]).tolist()
    return [0] + host[:size], host[size:]


def sharded_pass_kill(pools, act, end, rmsd_thr, mesh, pair_kill=qcp_kill):
    '''Kill bits (M,) of one pass on act's device, each slice of
    split_pass decided on its own device by pair_kill (K3's wrapper, or
    its plain twin to compare with) against that device's copy of the
    pool (pools: {device: pool}). Every slice is launched before the
    kill bits are gathered.'''
    M = act.numel()
    if M == 0:
        return torch.zeros(0, dtype=torch.bool, device=act.device)
    bounds, ends = split_pass(act, end, mesh.size)
    kills = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = bounds[s], bounds[s + 1]
        if hi > lo:
            kills.append(pair_kill(pools[dev], act[lo:ends[s]].to(dev),
                                   (end[lo:hi] - lo).to(dev), rmsd_thr,
                                   rows=hi - lo))
    return gather(kills, act.device)


def sharded_prune_rmsd(heavy_structures, mesh, rmsd_thr=0.5, n_real=None):
    '''The bucketed RMSD prune with every pass split over the mesh
    (K3 per slice on CUDA). heavy_structures (n, N, 3) tensor or array,
    taken to the mesh's first device; the schedule follows the first
    n_real rows (default all). Returns the (n,) keep mask (numpy).'''
    hs = torch.as_tensor(heavy_structures).to(mesh.devices[0])
    return prune_conformers_rmsd_device(hs, rmsd_thr=rmsd_thr,
                                        n_real=n_real, mesh=mesh)


def _chunk_pairs(n, k, active):
    '''Candidate pairs of a pass over n rows in k chunks with `active`
    rows spread evenly: chunks of n // k rows, the last the remainder.'''
    density = active / n
    cs = n // k
    tail = n - (k - 1) * cs
    return ((k - 1) * (cs * density) ** 2 + (tail * density) ** 2) / 2


def prune_collective_model(n, n_pool, n_atoms, n_devices, dtype_bytes=4,
                           entry_actives=None, survivors=None,
                           pair_rate=None, ici_bw=LINK_BYTES_PER_S):
    '''Analytic copy + compute wall model of sharded_prune_rmsd: shape
    arithmetic only, no device touched.

    Copies: the pool (n_pool rows of n_atoms x 3 values of dtype_bytes)
    goes from the first device to each other one once; each pass sends
    every other device its positions' act and end (4 bytes each) and
    gets back one kill byte a position. Syncs: one count at entry, then
    per pass the split's cut positions and the survivor count (the count
    only, on one device). Compute: a pass's candidate pairs (chunks of
    n // k rows holding the pass-start actives evenly) split evenly over
    the devices, at pair_rate pairs a second a device (default
    PAIR_RATE_N4, K3's measured H100 rate at N = 4, scaled by 4 /
    n_atoms). A stage's wall is max(compute, bytes / ici_bw), the link
    rate between cards; stage walls add. Fixed launch and sync costs
    are not modelled, so the model is for relative scaling.

    entry_actives: rows entering the prune (default n); survivors: {k:
    actives at pass start} (TIER2_SURVIVORS for the tier-2 pool), the
    last value carried between checkpoints. Returns (rows, totals): one
    dict per step with its mode, bytes, per-device pair work and wall;
    totals sums them and adds `projected_speedup` against one device.'''
    if pair_rate is None:
        pair_rate = PAIR_RATE_N4 * 4 / max(4, n_atoms)
    row_bytes = n_atoms * 3 * dtype_bytes
    rows = []
    totals = dict(replicate_bytes=0, slice_bytes=0, sync_calls=1,
                  pair_work_per_chip=0.0, wall_s=0.0)
    survivors = dict(survivors or {})
    active = int(entry_actives) if entry_actives is not None else int(n)
    active_at = {}
    for k in K_SCHEDULE:
        active = survivors.get(int(k), active)
        active_at[int(k)] = active

    def comm(b):
        return b if n_devices > 1 else 0        # one device moves nothing

    def emit(row, pairs_chip, bytes_moved):
        row['pair_work_per_chip'] = pairs_chip
        row['wall_s'] = max(pairs_chip / pair_rate, bytes_moved / ici_bw)
        totals['pair_work_per_chip'] += pairs_chip
        totals['wall_s'] += row['wall_s']
        rows.append(row)

    rep = comm((n_devices - 1) * n_pool * row_bytes)
    totals['replicate_bytes'] = rep
    emit(dict(k=None, mode='replicate pool', replicate_bytes=rep), 0.0, rep)
    for k in K_SCHEDULE:
        a = active_at[int(k)]
        if not (k == 1 or 20 * k < a):
            continue
        out = comm(round(a * (n_devices - 1) / n_devices) * 9)
        totals['slice_bytes'] += out
        totals['sync_calls'] += 2 if n_devices > 1 else 1
        emit(dict(k=int(k), mode='pass', actives=a, slice_bytes=out),
             _chunk_pairs(n, int(k), a) / n_devices, out)

    if n_devices > 1:
        _, t1 = prune_collective_model(
            n, n_pool, n_atoms, 1, dtype_bytes=dtype_bytes,
            entry_actives=entry_actives, survivors=survivors,
            pair_rate=pair_rate, ici_bw=ici_bw)
        totals['projected_speedup'] = (t1['wall_s'] / totals['wall_s']
                                       if totals['wall_s'] else 1.0)
    else:
        totals['projected_speedup'] = 1.0
    return rows, totals
