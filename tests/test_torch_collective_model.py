'''prune_collective_model of the port's sharded prune: shape arithmetic,
no device touched. The properties of tests/test_collective_model.py on
the port's own design (the pool copied once, each pass's slices out and
kill bits back, a cut read and a count read per pass).'''

import pytest

from tscode_tpu_torch.ops.rmsd_prune import K_SCHEDULE
from tscode_tpu_torch.parallel.prune import (TIER2_SURVIVORS,
                                             prune_collective_model)

pytestmark = pytest.mark.mesh

CFG = dict(n=884401, n_pool=1048576, n_atoms=5, entry_actives=884401)


def gated(survivors):
    '''The passes whose gate holds on the forward-walked trajectory.'''
    active, ks = CFG['entry_actives'], []
    for k in K_SCHEDULE:
        active = survivors.get(int(k), active)
        if k == 1 or 20 * k < active:
            ks.append(int(k))
    return ks


def test_walls_fall_as_devices_rise_when_pairs_dominate():
    '''A pool of distinct structures (no pass prunes): the pair work
    splits over the devices and outweighs the pool's copies.'''
    walls, speedups = [], []
    for nd in (1, 2, 4, 8):
        _, tot = prune_collective_model(n_devices=nd, **CFG)
        walls.append(tot['wall_s'])
        speedups.append(tot['projected_speedup'])
    assert walls[0] > walls[1] > walls[2] > walls[3]
    assert speedups[0] == 1.0 and speedups[3] > speedups[1] > 1.0
    assert speedups[3] < 8.0       # the copies cost something


def test_tier2_trajectory_is_bound_by_the_pool_copy():
    '''The tier-2 pool loses 96% of its rows in its first pass, so at
    K3's rate its pair work is smaller than one copy of the pool over
    the link: more devices only add copies.'''
    rows, tot = prune_collective_model(n_devices=8,
                                       survivors=TIER2_SURVIVORS, **CFG)
    assert rows[0]['mode'] == 'replicate pool'
    assert rows[0]['wall_s'] > sum(r['wall_s'] for r in rows[1:])
    assert tot['projected_speedup'] < 1.0


def test_one_device_moves_no_bytes():
    _, tot = prune_collective_model(n_devices=1,
                                    survivors=TIER2_SURVIVORS, **CFG)
    assert tot['replicate_bytes'] == 0 and tot['slice_bytes'] == 0
    assert tot['pair_work_per_chip'] > 0


@pytest.mark.parametrize('nd', [1, 8])
def test_syncs_are_counted_per_pass(nd):
    '''One count at entry; per pass the count, and on a mesh the read
    of the split's cut positions.'''
    rows, tot = prune_collective_model(n_devices=nd,
                                       survivors=TIER2_SURVIVORS, **CFG)
    passes = [r['k'] for r in rows if r['mode'] == 'pass']
    assert passes == gated(TIER2_SURVIVORS)
    assert tot['sync_calls'] == 1 + len(passes) * (2 if nd > 1 else 1)


def test_sparse_trajectory_stays_consistent():
    '''{first, last} checkpoints: the entry count is carried through
    every pass between them, so each of those passes is modelled at it,
    and the last at its own.'''
    sparse = {20000: 884401, 1: 29}
    rows, _ = prune_collective_model(n_devices=8, survivors=sparse, **CFG)
    passes = [r for r in rows if r['mode'] == 'pass']
    assert [r['k'] for r in passes] == gated(sparse)
    assert all(r['actives'] == 884401 for r in passes[:-1])
    assert passes[-1]['k'] == 1 and passes[-1]['actives'] == 29
    assert passes[0]['pair_work_per_chip'] > passes[-1]['pair_work_per_chip']
