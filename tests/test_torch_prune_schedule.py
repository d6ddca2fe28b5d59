'''The one-program prune and slice, float64 on the CPU: the port's
device_schedule against the JAX package's _device_schedule and against
the port's host loop; the size-bounded compaction against
clash_survivors; warmup_prune_kernels and the one-call path; and
run_pipeline against the host-driven slice, whole grid and c2 tiles.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscode_tpu.ops import rmsd_prune as jprune
from tscode_tpu_torch import pipeline as tp
from tscode_tpu_torch.ops import rmsd_prune as tprune
from tscode_tpu_torch.ops.kernels import qcp
from torch_parity import to_np


def clustered_pool(n, n_pool, seed, N=4):
    '''(n_pool, N, 3): n rows as tests/test_screen.py's _clustered_ensemble
    builds them (60% noisy copies of n // 6 cluster centres, the rest
    random), the rest zeros. N <= 4 keeps the JAX program's compile
    short: its banded tiers compile ~20 s per size for N > 4.'''
    g = np.random.default_rng(seed)
    clusters = g.normal(size=(max(2, n // 6), N, 3)) * 2
    pool = np.zeros((n_pool, N, 3))
    for i in range(n):
        if g.random() < 0.6:
            pool[i] = clusters[g.integers(len(clusters))] + \
                g.normal(size=(N, 3)) * 0.05
        else:
            pool[i] = g.normal(size=(N, 3)) * 2
    return pool


# (n, n_pool, seed, init): whole pools, a padded pool (n < n_pool) and
# init masks; equal shapes share one JAX compile
POOLS = {'600': (600, 600, 600, False), '700': (700, 700, 700, False),
         'padded': (650, 1024, 650, False), 'init': (700, 700, 701, True),
         'padded_init': (650, 1024, 651, True)}


@pytest.mark.parametrize('case', list(POOLS))
def test_device_schedule_matches_jax_and_host_loop(case):
    n, n_pool, seed, with_init = POOLS[case]
    pool = clustered_pool(n, n_pool, seed)
    init = np.random.default_rng(seed + 1).uniform(size=n_pool) > 0.15 \
        if with_init else np.ones(n_pool, dtype=bool)
    alive0 = init.copy()
    alive0[n:] = False

    a_j, n_j, fin_j = jprune._device_schedule(
        jnp.asarray(pool), jnp.asarray(alive0), jnp.asarray(0.5, jnp.float64),
        n=n, s_pad=jprune._FINISH_MAX)
    alive, n_active, finished = tprune.device_schedule(
        torch.as_tensor(pool), torch.as_tensor(init), 0.5, n)
    assert bool(fin_j) and bool(finished)
    np.testing.assert_array_equal(to_np(alive), np.asarray(a_j))
    assert int(n_active) == int(n_j) == int(to_np(alive).sum())

    host = tprune.prune_conformers_rmsd_device(
        torch.as_tensor(pool), init_mask=init, n_real=n)
    np.testing.assert_array_equal(to_np(alive), host)
    assert 0 < host.sum() < alive0.sum()
    assert len(tprune.schedule_ks(n)) > 2


@pytest.mark.parametrize('n,k', [(1000, 50), (1003, 10), (97, 5), (40, 1),
                                 (600, 20), (7, 2)])
def test_pass_chunks_fixed_matches_pass_chunks(n, k):
    '''The fixed-length compaction's first M entries are pass_chunks'
    act and end; M is on the device; the padding is zeros.'''
    mask = torch.as_tensor(np.random.default_rng(n + k).uniform(size=n + 5)
                           > 0.4)
    mask[n:] = False
    want_act, want_end = tprune.pass_chunks(mask, n, k)
    act, end, m = tprune.pass_chunks_fixed(mask, n, k)
    M = want_act.numel()
    assert act.dtype == end.dtype == m.dtype == torch.int32
    assert act.shape == end.shape == (n,) and m.tolist() == [M]
    assert torch.equal(act[:M].long(), want_act)
    assert torch.equal(end[:M].long(), want_end)
    assert not act[M:].any()


@pytest.mark.parametrize('n', [1, 2, 129, 5000, 70000])
def test_device_pass_blocks_cover_every_plan(n):
    '''The device-count launch's grid is the most blocks any pass of
    M <= n rows needs under launch_plan, found by trying every M.'''
    need = max(-(-M // (4 * (32 >> qcp.launch_plan(M)[0])))
               for M in range(1, n + 1))
    assert qcp.device_pass_blocks(n) == need


@pytest.mark.parametrize('k,runs', [(1, True), (20, True), (500, False)])
def test_device_entry_gate(k, runs):
    '''qcp_kill_dev's plain twin: with its gate open (k == 1 or 20 k <
    M) the kill bits are qcp_kill's and the killed rows' alive bits are
    cleared; shut, nothing is written.'''
    pool = torch.as_tensor(clustered_pool(640, 700, 9))
    mask = torch.ones(700, dtype=torch.bool)
    mask[::9] = False
    mask[640:] = False
    act, end, m = tprune.pass_chunks_fixed(mask, 640, k)
    M = int(m)
    alive = mask.clone()
    kill = torch.ones(640, dtype=torch.bool)        # a sentinel
    qcp.qcp_kill_dev(pool, act, end, m, k, 0.5, alive, kill)
    if not runs:
        assert torch.equal(alive, mask) and kill.all()
        return
    want = qcp.qcp_kill(pool, act[:M], end[:M], 0.5)
    assert torch.equal(kill[:M], want) and kill[M:].all()
    expect = mask.clone()
    expect[act[:M].long()[want]] = False
    assert torch.equal(alive, expect) and 0 < int(want.sum()) < M


@pytest.mark.parametrize('n,n_pool', [(700, 700), (650, 1024)])
def test_warmup_takes_the_one_call_path(monkeypatch, n, n_pool):
    '''warmup_prune_kernels records the pool's key; the prune of such a
    pool is then the one call, never the host loop (patched to raise),
    and equals the host loop's mask; another pool still takes the loop.'''
    monkeypatch.setattr(tprune, '_SCHEDULE_WARMED', set())
    pool = torch.as_tensor(clustered_pool(n, n_pool, n + 3))
    want = tprune.prune_conformers_rmsd_device(pool, n_real=n)
    tprune.warmup_prune_kernels(4, torch.float64, n_pool=n_pool, n_real=n,
                                device='cpu')
    assert (n, (n_pool, 4, 3), torch.float64, 'cpu') in \
        tprune._SCHEDULE_WARMED

    def host_loop(*args, **kwargs):
        raise AssertionError('the host loop ran')

    monkeypatch.setattr(tprune, 'host_schedule', host_loop)
    np.testing.assert_array_equal(
        tprune.prune_conformers_rmsd_device(pool, n_real=n), want)
    with pytest.raises(AssertionError, match='host loop'):
        tprune.prune_conformers_rmsd_device(pool, n_real=n - 1)


@pytest.mark.parametrize('form,s_pool', [('whole', None), ('tiled', None),
                                         ('short', 1000)])
def test_bounded_compaction_matches_clash_survivors(monkeypatch, form,
                                                    s_pool):
    '''Survivors in grid order in the first rows of the s_pool-row pool,
    the rest dead and zero, the count on the device; a pool shorter than
    the survivors keeps the first s_pool and still counts them all.'''
    inp = tp.inputs_from_numpy(*tp.build_workload(n_confs=6), 'cpu',
                               torch.float64)
    ok_want, hs_want = tp.clash_survivors(inp)
    n_ok = hs_want.shape[0]
    if form == 'tiled':
        monkeypatch.setattr(tp, 'WHOLE_GRID_MAX', 1000)
        monkeypatch.setattr(tp, '_GRID_TILE', 500)
        assert len(list(tp.grid_tiles(inp))) == 6     # one c2 a tile
    s_pool = s_pool or tp.pool_size(n_ok)
    ok, hs, alive, n_dev = tp.clash_survivors_bounded(inp, s_pool)
    assert torch.equal(ok, ok_want) and n_dev.tolist() == [n_ok]
    rows = min(n_ok, s_pool)
    assert hs.shape == (s_pool, 4, 3)
    assert torch.equal(hs[:rows], hs_want[:rows])
    assert torch.equal(alive, torch.arange(s_pool) < n_ok)
    assert not hs[rows:].any()


@pytest.mark.parametrize('form', ['whole', 'tiled'])
def test_run_pipeline_matches_host_driven(monkeypatch, form):
    '''run_pipeline (the warm-up, then the one program) against the
    host-driven slice: clash_survivors, then the prune's host loop.'''
    if form == 'tiled':
        monkeypatch.setattr(tp, 'WHOLE_GRID_MAX', 500)
        monkeypatch.setattr(tp, '_GRID_TILE', 300)
    mols = tp.build_workload(n_confs=4)
    n_poses, secs, n_ok, n_final, info = tp.run_pipeline(
        *mols, device='cpu', return_masks=True)
    inp = tp.inputs_from_numpy(*mols, 'cpu', torch.float64)
    ok, hs = tp.clash_survivors(inp)
    keep = tprune.prune_conformers_rmsd_device(hs)
    assert (n_poses, n_ok, n_final) == (1152, hs.shape[0], keep.sum())
    assert (n_ok, n_final) == (287, 4)
    np.testing.assert_array_equal(info['clash_ok'], to_np(ok))
    np.testing.assert_array_equal(info['keep'], keep)
    assert len(info['run_s']) == tp.TIMED_RUNS and secs == min(info['run_s'])
