'''Bucketed RMSD prune parity, float64: the port's keep masks against
tscode_tpu's host-loop prune_conformers_rmsd and device-resident
prune_conformers_rmsd_device, identical.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscode_tpu.ops import rmsd_prune as jprune
from tscode_tpu_torch.ops import rmsd_prune as tprune
from torch_parity import near_dup_pool


# (3000, 8) is held against the host loop only: the JAX device variant
# compiles its banded tiers for N > 4, which costs ~20 s on the CPU
@pytest.mark.parametrize('n,N,n_base,device_too', [
    (300, 4, 250, True), (300, 8, 250, True),
    (3000, 4, 700, True), (3000, 8, 700, False)])
def test_keep_mask_matches_jax(n, N, n_base, device_too):
    pool = near_dup_pool(np.random.default_rng(n + N), n, N, n_base)
    atomnos = np.array([6] * N + [1, 1])        # hydrogens are dropped
    structures = np.concatenate(
        [pool, np.random.default_rng(0).normal(size=(n, 2, 3))], axis=1)

    _, want = jprune.prune_conformers_rmsd(structures, atomnos)
    pruned, got = tprune.prune_conformers_rmsd(torch.as_tensor(structures),
                                               atomnos, device='cpu')
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pruned.numpy(), structures[want])
    if device_too:
        np.testing.assert_array_equal(
            tprune.prune_conformers_rmsd_device(torch.as_tensor(pool)),
            jprune.prune_conformers_rmsd_device(jnp.asarray(pool)))
    assert 0 < got.sum() < n
    if n > 1000:   # the k = 1 pass runs one chunk longer than 256 rows
        assert got.sum() > 256


def test_padded_pool_with_init_mask():
    '''A pow2-padded pool: the schedule follows the first n_real rows,
    rows past them start dead, and init_mask kills rows up front.'''
    n_real, n_pool = 300, 512
    pool = near_dup_pool(np.random.default_rng(5), n_pool, 4, 90)
    init = np.random.default_rng(6).uniform(size=n_pool) > 0.2
    want = jprune.prune_conformers_rmsd_device(
        jnp.asarray(pool), init_mask=init, n_real=n_real)
    got = tprune.prune_conformers_rmsd_device(
        torch.as_tensor(pool), init_mask=init, n_real=n_real)
    np.testing.assert_array_equal(got, want)
    assert not got[n_real:].any() and not got[~init].any()
    assert 0 < got.sum() < init[:n_real].sum()


@pytest.mark.parametrize('n,k', [(1000, 50), (1003, 10), (97, 5), (40, 1)])
def test_pass_chunks_match_the_reference_split(n, k):
    '''act/end reproduce the host loop's chunks: chunksize n // k, the
    last chunk takes the remainder, split over the active rows.'''
    mask = np.random.default_rng(n).uniform(size=n + 7) > 0.4
    mask[n:] = False
    act, end = tprune.pass_chunks(torch.as_tensor(mask), n, k)
    act, end = act.numpy(), end.numpy()
    chunksize = n // k
    want_end = []
    for c in range(k):
        first = c * chunksize
        last = n if c == k - 1 else chunksize * (c + 1)
        idx = np.nonzero(mask[first:last])[0]
        want_end += [len(want_end) + len(idx)] * len(idx)
    np.testing.assert_array_equal(act, np.flatnonzero(mask))
    np.testing.assert_array_equal(end, want_end)


def test_schedule_constants_match():
    assert tprune.K_SCHEDULE == jprune.K_SCHEDULE


def test_tiny_pools():
    for n in (0, 1):
        pool = np.zeros((n, 3, 3))
        got = tprune.prune_conformers_rmsd_device(torch.as_tensor(pool))
        assert got.shape == (n,) and got.all()
    two = np.zeros((2, 3, 3))
    np.testing.assert_array_equal(
        tprune.prune_conformers_rmsd_device(torch.as_tensor(two)),
        [False, True])


def test_scatter_update_keeps_the_masks():
    '''The pass update mask[act] = ~kill (no boolean index) gives the
    masks of the boolean-index update mask[act[kill]] = False, pass by
    pass, with dead rows and a cut pool.'''
    from tscode_tpu_torch.ops.kernels.qcp import qcp_kill_plain
    pool = torch.as_tensor(near_dup_pool(np.random.default_rng(4), 900, 4,
                                         60))
    init = np.ones(900, dtype=bool)
    init[::7] = False
    passes = []

    def recorded(hs, act, end, thr):
        kill = qcp_kill_plain(hs, act, end, thr)
        passes.append((act.clone(), kill))
        return kill

    got = tprune.prune_conformers_rmsd_device(pool, init_mask=init,
                                              n_real=850, pair_kill=recorded)
    mask = torch.as_tensor(init)
    mask[850:] = False
    for act, kill in passes:
        mask[act[kill]] = False
    np.testing.assert_array_equal(got, mask.numpy())
    assert len(passes) > 2 and 0 < got.sum() < 850


def test_prune_conformers_rmsd_takes_its_device(monkeypatch):
    """The device is required; a numpy ensemble is moved to it (pruned
    comes back there), and 'cuda' without a card raises."""
    pool = near_dup_pool(np.random.default_rng(9), 60, 5, 20)
    atomnos = np.array([6] * 5)
    with pytest.raises(TypeError):
        tprune.prune_conformers_rmsd(pool, atomnos)
    pruned, keep = tprune.prune_conformers_rmsd(pool, atomnos, device='cpu',
                                                dtype=torch.float32)
    assert pruned.dtype == torch.float32 and pruned.device.type == 'cpu'
    assert pruned.shape[0] == keep.sum() and 0 < keep.sum() < 60
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        tprune.prune_conformers_rmsd(pool, atomnos, device='cuda')
