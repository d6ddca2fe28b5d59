'''TFD screening parity on the CPU: tscode_tpu_torch.ops.tfd against
tscode_tpu.ops.tfd on the same numpy inputs. Fingerprints equal after
the float32 cast; prune and novelty masks identical (the port's device
novelty filter runs as plain PyTorch on CPU tensors here).'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscode_tpu import native
from tscode_tpu.ops import tfd as jt
from tscode_tpu_torch.ops import tfd as tt
from torch_parity import t64, to_np

CHAIN_QUADS = np.array([[i, i + 1, i + 2, i + 3] for i in range(7)])


def clustered_fps(rng, n, q=6, n_clusters=7, spread=0.5):
    '''Fingerprints with heavy near-duplication (the string-embed
    survivor regime): far-apart cluster centers, members within the
    threshold of their center, angles wrapped to [-180, 180).'''
    centers = rng.uniform(-180, 180, size=(n_clusters, q))
    who = rng.integers(0, n_clusters, n)
    fps = centers[who] + rng.normal(size=(n, q)) * spread
    return ((fps + 180) % 360 - 180).astype(np.float32)


def chain_fps():
    '''i0 accepted; i1 similar to i0 -> rejected; i2 similar ONLY to the
    rejected i1 -> accepted (the leader-rule trap), with a far row in
    between.'''
    f0 = np.zeros(4, np.float32)
    f1 = f0 + 2.0
    f2 = f1 + 2.0
    far = np.full(4, 90.0, np.float32)
    return np.stack([f0, f1, far, f2])


def test_fingerprints_equal_after_float32_cast():
    rng = np.random.default_rng(5)
    coords = rng.normal(size=(60, 10, 3)) * 1.5
    got = tt.torsion_fingerprints(t64(coords), CHAIN_QUADS)
    want = jt.torsion_fingerprints(jnp.asarray(coords), CHAIN_QUADS)
    assert got.dtype == torch.float32 and got.shape == (60, 7)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize('case', ['near_dup_structures', 'clustered_700',
                                  'clustered_2500', 'chain'])
def test_prune_conformers_tfd_masks_identical(case):
    rng = np.random.default_rng(7)
    if case == 'near_dup_structures':
        base = rng.normal(size=(12, 10, 3)) * 1.5
        structures = base[rng.integers(0, 12, 300)] + \
            rng.normal(size=(300, 10, 3)) * rng.choice(
                [0.005, 0.02, 0.1], size=300)[:, None, None]
        _, got = tt.prune_conformers_tfd(structures, CHAIN_QUADS,
                                         device='cpu')
        _, want = jt.prune_conformers_tfd(structures, CHAIN_QUADS)
    else:
        fps = (chain_fps() if case == 'chain' else
               clustered_fps(rng, int(case.split('_')[1]), n_clusters=40))
        dummy = np.zeros((len(fps), 1, 3))
        quads = np.zeros((fps.shape[1], 4), dtype=int)
        _, got = tt.prune_conformers_tfd(dummy, quads, tf_mat=fps,
                                        device='cpu')
        _, want = jt.prune_conformers_tfd(dummy, quads, tf_mat=fps)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_prune_conformers_tfd_trivial_inputs():
    s = np.zeros((0, 10, 3))
    assert tt.prune_conformers_tfd(s, CHAIN_QUADS,
                                   device='cpu')[1].shape == (0,)
    s = np.zeros((4, 10, 3))
    assert tt.prune_conformers_tfd(s, np.zeros((0, 4), int),
                                   device='cpu')[1].all()


@pytest.mark.parametrize('block', [8, 64, 4096])
@pytest.mark.parametrize('seed,n,accept_p', [(0, 700, 1.0), (1, 2500, 0.8),
                                             (2, 97, 0.5)])
def test_novelty_device_matches_jax_host_replay(block, seed, n, accept_p):
    rng = np.random.default_rng(seed)
    fps = clustered_fps(rng, n)
    accept = rng.random(n) < accept_p
    want = jt.is_new_structure_lru(fps, accept)
    stats = {}
    got, ok = tt.tfd_novelty_device(torch.as_tensor(fps), accept, block=block,
                                    stats=stats)
    assert ok
    np.testing.assert_array_equal(got, want)
    assert stats['blocks'] == -(-n // block)


def test_novelty_device_chain_wrap_and_overflow():
    fps = chain_fps()
    want = jt.is_new_structure_lru(fps, np.ones(4, bool))
    assert want.tolist() == [True, False, True, True]
    got, ok = tt.tfd_novelty_device(torch.as_tensor(fps), block=8)
    assert ok and got.tolist() == want.tolist()

    # +179 vs -179 is 2 degrees apart, not 358
    fps = torch.tensor([[179.0] * 3, [-179.0] * 3])
    got, ok = tt.tfd_novelty_device(fps, block=8)
    assert ok and got.tolist() == [True, False]

    # more accepted rows than the cache holds -> ok False, as in JAX
    fps = clustered_fps(np.random.default_rng(3), 64, n_clusters=64,
                        spread=0.0)
    for block in (8, 16):
        got, ok = tt.tfd_novelty_device(torch.as_tensor(fps), block=block,
                                        cache_cap=4)
        assert not ok and not got.any()
        _, ok_j = jt.tfd_novelty_device(fps, block=block, cache_cap=4)
        assert not ok_j

    # no rows or no torsions: the host path
    assert tt.tfd_novelty_device(torch.zeros((0, 3)))[1] is False
    assert tt.tfd_novelty_device(torch.zeros((5, 0)))[1] is False


def test_novelty_block_rule():
    for block in (1, 2, 5, 8, 9, 64, 3000, 4096):
        assert tt.novelty_block(block) == max(8, 1 << (block - 1).bit_length())


@pytest.mark.parametrize('native_loop', [True, False])
def test_is_new_structure_lru_masks_identical(monkeypatch, native_loop):
    if not native_loop:
        monkeypatch.setattr(native, 'tfd_available', lambda: False)
    rng = np.random.default_rng(11)
    fps = clustered_fps(rng, 600)
    accept = rng.random(600) < 0.9
    got = tt.is_new_structure_lru(fps, accept)
    np.testing.assert_array_equal(got, jt.is_new_structure_lru(fps, accept))
    assert 0 < got.sum() < accept.sum()


def test_prune_conformers_tfd_device_is_required(monkeypatch):
    s = np.random.default_rng(2).normal(size=(6, 10, 3))
    with pytest.raises(TypeError):
        tt.prune_conformers_tfd(s, CHAIN_QUADS)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        tt.prune_conformers_tfd(s, CHAIN_QUADS, device='cuda')
