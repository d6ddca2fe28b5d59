'''Clash screen parity: the port's plain clash (what a CPU tensor runs)
against the Pallas kernels in interpret mode (float32) and the JAX
matmul form (float64), exact masks.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tscode_tpu.ops import clash as jclash
from tscode_tpu.ops.pallas.clash import (clash_ok_traced,
                                         compenetration_mask_pallas)
from tscode_tpu_torch.ops import clash as tclash
from tscode_tpu_torch.ops.kernels.clash import (CLASH_WARP_MIN_PAIRS,
                                                clash_ok, clash_regime,
                                                compenetration_mask_kernel)
from torch_parity import to_np


@pytest.mark.parametrize('B,ids,scale,max_clashes', [
    (64, (7, 9), 2.0, 0),
    (32, (5, 5), 1.5, 0),
    (32, (5, 5), 1.5, 3),
])
def test_plain_clash_matches_pallas_k2(B, ids, scale, max_clashes):
    rng = np.random.default_rng(B + max_clashes)
    poses = (rng.normal(size=(B, sum(ids), 3)) * scale).astype(np.float32)
    pm = jclash.cross_fragment_pair_mask(ids)
    want = np.asarray(compenetration_mask_pallas(
        jnp.asarray(poses), pm, max_clashes=max_clashes, interpret=True))
    got = compenetration_mask_kernel(torch.as_tensor(poses), pm, 1.5,
                                     max_clashes)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(to_np(got), want)
    assert 0 < want.sum() < B          # both outcomes occur


def test_plain_clash_matches_pallas_k1_traced():
    rng = np.random.default_rng(137)
    poses = (rng.normal(size=(137, 11, 3)) * 2.2).astype(np.float32)
    pm = jclash.cross_fragment_pair_mask((5, 6))
    want = np.asarray(clash_ok_traced(jnp.asarray(poses),
                                      jclash.static_pairs(pm),
                                      jnp.asarray(1.5)))
    got = clash_ok(torch.as_tensor(poses), tclash.static_pairs(pm), 1.5)
    np.testing.assert_array_equal(to_np(got), want)
    assert 0 < want.sum() < 137


@pytest.mark.parametrize('max_clashes', [0, 2])
def test_compenetration_mask_float64(max_clashes):
    rng = np.random.default_rng(64 + max_clashes)
    ids = (6, 5)
    poses = rng.normal(size=(500, 11, 3)) * 2.0
    pm = jclash.cross_fragment_pair_mask(ids)
    np.testing.assert_array_equal(tclash.cross_fragment_pair_mask(ids), pm)
    want = np.asarray(jclash.compenetration_mask(
        jnp.asarray(poses), jnp.asarray(pm), thresh=1.5,
        max_clashes=max_clashes))
    got = tclash.compenetration_mask(torch.as_tensor(poses), pm, 1.5,
                                     max_clashes)
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(
        to_np(tclash.count_cross_clashes(torch.as_tensor(poses), pm)),
        np.asarray(jclash.count_cross_clashes(jnp.asarray(poses),
                                              jnp.asarray(pm))))
    np.testing.assert_allclose(
        to_np(tclash.pairwise_dist2(torch.as_tensor(poses),
                                    torch.as_tensor(poses))),
        np.asarray(jclash.pairwise_dist2(jnp.asarray(poses),
                                         jnp.asarray(poses))),
        rtol=0, atol=1e-9)


def test_pair_list_matches_jax_static_pairs():
    pm = jclash.cross_fragment_pair_mask((3, 4, 2), n_pad=12)
    np.testing.assert_array_equal(tclash.cross_fragment_pair_mask(
        (3, 4, 2), n_pad=12), pm)
    np.testing.assert_array_equal(tclash.fragment_labels((3, 4, 2)),
                                  jclash.fragment_labels((3, 4, 2)))
    pairs = tclash.static_pairs(pm)
    assert pairs.dtype == np.int32 and pairs.shape == (3 * 4 + 3 * 2 + 4 * 2,
                                                       2)
    assert [tuple(p) for p in pairs.tolist()] == list(jclash.static_pairs(pm))


@pytest.mark.parametrize('n_pairs,n_atoms,itemsize,regime', [
    (30, 11, 4, 'thread'),              # the headline and sn2_string
    (CLASH_WARP_MIN_PAIRS - 1, 16, 8, 'thread'),
    (CLASH_WARP_MIN_PAIRS, 16, 4, 'warp'),
    (CLASH_WARP_MIN_PAIRS - 1, 16, 4, 'thread'),
    (CLASH_WARP_MIN_PAIRS, 16, 8, 'warp'),
    (5476, 148, 4, 'warp'),             # large_n_string
    (25600, 320, 8, 'warp'),            # two 160-atom fragments
    (62500, 500, 8, 'warp'),            # past the resident pair list
    (10 ** 6, 10 ** 4, 8, 'thread'),    # two pose slots do not fit
])
def test_clash_regime_choice(n_pairs, n_atoms, itemsize, regime):
    '''The kernel a CUDA batch would launch, chosen on the host by the
    pair count and whether two pose slots fit in shared memory.'''
    assert clash_regime(n_pairs, n_atoms, itemsize) == regime


def test_pair_lists_are_unique_and_plain_rejects_repeats():
    '''static_pairs lists each pair once, in row-major order; a pair
    listed twice would count twice in the kernels and once in the plain
    twin's mask, so the plain twin raises on it.'''
    rng = np.random.default_rng(5)
    pm = rng.random((12, 12)) < 0.4
    pairs = tclash.static_pairs(pm)
    assert len({tuple(p) for p in pairs.tolist()}) == len(pairs) == pm.sum()
    assert pairs.tolist() == sorted(pairs.tolist())
    poses = torch.as_tensor(rng.normal(size=(16, 12, 3)) * 2.0)
    with pytest.raises(ValueError, match='more than once'):
        clash_ok(poses, np.concatenate([pairs, pairs[2:3]]), 1.5)
    want = tclash.compenetration_mask(poses, pm, 1.5, 1)
    np.testing.assert_array_equal(to_np(clash_ok(poses, pairs, 1.5, 1)),
                                  to_np(want))


def test_k2_pair_list_is_built_once_per_mask():
    '''K2's entry keeps the device pair list of a mask: the same mask
    (as array or tensor) gives the same tensor again, another mask its
    own list, each equal to static_pairs of its mask.'''
    from tscode_tpu_torch.ops.kernels.clash import pairs_of_mask
    pm = tclash.cross_fragment_pair_mask((5, 6))
    first = pairs_of_mask(pm, torch.device('cpu'))
    assert pairs_of_mask(pm.copy(), torch.device('cpu')) is first
    assert pairs_of_mask(torch.as_tensor(pm), torch.device('cpu')) is first
    assert first.dtype == torch.int32
    np.testing.assert_array_equal(to_np(first), tclash.static_pairs(pm))
    other = tclash.cross_fragment_pair_mask((6, 5))
    second = pairs_of_mask(other, torch.device('cpu'))
    assert second is not first
    np.testing.assert_array_equal(to_np(second), tclash.static_pairs(other))
    assert pairs_of_mask(pm, torch.device('cpu')) is first
