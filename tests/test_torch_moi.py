'''Moment-of-inertia prune parity on the CPU, float64:
tscode_tpu_torch.ops.moi against tscode_tpu.ops.moi, identical masks.'''

import numpy as np
import pytest
import torch

from tscode_tpu.ops import moi as jm
from tscode_tpu_torch.ops import moi as tm
from torch_parity import near_dup_pool

ATOMNOS = np.array([6, 6, 8, 1, 1, 7, 6, 1, 9])


def rotation(axis, deg):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    t = np.radians(deg)
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


def test_rotamer_and_enantiomer_duplicates():
    rng = np.random.default_rng(1)
    base = rng.normal(size=(9, 3)) * 2
    R = rotation([0.3, 1.0, -0.2], 73.0)
    structures = np.array([
        base,
        (R @ base.T).T + 5.0,                   # rotated copy: duplicate
        base + rng.normal(size=(9, 3)),          # distinct
        base * np.array([1, 1, -1.0]),           # mirror image: duplicate
    ])
    _, got = tm.prune_by_moment_of_inertia(structures, ATOMNOS,
                                           device='cpu')
    _, want = jm.prune_by_moment_of_inertia(structures, ATOMNOS)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, False, True, False]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_near_duplicate_pools(seed):
    '''Rotated and shifted copies of a few base structures with noise
    from none to well past the 1e-2 relative moment threshold.'''
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(25, 9, 3)) * 1.5
    pool = []
    for i in rng.integers(0, 25, size=150):
        R = rotation(rng.normal(size=3), rng.uniform(0, 360))
        noise = rng.choice([0.0, 1e-3, 1e-2, 5e-2])
        pool.append(base[i] @ R.T + rng.normal(size=3) * 4
                    + rng.normal(size=(9, 3)) * noise)
    pool = np.array(pool)
    _, got = tm.prune_by_moment_of_inertia(pool, ATOMNOS, device='cpu')
    _, want = jm.prune_by_moment_of_inertia(pool, ATOMNOS)
    np.testing.assert_array_equal(got, want)
    assert 25 <= got.sum() < len(pool)


def test_similarity_matrix_and_trivial_pools():
    rng = np.random.default_rng(3)
    pool = near_dup_pool(rng, 40, 6, 5)
    masses = rng.uniform(1.0, 20.0, size=6)
    np.testing.assert_array_equal(
        tm.moi_similarity_matrix(pool, masses, device='cpu'),
        jm.moi_similarity_matrix(pool, masses))
    one = pool[:1]
    assert tm.prune_by_moment_of_inertia(
        one, ATOMNOS[:6], device='cpu')[1].tolist() == [True]


def test_device_is_required_and_never_falls_back(monkeypatch):
    pool = near_dup_pool(np.random.default_rng(4), 10, 9, 3)
    with pytest.raises(TypeError):
        tm.prune_by_moment_of_inertia(pool, ATOMNOS)
    with pytest.raises(TypeError):
        tm.moi_similarity_matrix(pool, np.ones(9))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        tm.prune_by_moment_of_inertia(pool, ATOMNOS, device='cuda')
    with pytest.raises(RuntimeError, match='cuda'):
        tm.moi_similarity_matrix(pool, np.ones(9), device='cuda')
