'''The string embed on the CPU, float64: tscode_tpu_torch.embeds.string
against tscode_tpu.embeds.string on bench_suite's sn2_string molecules
at 4 conformers (2,304 candidates -> 1,007 clash-ok -> 73 novel).'''

import numpy as np
import pytest
import torch

import bench_suite
from tscode_tpu.embeds.string import string_embed as jax_string_embed
from tscode_tpu.errors import ZeroCandidatesError
from tscode_tpu.molecule import Molecule
from tscode_tpu_torch.embeds import string as ts
from tscode_tpu_torch.embeds.common import (DeviceSurvivors, flat_grid,
                                            inputs_from_numpy)

ANGLES = [n * 360 / 36 for n in range(36)]     # the Embedder's spin grid
COUNTS = (2304, 1007, 73)


def quiet(*_args, **_kwargs):
    pass


@pytest.fixture(scope='module')
def sn2_mols(tmp_path_factory):
    d = tmp_path_factory.mktemp('sn2_string')
    n_confs = bench_suite.N_CONFS
    bench_suite.N_CONFS = 4
    try:
        bench_suite._config_files('sn2_string', str(d))
    finally:
        bench_suite.N_CONFS = n_confs
    mols = []
    for name in ('m1.xyz', 'm2.xyz'):
        mol = Molecule(str(d / name), reactive_indices=[0])
        mol.compute_orbitals()
        mols.append(mol)
    return mols


@pytest.fixture(scope='module')
def jax_result(sn2_mols):
    return jax_string_embed(*sn2_mols, ANGLES, log=quiet)


@pytest.mark.parametrize('lane,tile_rows', [('host', ts.TILE_ROWS),
                                            ('device', 600)])
def test_string_embed_matches_jax(monkeypatch, sn2_mols, jax_result, lane,
                                  tile_rows):
    '''Same novel rows, poses within 1e-6 A, on the host replay lane and
    on the device novelty lane with one c2 value per tile.'''
    monkeypatch.setattr(ts, 'TILE_ROWS', tile_rows)
    want, want_cons = jax_result
    info = {}
    got, cons = ts.string_embed(*sn2_mols, ANGLES, log=quiet, device='cpu',
                                device_novelty=lane == 'device', info=info)
    assert got.dtype == np.float64 and got.shape == (COUNTS[2], 11, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(cons, want_cons)
    assert (info['candidates'], info['clash_ok'], info['novel']) == COUNTS
    assert info['tfd_lane'] == lane


def test_zero_candidates_raise(sn2_mols):
    with pytest.raises(ZeroCandidatesError):
        ts.string_embed(*sn2_mols, ANGLES, clash_thresh=100.0, log=quiet,
                        device='cpu')
    with pytest.raises(ZeroCandidatesError):
        jax_string_embed(*sn2_mols, ANGLES, clash_thresh=100.0, log=quiet)


def test_tiles_follow_the_flat_grid_order(sn2_mols):
    '''The broadcast tiles, concatenated, are the grid in flat_grid's
    (c2, c1, l2, l1, angle) order.'''
    m1, m2 = sn2_mols
    inp = inputs_from_numpy(m1, m2, 'cpu', torch.float64)
    angles = ts.spin_angles(ANGLES, torch.float64, 'cpu')
    tiles = list(ts.bcast_tiles(inp, angles, 1.5, c2_per_tile=3))
    assert len(tiles) == 2
    poses = torch.cat([p for p, _ in tiles])
    k1, k2 = inp.centers1.shape[1], inp.centers2.shape[1]
    c2, c1, l2, l1, ai = flat_grid(m2.n_confs, m1.n_confs, k2, k1, 36)
    assert poses.shape == (len(c2), 11, 3)
    np.testing.assert_array_equal(poses[:, :6].numpy(),
                                  m1.atomcoords[c1])
    i = 1000
    one, _ = ts.bcast_block(inp, angles[ai[i]:ai[i] + 1], c2[i], c2[i] + 1,
                            1.5)
    row = ((c1[i] * k2 + l2[i]) * k1 + l1[i])
    torch.testing.assert_close(one[row], poses[i], rtol=0, atol=1e-12)


def test_device_survivors_keep_generation_order():
    acc = DeviceSurvivors()
    a = torch.arange(10.0)
    acc.add((a, a * 2), a % 3 == 0)
    acc.add((a + 10, a), a > 7)
    (f0, f1), mask = acc.finish()
    assert f0.tolist() == [0, 3, 6, 9, 18, 19]
    assert f1.tolist() == [0, 6, 12, 18, 8, 9]
    assert mask.tolist() == ([i % 3 == 0 for i in range(10)]
                             + [i > 7 for i in range(10)])
    assert DeviceSurvivors().finish()[1].shape == (0,)
