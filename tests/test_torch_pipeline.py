'''The slice as a whole, float64 on the CPU: the port's workload, pose
grid, clash mask and keep mask against bench.py's device pipeline.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from tscode_tpu.embeds.common import stacked_lobes as jax_stacked_lobes
from tscode_tpu.ops.clash import cross_fragment_pair_mask
from tscode_tpu_torch import pipeline as tp
from tscode_tpu_torch.embeds.common import stacked_lobes
from torch_parity import to_np

# (n_confs, clash-ok, final): 2,592 and 10,368 poses
COUNTS = {6: (1362, 6), 12: (7060, 7)}


def jax_workload(monkeypatch, n_confs):
    monkeypatch.setattr(bench, 'N_CONFS', n_confs)
    return bench.build_workload()


def jax_args(mols):
    m1, m2 = mols
    c1, v1 = jax_stacked_lobes(m1)
    c2, v2 = jax_stacked_lobes(m2)
    angles = np.linspace(0.0, 360.0 - 360.0 / bench.N_ANGLES, bench.N_ANGLES)
    return (jnp.asarray(m1.atomcoords), jnp.asarray(m2.atomcoords),
            jnp.asarray(c1), jnp.asarray(v1), jnp.asarray(c2),
            jnp.asarray(v2),
            jnp.asarray(cross_fragment_pair_mask((m1.n_atoms, m2.n_atoms))),
            jnp.asarray(angles))


@pytest.mark.parametrize('n_confs', [6, 12])
def test_slice_matches_bench_pipeline(monkeypatch, n_confs):
    mols_j = jax_workload(monkeypatch, n_confs)
    mols = tp.build_workload(n_confs=n_confs)
    for mj, mt in zip(mols_j, mols):
        np.testing.assert_array_equal(mt.atomcoords, mj.atomcoords)
        for a, b in zip(stacked_lobes(mt), jax_stacked_lobes(mj)):
            np.testing.assert_array_equal(a, b)

    args = jax_args(mols_j)
    poses_j, ok_j = bench._embed_clash(args, bench.N_ANGLES, None)
    inp = tp.inputs_from_numpy(*mols, 'cpu', torch.float64)
    poses, ok = tp.embed_clash_all(inp)
    np.testing.assert_allclose(to_np(poses), np.asarray(poses_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(to_np(ok), np.asarray(ok_j))

    n_poses, seconds, n_ok, n_final, info = tp.run_pipeline(
        *mols, device='cpu', return_masks=True)
    assert n_poses == n_confs * n_confs * 2 * 36 and seconds > 0
    np.testing.assert_array_equal(info['clash_ok'], np.asarray(ok_j))

    heavy = np.flatnonzero(np.concatenate(
        [mols_j[0].atomnos, mols_j[1].atomnos]) != 1)
    pool = int(2 ** np.ceil(np.log2(max(n_ok, 2))))
    keep_j, stats = bench._pipeline_fused(
        *args, jnp.asarray(heavy), n_angles=bench.N_ANGLES, n_ok=n_ok,
        s_pool=pool)
    stats = np.asarray(stats)
    assert stats[2] == 1                     # the JAX schedule finished
    np.testing.assert_array_equal(info['keep'], np.asarray(keep_j)[:n_ok])
    assert (n_ok, n_final) == (int(stats[1]), int(stats[0]))
    if n_confs in COUNTS:
        assert (n_ok, n_final) == COUNTS[n_confs]


def test_tiled_grid_matches_whole_grid_and_bench_mapped(monkeypatch):
    '''The c2-tiled grid (tiles of whole c2 values, the last one short)
    reproduces the whole grid and bench._embed_clash_all_mapped, and the
    tile-by-tile survivor compaction equals the whole-grid one.'''
    mols_j = jax_workload(monkeypatch, 6)
    mols = tp.build_workload(n_confs=6)
    inp = tp.inputs_from_numpy(*mols, 'cpu', torch.float64)
    poses, ok = tp.embed_clash_all(inp)
    tiles = list(tp.embed_clash_tiles(inp, c2_per_tile=4))
    assert [len(p) for p, _ in tiles] == [4 * 72 * 6, 2 * 72 * 6]
    assert torch.equal(torch.cat([p for p, _ in tiles]), poses)
    assert torch.equal(torch.cat([ok for _, ok in tiles]), ok)

    poses_j, ok_j = bench._embed_clash_all_mapped(
        *jax_args(mols_j), n_angles=bench.N_ANGLES, n_tiles=2, c2_per_tile=4)
    B = poses.shape[0]
    np.testing.assert_allclose(to_np(poses), np.asarray(poses_j)[:B],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to_np(ok), np.asarray(ok_j)[:B])
    assert not np.asarray(ok_j)[B:].any()

    ok_whole, hs_whole = tp.clash_survivors(inp)
    monkeypatch.setattr(tp, 'WHOLE_GRID_MAX', 1000)
    monkeypatch.setattr(tp, '_GRID_TILE', 500)
    ok_tiles, hs_tiles = tp.clash_survivors(inp)
    assert torch.equal(ok_tiles, ok_whole) and torch.equal(hs_tiles,
                                                           hs_whole)
    assert hs_whole.shape == (int(ok.sum()), 4, 3)
    assert torch.equal(hs_whole, poses[ok][:, inp.heavy_idx])


def test_inputs_from_numpy_carries_the_host_arrays():
    mols = tp.build_workload(n_confs=3)
    inp = tp.inputs_from_numpy(*mols, 'cpu', torch.float32)
    assert inp.coords1.dtype == torch.float32
    np.testing.assert_array_equal(
        to_np(inp.pair_mask),
        cross_fragment_pair_mask((mols[0].n_atoms, mols[1].n_atoms)))
    assert inp.pairs.dtype == torch.int32 and inp.pairs.shape == (30, 2)
    # C2H4 (C, H, H, C, H, H) + CH3Cl (C, H, H, H, Cl)
    np.testing.assert_array_equal(to_np(inp.heavy_idx), [0, 3, 6, 10])
    np.testing.assert_array_equal(to_np(inp.centers2),
                                  stacked_lobes(mols[1])[0].astype(
                                      np.float32))
