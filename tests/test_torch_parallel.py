'''The port's mesh (tscode_tpu_torch/parallel) on the CPU, float64: the
helpers and gates, and every sharded op on an 8-entry CPU mesh (one
process, the CPU named 8 times) against the JAX package's function on
its 8-device virtual CPU mesh (tests/conftest.py) and against the
port's unsharded op: masks and indices identical, moments within
1e-12 relative.'''

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tscode_tpu.molecule import Molecule
from tscode_tpu.ops import rmsd_prune as jprune
from tscode_tpu.ops.clash import cross_fragment_pair_mask
from tscode_tpu.parallel import sharding as jsh
from tscode_tpu_torch.embeds.common import stacked_lobes
from tscode_tpu_torch.ops import moi as tmoi
from tscode_tpu_torch.ops import rmsd_prune as tprune
from tscode_tpu_torch.ops import tfd as ttfd
from tscode_tpu_torch.optimizers import (fire_minimize_batch,
                                         fire_minimize_batch_sharded)
from tscode_tpu_torch.parallel import prune as tpp
from tscode_tpu_torch.parallel import sharding as tsh
from torch_parity import near_dup_pool

pytestmark = pytest.mark.mesh

CPU8 = tsh.make_mesh(devices=['cpu'] * 8)


@pytest.fixture
def no_mesh_env(monkeypatch):
    monkeypatch.delenv('TSCODE_MESH', raising=False)
    monkeypatch.delenv('TSCODE_DISABLE_MESH', raising=False)


def test_make_mesh_takes_repeats_and_refuses_missing_devices():
    assert CPU8.size == 8 and CPU8.axis_name == 'poses'
    assert set(CPU8.devices) == {torch.device('cpu')}
    assert tsh.make_mesh(3, devices=['cpu'] * 8).size == 3
    with pytest.raises(RuntimeError):
        tsh.make_mesh(9, devices=['cpu'] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tsh.make_mesh()
        with pytest.raises(RuntimeError):
            tsh.make_mesh(devices=['cuda:0'])
    with pytest.raises(ValueError):
        tsh.make_mesh(devices=['meta'])


def test_default_mesh_and_gates(monkeypatch, no_mesh_env):
    if not torch.cuda.is_available():
        assert tsh.get_default_mesh() is None
    with tsh.default_mesh(CPU8):
        assert tsh.get_default_mesh() is CPU8
        assert tsh.get_default_mesh(device='cpu') is CPU8
        assert tsh.get_default_mesh(device='cuda') is None   # other type
        assert tsh.mesh_for(4095) is None
        assert tsh.mesh_for(4096) is CPU8
        assert not tsh.mesh_wants(10) and tsh.mesh_wants(10, threshold=8)
        monkeypatch.setenv('TSCODE_MESH', '1')
        assert tsh.mesh_wants(1) and tsh.mesh_for(1, device='cpu') is CPU8
        assert tsh.mesh_for(1, threshold=math.inf) is CPU8    # forced
        monkeypatch.setenv('TSCODE_DISABLE_MESH', '1')
        assert tsh.get_default_mesh() is None and tsh.mesh_for(1) is None
    monkeypatch.delenv('TSCODE_DISABLE_MESH')
    with tsh.default_mesh(tsh.make_mesh(devices=['cpu'])):
        # one device shards nothing: the call sites get no mesh
        assert tsh.get_default_mesh() is None and tsh.mesh_for(1) is None
    assert tsh.mesh_for(10 ** 9, threshold=math.inf, device='cpu') is None
    if not torch.cuda.is_available():
        assert tsh.mesh_for(10 ** 6) is None


@pytest.mark.parametrize('n', [0, 5, 37, 64])
def test_shards_are_tensor_split_slices(n):
    sizes = [hi - lo for lo, hi in tsh.shard_bounds(n, 8)]
    assert sizes == [len(p) for p in torch.tensor_split(torch.arange(n), 8)]
    x = torch.arange(n * 2.0).reshape(n, 2)
    rows = tsh.shard_rows(x, CPU8)
    assert torch.equal(tsh.gather([r for _, r in rows], 'cpu'), x)


def test_sharded_compenetration_matches_jax():
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(37, 9, 3)) * 2.5       # not a multiple of 8
    pm = cross_fragment_pair_mask((4, 5))
    want = jsh.sharded_compenetration_mask(poses, pm, jsh.get_default_mesh(),
                                           thresh=1.5)
    got = tsh.sharded_compenetration_mask(poses, pm, CPU8, thresh=1.5)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_sharded_moments_match_jax():
    rng = np.random.default_rng(2)
    structures = rng.normal(size=(30, 8, 3)) * 2
    masses = rng.uniform(1.0, 35.0, size=8)
    want = jsh.sharded_moments(structures, masses, jsh.get_default_mesh())
    got = tsh.sharded_moments(structures, masses, CPU8)
    # moments reach ~2e3 amu A^2: 1e-12 of their size (the eigensolvers
    # of the two packages round apart by ~2e-14 of it)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_sharded_first_similar_successor_matches_jax():
    rng = np.random.default_rng(1)
    base = rng.uniform(-180, 180, size=(5, 6)).astype(np.float32)
    tf = base[rng.integers(0, 5, size=43)] \
        + rng.normal(size=(43, 6)).astype(np.float32) * 2
    want = jsh.sharded_first_similar_successor(tf, 10.0,
                                               jsh.get_default_mesh())
    got = tsh.sharded_first_similar_successor(tf, 10.0, CPU8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ttfd._first_similar_successor(torch.as_tensor(tf), 10.0))
    assert (got >= 0).sum() > 10 and (got < 0).any()


def test_sharded_screen_pipeline_matches_jax():
    rng = np.random.default_rng(31)
    ids = (5, 6)
    poses = rng.normal(size=(64, sum(ids), 3)) * 3
    poses[40] = poses[3] + 1e-4        # duplicates across shards
    poses[41] = poses[3] + 2e-4
    pm = cross_fragment_pair_mask(ids)
    keep_j, n_j = jsh.sharded_screen_pipeline(jsh.get_default_mesh())(
        jnp.asarray(poses), jnp.asarray(pm))
    keep, n = tsh.sharded_screen_pipeline(CPU8)(poses, pm)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    assert n == int(n_j) == int(keep.sum()) and not keep[3]


def test_sharded_embed_screen_step_matches_jax(tmp_path):
    import bench_suite
    n_confs, bench_suite.N_CONFS = bench_suite.N_CONFS, 4
    try:
        bench_suite._config_files('sn2_string', str(tmp_path))
    finally:
        bench_suite.N_CONFS = n_confs
    mols = []
    for name in ('m1.xyz', 'm2.xyz'):
        mol = Molecule(str(tmp_path / name), reactive_indices=[0])
        mol.compute_orbitals()
        mols.append(mol)
    (c1, v1), (c2, v2) = stacked_lobes(mols[0]), stacked_lobes(mols[1])
    B = 64
    rng = np.random.default_rng(0)
    args = (mols[0].atomcoords, mols[1].atomcoords, c1, v1, c2, v2,
            rng.integers(0, mols[0].n_confs, B, dtype=np.int32),
            rng.integers(0, mols[1].n_confs, B, dtype=np.int32),
            rng.integers(0, c1.shape[1], B, dtype=np.int32),
            rng.integers(0, c2.shape[1], B, dtype=np.int32),
            rng.choice(np.linspace(0.0, 350.0, 36), B),
            cross_fragment_pair_mask((mols[0].n_atoms, mols[1].n_atoms)))
    poses_j, keep_j, n_j = jsh.sharded_embed_screen_step(
        jsh.get_default_mesh())(*map(jnp.asarray, args))
    poses, keep, n = tsh.sharded_embed_screen_step(CPU8)(*args)
    np.testing.assert_allclose(poses.numpy(), np.asarray(poses_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    assert n == int(n_j) and 0 < n < B


def _recording_split(monkeypatch):
    calls = []
    split = tpp.split_pass

    def recorded(act, end, size):
        bounds, ends = split(act, end, size)
        calls.append((end.clone(), bounds))
        return bounds, ends
    monkeypatch.setattr(tpp, 'split_pass', recorded)
    return calls


@pytest.mark.parametrize('n,N,n_base', [(1500, 4, 400), (300, 8, 250),
                                        (1200, 4, 30)])
def test_sharded_prune_matches_port_and_jax(monkeypatch, n, N, n_base):
    '''Identical masks; the recorded passes show a slice boundary inside
    a chunk of a k > 1 pass and a k = 1 pass split inside its chunk.'''
    calls = _recording_split(monkeypatch)
    pool = near_dup_pool(np.random.default_rng(n + N), n, N, n_base)
    atomnos = np.array([6] * N + [1])
    structures = np.concatenate([pool, np.zeros((n, 1, 3))], axis=1)
    _, want = jprune.prune_conformers_rmsd(structures, atomnos)
    single = tprune.prune_conformers_rmsd_device(torch.as_tensor(pool))
    got = tpp.sharded_prune_rmsd(pool, CPU8)
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(got, want)
    _, via_op = tprune.prune_conformers_rmsd(structures, atomnos,
                                             device='cpu', mesh=CPU8)
    np.testing.assert_array_equal(via_op, want)
    assert 0 < got.sum() < n

    straddle = k1_split = False
    for end, bounds in calls:
        inner = [b for b in bounds[1:-1] if 0 < b < len(end)]
        if len(set(end.tolist())) > 1:
            straddle |= any(end[b - 1] == end[b] for b in inner)
        else:
            k1_split |= len(set(bounds)) > 2
    assert straddle and k1_split


def test_sharded_op_entries_match_unsharded():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(6, 8, 3)) * 2
    structures = base[rng.integers(0, 6, size=30)] \
        + rng.normal(size=(30, 8, 3)) * 0.01
    atomnos = np.array([6, 6, 8, 1, 1, 7, 6, 17])
    _, want = tmoi.prune_by_moment_of_inertia(structures, atomnos,
                                              device='cpu')
    _, got = tmoi.prune_by_moment_of_inertia(structures, atomnos,
                                             device='cpu', mesh=CPU8)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)

    quads = np.array([[0, 1, 2, 5], [1, 2, 5, 6], [2, 5, 6, 7]])
    _, want = ttfd.prune_conformers_tfd(structures, quads, device='cpu')
    _, got = ttfd.prune_conformers_tfd(structures, quads, device='cpu',
                                       mesh=CPU8)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_sharded_fire_matches_unsharded():
    '''19 structures over 8 shards, 120 steps: FIRE's state is per
    structure, so the result is the unsharded one exactly.'''
    rng = np.random.default_rng(5)
    coords = torch.as_tensor(rng.normal(size=(19, 6, 3)))
    center = torch.as_tensor(rng.normal(size=(6, 3)))

    def energy(c, center):
        return torch.sum((c - center) ** 2 * (1 + c ** 2), dim=(-2, -1))

    want = fire_minimize_batch(coords, energy, n_steps=120, fmax=1e-4,
                               energy_args=(center,))
    got = fire_minimize_batch_sharded(coords, energy, CPU8, n_steps=120,
                                      fmax=1e-4, energy_args=(center,))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int(want[2].sum()) < 19
    assert jax.devices()[0].platform == 'cpu'
