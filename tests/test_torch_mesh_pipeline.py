'''The production pipeline (Embedder.run) on an 8-entry CPU mesh, float64:
with TSCODE_MESH=1 every mesh call site takes its sharded branch (the
string sweep, the block sweeps, the back-off, the compenetration stage,
the TFD, MOI and RMSD prunes) whatever the size; TSCODE_DISABLE_MESH=1
pins the unsharded path. Both are read per call, so one process compares
them: the same counts at every stage, frames within 1e-6 A. The string
route is also held to the JAX package's single-device run.'''

import json
import os
import shutil

import numpy as np
import pytest

import bench_suite
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.io_xyz import read_xyz
from tscode_tpu_torch.parallel import sharding
from tscode_tpu_torch.suite_inputs import config_files, refine_input

pytestmark = pytest.mark.mesh

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'fixtures')
CPU8 = sharding.make_mesh(devices=['cpu'] * 8)


def run_in(path, env_key, stamp, monkeypatch, cls=Embedder, **kw):
    '''Embedder(path).run() with env_key=1 under the CPU mesh: (run, run
    report, written frames).'''
    for k in ('TSCODE_MESH', 'TSCODE_DISABLE_MESH'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(env_key, '1')
    d = os.path.dirname(path)
    cwd = os.getcwd()
    try:
        with sharding.default_mesh(CPU8):
            run = cls(path, stamp=stamp, **kw).run()
    finally:
        os.chdir(cwd)
        monkeypatch.delenv(env_key)
    with open(os.path.join(d, f'tscode_report_{stamp}.json')) as f:
        report = json.load(f)
    xyz = read_xyz(os.path.join(d, f'tscode_unoptimized_{stamp}.xyz'))
    return run, report, np.asarray(xyz.atomcoords)


@pytest.fixture
def spied(monkeypatch):
    '''Calls of each sharded function, counted by module and name (the
    mesh runs must go through them, the unsharded runs must not).'''
    from tscode_tpu_torch import embedder, torsions
    from tscode_tpu_torch.embeds import string
    from tscode_tpu_torch.parallel import prune
    calls = {}
    for mod, name in ((string, 'shard_slices'),
                      (sharding, 'sharded_first_similar_successor'),
                      (sharding, 'sharded_moments'),
                      (prune, 'sharded_pass_kill'),
                      (embedder, 'sharded_compenetration_mask'),
                      (torsions, 'shard_slices')):
        key = f"{mod.__name__.rsplit('.', 1)[1]}.{name}"

        def counted(*a, _fn=getattr(mod, name), _key=key, **k):
            calls[_key] = calls.get(_key, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def counts(report):
    return [(s['stage'], s['structures_in'], s['structures_out'])
            for s in report['stages']], report['final_structures']


def same_runs(path, monkeypatch, seed=None):
    '''The unsharded and the sharded run of `path`, held alike; with a
    seed, each run's searches draw from np.random.RandomState(seed).'''
    def kw():
        return {} if seed is None else {'rng': np.random.RandomState(seed)}
    single = run_in(path, 'TSCODE_DISABLE_MESH', 'single', monkeypatch,
                    device='cpu', **kw())
    sharded = run_in(path, 'TSCODE_MESH', 'sharded', monkeypatch,
                     device='cpu', **kw())
    assert counts(sharded[1]) == counts(single[1])
    assert sharded[2].shape == single[2].shape and len(single[2]) > 0
    np.testing.assert_allclose(sharded[2], single[2], rtol=0, atol=1e-6)
    return single, sharded


def test_string_route_mesh_identity(tmp_path, monkeypatch, spied):
    n, bench_suite.N_CONFS = bench_suite.N_CONFS, 4
    try:
        bench_suite._config_files('sn2_string', str(tmp_path))
    finally:
        bench_suite.N_CONFS = n
    path = str(tmp_path / 'input.txt')
    from tscode_tpu_torch.embeds import string
    monkeypatch.setattr(string, 'TILE_ROWS', 600)   # a tile per c2 value
    single, sharded = same_runs(path, monkeypatch)
    assert spied == {'string.shard_slices': 1,
                     'sharding.sharded_moments': 1}
    se = sharded[1]['string_embed']
    assert (se['candidates'], se['clash_ok'], se['novel']) == \
        (2304, 1007, 73)
    assert sharded[1]['final_structures'] == 55
    _, _, jax_frames = run_in(path, 'TSCODE_DISABLE_MESH', 'jax',
                              monkeypatch, cls=JaxEmbedder)
    np.testing.assert_allclose(sharded[2], jax_frames, rtol=0, atol=1e-6)


def test_rigid_bimolecular_and_refine_mesh_identity(tmp_path, monkeypatch,
                                                    spied):
    '''The rigid two-molecule sweep, then REFINE on its output: the
    RMSD prune with every pass split over the mesh.'''
    path = config_files('da_cyclical', str(tmp_path), 4)
    single, sharded = same_runs(path, monkeypatch)
    ce = sharded[1]['cyclical_embed']
    assert (ce['candidates'], ce['survivors']) == (4608, 47)
    assert ce['shards'] == 8 and single[1]['cyclical_embed']['shards'] == 1
    assert sharded[1]['final_structures'] == 44

    d = tmp_path / 'refine'
    d.mkdir()
    path = refine_input(str(tmp_path / 'tscode_unoptimized_single.xyz'),
                        str(d))
    single, sharded = same_runs(path, monkeypatch)
    assert sharded[1]['final_structures'] == 1
    assert spied.get('prune.sharded_pass_kill', 0) >= 1


def test_chelotropic_mesh_identity(tmp_path, monkeypatch, spied):
    '''The rigid sweep, then the compenetration stage sharded (K2 per
    shard on CUDA).'''
    path = config_files('chelotropic', str(tmp_path), 4)
    single, sharded = same_runs(path, monkeypatch)
    assert counts(sharded[1])[0][1] == ('compenetration_refining', 128, 128)
    assert sharded[1]['final_structures'] == 70
    assert spied['embedder.sharded_compenetration_mask'] == 1


def test_rigid_trimolecular_mesh_identity(tmp_path, monkeypatch):
    path = config_files('trimolecular_rigid', str(tmp_path), 12)
    single, sharded = same_runs(path, monkeypatch)
    ce = sharded[1]['cyclical_embed']
    assert (ce['candidates'], ce['survivors']) == (1458, 54)
    assert ce['shards'] == 8


def test_csearch_mesh_identity(tmp_path, monkeypatch, spied):
    '''csearch> in front of a string embed: the back-off split over the
    mesh (K1's torsion entry per shard), the search's TFD prune, then
    the sharded string route; the searched conformers equal too.'''
    for name in ('C2F2H4.xyz', 'C2H4.xyz'):
        shutil.copy(os.path.join(FIX, name), tmp_path)
    path = str(tmp_path / 'input.txt')
    (tmp_path / 'input.txt').write_text(
        'NOOPT\ncsearch> C2F2H4.xyz 3\nC2H4.xyz 0\n')
    single, sharded = same_runs(path, monkeypatch, seed=0)
    assert spied['torsions.shard_slices'] >= 1
    assert spied['sharding.sharded_first_similar_successor'] >= 1
    assert spied['string.shard_slices'] == 1
    a, b = (r[0].objects[0].atomcoords for r in (single, sharded))
    assert len(a) >= 2
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
