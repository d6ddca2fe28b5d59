'''The bending routes end to end on the CPU, float64: the port
(tscode_tpu_torch) against the JAX package's pinned ensembles
(tests/golden/nonrigid_embed.npz, the inputs of
tests/test_nonrigid_golden.py) and against JAX runs of a non-rigid
chelotropic input and of the monomolecular input; structures within
1e-6 A, constrained indices and counts equal.'''

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu_torch import bending
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.embeds import cyclical as tc
from tscode_tpu_torch.io_xyz import read_xyz
from tscode_tpu_torch.suite_inputs import config_files, write_noisy

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
FIX = os.path.join(os.path.dirname(__file__), 'fixtures')
GOLD = np.load(os.path.join(os.path.dirname(__file__), 'golden',
                            'nonrigid_embed.npz'))

# the two inputs of tests/test_nonrigid_golden.py: content, fixtures
# copied as they are, fixtures written as noisy conformers (seed 7, noise
# 0.05), and what the port's embed reports
GOLDEN = {
    'bimol_nonrigid': (
        'NOOPT DIST(a=2.2,b=2.3)\nm1.xyz 0a 3b\nm2.xyz 0a 4b\n', (),
        (('C2H4.xyz', 'm1.xyz', 3), ('CH3Cl.xyz', 'm2.xyz', 3)),
        dict(bends=0, bend_hits=0, bend_reverts=0, groups=1, blocks=108,
             candidates=3888, survivors=54)),
    'tri_small': (
        'BYPASS DIST(A=2.5,x=2,y=2.5,C=1) SHRINK ROTRANGE=10 STEPS=1\n'
        'm1.xyz 0A 4y\nm2.xyz 1A 4x 0C 2C\nm2.xyz 1x 4y\n',
        (('CH3Cl.xyz', 'm1.xyz'),), (('HCOOH.xyz', 'm2.xyz', 2),),
        dict(bends=3, bend_hits=0, bend_reverts=0, groups=4, blocks=36,
             candidates=288, survivors=33)),
}


def golden_input(tmp_path, prefix):
    content, copies, noisy, _ = GOLDEN[prefix]
    rng = np.random.default_rng(7)
    for src, dst in copies:
        shutil.copy(os.path.join(FIX, src), str(tmp_path / dst))
    for src, dst, n in noisy:
        write_noisy(os.path.join(FIX, src), str(tmp_path / dst), n, rng,
                    noise=0.05)
    inp = tmp_path / 'input.txt'
    inp.write_text(content)
    return str(inp)


def run_in(cls, path, stamp, **kw):
    cwd = os.getcwd()
    try:
        return cls(path, stamp=stamp, **kw).run()
    finally:
        os.chdir(cwd)


def report_of(path, stamp):
    with open(os.path.join(os.path.dirname(path),
                           f'tscode_report_{stamp}.json')) as f:
        return json.load(f)


def stages(report):
    return [(s['stage'], s['structures_in'], s['structures_out'])
            for s in report['stages']]


@pytest.mark.parametrize('prefix', list(GOLDEN))
def test_nonrigid_embed_matches_the_golden(tmp_path, prefix, monkeypatch):
    '''The port's run gives the pinned ensemble of the JAX package: the
    same shapes, equal constrained indices, coordinates within 1e-6 A;
    the three-molecule input bends 3 times, the two-molecule one never
    (its pivot norms never differ by 5 A).'''
    monkeypatch.setenv('TSCODE_EMBED_TRACE', '1')
    path = golden_input(tmp_path, prefix)
    run = run_in(Embedder, path, 'port', device='cpu')
    want = GOLD[f'{prefix}_structures']
    structures = np.asarray(run.structures)
    assert structures.shape == want.shape and structures.dtype == np.float64
    np.testing.assert_allclose(structures, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(run.constrained_indices),
                                  GOLD[f'{prefix}_cons'])
    ce = report_of(path, 'port')['cyclical_embed']
    assert {k: ce[k] for k in GOLDEN[prefix][3]} == GOLDEN[prefix][3]
    assert ce['chunks'] >= ce['groups'] and ce['dtype'] == 'float64'
    assert (ce['bend_relaxations'] > 0) == (ce['bends'] > 0)
    if ce['bends']:
        assert ce['bends_s'] > 0 and ce['adjust_near_ties'] == 0
        assert len(run.bent_mols_cache) == ce['bends']


def test_nonrigid_rows_group_by_coordinate_arrays(tmp_path):
    '''Phase 1 of the three-molecule golden input: each bend starts a
    new group whose molecules hold the bent coordinates, a group's rows
    were all made from its molecules, and the first group's molecules
    are the embedder's own.'''
    path = golden_input(tmp_path, 'tri_small')
    cwd = os.getcwd()
    try:
        emb = Embedder(path, stamp='rows', device='cpu')
    finally:
        os.chdir(cwd)
    emb.logfile.close()
    emb.log = lambda *a, **kw: None
    calls = []

    def bend(mol, conf, pivot, target):
        calls.append((conf, pivot.index, target))
        return bending.bend_molecule(mol, conf, pivot, target, device='cpu')

    groups = tc.nonrigid_rows(emb, 5, bend)
    assert len(calls) == 3 and len(groups) == 4
    assert all(a is b for a, b in zip(groups[0]['mols'], emb.objects))
    keys = [tuple(id(m.atomcoords) for m in g['mols']) for g in groups]
    assert len(set(keys)) == 4
    for before, after in zip(groups, groups[1:]):
        changed = [a is not b
                   for a, b in zip(before['mols'], after['mols'])]
        assert sum(changed) == 1
    assert sum(len(g['rows']) for g in groups) == 36
    for g in groups:
        for row in g['rows']:
            for m, mol in enumerate(g['mols']):
                rc = mol.atomcoords[row['confs'][m]][mol.reactive_indices]
                np.testing.assert_array_equal(row['apms'][m],
                                              rc.mean(axis=0))
        assert g['rows'][0]['reset']
    blks, gap = tc.nonrigid_blocks(groups, torch.device('cpu'))
    assert [len(b['ids']) for b in blks] == [len(g['rows']) for g in groups]
    assert gap.shape == (36,) and blks[0]['dirs'].shape[1:] == (3, 3)
    # the input molecules are left unbent
    assert emb.objects[1].atomcoords is groups[0]['mols'][1].atomcoords


def both_runs(tmp_path, name, n_confs):
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    pj = config_files(name, str(tmp_path / 'jax'), n_confs)
    pt = config_files(name, str(tmp_path / 'port'), n_confs)
    return (pj, run_in(JaxEmbedder, pj, 'jax'),
            pt, run_in(Embedder, pt, 'port', device='cpu'))


def same_frames(pj, pt, tag, n_atoms):
    got = read_xyz(os.path.join(os.path.dirname(pt),
                                f'tscode_{tag}_port.xyz')).atomcoords
    want = read_xyz(os.path.join(os.path.dirname(pj),
                                 f'tscode_{tag}_jax.xyz')).atomcoords
    assert got.shape == want.shape and got.shape[1:] == (n_atoms, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    return len(got)


def test_nonrigid_chelotropic_run_matches_jax(tmp_path):
    '''The port's `chelotropic_nonrigid` input (no RIGID) at 4
    conformers through both packages: the same counts at every stage
    (the compenetration stage runs: K2's entry), the same structures
    and constraints.'''
    pj, run_j, pt, run_t = both_runs(tmp_path, 'chelotropic_nonrigid', 4)
    assert run_t.embed == run_j.embed == 'chelotropic'
    assert not run_t.options.rigid and not run_j.options.rigid
    assert stages(report_of(pt, 'port')) == stages(report_of(pj, 'jax'))
    assert [s[0] for s in stages(report_of(pt, 'port'))] == [
        'generate_candidates', 'compenetration_refining',
        'similarity_refining']
    np.testing.assert_allclose(run_t.structures, run_j.structures, rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(run_t.constrained_indices,
                                  run_j.constrained_indices)
    assert same_frames(pj, pt, 'embedded', 12) > len(run_t.structures) > 0
    ce = report_of(pt, 'port')['chelotropic_embed']
    assert ce['groups'] == 1 and ce['survivors'] == \
        stages(report_of(pt, 'port'))[0][2]


def test_chelotropic_digon_bend_matches_jax(tmp_path):
    '''The digon branch: C2F2H4's pivot (4.09 A) against the peroxy
    oxygen's (1.90 A) with max_norm_delta lowered to 2 A, so that the
    embed bends C2F2H4 toward the shorter norm (the one-atom molecule is
    never bent). Both packages' embed functions on their own set-ups:
    the same bent molecules, poses and constraints.'''
    from tscode_tpu.embedder import RunEmbedding as JaxRun
    from tscode_tpu.embeds import cyclical as jc
    from tscode_tpu_torch.embedder import RunEmbedding
    for d in ('jax', 'port'):
        (tmp_path / d).mkdir()
        for name in ('C2F2H4.xyz', 'HCOOOH.xyz'):
            shutil.copy(os.path.join(FIX, name), str(tmp_path / d / name))
        (tmp_path / d / 'input.txt').write_text(
            'NOOPT DIST(A=2.5,B=2.5)\nC2F2H4.xyz 3A 5B\nHCOOOH.xyz 4AB\n')
    cwd = os.getcwd()
    try:
        je = JaxRun(JaxEmbedder(str(tmp_path / 'jax' / 'input.txt'),
                                stamp='jax'))
        te = RunEmbedding(Embedder(str(tmp_path / 'port' / 'input.txt'),
                                   stamp='port', device='cpu'))
    finally:
        os.chdir(cwd)
    assert te.embed == je.embed == 'chelotropic'
    norms = [float(np.linalg.norm(m.pivots[0][0].pivot)) for m in te.objects]
    assert norms == pytest.approx(
        [float(np.linalg.norm(m.pivots[0][0].pivot)) for m in je.objects])
    assert 2 <= abs(norms[0] - norms[1]) < 5
    poses_j, cons_j = jc.cyclical_embed_nonrigid(je, max_norm_delta=2)
    poses_t, cons_t = tc.cyclical_embed_nonrigid(te, max_norm_delta=2)
    info = te.embed_info
    assert info['bends'] == len(te.bent_mols_cache) == \
        len(je.bent_mols_cache) == 1
    assert info['groups'] == 1 and info['bend_relaxations'] > 1
    (key, bent), = te.bent_mols_cache.items()
    assert key[2] == round(min(norms), 3)
    np.testing.assert_allclose(bent.atomcoords,
                               je.bent_mols_cache[key].atomcoords, rtol=0,
                               atol=1e-6)
    assert bent.n_atoms == 8 and bent is not te.objects[0]
    assert poses_t.shape == np.asarray(poses_j).shape and len(poses_t) > 0
    np.testing.assert_allclose(poses_t, poses_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(cons_t, cons_j)
    # with the reference's 5 A nothing is bent
    te.bent_mols_cache.clear()
    tc.cyclical_embed_nonrigid(te, max_norm_delta=5)
    assert te.embed_info['bends'] == 0 and not te.bent_mols_cache


@pytest.mark.parametrize('content,n_structures', [
    ('NOOPT CONFS=1\nC2F2H4.xyz 3 5\n', 1),
    ('NOOPT EZPROT\nC2F2H4.xyz 3 5\n', 2)])
def test_monomolecular_run_matches_jax(tmp_path, content, n_structures):
    '''One molecule with two reactive atoms: the fixture alone with
    CONFS=1, and two noisy conformers with EZPROT, through both
    packages: candidates, stage counts, structures within 1e-6 A, the
    empty constraints, and a second run on the same Embedder answered by
    the bend cache.'''
    for d in ('jax', 'port'):
        (tmp_path / d).mkdir()
        if n_structures == 1:
            shutil.copy(os.path.join(FIX, 'C2F2H4.xyz'), str(tmp_path / d))
        else:
            write_noisy(os.path.join(FIX, 'C2F2H4.xyz'),
                        str(tmp_path / d / 'C2F2H4.xyz'), 2,
                        np.random.default_rng(7), noise=0.05)
        (tmp_path / d / 'input.txt').write_text(content)
    pj, pt = (str(tmp_path / d / 'input.txt') for d in ('jax', 'port'))
    cwd = os.getcwd()
    try:
        je = JaxEmbedder(pj, stamp='jax')       # each writes where it is
        run_j = je.run()
        te = Embedder(pt, stamp='port', device='cpu')
        assert te.embed == je.embed == 'monomolecular'
        assert te.candidates == je.candidates == n_structures
        run_t = te.run()
    finally:
        os.chdir(cwd)
    rep = report_of(pt, 'port')
    assert stages(rep) == stages(report_of(pj, 'jax'))
    assert stages(rep)[0] == ('generate_candidates', 0, n_structures ** 2)
    assert stages(rep)[1][1:] == (n_structures ** 2, n_structures ** 2)
    np.testing.assert_allclose(run_t.structures, run_j.structures, rtol=0,
                               atol=1e-6)
    assert np.asarray(run_t.constrained_indices).shape == \
        np.asarray(run_j.constrained_indices).shape
    same_frames(pj, pt, 'unoptimized', 8)
    me = rep['monomolecular_embed']
    assert me['bends'] == n_structures and me['bend_hits'] == 0
    assert me['bend_relaxations'] >= me['bends']
    # the bent conformer moved, toward a shorter reactive distance
    mol = te.objects[0]
    i1, i2 = mol.reactive_indices
    d0 = np.linalg.norm(mol.atomcoords[0][i1] - mol.atomcoords[0][i2])
    d1 = np.linalg.norm(run_t.structures[0][i1] - run_t.structures[0][i2])
    assert d1 < d0 - 0.3


def test_cli_runs_the_nonrigid_route_in_a_subprocess(tmp_path):
    '''`python -m tscode_tpu_torch input.txt --device cpu` on the
    three-molecule golden input: exit code 0, the pinned ensemble in the
    written file (6 decimals), 3 bends in the run report, and no jax in
    the process.'''
    golden_input(tmp_path, 'tri_small')
    env = dict(os.environ, PYTHONPATH=REPO, TSCODE_EMBED_TRACE='1')
    code = ('import sys; from tscode_tpu_torch.__main__ import main; '
            'rc = main(["input.txt", "--device", "cpu", "-n", "cli"]); '
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.split(".")[0] == "tscode_tpu"]; '
            'print("LOADED", bad); sys.exit(rc)')
    r = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'LOADED []' in r.stdout
    assert '3 bends' in r.stderr            # the embed's trace line
    frames = read_xyz(str(tmp_path / 'tscode_unoptimized_cli.xyz')).atomcoords
    want = GOLD['tri_small_structures']
    assert frames.shape == want.shape
    with open(tmp_path / 'tscode_report_cli.json') as f:
        ce = json.load(f)['cyclical_embed']
    assert ce['bends'] == 3 and ce['survivors'] == len(want)
    # the written frames are aligned copies: compare pair distances
    def dists(x):
        return np.linalg.norm(x[:, :, None] - x[:, None, :], axis=-1)
    np.testing.assert_allclose(dists(frames), dists(want), rtol=0, atol=1e-5)
