'''The rigid chelotropic route on the CPU, float64: the port
(tscode_tpu_torch) against the JAX package on the port's `chelotropic`
suite input (jittered C2H4 docked with both carbons on the two lobes of
HCOOOH's peroxy oxygen) at 4 conformers: set-up, the run (4,608
candidates -> 128 embedded -> 128 after the compenetration stage, which
is kernel K2's entry -> 70 final) and the large-embed rule.'''

import json
import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.io_xyz import read_xyz
from tscode_tpu_torch.embedder import Embedder, RunEmbedding
from tscode_tpu_torch.ops.kernels import clash
from tscode_tpu_torch.suite_inputs import config_files

COUNTS_4 = (4608, 128, 128, 70)   # candidates, embedded, compenetration, final


def set_up(cls, path, **kw):
    cwd = os.getcwd()
    try:
        emb = cls(path, stamp='setup', **kw)
    finally:
        os.chdir(cwd)
    emb.logfile.close()
    return emb


@pytest.fixture(scope='module')
def chel4(tmp_path_factory):
    d = tmp_path_factory.mktemp('chel4')
    path = config_files('chelotropic', str(d), 4)
    return (path, set_up(JaxEmbedder, path),
            set_up(Embedder, path, device='cpu'))


def test_chelotropic_setup_matches_jax(chel4):
    '''Embed type, angle grid, candidates, pivots and every reactive
    atom's enlarged orbital: centres within 1e-9 A of the JAX package's,
    0.2 A farther out than the atom type's own.'''
    _, je, te = chel4
    assert te.embed == je.embed == 'chelotropic'
    assert te.candidates == je.candidates == COUNTS_4[0]
    np.testing.assert_array_equal(te.systematic_angles, je.systematic_angles)
    assert te.systematic_angles.shape == (36, 2)
    for mt, mj in zip(te.objects, je.objects):
        assert [len(p) for p in mt.pivots] == [len(p) for p in mj.pivots]
        for c in range(mt.n_confs):
            assert sorted(mt.reactive_atoms[c]) == sorted(mj.reactive_atoms[c])
            for i, at in mt.reactive_atoms[c].items():
                aj = mj.reactive_atoms[c][i]
                np.testing.assert_allclose(at.center, aj.center, rtol=0,
                                           atol=1e-9)
                np.testing.assert_allclose(at.coord, aj.coord, rtol=0,
                                           atol=1e-9)
    # the peroxy oxygen: two lobes, one pivot between them
    oxygen = te.objects[1]
    assert len(oxygen.reactive_indices) == 1
    assert [len(p) for p in oxygen.pivots] == [1] * 4


def test_chelotropic_orbitals_are_enlarged(chel4):
    '''Every lobe of the chelotropic set-up lies 0.2 A farther from its
    atom than the lobe its atom type gets on its own (DIST's sizes are
    set before the enlargement recomputes the orbitals, so they do not
    enter).'''
    from tscode_tpu_torch.molecule import Molecule
    path, _, te = chel4
    d = os.path.dirname(path)
    for mol, name in zip(te.objects, ('m1.xyz', 'm2.xyz')):
        own = Molecule(os.path.join(d, name),
                       [int(i) for i in mol.reactive_indices])
        own.compute_orbitals()
        for c in range(mol.n_confs):
            for i, atom in mol.reactive_atoms[c].items():
                plain = own.reactive_atoms[c][i]
                grown = np.linalg.norm(atom.center - atom.coord, axis=1)
                np.testing.assert_allclose(
                    grown, np.linalg.norm(plain.center - plain.coord, axis=1)
                    + 0.2, rtol=0, atol=1e-9)


def test_chelotropic_run_matches_jax(chel4):
    '''Embedder.run(): every stage's counts equal the JAX run's, the
    embedded and final frames within 1e-6 A; the compenetration stage
    went through K2's entry (its plain twin here) with the run's
    max_clashes.'''
    path, _, _ = chel4
    d = os.path.dirname(path)
    cwd = os.getcwd()
    try:
        JaxEmbedder(path, stamp='jax').run()
        run = Embedder(path, stamp='port', device='cpu').run()
    finally:
        os.chdir(cwd)
    reps = {}
    for stamp in ('jax', 'port'):
        with open(os.path.join(d, f'tscode_report_{stamp}.json')) as f:
            reps[stamp] = json.load(f)
    counts = [[(s['stage'], s['structures_in'], s['structures_out'])
               for s in reps[k]['stages']] for k in ('jax', 'port')]
    assert counts[0] == counts[1] == [
        ('generate_candidates', 0, COUNTS_4[1]),
        ('compenetration_refining', COUNTS_4[1], COUNTS_4[2]),
        ('similarity_refining', COUNTS_4[2], COUNTS_4[3])]
    for tag, n in (('embedded', COUNTS_4[1]), ('unoptimized', COUNTS_4[3])):
        got = read_xyz(os.path.join(d, f'tscode_{tag}_port.xyz')).atomcoords
        want = read_xyz(os.path.join(d, f'tscode_{tag}_jax.xyz')).atomcoords
        assert got.shape == want.shape == (n, 12, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ce = reps['port']['chelotropic_embed']
    assert (ce['candidates'], ce['survivors']) == COUNTS_4[:2]
    assert len(run.structures) == COUNTS_4[3]


def test_compenetration_stage_passes_max_clashes_to_k2(chel4, monkeypatch):
    '''compenetration_refining hands K2's entry the run's ensemble on
    the run's device, the cross-fragment mask of its fragment sizes, and
    CLASHES' threshold and count.'''
    import tscode_tpu_torch.embedder as mod
    path, _, _ = chel4
    with open(path) as f:
        text = f.read()
    alt = os.path.join(os.path.dirname(path), 'clashes.txt')
    with open(alt, 'w') as f:
        f.write(text.replace('NOOPT', 'NOOPT CLASHES(num=3,dist=1.3)'))
    run = RunEmbedding(set_up(Embedder, alt, device='cpu'))
    rng = np.random.default_rng(0)
    run.structures = rng.normal(size=(40, 12, 3)) * 1.6
    run.constrained_indices = np.zeros((40, 2, 2), dtype=int)
    run.logfile = open(os.devnull, 'w')
    seen = {}

    def spy(poses, pair_mask, thresh, max_clashes):
        seen.update(device=poses.device.type, dtype=poses.dtype,
                    shape=tuple(poses.shape), pairs=int(pair_mask.sum()),
                    thresh=thresh, max_clashes=max_clashes)
        return clash.compenetration_mask_kernel(poses, pair_mask, thresh,
                                                max_clashes)

    monkeypatch.setattr(mod, 'compenetration_mask_kernel', spy)
    run.compenetration_refining()
    assert seen == dict(device='cpu', dtype=torch.float64, shape=(40, 12, 3),
                        pairs=36, thresh=1.3, max_clashes=3)
    assert 0 < len(run.structures) < 40
    assert len(run.energies) == len(run.structures)


@pytest.mark.parametrize('n_confs,rigid', [(101, True), (62, False)])
def test_large_embed_rule_covers_chelotropic(tmp_path, n_confs, rigid):
    '''Over 100 conformers and no LET, run() makes a chelotropic embed
    rigid, as the JAX package does; at 62 it stays non-rigid in both.'''
    path = config_files('chelotropic', str(tmp_path), n_confs)
    with open(path) as f:
        text = f.read()
    with open(path, 'w') as f:
        f.write(text.replace('NOOPT RIGID', 'NOOPT DRYRUN'))
    cwd = os.getcwd()
    try:
        run_j = JaxEmbedder(path, stamp='jax').run()
        run_t = Embedder(path, stamp='port', device='cpu').run()
    finally:
        os.chdir(cwd)
    assert run_t.embed == run_j.embed == 'chelotropic'
    assert run_t.options.rigid == run_j.options.rigid == rigid
    for stamp in ('jax', 'port'):
        with open(tmp_path / f'tscode_{stamp}.log') as f:
            assert ('Large embed: RIGID keyword added' in f.read()) == rigid
    assert not list(tmp_path.glob('tscode_embedded_*.xyz'))
