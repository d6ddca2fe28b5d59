'''The operators and stages that need a calculator, in the port against
the JAX package, float64 on the CPU, every xtb call answered in process
by the stand-in xtb of tests/torch_standin (a test double: no number it
gives is chemistry) in both packages: opt>, mtd> and mtd_search> (CREST
mocked, as the JAX package's own tests do: the stand-in serves no
metadynamics), automep> (its dihedral-constrained optimisations on the
stand-in), pka> (optimisations and --ohess free energies on the
stand-in), the NCI report (print_nci), and the conformer search's
stability mode 0 (every group optimised on the stand-in) and its
energy-aware diverse selection; and the CLI's -b (-t:
tests/test_torch_cli_flags.py). Coordinates within 1e-6 A, energies
within 1e-6 kcal/mol, counts and written text exactly.'''

import contextlib
import io
import os
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
import tscode_tpu.settings as jsettings
from test_torch_suite_counts import opt_counts
from tscode_tpu import nci as jnci
from tscode_tpu import torsions as jt
from tscode_tpu.calculators import dispatch as jdispatch
from tscode_tpu.calculators import gradients as jgradients
from tscode_tpu.calculators import xtb as jxtb
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu_torch import nci, settings
from tscode_tpu_torch import torsions as tt
from tscode_tpu_torch.calculators import dispatch, gradients, xtb
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.io_xyz import read_xyz, write_xyz
from tscode_tpu_torch.opt_records import STANDIN_DIR, InProcessSubprocess
from test_torch_cli_flags import cli
from tscode_tpu_torch.pipeline import FIXTURE_DIR
from tscode_tpu_torch.suite_inputs import (chloroalkane, chlorocycloalkane,
                                           config_files)

ATOL = 1e-6


def close(got, want, atol=ATOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture
def standin(monkeypatch):
    fake = InProcessSubprocess()
    for m in (xtb, jxtb, gradients, jgradients):
        monkeypatch.setattr(m, 'subprocess', fake)
    return fake


def spy_on(monkeypatch, pairs):
    '''The results of each (module, name) pair's function, by package
    ('jax' for a module of tscode_tpu), in call order.'''
    out = {'jax': [], 'port': []}
    for mod, name in pairs:
        fn = getattr(mod, name)
        key = 'port' if mod.__name__.startswith('tscode_tpu_torch') \
            else 'jax'

        def spy(*a, _fn=fn, _key=key, **k):
            res = _fn(*a, **k)
            out[_key].append(res)
            return res
        monkeypatch.setattr(mod, name, spy)
    return out


def run_both(tmp_path, write, content, standin=None):
    '''`content` as input.txt beside the files `write(d)` puts in d, run
    by both packages (their searches seeded with 0). Returns the two
    set-up Embedders, JAX's first; with the in-process `standin`, also
    the stand-in calls of each run.'''
    out, calls = [], []
    cwd = os.getcwd()
    for key in ('jax', 'port'):
        before = standin.calls if standin is not None else 0
        d = tmp_path / key
        d.mkdir()
        write(d)
        (d / 'input.txt').write_text(content)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                if key == 'jax':
                    np.random.seed(0)
                    emb = JaxEmbedder(str(d / 'input.txt'), stamp='s')
                else:
                    emb = Embedder(str(d / 'input.txt'), stamp='s',
                                   device='cpu',
                                   rng=np.random.RandomState(0))
                emb.run()
        finally:
            os.chdir(cwd)
        out.append(emb)
        if standin is not None:
            calls.append(standin.calls - before)
    return (out, calls) if standin is not None else out


def log_of(tmp_path, key):
    return (tmp_path / key / 'tscode_s.log').read_text()


def sn2_files(d):
    config_files('sn2_string', str(d), 4)


def test_opt_operator_equals_the_jax_package(tmp_path, standin, monkeypatch):
    '''opt> on C2H4's 4 conformers: each optimised on the stand-in, the
    energy window and the RMSD prune; then the string embed on the
    optimised ensemble.'''
    spied = spy_on(monkeypatch, [(dispatch, 'optimize_ensemble_pipeline'),
                                 (jdispatch, 'optimize_ensemble_pipeline')])
    _, calls = run_both(tmp_path, sn2_files, 'CALC=XTB NOOPT\nopt> '
                        'm1.xyz 0\nm2.xyz 0\n', standin)
    (got,), (want,) = spied['port'], spied['jax']
    close(got.atomcoords, want.atomcoords)
    assert calls == [4, 4]
    frames = {k: read_xyz(str(tmp_path / k / 'tscode_unoptimized_s.xyz'))
              .atomcoords for k in ('jax', 'port')}
    close(frames['port'], frames['jax'])
    assert 'optimizing 4 conformers' in log_of(tmp_path, 'port')


def crest(coords, atomnos, method='GFN2-xTB//GFN-FF', title='t', **kw):
    '''CREST mocked: fails at the default method (as a crashed
    metadynamics would), then answers 8 jittered copies of the input,
    seeded by the conformer's title.'''
    if method != 'GFN2-XTB':
        raise subprocess.CalledProcessError(1, ['crest'])
    rng = np.random.default_rng(int(title.split('mtd')[-1]))
    out = np.asarray(coords)[None] + rng.normal(size=(8,) + np.shape(coords)) \
        * 0.3
    return out, np.arange(8.0)


@pytest.mark.parametrize('name', ['mtd', 'mtd_search'])
def test_mtd_operators_with_mocked_crest(tmp_path, monkeypatch, name):
    '''CREST's ensemble of each conformer (the retry at GFN2-XTB after a
    failed first run), merged and pruned (TFD, RMSD, symmetry-corrected
    RMSD) on the port's prunes.'''
    for m in (xtb, jxtb):
        monkeypatch.setattr(m, 'crest_mtd_search', crest)
    monkeypatch.setattr(settings, 'CREST_AVAILABLE', True)
    monkeypatch.setattr(jsettings, 'CREST_AVAILABLE', True)
    spied = spy_on(monkeypatch, [(xtb, 'crest_mtd_search_operator'),
                                 (jxtb, 'crest_mtd_search_operator')])

    def write(d):
        coords, nos = chloroalkane(5)
        with open(d / 'chain.xyz', 'w') as f:
            for k in range(2):
                write_xyz(coords + 0.05 * k, nos, f, title=f'conf {k}')
        shutil.copy(os.path.join(FIXTURE_DIR, 'C2H4.xyz'), d)

    run_both(tmp_path, write, f'CALC=XTB NOOPT\n{name}> chain.xyz 0\n'
             'C2H4.xyz 0\n')
    (got,), (want,) = spied['port'], spied['jax']
    close(got.atomcoords, want.atomcoords)
    assert 1 < len(got.atomcoords) < 16
    assert 'retrying with just GFN2-XTB' in log_of(tmp_path, 'port')


def test_automep_operator_equals_the_jax_package(tmp_path, standin):
    '''automep> on an eight-membered ring and its mirror image: the
    stand-in optimisations (the planar guess with every ring dihedral
    held at 0 and the exocyclic ones at 180, each interior image with
    its bonds and dihedrals held), the IDPP path between them.'''
    def write(d):
        coords, nos = chlorocycloalkane(8)
        for name, x in (('ring.xyz', coords),
                        ('flip.xyz', coords * np.array([1.0, 1.0, -1.0]))):
            with open(d / name, 'w') as f:
                write_xyz(x, nos, f, title=name)

    _, calls = run_both(tmp_path, write, 'CALC=XTB\nautomep> ring.xyz\n'
                        'flip.xyz\n', standin)
    mep = {k: read_xyz(str(tmp_path / k / 'ring_automep.xyz')).atomcoords
           for k in ('jax', 'port')}
    close(mep['port'], mep['jax'], atol=2e-6)
    # the optimisation, the planar guess, then the interior images (a
    # held distance far from its target walks there in steps)
    assert len(mep['port']) == 9 and calls[0] == calls[1] >= 9


def test_pka_operator_equals_the_jax_package(tmp_path, standin):
    '''pka> on formic acid's acidic H (HA -> A-) and its carbonyl O (B
    -> BH+): the optimisations and the --ohess free energies on the
    stand-in, the ladder against PKA(HCOOH.xyz)=3.77 and the
    equilibrium block.'''
    def write(d):
        shutil.copy(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'), d)
        shutil.copy(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'), d / 'base.xyz')

    (je, te), calls = run_both(tmp_path, write,
                               'CALC=XTB PKA(HCOOH.xyz)=3.77\n'
                               'pka> HCOOH.xyz 4\npka> base.xyz 1\n',
                               standin)
    for jm, tm in zip(je.objects, te.objects):
        assert tm.pka_data[0] == jm.pka_data[0]
        assert abs(tm.pka_data[1] - jm.pka_data[1]) <= ATOL
    ladders = [log_of(tmp_path, k).split('pKa energetics')[1]
               .split('Data run')[0] for k in ('jax', 'port')]
    assert ladders[1] == ladders[0]
    assert 'Equilibrium data' in ladders[1]
    # an optimisation and a free energy per conformer and charge
    assert calls[0] == calls[1] >= 8


def hcooh_dimer():
    '''Two formic acids, the second's carbonyl O 1.9 A from the first's
    acidic H: one O-H hydrogen bond between the fragments.'''
    data = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    a, nos = np.asarray(data.atomcoords[0]), np.asarray(data.atomnos)
    h = a[4]
    direction = (h - a[3]) / np.linalg.norm(h - a[3])
    b = a - a[1] + h + 1.9 * direction
    return np.concatenate([a, b]), np.concatenate([nos, nos])


def test_print_nci_equals_the_jax_package():
    '''print_nci on the dimer (a hydrogen bond), on the dimer pulled
    apart (none) and on a refine run (no partition: skipped).'''
    x, nos = hcooh_dimer()
    far = x.copy()
    far[5:] += 6.0
    for structures, ids in (([x, far], [5, 5]), ([x, far], None)):
        logs = {}
        for key, mod in (('jax', jnci), ('port', nci)):
            lines = []
            emb = SimpleNamespace(
                log=lambda s='', p=True, _l=lines: _l.append(s),
                structures=np.array(structures), atomnos=nos,
                constrained_indices=np.zeros((2, 0, 2), dtype=int), ids=ids)
            mod.print_nci(emb)
            logs[key] = (lines, getattr(emb, 'nci', None))
        assert logs['port'] == logs['jax']
        found = any('hydrogen bond' in s for s in logs['port'][0])
        assert found == (ids is not None)


def test_nci_keyword_on_the_optimisation_route(tmp_path):
    '''NCI on an optimising run: the report after the stages, the same
    in both packages.'''
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    sections = []
    for key in ('jax', 'port'):
        with contextlib.redirect_stdout(io.StringIO()):
            opt_counts(key, 'sn2_string_opt', 4, str(tmp_path / key),
                       keywords='NCI')
        log = (tmp_path / key / f'tscode_{key}.log').read_text()
        sections.append(log.split('Non-covalent interactions spotting')[1]
                        .split('\n\n')[0])
    assert sections[1] == sections[0]
    assert 'NCIs spotted' in sections[1]


def test_search_mode_0_equals_the_jax_package(standin):
    '''csearch in stability mode: every rotated conformer optimised on
    the stand-in (GFN-FF), the most stable n_out kept.'''
    coords, nos = chloroalkane(5)
    kw = dict(mode=0, ff_opt=True, calc='XTB', method='GFN-FF', n_out=6,
              logfunction=lambda *a, **k: None)
    want = jt.csearch(coords, nos, **kw)
    calls = standin.calls
    got = tt.csearch(coords, nos, rng=np.random.RandomState(0),
                     device='cpu', **kw)
    close(got, want)
    assert len(got) == 6 and standin.calls == 2 * calls


def test_energy_aware_selection_equals_the_jax_package(monkeypatch):
    '''most_diverse_conformers with energies: the lowest-energy member
    of each cluster, its energy beside it; the clustering given to both
    packages alike (k-means itself: tests/test_torch_csearch.py).'''
    coords, nos = chloroalkane(5)
    rng = np.random.default_rng(4)
    structures = coords[None] + rng.normal(size=(40,) + coords.shape) * 0.4
    energies = rng.normal(size=40) * 5.0
    torsion_array = np.array([[0, 3, 6, 9], [3, 6, 9, 12]])
    n = 6

    def labels(m):
        return np.arange(m) % n

    class FakeKMeans:
        def __init__(self, n_clusters, n_init=10):
            pass

        def fit(self, features):
            self.labels_ = labels(len(features))
            self.cluster_centers_ = np.zeros((n, features.shape[1]))
            return self

    import sklearn.cluster
    monkeypatch.setattr(sklearn.cluster, 'KMeans', FakeKMeans)
    monkeypatch.setattr(tt, 'kmeans', lambda f, k, rng, device: (
        labels(len(f)), np.zeros((k, f.shape[1]))))
    want = jt.most_diverse_conformers(n, structures, torsion_array,
                                      energies=energies,
                                      return_energies=True)
    got = tt.most_diverse_conformers(n, structures, torsion_array,
                                     energies=energies, return_energies=True,
                                     rng=np.random.RandomState(0),
                                     device='cpu')
    close(got[0], want[0])
    close(got[1], want[1])
    assert len(got[0]) == n


def test_concurrency_benchmark(tmp_path):
    '''-b in a subprocess on the CPU: the internal force field's batched
    FIRE on --device without xtb, and the threaded xtb grid with the
    stand-in first on PATH.'''
    shutil.copy(os.path.join(FIXTURE_DIR, 'CH3Cl.xyz'), tmp_path)
    r = cli(['CH3Cl.xyz', '-b', '--device', 'cpu'], str(tmp_path))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert 'internal-FF batched optimizer' in r.stdout
    assert r.stdout.count('ms/structure') == 3
    r = cli(['CH3Cl.xyz', '-b', '--device', 'cpu'], str(tmp_path),
            path=STANDIN_DIR)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.count('s/structure') == 12
    assert '--> Recommended: --procs' in r.stdout
