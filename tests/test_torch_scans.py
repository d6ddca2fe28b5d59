'''The port's scans (tscode_tpu_torch.scans) against the JAX package's,
float64 on the CPU: the peak rule, the dihedral scan and two distance
scans through each package's Embedder (trajectories, peaks, plots), the
SADDLE and NEB refinements of the sub-peaks through the Embedder (the
scan points from one numpy fake of `_relax_point` patched into both
packages, the dimer and the band on the internal force field), the
SADDLE dihedral scan of
chip_smoke.py phase 18 on the six-carbon ring, and the flat scans of
csearch_string's chain that made phase 18 scan a ring. Coordinates agree
within 1e-6 A, energies within 1e-6 kcal/mol, indices and counts
exactly.'''

import contextlib
import io
import os
import re
import shutil

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_suite_counts import ff_counts, same_ff_records
from tscode_tpu import scans as jscans
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu_torch import scans
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.errors import InputError
from tscode_tpu_torch.ff import _dihedral_np
from tscode_tpu_torch.io_xyz import read_xyz
from tscode_tpu_torch.pipeline import FIXTURE_DIR
from tscode_tpu_torch.rot_rmsd import _rotate
from tscode_tpu_torch.suite_inputs import chloroalkane
from tscode_tpu_torch.torsions import get_rotation_mask

ATOL = 1e-6            # A, and kcal/mol on energies
PACKAGES = {'jax': (JaxEmbedder, {}), 'port': (Embedder, {'device': 'cpu'})}


def make_embedder(d, which, content, files):
    '''The named package's Embedder on `content`, the fixtures `files`
    copied into d.'''
    d.mkdir(exist_ok=True)
    for name in files:
        shutil.copy(os.path.join(FIXTURE_DIR, name), d)
    (d / 'input.txt').write_text(content)
    cls, kw = PACKAGES[which]
    with contextlib.redirect_stdout(io.StringIO()):
        return cls(str(d / 'input.txt'), stamp='s', **kw)


def run_both(tmp_path, content, files):
    '''Both packages' full run of `content`; the working directory is
    restored.'''
    cwd = os.getcwd()
    try:
        for which in PACKAGES:
            emb = make_embedder(tmp_path / which, which, content, files)
            with contextlib.redirect_stdout(io.StringIO()):
                emb.run()
    finally:
        os.chdir(cwd)


@pytest.fixture
def spied(monkeypatch):
    '''What both packages' sweeps, distance scans and dihedral scans
    returned, in call order.'''
    out = {'jax': [], 'port': []}
    for key, mod in (('jax', jscans), ('port', scans)):
        for name in ('_dihedral_sweep', 'distance_scan', 'dihedral_scan'):
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _key=key, _name=name, **k):
                res = _fn(*a, **k)
                out[_key].append((_name, res))
                return res
            monkeypatch.setattr(mod, name, spy)
    return out


def assert_same_calls(got, want):
    '''Each call's name, lengths and values: arrays within ATOL, indices
    exactly.'''
    assert [g[0] for g in got] == [w[0] for w in want]
    for (_, g), (_, w) in zip(got, want):
        for a, b in zip(g, w, strict=True):
            if isinstance(b, (int, np.integer)):
                assert a == b
            else:
                a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_atropisomer_peaks_equal_the_jax_package():
    rng = np.random.default_rng(12)
    traces = [np.abs(np.cumsum(rng.normal(size=36))) * 3.0
              for _ in range(30)]
    traces += [[0.0, 1.0, 0.5, 6.0, 8.0, 9.0, 10.0, 3.0, 2.0, 1.0, 0.5, 0.8,
                0.2, 5.0, 6.0, 6.0, 0.4, 0.1, 7.0, 7.5],
               [5.0, 1.0, 0.5, 0.2, 0.1, 0.3, 0.2, 6.0],
               [5.0, 1.0, 0.5, 0.2, 0.1, 0.3, 0.2, 4.0], [1.0], []]
    for t in traces:
        for lo, hi in ((0.1, 75), (0.5, 50)):
            assert scans.atropisomer_peaks(t, lo, hi) == \
                jscans.atropisomer_peaks(t, lo, hi)
    assert any(scans.atropisomer_peaks(t, 0.5, 50) for t in traces)


def test_dihedral_scan_cli_equals_the_jax_package(tmp_path, spied):
    '''scan> with four indices (F-C-C-F of C2F2H4) through the Embedder:
    both coarse sweeps point for point, each direction's trajectory and
    plot written.'''
    run_both(tmp_path, 'NOOPT\nscan> C2F2H4.xyz 3 0 1 5\n', ('C2F2H4.xyz',))
    assert_same_calls(spied['port'], spied['jax'])
    assert [c[0] for c in spied['port']] == \
        ['_dihedral_sweep', '_dihedral_sweep', 'dihedral_scan']
    for direction in ('clockwise', 'counterclockwise'):
        name = f'C2F2H4_torsion_scan_{direction}'
        frames = {w: read_xyz(str(tmp_path / w / f'{name}.xyz')).atomcoords
                  for w in PACKAGES}
        assert frames['port'].shape == (36, 8, 3)
        np.testing.assert_allclose(frames['port'], frames['jax'], rtol=0,
                                   atol=2e-6)
        assert (tmp_path / 'port' / f'{name}_plt.svg').exists()


def test_distance_scans_cli_equal_the_jax_package(tmp_path, spied):
    '''Two scan> molecules with two indices (the O...H approach of
    HCOOH, twice): their points, energies and maxima, the trajectory,
    the maximum and the plots, and the cumulative plot of the data
    termination.'''
    for which in PACKAGES:
        (tmp_path / which).mkdir()
        shutil.copy(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'),
                    tmp_path / which / 'molB.xyz')
    run_both(tmp_path, 'NOOPT\nscan> HCOOH.xyz 1 4\nscan> molB.xyz 1 4\n',
             ('HCOOH.xyz',))
    assert_same_calls(spied['port'], spied['jax'])
    assert [c[0] for c in spied['port']] == ['distance_scan'] * 2
    dists = spied['port'][0][1][0]
    assert len(dists) > 3 and dists[0] == max(dists)
    port = tmp_path / 'port'
    for name in ('HCOOH_scan.xyz', 'HCOOH_scan_max.xyz', 'molB_scan.xyz',
                 'HCOOH_distance_scan_plt.svg', 's_cumulative_plt.svg'):
        assert (port / name).exists(), name


def fake_relax(embedder, mol, coords, pair=None, pair_dist=None,
               dihedral=None, dihedral_angle=None, move_mask=None):
    '''One numpy stand-in for _relax_point, shared by both packages:
    impose the dihedral exactly (no relaxation), energy 6 (1 - cos(theta
    + 60)): one barrier of 12 kcal/mol, at 120 degrees, opposite the
    fixture's -60.'''
    quad = tuple(dihedral)
    cur = np.degrees(_dihedral_np(coords[list(quad)]))
    mask = get_rotation_mask(mol.graph, quad)
    cand = _rotate(coords, quad, dihedral_angle - cur, mask)
    ach = np.degrees(_dihedral_np(cand[list(quad)]))
    if abs((ach - dihedral_angle + 180) % 360 - 180) > 1e-3:
        cand = _rotate(coords, quad, cur - dihedral_angle, mask)
        ach = np.degrees(_dihedral_np(cand[list(quad)]))
    return cand, 6.0 * (1 - np.cos(np.radians(ach + 60.0)))


def jax_fake_relax(embedder, mol, coords, **kw):
    '''fake_relax for the JAX package, which also keeps the molecule's
    force-field tables where its _relax_point keeps them (its NEB branch
    reads them; the port builds them where they are missing).'''
    if not hasattr(mol, '_ff_params_dev'):
        from tscode_tpu import ff as jff
        mol._ff_params_dev = jff.params_to_device(jff.build_ff_params(
            mol.atomcoords[0], mol.atomnos, mol.graph))
    return fake_relax(embedder, mol, coords, **kw)


@pytest.mark.parametrize('keyword,tag', [('SADDLE', 'Saddle opt on'),
                                         ('NOOPT NEB', 'NEB TS opt on')])
def test_subpeak_refinement_equals_the_jax_package(tmp_path, monkeypatch,
                                                   spied, keyword, tag):
    '''scan> of F-C-C-F on C2F2H4 through each package's Embedder with
    SADDLE (no NOOPT: a data run) or NEB, the scan points from
    fake_relax, every sub-peak refined on the internal force field by
    the dimer or the climbing-image band: both sweeps and their
    re-scans, the refined maxima after the RMSD prune, their barriers,
    and the log's refinements.'''
    monkeypatch.setattr(jscans, '_relax_point', jax_fake_relax)
    monkeypatch.setattr(scans, '_relax_point', fake_relax)
    run_both(tmp_path, f'{keyword}\nscan> C2F2H4.xyz 3 0 1 5\n',
             ('C2F2H4.xyz',))
    assert_same_calls(spied['port'], spied['jax'])
    logs = {w: (tmp_path / w / 'tscode_s.log').read_text() for w in PACKAGES}
    refined = re.findall(r'refined to ([-\d.]+) deg \(([-\d.]+) kcal',
                         logs['port'])
    assert refined == re.findall(r'refined to ([-\d.]+) deg \(([-\d.]+) '
                                 r'kcal', logs['jax'])
    assert len(refined) == 2
    assert logs['port'].count(tag) == logs['jax'].count(tag) == 2
    maxima = read_xyz(str(tmp_path / 'port' / 'tscode_maxima_s.xyz'))
    assert len(maxima.atomcoords) == len(spied['port'][-1][1][0]) >= 1


def test_dihedral_scan_on_the_ring_equals_the_jax_package(tmp_path):
    '''chip_smoke.py phase 18's input on the six-carbon ring (SADDLE,
    scan> of the ring torsion C3-C4-C5-C0): the record of
    tests/test_torch_suite_counts.py from both packages, every sweep,
    peak, dimer and surviving maximum, and the imaginary modes of each
    refined maximum.'''
    for d in PACKAGES:
        (tmp_path / d).mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        want = ff_counts('jax', 'dihedral_scan', 6, str(tmp_path / 'jax'))
        got = ff_counts('port', 'dihedral_scan', 6, str(tmp_path / 'port'))
    assert want['maxima'] >= 1 and any(len(p) for p in want['peaks'])
    same_ff_records(got, want)


def test_moved_atoms_mask_equals_the_jax_package(tmp_path):
    '''A contiguous acyclic quadruplet rotates its side (no mask), a
    ring quadruplet and a non-contiguous one under LET move their last
    atom, and a non-contiguous one without LET raises.'''
    cwd = os.getcwd()
    try:
        embs = {w: make_embedder(tmp_path / w, w, 'NOOPT\nC2F2H4.xyz\n',
                                 ('C2F2H4.xyz',)) for w in PACKAGES}
    finally:
        os.chdir(cwd)
    for quad in ((3, 0, 1, 5), (3, 0, 1, 4)):
        for let in (False, True):
            out = {}
            for which, module in (('jax', jscans), ('port', scans)):
                emb = embs[which]
                emb.options.let = let
                try:
                    out[which] = module._moved_atoms_mask(
                        emb, emb.objects[0], quad)
                except Exception as e:
                    out[which] = type(e).__name__
            assert str(out['port']) == str(out['jax'])
    assert out['port'].sum() == 1
    with pytest.raises(InputError, match='LET'):
        embs['port'].options.let = False
        scans._moved_atoms_mask(embs['port'], embs['port'].objects[0],
                                (3, 0, 1, 4))
    for emb in embs.values():
        emb.logfile.close()


# every backbone torsion of the C10 chain (Cl-C0-C1-C2, then Ck-Ck+1-
# Ck+2-Ck+3; carbon k > 0 is atom 3k + 1)
CHAIN_TORSIONS = [(1, 0, 4, 7), (0, 4, 7, 10)] + [
    (3 * k + 1, 3 * k + 4, 3 * k + 7, 3 * k + 10) for k in range(1, 7)]


@pytest.mark.parametrize('quad', CHAIN_TORSIONS)
def test_chain_torsions_scan_flat(tmp_path, quad):
    '''Why chip_smoke.py phase 18 scans a ring: on the internal force
    field (no torsion terms, repulsion inside 0.85 of the covalent radii)
    every backbone torsion of csearch_string's C10H21Cl chain rotates its
    side rigidly and never clashes, so both coarse sweeps stay flat (every
    point at 0.0 kcal/mol to the title's two decimals): no peak.'''
    from tscode_tpu_torch.io_xyz import write_xyz
    (tmp_path / 'port').mkdir()
    coords, nos = chloroalkane(10)
    with open(tmp_path / 'port' / 'm1.xyz', 'w') as f:
        write_xyz(coords, nos, f, title='conf 0')
    (tmp_path / 'port' / 'input.txt').write_text(
        'SADDLE\nscan> m1.xyz ' + ' '.join(map(str, quad)) + '\n')
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            emb = Embedder(str(tmp_path / 'port' / 'input.txt'), stamp='s',
                           device='cpu')
    finally:
        os.chdir(cwd)
    emb.logfile.close()
    assert emb.embed == 'data'
    assert emb.objects[0].torsion_scan_data is None
    log = (tmp_path / 'port' / 'tscode_s.log').read_text()
    assert log.count('scan: 0 peaks above 5.0 kcal/mol') == 2
    for direction in ('clockwise', 'counterclockwise'):
        titles = [ln for ln in (tmp_path / 'port' /
                                f'm1_torsion_scan_{direction}.xyz'
                                ).read_text().splitlines()
                  if ln.startswith('Scan point')]
        assert len(titles) == 36
        assert all('Rel. E = 0.0 kcal/mol' in t for t in titles)


def test_plots_are_skipped_without_matplotlib(tmp_path, monkeypatch):
    '''Where matplotlib is missing, the port writes every structure and
    number and skips each plot, saying so in the log: the distance
    scans' plots, the cumulative plot, and the NEB plot.'''
    from tscode_tpu_torch import utils
    monkeypatch.setattr(utils, 'pyplot', lambda: None)
    monkeypatch.setattr(scans, 'pyplot', lambda: None)
    d = tmp_path / 'port'
    d.mkdir()
    shutil.copy(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'), d / 'molB.xyz')
    mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    from tscode_tpu_torch.io_xyz import write_xyz
    with open(d / 'pair.xyz', 'w') as f:
        for shift in (0.0, 0.05):
            write_xyz(mol.atomcoords[0] + shift, mol.atomnos, f,
                      title='conf')
    cwd = os.getcwd()
    try:
        emb = make_embedder(d, 'port', 'NOOPT\nscan> HCOOH.xyz 1 4\n'
                            'scan> molB.xyz 1 4\nneb> pair.xyz\n',
                            ('HCOOH.xyz',))
        with contextlib.redirect_stdout(io.StringIO()):
            emb.run()
    finally:
        os.chdir(cwd)
    assert not list(d.glob('*.svg'))
    for name in ('HCOOH_scan.xyz', 'molB_scan_max.xyz', 'pair_MEP.xyz'):
        assert (d / name).exists(), name
    log = (d / 'tscode_s.log').read_text()
    assert log.count('matplotlib is not installed: skipped the') == 4
