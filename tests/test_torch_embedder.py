'''The string route end to end on the CPU, float64: the port's Embedder
and CLI against the JAX package's on the same input files (the written
.xyz within 1e-6 A, the same stage counts), the routes that need a
calculator raising the JAX package's InputError when there is none, and
the bending routes set up as the JAX package sets them up.'''

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_suite
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.io_xyz import read_xyz
from tscode_tpu_torch.embedder import Embedder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, 'tests', 'fixtures')


def run_in(d, embedder_cls, stamp, **kw):
    '''Set up and run one Embedder on d/input.txt (it changes into d);
    returns (run, report dict).'''
    cwd = os.getcwd()
    try:
        run = embedder_cls(str(d / 'input.txt'), stamp=stamp, **kw).run()
    finally:
        os.chdir(cwd)
    with open(d / f'tscode_report_{stamp}.json') as f:
        return run, json.load(f)


def frames(d, tag, stamp):
    return read_xyz(str(d / f'tscode_{tag}_{stamp}.xyz')).atomcoords


def write_input(d, content, files=('C2H4.xyz', 'CH3Cl.xyz')):
    for name in files:
        shutil.copy(os.path.join(FIX, name), d)
    (d / 'input.txt').write_text(content)


def sn2_input(d, n_confs=4):
    n = bench_suite.N_CONFS
    bench_suite.N_CONFS = n_confs
    try:
        bench_suite._config_files('sn2_string', str(d))
    finally:
        bench_suite.N_CONFS = n


def assert_same_run(d, stamp_j, stamp_t, rep_j, rep_t):
    for tag in ('embedded', 'unoptimized'):
        np.testing.assert_allclose(frames(d, tag, stamp_t),
                                   frames(d, tag, stamp_j), rtol=0,
                                   atol=1e-6)
    stage_counts = [[(s['stage'], s['structures_in'], s['structures_out'])
                     for s in r['stages']] for r in (rep_j, rep_t)]
    assert stage_counts[0] == stage_counts[1]
    assert rep_t['final_structures'] == rep_j['final_structures']


def test_sn2_string_run_matches_jax(tmp_path):
    sn2_input(tmp_path)
    run_j, rep_j = run_in(tmp_path, JaxEmbedder, 'jax')
    run_t, rep_t = run_in(tmp_path, Embedder, 'port', device='cpu')
    assert_same_run(tmp_path, 'jax', 'port', rep_j, rep_t)
    assert rep_t['final_structures'] == 55 == len(run_t.structures)
    se = rep_t['string_embed']
    assert (se['candidates'], se['clash_ok'], se['novel']) == (2304, 1007, 73)
    assert se['tfd_lane'] == 'host' and rep_t['dtype'] == 'float64'
    assert run_t.candidates == run_j.candidates == 2304


def test_fixture_string_input_matches_jax(tmp_path):
    write_input(tmp_path, 'NOOPT\nC2H4.xyz 0\nCH3Cl.xyz 0\n')
    _, rep_j = run_in(tmp_path, JaxEmbedder, 'jax')
    _, rep_t = run_in(tmp_path, Embedder, 'port', device='cpu')
    assert_same_run(tmp_path, 'jax', 'port', rep_j, rep_t)
    assert rep_t['final_structures'] > 0


def test_resume_after_the_prunes(tmp_path):
    sn2_input(tmp_path)
    run_in(tmp_path, Embedder, 'first', device='cpu')
    pkl = str(tmp_path / 'tscode_resume_first.pkl')
    cwd = os.getcwd()
    try:
        Embedder(str(tmp_path / 'input.txt'), stamp='again',
                 device='cpu').run(resume_from=pkl)
    finally:
        os.chdir(cwd)
    np.testing.assert_array_equal(frames(tmp_path, 'unoptimized', 'again'),
                                  frames(tmp_path, 'unoptimized', 'first'))
    assert not (tmp_path / 'tscode_embedded_again.xyz').exists()


@pytest.mark.parametrize('content,files,item', [
    ('C2H4.xyz 0\nCH3Cl.xyz 0\n', ('C2H4.xyz', 'CH3Cl.xyz'),
     'after'),                                                # optimisation
    ('NOOPT\nopt> C2H4.xyz 0\nCH3Cl.xyz 0\n',
     ('C2H4.xyz', 'CH3Cl.xyz'), 'before'),                    # operators
    ('SADDLE\nC2H4.xyz 0\nCH3Cl.xyz 0\n', ('C2H4.xyz', 'CH3Cl.xyz'),
     'after'),                                                # saddle
    ('TS\nC2H4.xyz 0\nCH3Cl.xyz 0\n', ('C2H4.xyz', 'CH3Cl.xyz'),
     'after'),                                                # TS
    ('SADDLE\nscan> C2F2H4.xyz 3 0 1 5\n', ('C2F2H4.xyz',),
     None),                                                   # a data run
])
def test_unported_routes_raise_before_the_embed(tmp_path, content, files,
                                                item, monkeypatch):
    '''With no calculator on the machine: an opt> operator raises the
    JAX package's InputError before any embed work; optimisation, and
    SADDLE and TS (which need it), raise the JAX package's InputError
    once the candidates are embedded and pruned, word for word; a data
    run (scan> here) optimises nothing, so SADDLE without NOOPT passes
    and the run ends with its data.'''
    import tscode_tpu.options as joptions
    from tscode_tpu.errors import InputError as JaxInputError
    from tscode_tpu_torch import options
    from tscode_tpu_torch.errors import InputError
    for m in (options, joptions):
        monkeypatch.setattr(m, 'CALCULATOR', None)
        monkeypatch.setattr(m, 'FF_CALC', None)
        monkeypatch.setattr(m, 'FF_OPT_BOOL', False)
    write_input(tmp_path, content, files)
    cwd = os.getcwd()
    try:
        if item is None:
            with contextlib.redirect_stdout(io.StringIO()):
                emb = Embedder(str(tmp_path / 'input.txt'), stamp='np',
                               device='cpu')
                emb.run()
            assert emb.embed == 'data'
            assert (tmp_path / 'C2F2H4_torsion_scan_clockwise.xyz').exists()
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                with pytest.raises(JaxInputError) as want:
                    JaxEmbedder(str(tmp_path / 'input.txt'),
                                stamp='jax').run()
                with pytest.raises(InputError) as got:
                    Embedder(str(tmp_path / 'input.txt'), stamp='np',
                             device='cpu').run()
            assert str(got.value) == str(want.value)
            assert 'requires an external calculator' in str(got.value)
    finally:
        os.chdir(cwd)
    embedded = list(tmp_path.glob('tscode_embedded_np.xyz'))
    assert bool(embedded) == (item == 'after')


@pytest.mark.parametrize('content,files,embed', [
    ('NOOPT\nC2H4.xyz 0 3\nC2H4.xyz 0 3\nC2H4.xyz 0 3\n', ('C2H4.xyz',),
     'cyclical'),
    ('NOOPT DIST(a=2.2,b=2.3)\nC2H4.xyz 0a 3b\nCH3Cl.xyz 0a 4b\n',
     ('C2H4.xyz', 'CH3Cl.xyz'), 'cyclical'),
    ('NOOPT\nC2H4.xyz 0 3\nCH3Cl.xyz 0\n', ('C2H4.xyz', 'CH3Cl.xyz'),
     'chelotropic'),
    ('NOOPT\nC2F2H4.xyz 3 5\n', ('C2F2H4.xyz',), 'monomolecular'),
])
def test_bending_routes_are_set_up(tmp_path, content, files, embed):
    '''The non-rigid cyclical and chelotropic inputs and the
    one-molecule input set up as the JAX package sets them up: embed
    type, RIGID off, candidates.'''
    from tscode_tpu.embedder import Embedder as JaxEmbedder
    write_input(tmp_path, content, files)
    cwd = os.getcwd()
    try:
        te = Embedder(str(tmp_path / 'input.txt'), stamp='np', device='cpu')
        je = JaxEmbedder(str(tmp_path / 'input.txt'), stamp='jax')
    finally:
        os.chdir(cwd)
    assert te.embed == je.embed == embed
    # CH3Cl's single lobe gives the chelotropic input no pivot: 0, "Many"
    assert te.candidates == je.candidates
    assert (te.candidates > 0) == (embed != 'chelotropic')
    assert not te.options.rigid and not je.options.rigid
    if embed == 'monomolecular':
        assert te.options.only_refined and \
            te.options.fix_angles_in_deformation
        assert [len(p) for p in te.objects[0].pivots] == \
            [len(p) for p in je.objects[0].pivots]


def test_bending_on_xtb_gradients_raises(monkeypatch):
    '''qm_gradient_source: no callback (the internal force field) unless
    the calculator is XTB and xtb was on PATH when settings were read;
    then the calculators' gradient callback, which gives the JAX
    package's numbers on the same stand-in xtb (run in process).'''
    from types import SimpleNamespace
    import tscode_tpu.calculators.gradients as jgradients
    import tscode_tpu.operators as jops
    import tscode_tpu.settings as jsettings
    from tscode_tpu_torch import operators
    from tscode_tpu_torch.calculators import gradients
    from tscode_tpu_torch.opt_records import InProcessSubprocess
    fake = InProcessSubprocess()
    for m in (gradients, jgradients):
        monkeypatch.setattr(m, 'subprocess', fake)
    data = read_xyz(os.path.join(FIX, 'CH3Cl.xyz'))
    mol = SimpleNamespace(atomnos=np.asarray(data.atomnos))
    emb = SimpleNamespace(options=SimpleNamespace(
        calculator='XTB', theory_level=None, solvent=None, charge=0),
        procs=1, threads=2)
    monkeypatch.setattr(operators, 'XTB_AVAILABLE', False)
    assert operators.qm_gradient_source(emb, mol) is None
    monkeypatch.setattr(operators, 'XTB_AVAILABLE', True)
    monkeypatch.setattr(jsettings, 'XTB_AVAILABLE', True)
    coords = np.asarray(data.atomcoords[0]) + 0.05
    got = operators.qm_gradient_source(emb, mol)(coords)
    want = jops.qm_gradient_source(emb, mol)(coords)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert np.abs(got[1]).max() > 0 and fake.calls == 2
    emb.options.calculator = 'ORCA'
    assert operators.qm_gradient_source(emb, mol) is None


def test_cuda_requested_without_a_card_raises(tmp_path, monkeypatch):
    sn2_input(tmp_path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cwd = os.getcwd()
    try:
        with pytest.raises(RuntimeError, match='cuda'):
            Embedder(str(tmp_path / 'input.txt'), device='cuda')
    finally:
        os.chdir(cwd)
    assert not list(tmp_path.glob('tscode_*'))


def test_cli_in_a_subprocess(tmp_path):
    sn2_input(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, '-m', 'tscode_tpu_torch']
    r = subprocess.run(cmd + ['input.txt', '--device', 'cpu', '-n', 'cli'],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'TFD novelty filter ran on the host lane' in r.stdout
    assert frames(tmp_path, 'unoptimized', 'cli').shape == (55, 11, 3)
    # -t and -b run (tests/test_torch_opt_operators.py); --trace writes
    # one Chrome trace (tests/test_torch_trace.py)
    r = subprocess.run(cmd + ['input.txt', '--device', 'cpu', '--trace=prof',
                              '-n', 'traced'], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(list((tmp_path / 'prof').glob('*.pt.trace.json'))) == 1
