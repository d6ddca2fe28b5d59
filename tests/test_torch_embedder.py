'''The string route end to end on the CPU, float64: the port's Embedder
and CLI against the JAX package's on the same input files (the written
.xyz within 1e-6 A, the same stage counts), and the routes the port does
not run yet raising NotImplementedError before any embed work, while
the bending routes are set up as the JAX package sets them up.'''

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
     'item 15b'),                                             # optimisation
    ('NOOPT\nopt> C2H4.xyz 0\nCH3Cl.xyz 0\n',
     ('C2H4.xyz', 'CH3Cl.xyz'), 'item 15'),                   # operators
    ('SADDLE\nC2H4.xyz 0\nCH3Cl.xyz 0\n', ('C2H4.xyz', 'CH3Cl.xyz'),
     'item 15b'),                                             # saddle
    ('TS\nC2H4.xyz 0\nCH3Cl.xyz 0\n', ('C2H4.xyz', 'CH3Cl.xyz'),
     'item 15b'),                                             # TS
    ('SADDLE\nscan> C2F2H4.xyz 3 0 1 5\n', ('C2F2H4.xyz',),
     None),                                                   # a data run
])
def test_unported_routes_raise_before_the_embed(tmp_path, content, files,
                                                item):
    '''Optimisation, an unported operator, SADDLE and TS on an embed
    run raise their ROADMAP item before any embed work; a data run
    (scan> here) optimises nothing, so SADDLE without NOOPT passes and
    the run ends with its data.'''
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
            with pytest.raises(NotImplementedError,
                               match=f'ROADMAP.md {item}'):
                Embedder(str(tmp_path / 'input.txt'), stamp='np',
                         device='cpu')
    finally:
        os.chdir(cwd)
    assert not list(tmp_path.glob('tscode_embedded_*.xyz'))


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
    the calculator is XTB and xtb is installed; then it raises the
    calculators' ROADMAP item.'''
    from types import SimpleNamespace
    from tscode_tpu_torch import operators
    emb = SimpleNamespace(options=SimpleNamespace(calculator='XTB'))
    monkeypatch.setattr(operators, 'XTB_AVAILABLE', False)
    assert operators.qm_gradient_source(emb, None) is None
    monkeypatch.setattr(operators, 'XTB_AVAILABLE', True)
    with pytest.raises(NotImplementedError, match='ROADMAP.md item 15'):
        operators.qm_gradient_source(emb, None)
    emb.options.calculator = 'ORCA'
    assert operators.qm_gradient_source(emb, None) is None


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
    for flag in ('-t', '-b', '--trace=prof'):
        r = subprocess.run(cmd + ['input.txt', flag], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and 'ROADMAP.md item' in r.stderr
