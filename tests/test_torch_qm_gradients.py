'''The calculator-gradient procedures of the port against the JAX
package's, float64 on the CPU, every gradient answered in process by the
stand-in xtb of tests/torch_standin (a test double: no number it gives
is chemistry) in both packages: a bend, the neb> operator and the
saddle> operator on the stand-in's gradients (qm_gradient_source with
XTB chosen and installed), make_chain_gradient_fn's image order when
the images finish out of order (the SADDLE stage, saddle_refining, in
both branches: tests/test_torch_saddle_stage.py). Coordinates within
1e-6 A, energies within 1e-6 kcal/mol, flags and counts exactly.'''

import contextlib
import io
import os
import time

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
import tscode_tpu.settings as jsettings
from tscode_tpu import bending as jb
from tscode_tpu import neb as jneb
from tscode_tpu import saddle as jsaddle
from tscode_tpu.calculators import gradients as jgradients
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu.molecule import Molecule as JaxMolecule
from tscode_tpu.pivots import set_pivots as jax_set_pivots
from tscode_tpu_torch import bending, neb, operators, saddle
from tscode_tpu_torch.calculators import gradients
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.io_xyz import read_xyz, write_xyz
from tscode_tpu_torch.molecule import Molecule
from tscode_tpu_torch.opt_records import InProcessSubprocess
from tscode_tpu_torch.pipeline import FIXTURE_DIR
from tscode_tpu_torch.pivots import set_pivots

ATOL = 1e-6


def close(got, want, atol=ATOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture
def standin(monkeypatch):
    '''Both packages' gradient adapters on one in-process stand-in, and
    xtb taken as installed by both packages' gradient sources.'''
    fake = InProcessSubprocess()
    for m in (gradients, jgradients):
        monkeypatch.setattr(m, 'subprocess', fake)
    monkeypatch.setattr(operators, 'XTB_AVAILABLE', True)
    monkeypatch.setattr(jsettings, 'XTB_AVAILABLE', True)
    return fake


@pytest.fixture
def spied(monkeypatch):
    '''The results of both packages' callback procedures, in call
    order.'''
    out = {'jax': [], 'port': []}
    for key, mods in (('jax', (jneb, jsaddle)), ('port', (neb, saddle))):
        for mod, name in zip(mods, ('run_neb_callback',
                                    'dimer_saddle_callback')):
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _key=key, **k):
                res = _fn(*a, **k)
                out[_key].append(res)
                return res
            monkeypatch.setattr(mod, name, spy)
    return out


def formic(seed, sigma):
    mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    rng = np.random.default_rng(seed)
    return mol.atomcoords[0] + rng.normal(size=(5, 3)) * sigma, mol.atomnos


def run_operator(tmp_path, which, frames, nos, content):
    '''`content` through the named package's Embedder on m.xyz holding
    `frames`.'''
    d = tmp_path / which
    d.mkdir()
    with open(d / 'm.xyz', 'w') as f:
        for x in frames:
            write_xyz(x, nos, f, title='conf')
    (d / 'input.txt').write_text(content)
    cwd = os.getcwd()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            if which == 'jax':
                JaxEmbedder(str(d / 'input.txt'), stamp='s').run()
            else:
                Embedder(str(d / 'input.txt'), stamp='s',
                         device='cpu').run()
    finally:
        os.chdir(cwd)
    return d


def test_neb_operator_on_standin_gradients(tmp_path, standin, spied):
    '''CALC=XTB neb> on two HCOOH geometries (the O-H turned): the
    callback NEB's band, energies, TS image and status at every
    attempt, the MEP file.'''
    a, nos = formic(0, 0.02)
    b = a.copy()
    b[4] = a[3] + (a[3] - a[4]) * np.array([1.0, -1.0, 1.0]) * 0.9
    for which in ('jax', 'port'):
        run_operator(tmp_path, which, [a, b], nos, 'CALC=XTB NOOPT\nneb> '
                     'm.xyz\n')
    assert len(spied['port']) == len(spied['jax']) >= 1
    for got, want in zip(spied['port'], spied['jax']):
        close(got[0], want[0])
        close(got[1], want[1])
        assert got[2:] == want[2:]
    mep = {k: read_xyz(str(tmp_path / k / 'm_MEP.xyz')).atomcoords
           for k in ('jax', 'port')}
    close(mep['port'], mep['jax'], atol=2e-6)
    assert standin.calls > 100


def test_saddle_operator_on_standin_gradients(tmp_path, standin, spied):
    '''CALC=XTB saddle> on a jittered HCOOH: the host-loop dimer on the
    stand-in's gradients, and the saddle file.'''
    x, nos = formic(3, 0.15)
    for which in ('jax', 'port'):
        run_operator(tmp_path, which, [x], nos, 'CALC=XTB NOOPT\nsaddle> '
                     'm.xyz\n')
    (got,), (want,) = spied['port'], spied['jax']
    close(got[0], want[0])
    assert abs(got[1] - want[1]) <= ATOL and got[2] == want[2]
    close(got[0], x, atol=10.0)
    assert np.abs(got[0] - x).max() > 1e-3          # the dimer moved
    files = {k: (tmp_path / k / 'm_saddle.xyz').read_text().splitlines()[1]
             for k in ('jax', 'port')}
    assert files['port'] == files['jax']


def test_bend_on_standin_gradients(standin):
    '''bend_molecule on HCOOOH's pivot with the stand-in's gradients in
    place of the force field (make_gradient_fn of each package): four
    relaxations, the bent coordinates.'''
    path = os.path.join(FIXTURE_DIR, 'HCOOOH.xyz')
    jm = JaxMolecule(path, reactive_indices=[0, 4])
    jm.compute_orbitals()
    jax_set_pivots(jm)
    pm = Molecule(path, reactive_indices=[0, 4])
    pm.compute_orbitals()
    set_pivots(pm)
    target = float(np.linalg.norm(jm.pivots[0][0].pivot)) - 0.6
    jfn = jgradients.make_gradient_fn(jm.atomnos, method='GFN-FF')
    pfn = gradients.make_gradient_fn(pm.atomnos, method='GFN-FF')
    bj = jb.bend_molecule(jm, 0, jm.pivots[0][0], target, max_iter=4,
                          gradient_fn=jfn)
    stats = {}
    bt = bending.bend_molecule(pm, 0, pm.pivots[0][0], target, max_iter=4,
                               gradient_fn=pfn, stats=stats, device='cpu')
    close(bt.atomcoords, bj.atomcoords)
    assert stats['relaxations'] >= 1
    assert np.abs(bt.atomcoords[0] - pm.atomcoords[0]).max() > 1e-3


@pytest.mark.parametrize('package', ['jax', 'port'])
def test_chain_gradients_keep_the_image_order(monkeypatch, package):
    '''make_chain_gradient_fn keys its results by submission index: with
    the later images finishing first, energy i is image i's.'''
    mod = gradients if package == 'port' else jgradients

    def slow_first(coords, atomnos, title='', **kw):
        i = int(title.replace('grad_im', ''))
        time.sleep(0.02 * (5 - i))
        return float(i), np.full((len(atomnos), 3), float(i))

    monkeypatch.setattr(mod, 'xtb_gradient', slow_first)
    fn = mod.make_chain_gradient_fn(np.array([6, 1]), maxthreads=5)
    energies, grads = fn(np.zeros((5, 2, 3)))
    np.testing.assert_array_equal(energies, np.arange(5.0))
    np.testing.assert_array_equal(grads[:, 0, 0], np.arange(5.0))
