'''The scan operator's calculator branches in the port against the JAX
package's, float64 on the CPU, every xtb call answered in process by
the stand-in xtb of tests/torch_standin (a test double: no number it
gives is chemistry) in both packages: a distance scan and a dihedral
scan whose points are constrained optimisations on the calculator
(`CALC=XTB scan>`), and the SADDLE and NEB refinements of a sub-peak on
the calculator's gradients (the host-loop dimer, the callback band).
Coordinates within 1e-6 A, energies within 1e-6 kcal/mol, indices and
counts exactly.'''

import contextlib
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_qm_gradients import close, formic
from tscode_tpu import scans as jscans
from tscode_tpu.calculators import gradients as jgradients
from tscode_tpu.calculators import xtb as jxtb
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu_torch import scans
from tscode_tpu_torch.calculators import gradients, xtb
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.io_xyz import write_xyz
from tscode_tpu_torch.opt_records import InProcessSubprocess
from tscode_tpu_torch.suite_inputs import chlorocycloalkane, ring_torsion


@pytest.fixture
def standin(monkeypatch):
    '''Both packages' xtb adapters on one in-process stand-in.'''
    fake = InProcessSubprocess()
    for m in (xtb, jxtb, gradients, jgradients):
        monkeypatch.setattr(m, 'subprocess', fake)
    return fake


def same(got, want):
    '''Equal scan outputs: arrays within 1e-6, the rest exactly.'''
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, (int, np.integer)):
            assert int(a) == int(b)
        else:
            close(a, b)


def run_scan(tmp_path, monkeypatch, indices):
    '''`CALC=XTB scan>` of the six-carbon ring on `indices` through both
    packages' Embedders; the scan function's results, JAX's first.'''
    coords, nos = chlorocycloalkane(6)
    name = 'distance_scan' if len(indices) == 2 else 'dihedral_scan'
    out = {}
    for key, mod, cls in (('jax', jscans, JaxEmbedder),
                          ('port', scans, Embedder)):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _k=key, **k:
                            out.setdefault(_k, _fn(*a, **k)))
        d = tmp_path / key
        d.mkdir()
        with open(d / 'm.xyz', 'w') as f:
            write_xyz(coords, nos, f, title='ring')
        (d / 'input.txt').write_text(
            f'CALC=XTB\nscan> m.xyz {" ".join(map(str, indices))}\n')
        kw = {} if key == 'jax' else {'device': 'cpu'}
        cwd = os.getcwd()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cls(str(d / 'input.txt'), stamp='s', **kw).run()
        finally:
            os.chdir(cwd)
    return out['jax'], out['port']


def test_distance_scan_on_standin(tmp_path, standin, monkeypatch):
    '''The C0-Cl bond stretched in 0.05 A steps, each point a
    constrained optimisation on the stand-in.'''
    want, got = run_scan(tmp_path, monkeypatch, (0, 1))
    same(got, want)
    assert len(want[0]) > 10 and standin.calls == 2 * len(want[0])


def test_dihedral_scan_on_standin(tmp_path, standin, monkeypatch):
    '''A ring torsion driven both ways, each point optimised on the
    stand-in with the torsion held by its dihedral constraint; the
    maxima and their energies.'''
    want, got = run_scan(tmp_path, monkeypatch, ring_torsion(6))
    same(got, want)
    assert standin.calls > 40


@pytest.mark.parametrize('option', ['saddle', 'neb'])
def test_subpeak_refinement_on_standin_gradients(standin, option,
                                                 monkeypatch):
    '''_refine_subpeak with SADDLE (the host-loop dimer) or NEB (the
    callback band between the points two before and one after) on the
    stand-in's gradients, on five HCOOH geometries. The stand-in's model
    has no angle terms, so the dimer climbs a soft bend until a bond
    breaks: both packages discard that sub-peak alike; the band's TS
    image is kept.'''
    from tscode_tpu import saddle as jsaddle
    from tscode_tpu_torch import saddle
    dimers = {}
    for key, mod in (('jax', jsaddle), ('port', saddle)):
        fn = mod.dimer_saddle_callback
        monkeypatch.setattr(mod, 'dimer_saddle_callback',
                            lambda *a, _fn=fn, _k=key, **k:
                            dimers.setdefault(_k, _fn(*a, **k)))
    x, nos = formic(3, 0.1)
    fine = np.array([x + 0.03 * k for k in range(5)])
    energies = np.arange(5.0)
    out = {}
    for key, mod in (('jax', jscans), ('port', scans)):
        emb = SimpleNamespace(
            options=SimpleNamespace(saddle=option == 'saddle',
                                    neb=option == 'neb', calculator='XTB',
                                    theory_level='GFN2-xTB', solvent=None,
                                    charge=0),
            procs=1, device='cpu', log=lambda *a, **k: None)
        mol = SimpleNamespace(atomnos=nos, rootname='m')
        out[key] = mod._refine_subpeak(emb, mol, fine, energies, 2, 'peak')
    if option == 'saddle':
        assert out['port'] is None and out['jax'] is None
        close(dimers['port'][0], dimers['jax'][0])
        assert abs(dimers['port'][1] - dimers['jax'][1]) <= 1e-6
        assert dimers['port'][2] == dimers['jax'][2]
    else:
        close(out['port'][0], out['jax'][0])
        assert abs(out['port'][1] - out['jax'][1]) <= 1e-6
    assert standin.calls > 50
