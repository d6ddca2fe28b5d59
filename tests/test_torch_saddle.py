'''The port's dimer method (tscode_tpu_torch.saddle) against the JAX
package's, float64 on the CPU: the jitted dimer on an analytic surface
and on the internal force field, the host-loop dimer on one numpy
gradient callback shared by both packages, and the saddle> operator
through each package's Embedder (internal force field, and the branch
of a gradient callback). Inputs are HCOOH geometries jittered by a
seeded numpy generator; coordinates agree within 1e-6 A, energies within
1e-6 kcal/mol, the convergence flags exactly.'''

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu import operators as jops
from tscode_tpu import saddle as jsaddle
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu_torch import ff, operators, saddle
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.io_xyz import read_xyz, write_xyz
from tscode_tpu_torch.pipeline import FIXTURE_DIR

ATOL = 1e-6            # A, and kcal/mol on energies


def hcooh(seed=3, sigma=0.15):
    '''HCOOH's fixture jittered by sigma A (seed), its atomic numbers.'''
    mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    rng = np.random.default_rng(seed)
    return mol.atomcoords[0] + rng.normal(size=(5, 3)) * sigma, mol.atomnos


def test_dimer_on_an_analytic_surface_equals_the_jax_package():
    '''One point on E = (x^2 - 1)^2 + 2 y^2 + z^2 - 0.3 x y, whose
    first-order saddle lies at the origin: both packages converge to it
    on the same path.'''
    def port_e(c):
        x, y, z = c[..., 0, 0], c[..., 0, 1], c[..., 0, 2]
        return (x ** 2 - 1) ** 2 + 2 * y ** 2 + z ** 2 - 0.3 * x * y

    def jax_e(c):
        x, y, z = c[0, 0], c[0, 1], c[0, 2]
        return (x ** 2 - 1) ** 2 + 2 * y ** 2 + z ** 2 - 0.3 * x * y

    start = np.array([[0.45, -0.2, 0.1]])
    c, e, done = saddle.dimer_saddle(torch.as_tensor(start), port_e)
    jc, je, jdone = jsaddle.dimer_saddle(jnp.asarray(start), jax_e)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    assert float(e) == pytest.approx(float(je), abs=ATOL)
    assert bool(done) == bool(jdone) is True
    assert np.abs(c.numpy()).max() < 0.05


def test_dimer_start_equals_the_jax_package():
    '''The initial mode sin(arange(3n) * 12.9898 + 4.1414), projected and
    normalised, built in float64 as JAX builds it.'''
    x = torch.zeros((32, 3), dtype=torch.float64)
    v = np.sin(np.arange(96, dtype=float) * 12.9898 + 4.1414).reshape(32, 3)
    v = v - v.mean(axis=0)
    np.testing.assert_allclose(saddle.dimer_start(x).numpy(),
                               v / np.linalg.norm(v), rtol=0, atol=1e-15)


def shared_gradient(coords, nos):
    '''One numpy (energy, gradient) callback, the port's force field of
    HCOOH on the CPU, given to both packages.'''
    p = ff.params_to_device(ff.build_ff_params(coords, nos,
                                               graphize(coords, nos)),
                            'cpu', torch.float64)

    def gradient_fn(c):
        x = torch.tensor(np.asarray(c), dtype=torch.float64,
                         requires_grad=True)
        e = ff.ff_energy(x, p)
        return float(e.detach()), torch.autograd.grad(e, x)[0].numpy()
    return gradient_fn


def test_dimer_callback_equals_the_jax_package():
    x, nos = hcooh(seed=4)
    fn = shared_gradient(*hcooh(seed=0, sigma=0.0))
    got = saddle.dimer_saddle_callback(x, fn, n_steps=25)
    want = jsaddle.dimer_saddle_callback(x, fn, n_steps=25)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    assert got[1] == pytest.approx(want[1], abs=ATOL)
    assert got[2] == want[2]


def run_saddle_operator(tmp_path, which, content):
    '''saddle> through the named package's Embedder on a jittered HCOOH
    (seed 3), the dimer's outputs spied on. Returns [(coords, energy,
    converged)] and the written saddle file's frame.'''
    d = tmp_path / which
    d.mkdir()
    x, nos = hcooh()
    with open(d / 'ts.xyz', 'w') as f:
        write_xyz(x, nos, f, title='guess')
    (d / 'input.txt').write_text(content)
    seen = []
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
    return read_xyz(str(d / 'ts_saddle.xyz')).atomcoords[0], \
        (d / 'ts_saddle.xyz').read_text().splitlines()[1]


@pytest.fixture
def spied(monkeypatch):
    '''The results of both packages' saddle_refine_structure and
    dimer_saddle_callback, in call order.'''
    out = {'jax': [], 'port': []}
    for key, mod in (('jax', jsaddle), ('port', saddle)):
        for name in ('saddle_refine_structure', 'dimer_saddle_callback'):
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _key=key, **k):
                res = _fn(*a, **k)
                out[_key].append(res)
                return res
            monkeypatch.setattr(mod, name, spy)
    return out


def assert_same_saddles(got, want):
    assert len(got) == len(want) == 1
    (c, e, done), (jc, je, jdone) = got[0], want[0]
    np.testing.assert_allclose(c, np.asarray(jc), rtol=0, atol=ATOL)
    assert e == pytest.approx(float(je), abs=ATOL)
    assert bool(done) == bool(jdone)


def test_saddle_operator_equals_the_jax_package(tmp_path, spied):
    '''saddle> on the internal force field, without NOOPT (a data run
    optimises nothing): the dimer's 300 steps, its coordinates, energy
    and flag, and the written structure.'''
    frames = {w: run_saddle_operator(tmp_path, w, 'saddle> ts.xyz\n')
              for w in ('jax', 'port')}
    assert_same_saddles(spied['port'], spied['jax'])
    np.testing.assert_allclose(frames['port'][0], frames['jax'][0], rtol=0,
                               atol=2e-6)
    assert frames['port'][1] == frames['jax'][1]


def test_saddle_operator_on_a_gradient_callback(tmp_path, spied,
                                                monkeypatch):
    '''The branch of a gradient source (xtb's, once the calculators are
    ported), given the shared numpy callback in both packages: the
    host-loop dimer's result.'''
    fn = shared_gradient(*hcooh(seed=0, sigma=0.0))
    monkeypatch.setattr(jops, 'qm_gradient_source', lambda *a, **k: fn)
    monkeypatch.setattr(operators, 'qm_gradient_source',
                        lambda *a, **k: fn)
    for w in ('jax', 'port'):
        run_saddle_operator(tmp_path, w, 'NOOPT\nsaddle> ts.xyz\n')
    assert_same_saddles(spied['port'], spied['jax'])


def test_saddle_on_xtb_gradients_names_the_procedure(tmp_path, monkeypatch):
    '''With XTB chosen and installed, qm_gradient_source gives the
    calculators' callbacks: the per-structure one (saddle>, bending) and
    the per-image one (neb>, chain=True), equal to the JAX package's on
    the same stand-in xtb run in process.'''
    from types import SimpleNamespace
    import tscode_tpu.calculators.gradients as jgradients
    import tscode_tpu.settings as jsettings
    from tscode_tpu_torch.calculators import gradients
    from tscode_tpu_torch.opt_records import InProcessSubprocess
    fake = InProcessSubprocess()
    for m in (gradients, jgradients):
        monkeypatch.setattr(m, 'subprocess', fake)
    monkeypatch.setattr(operators, 'XTB_AVAILABLE', True)
    monkeypatch.setattr(jsettings, 'XTB_AVAILABLE', True)
    coords, nos = hcooh(seed=1)
    mol = SimpleNamespace(atomnos=nos)
    emb = SimpleNamespace(options=SimpleNamespace(
        calculator='XTB', theory_level='GFN2-xTB', solvent=None, charge=0),
        procs=1, threads=2)
    chain = np.stack([coords, coords + 0.03, coords - 0.03])
    got = operators.qm_gradient_source(emb, mol, chain=True)(chain)
    want = jops.qm_gradient_source(emb, mol, chain=True)(chain)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    one = operators.qm_gradient_source(emb, mol)(coords)
    assert one[0] == got[0][0]
    np.testing.assert_array_equal(one[1], got[1][0])
