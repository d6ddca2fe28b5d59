'''The port's vibrational analysis (tscode_tpu_torch.vibrations) against
the JAX package's, float64 on the CPU: force-field frequencies of one
structure and of a batch, frequencies from a gradient callback (one
numpy function shared by both packages), the symmetry number, the RRHO
thermochemistry and the force-field free energy. Inputs are jittered
HCOOH geometries from a seeded numpy generator; frequencies agree within
1e-6 relative, energies within 1e-6 kcal/mol, imaginary-mode counts
exactly.'''

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from tscode_tpu import ff as jff
from tscode_tpu import vibrations as jvib
from tscode_tpu_torch import ff, vibrations
from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.io_xyz import read_xyz
from tscode_tpu_torch.pipeline import FIXTURE_DIR

FREQ_RTOL = 1e-6
E_ATOL = 1e-6          # kcal/mol


@pytest.fixture(scope='module')
def hcooh():
    '''HCOOH's atomic numbers, both packages' force-field energy of one
    (N, 3) structure (tables from the fixture geometry) and three
    jittered geometries (sigma 0.08 A, seed 5).'''
    mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    coords, nos = mol.atomcoords[0], mol.atomnos
    params = ff.build_ff_params(coords, nos, graphize(coords, nos))
    p = ff.params_to_device(params, 'cpu', torch.float64)
    jp = jff.params_to_device(params)
    rng = np.random.default_rng(5)
    X = coords + rng.normal(size=(3, len(nos), 3)) * 0.08
    return dict(nos=nos, X=X,
                port=lambda c: ff.ff_energy(c, p),
                jax=lambda c: jff.ff_energy(c[None], jp)[0])


def assert_freqs(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FREQ_RTOL, atol=1e-9)


@pytest.mark.parametrize('project', [True, False])
def test_frequencies_equal_the_jax_package(hcooh, project):
    for x in hcooh['X']:
        got, n_got = vibrations.frequencies(x, hcooh['nos'], hcooh['port'],
                                            project=project, device='cpu')
        want, n_want = jvib.frequencies(x, hcooh['nos'], hcooh['jax'],
                                        project=project)
        assert_freqs(got, want)
        assert n_got == n_want
    assert np.count_nonzero(want) >= 3 * len(hcooh['nos']) - 6


def test_frequencies_batch_equals_the_jax_package(hcooh):
    got, n_got = vibrations.frequencies_batch(hcooh['X'], hcooh['nos'],
                                              hcooh['port'], device='cpu')
    want, n_want = jvib.frequencies_batch(hcooh['X'], hcooh['nos'],
                                          hcooh['jax'])
    assert_freqs(got, want)
    np.testing.assert_array_equal(n_got, n_want)
    single, _ = vibrations.frequencies(hcooh['X'][1], hcooh['nos'],
                                       hcooh['port'], device='cpu')
    assert_freqs(got[1], single)


def test_frequencies_find_the_imaginary_mode_of_a_maximum():
    '''A diatomic at the top of -50 (d - d0)^2: one imaginary mode in
    both packages, at the analytic wavenumber.'''
    coords = np.array([[0.0, 0, 0], [1.27, 0, 0]])
    nos = np.array([1, 17])
    got, n_got = vibrations.frequencies(
        coords, nos,
        lambda c: -50.0 * (torch.linalg.norm(c[0] - c[1]) - 1.27) ** 2,
        device='cpu')
    want, n_want = jvib.frequencies(
        coords, nos,
        lambda c: -50.0 * (jnp.linalg.norm(c[0] - c[1]) - 1.27) ** 2)
    assert_freqs(got, want)
    assert n_got == n_want == 1


def shared_gradient(hcooh):
    '''One numpy (energy, gradient) callback, the port's force field on
    the CPU, given to both packages.'''
    def gradient_fn(c):
        x = torch.tensor(np.asarray(c), dtype=torch.float64,
                         requires_grad=True)
        e = hcooh['port'](x)
        return float(e.detach()), torch.autograd.grad(e, x)[0].numpy()
    return gradient_fn


def test_frequencies_from_gradients_equal_the_jax_package(hcooh):
    fn = shared_gradient(hcooh)
    x = hcooh['X'][0]
    got, n_got = vibrations.frequencies_from_gradients(
        x, hcooh['nos'], fn, device='cpu')
    want, n_want = jvib.frequencies_from_gradients(x, hcooh['nos'], fn)
    assert_freqs(got, want)
    assert n_got == n_want


SHAPES = {
    'water': ([[0.0, 0.0, 0.117], [0.0, 0.757, -0.469],
               [0.0, -0.757, -0.469]], [8, 1, 1]),
    'co2': ([[0.0, 0.0, 0.0], [0.0, 0.0, 1.16], [0.0, 0.0, -1.16]],
            [6, 8, 8]),
    'hcn': ([[0.0, 0.0, -1.064], [0.0, 0.0, 0.0], [0.0, 0.0, 1.156]],
            [1, 6, 7]),
    'nh3': ([[0.0, 0.0, 0.12], [0.94, 0.0, -0.27], [-0.47, 0.81, -0.27],
             [-0.47, -0.81, -0.27]], [7, 1, 1, 1]),
    'benzene': (np.concatenate([
        [[1.39 * np.cos(np.radians(60 * k)),
          1.39 * np.sin(np.radians(60 * k)), 0.0] for k in range(6)],
        [[2.47 * np.cos(np.radians(60 * k)),
          2.47 * np.sin(np.radians(60 * k)), 0.0] for k in range(6)]]),
        [6] * 6 + [1] * 6),
    'argon': ([[0.0, 0.0, 0.0]], [18]),
}


@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_symmetry_and_thermochemistry_equal_the_jax_package(shape):
    coords, nos = (np.asarray(a) for a in SHAPES[shape])
    sigma = vibrations.detect_symmetry_number(coords, nos)
    assert sigma == jvib.detect_symmetry_number(coords, nos)
    freqs = np.array([1595.0, 3657.0, 3756.0, 0.0, -120.0])
    for sym in (None, 1):
        got = vibrations.thermochemistry(freqs, nos, coords,
                                         symmetry_number=sym)
        want = jvib.thermochemistry(freqs, nos, coords,
                                    symmetry_number=sym)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-12)


def test_ff_free_energy_equals_the_jax_package(hcooh):
    x = hcooh['X'][2]
    got, n_got = vibrations.ff_free_energy(x, hcooh['nos'], hcooh['port'],
                                           device='cpu')
    want, n_want = jvib.ff_free_energy(x, hcooh['nos'], hcooh['jax'])
    assert got == pytest.approx(want, rel=0, abs=E_ATOL)
    assert n_got == n_want
