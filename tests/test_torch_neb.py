'''The port's nudged elastic band (tscode_tpu_torch.neb) against the JAX
package's, float64 on the CPU: the linear and IDPP interpolations, the
upwind tangents and band forces, the climbing-image NEB on the internal
force field, the host-loop NEB on one numpy gradient callback shared by
both packages, the neb> and mep_relax> operators through each package's
Embedder (two structures, three, an odd chain; the checkpointing branch
of a gradient callback), and the force-field operators of chip_smoke.py
phase 19 on the six-carbon ring. Inputs are HCOOH geometries from a
seeded numpy generator; coordinates agree within 1e-6 A, energies within
1e-6 kcal/mol, indices exactly.'''

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_suite_counts import ff_counts, same_ff_records
from tscode_tpu import ff as jff
from tscode_tpu import neb as jneb
from tscode_tpu import operators as jops
from tscode_tpu.embedder import Embedder as JaxEmbedder
from tscode_tpu_torch import ff, neb, operators
from tscode_tpu_torch.embedder import Embedder
from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.io_xyz import read_xyz, write_xyz
from tscode_tpu_torch.pipeline import FIXTURE_DIR
from tscode_tpu_torch.rot_rmsd import _rotate

ATOL = 1e-6            # A, and kcal/mol on energies


@pytest.fixture(scope='module')
def formic():
    '''HCOOH: its atomic numbers, both packages' force-field tables (from
    the fixture) and five conformers, the O-H turned about the C-O bond
    by 0, 45, 90, 135 and 180 degrees, each jittered by 0.05 A (seed 2).'''
    mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
    coords, nos = mol.atomcoords[0], mol.atomnos
    params = ff.build_ff_params(coords, nos, graphize(coords, nos))
    mask = np.zeros(5, dtype=bool)
    mask[4] = True
    rng = np.random.default_rng(2)
    confs = np.array([_rotate(coords, (1, 0, 3, 4), a, mask)
                      for a in (0, 45, 90, 135, 180)])
    confs += rng.normal(size=confs.shape) * 0.05
    return dict(nos=nos, confs=confs, params=params,
                port=ff.params_to_device(params, 'cpu', torch.float64),
                jax=jff.params_to_device(params))


def close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_interpolations_equal_the_jax_package(formic):
    a, b = formic['confs'][0], formic['confs'][-1]
    close(neb.interpolate_chain(a, b, 7), jneb.interpolate_chain(a, b, 7),
          atol=0)
    close(neb.idpp_interpolate(a, b, 7, device='cpu'),
          jneb.idpp_interpolate(a, b, 7))
    three = formic['confs'][[0, 2, 4]]
    for n, method in ((7, 'idpp'), (7, 'linear'), (3, 'idpp')):
        close(neb.interpolate_structures(three, formic['nos'], n, method,
                                         device='cpu'),
              jneb.interpolate_structures(three, formic['nos'], n, method))


@pytest.mark.parametrize('climbing', [False, True])
def test_band_forces_equal_the_jax_package(climbing):
    '''Tangents and band forces on a random band whose energies rise,
    fall and turn (every branch of the upwind tangent).'''
    rng = np.random.default_rng(9)
    chain = rng.normal(size=(9, 5, 3))
    energies = np.array([0.0, 1.0, 3.0, 2.5, 4.0, 1.0, 0.5, 0.7, 0.2])
    grad = rng.normal(size=chain.shape)
    got = neb.band_forces(torch.as_tensor(chain), torch.as_tensor(energies),
                          torch.as_tensor(grad), k_spring=1.3,
                          climbing=climbing)
    want = jneb.band_forces(jnp.asarray(chain), jnp.asarray(energies),
                            jnp.asarray(grad), k_spring=1.3,
                            climbing=climbing)
    close(got.numpy(), want, atol=1e-12)
    assert not got[0].any() and not got[-1].any()


def test_run_neb_equals_the_jax_package(formic):
    a, b = formic['confs'][0], formic['confs'][-1]
    got = neb.run_neb(a, b, ff.ff_energy, energy_args=(formic['port'],),
                      device='cpu')
    want = jneb.run_neb(a, b, lambda c: jff.ff_energy(c, formic['jax']))
    close(got[0], want[0])
    close(got[1], want[1])
    assert got[2] == want[2]


def shared_chain_gradient(formic):
    '''One numpy band callback, the port's force field on the CPU:
    chain (I, N, 3) -> (energies (I,), gradients (I, N, 3)).'''
    def grad_chain_fn(chain):
        x = torch.tensor(np.asarray(chain), dtype=torch.float64,
                         requires_grad=True)
        e = ff.ff_energy(x, formic['port'])
        return e.detach().numpy(), \
            torch.autograd.grad(e.sum(), x)[0].numpy()
    return grad_chain_fn


def test_run_neb_callback_equals_the_jax_package(formic):
    '''The host loop with checkpoints every 10 steps and its status.'''
    fn = shared_chain_gradient(formic)
    a, b = formic['confs'][0], formic['confs'][-1]
    runs = {}
    for key, run in (('port', lambda **k: neb.run_neb_callback(
                          device='cpu', **k)),
                     ('jax', jneb.run_neb_callback)):
        saved = []
        out = run(start=a, end=b, grad_chain_fn=fn, n_images=5,
                  checkpoint_fn=saved.append, with_status=True)
        runs[key] = out + (saved,)
    got, want = runs['port'], runs['jax']
    close(got[0], want[0])
    close(got[1], want[1])
    assert got[2:4] == want[2:4]
    assert len(got[4]) == len(want[4]) > 1
    close(np.array(got[4]), np.array(want[4]))


def neb_input(d, formic, which, op):
    '''`op`> on m.xyz holding the conformers `which` of the fixture.'''
    d.mkdir()
    with open(d / 'm.xyz', 'w') as f:
        for c in formic['confs'][list(which)]:
            write_xyz(c, formic['nos'], f, title='conf')
    (d / 'input.txt').write_text(op + ' m.xyz\n')
    return str(d / 'input.txt')


@pytest.fixture
def spied(monkeypatch):
    '''The results of both packages' run_neb and run_neb_callback.'''
    out = {'jax': [], 'port': []}
    for key, mod in (('jax', jneb), ('port', neb)):
        for name in ('run_neb', 'run_neb_callback'):
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _key=key, **k):
                res = _fn(*a, **k)
                out[_key].append(res)
                return res
            monkeypatch.setattr(mod, name, spy)
    return out


def run_both(tmp_path, formic, which, op):
    cwd = os.getcwd()
    try:
        for key in ('jax', 'port'):
            inp = neb_input(tmp_path / key, formic, which, op)
            with contextlib.redirect_stdout(io.StringIO()):
                if key == 'jax':
                    JaxEmbedder(inp, stamp='s').run()
                else:
                    Embedder(inp, stamp='s', device='cpu').run()
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize('which,op', [
    ((0, 4), 'NOOPT\nneb>'),                  # ends: an IDPP band of 7
    ((0, 2, 4), 'NOOPT\nneb>'),               # ends + TS guess: two halves
    ((0, 1, 2, 3, 4), 'NOOPT\nneb>'),         # an odd chain: the band
    ((0, 1, 2, 3, 4), 'mep_relax>'),          # no NOOPT: a data run
])
def test_neb_operator_equals_the_jax_package(tmp_path, formic, spied, which,
                                             op):
    run_both(tmp_path, formic, which, op)
    (got,), (want,) = spied['port'], spied['jax']
    close(got[0], want[0])
    close(got[1], want[1])
    assert got[2] == want[2]
    assert len(got[0]) == (5 if len(which) == 5 else 7)
    mep = {k: read_xyz(str(tmp_path / k / 'm_MEP.xyz')).atomcoords
           for k in ('jax', 'port')}
    close(mep['port'], mep['jax'], atol=2e-6)
    assert (tmp_path / 'port' / 'm_NEB_TS.xyz').exists()
    assert (tmp_path / 'port' / 'm_NEB_plt.svg').exists()


def test_neb_operator_on_a_gradient_callback(tmp_path, formic, spied,
                                             monkeypatch):
    '''The branch of a gradient source (xtb's, once the calculators are
    ported), given the shared numpy callback in both packages: the host
    loop's band and status at every attempt (an unconverged band
    restarts from its checkpoint), and the checkpoint file.'''
    fn = shared_chain_gradient(formic)
    monkeypatch.setattr(jops, 'qm_gradient_source', lambda *a, **k: fn)
    monkeypatch.setattr(operators, 'qm_gradient_source',
                        lambda *a, **k: fn)
    run_both(tmp_path, formic, (0, 4), 'NOOPT\nneb>')
    assert len(spied['port']) == len(spied['jax']) >= 1   # restarts
    for got, want in zip(spied['port'], spied['jax']):
        close(got[0], want[0])
        close(got[1], want[1])
        assert got[2:] == want[2:]
    chk = {k: read_xyz(str(tmp_path / k / 'm_MEP_chkpt.xyz')).atomcoords
           for k in ('jax', 'port')}
    close(chk['port'], chk['jax'], atol=2e-6)


def test_ff_operators_equal_the_jax_package(tmp_path):
    '''chip_smoke.py phase 19's input on the six-carbon ring (neb> on
    the scan's first point and the point 120 degrees on, saddle> on its
    highest point, the separating scan of C0-Cl): the record of
    tests/test_torch_suite_counts.py from both packages.'''
    for d in ('scan', 'jax', 'port'):
        (tmp_path / d).mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        scan = ff_counts('jax', 'dihedral_scan', 6, str(tmp_path / 'scan'))
        want = ff_counts('jax', 'ff_operators', 6, str(tmp_path / 'jax'),
                         scan=scan)
        got = ff_counts('port', 'ff_operators', 6, str(tmp_path / 'port'),
                        scan=scan)
    assert want['distance_points'] > 3 and want['neb_ts'][0] > 0
    same_ff_records(got, want)


@pytest.mark.parametrize('route', ['band', 'dimer'])
def test_loop_bodies_key_their_constants_and_hold_no_tensor(route):
    '''A captured loop body's graph key (capture.body_key): two
    bodies made on equal constants share one key, a change of any
    constant or of the energy function gives another, and a body whose
    closure holds a tensor (which the graph would read by its address
    after the caller let it go) is refused.'''
    from tscode_tpu_torch import saddle
    from tscode_tpu_torch.capture import body_key
    from tscode_tpu_torch.optimizers import fire_band_update
    if route == 'band':
        def make(energy_fn=ff.ff_energy, k=1.0, fmax=0.05, climbing=True):
            return neb._band_body(energy_fn, k, fmax, climbing)
        changes = [dict(k=2.0), dict(fmax=0.1), dict(climbing=False)]
    else:
        def make(energy_fn=ff.ff_energy, n_rot=12, dr=1e-3, fmax=0.05):
            return saddle._dimer_step(energy_fn, n_rot, dr, 0.02, fmax)
        changes = [dict(n_rot=8), dict(dr=2e-3), dict(fmax=0.1)]
    changes.append(dict(energy_fn=neb._idpp_energy))
    a, b = make(), make()
    assert a is not b and body_key(a) == body_key(b)
    assert len({body_key(make(**c)) for c in changes} | {body_key(a)}) == \
        len(changes) + 1

    dt0 = torch.tensor(0.01, dtype=torch.float64)

    def holds_a_tensor(state, args):
        return fire_band_update(state, args, dt0, 0.05)
    with pytest.raises(TypeError, match='closure'):
        body_key(holds_a_tensor)
