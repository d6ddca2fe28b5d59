'''The port's force field and FIRE minimiser (tscode_tpu_torch.ff,
tscode_tpu_torch.optimizers) against the JAX package's, float64 on the
CPU, on the same numpy inputs made from a seed: energies and gradients
within 1e-10, FIRE states within 1e-9.'''

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from torch_parity import t64

from tscode_tpu import ff as jff
from tscode_tpu import neb as jneb
from tscode_tpu import optimizers as jopt
from tscode_tpu.molecule import Molecule as JaxMolecule
from tscode_tpu_torch import ff as tff
from tscode_tpu_torch import optimizers as topt
from tscode_tpu_torch.molecule import Molecule as PortMolecule

FIX = os.path.join(os.path.dirname(__file__), 'fixtures')
FIELDS = ('bonds', 'bond_r0', 'angles', 'angle_t0', 'nb_pairs', 'nb_r0',
          'dihedrals', 'dihedral_t0')
TERMS = {'bonds': ('bonds', 'bond_r0'), 'angles': ('angles', 'angle_t0'),
         'repulsion': ('nb_pairs', 'nb_r0'),
         'dihedrals': ('dihedrals', 'dihedral_t0')}
N_ATOMS = 9


def synthetic_params(rng, keep=tuple(TERMS)):
    '''FFParams of a made-up 9-atom topology, as numpy arrays; the terms
    not in `keep` get empty tables. Repulsion onsets are long enough
    that some pairs overlap and some do not.'''
    def table(n, width):
        return np.array([rng.choice(N_ATOMS, size=width, replace=False)
                         for _ in range(n)])

    full = dict(bonds=table(8, 2), bond_r0=rng.uniform(1.0, 1.6, 8),
                angles=table(10, 3), angle_t0=rng.uniform(1.5, 2.2, 10),
                nb_pairs=table(12, 2), nb_r0=rng.uniform(1.5, 3.5, 12),
                dihedrals=table(4, 4), dihedral_t0=rng.uniform(-3, 3, 4))
    for term, (idx, val) in TERMS.items():
        if term not in keep:
            full[idx] = np.zeros((0, full[idx].shape[1]), dtype=int)
            full[val] = np.zeros(0)
    return full


def both_params(fields):
    return (jff.params_to_device(jff.FFParams(**fields)),
            tff.params_to_device(tff.FFParams(**fields), 'cpu',
                                 torch.float64))


def jax_energy_gradient(energy_fn, X, *args):
    e = energy_fn(jnp.asarray(X), *args)
    g = jax.grad(lambda c: jnp.sum(energy_fn(c, *args)))(jnp.asarray(X))
    return np.asarray(e), np.asarray(g)


def port_energy_gradient(energy_fn, X, *args):
    x = t64(X).requires_grad_(True)
    e = energy_fn(x, *args)
    if not e.requires_grad:          # no term: jax.grad gives zeros too
        return e.numpy(), np.zeros_like(X)
    g, = torch.autograd.grad(e.sum(), x)
    return e.detach().numpy(), g.numpy()


@pytest.mark.parametrize('keep', [('bonds',), ('angles',), ('repulsion',),
                                  ('dihedrals',),
                                  ('bonds', 'angles', 'repulsion'),
                                  tuple(TERMS), ()],
                         ids=['bonds', 'angles', 'repulsion', 'dihedrals',
                              'no_dihedrals', 'all', 'empty'])
@pytest.mark.parametrize('batch', [(), (7,), (2, 3)],
                         ids=['single', 'batch', 'batch2d'])
def test_ff_energy_and_gradient_equal_the_jax_package(keep, batch):
    rng = np.random.default_rng(5)
    jp, tp = both_params(synthetic_params(rng, keep))
    X = rng.normal(size=batch + (N_ATOMS, 3)) * 1.5
    ej, gj = jax_energy_gradient(jff.ff_energy, X, jp)
    et, gt = port_energy_gradient(tff.ff_energy, X, tp)
    assert et.shape == batch
    np.testing.assert_allclose(et, ej, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gt, gj, rtol=1e-10, atol=1e-10)
    if keep:
        assert np.abs(gj).max() > 1e-3
    else:
        assert not et.any() and not gj.any()
        assert not topt.forces(t64(X).reshape(-1, N_ATOMS, 3),
                               tff.ff_energy, (tp,)).any()


def test_ff_energy_takes_six_tables_without_dihedrals():
    rng = np.random.default_rng(6)
    jp, tp = both_params(synthetic_params(rng))
    X = rng.normal(size=(4, N_ATOMS, 3)) * 1.5
    ej, gj = jax_energy_gradient(jff.ff_energy, X, jp[:6])
    et, gt = port_energy_gradient(tff.ff_energy, X, tp[:6])
    np.testing.assert_allclose(et, ej, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gt, gj, rtol=1e-10, atol=1e-10)
    assert np.abs(et - port_energy_gradient(tff.ff_energy, X, tp)[0]).max() \
        > 1e-3


def fixture_params(name, protect):
    jm = JaxMolecule(os.path.join(FIX, name))
    pm = PortMolecule(os.path.join(FIX, name))
    return (jm, jff.build_ff_params(jm.atomcoords[0], jm.atomnos, jm.graph,
                                    protect_double_bonds=protect),
            tff.build_ff_params(pm.atomcoords[0], pm.atomnos, pm.graph,
                                protect_double_bonds=protect))


@pytest.mark.parametrize('name,protect,n_dihedrals',
                         [('C2H4.xyz', True, 1), ('C2H4.xyz', False, 0),
                          ('HCOOOH.xyz', True, 0), ('HCOOH.xyz', False, 0),
                          ('C2F2H4.xyz', True, 0)])
def test_build_ff_params_equal_the_jax_package(name, protect, n_dihedrals):
    jm, pj, pt = fixture_params(name, protect)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    assert len(pt.dihedrals) == n_dihedrals and len(pt.bonds) > 0
    rng = np.random.default_rng(8)
    X = jm.atomcoords[0] + rng.normal(size=(5,) + jm.atomcoords[0].shape) * .1
    ej, gj = jax_energy_gradient(jff.ff_energy, X, jff.params_to_device(pj))
    et, gt = port_energy_gradient(
        tff.ff_energy, X, tff.params_to_device(pt, 'cpu', torch.float64))
    np.testing.assert_allclose(et, ej, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gt, gj, rtol=1e-10, atol=1e-10)
    # the geometry the tables were made from is the minimum
    e0, g0 = port_energy_gradient(
        tff.ff_energy, jm.atomcoords[0],
        tff.params_to_device(pt, 'cpu', torch.float64))
    assert abs(float(e0)) < 1e-12 and np.abs(g0).max() < 1e-6


def test_params_to_device_dtypes():
    _, _, pt = fixture_params('C2H4.xyz', True)
    for dtype in (torch.float64, torch.float32):
        arrays = tff.params_to_device(pt, 'cpu', dtype)
        assert [a.dtype for a in arrays] == [torch.int64, dtype] * 4
        assert all(a.device.type == 'cpu' for a in arrays)


def test_merge_ff_params_equal_the_jax_package():
    parts = [fixture_params(n, True)
             for n in ('CH3Cl.xyz', 'HCOOH.xyz', 'C2H4.xyz')]
    offsets = np.concatenate([[0], np.cumsum(
        [len(p[0].atomnos) for p in parts])[:-1]])
    mj = jff.merge_ff_params([p[1] for p in parts], offsets)
    mt = tff.merge_ff_params([p[2] for p in parts], offsets)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
    assert len(mt.bonds) == sum(len(p[2].bonds) for p in parts)
    assert mt.dihedrals.tolist() == (parts[2][2].dihedrals
                                     + offsets[2]).tolist()
    # the merged energy is the sum of the parts' energies
    rng = np.random.default_rng(9)
    X = [p[0].atomcoords[0] + rng.normal(size=p[0].atomcoords[0].shape) * .1
         for p in parts]
    whole = tff.ff_energy(t64(np.concatenate(X)), tff.params_to_device(
        mt, 'cpu', torch.float64))
    apart = sum(tff.ff_energy(t64(x), tff.params_to_device(
        p[2], 'cpu', torch.float64)) for x, p in zip(X, parts))
    assert abs(float(whole - apart)) < 1e-10 and float(whole) > 0.1


def test_gradient_at_the_clips():
    '''What each package gives where a clip decides. An exactly linear
    angle: its cosine lies outside the clip, the angle takes the clipped
    value and sends no force, in both. A pair exactly at its repulsion
    onset: no overlap, no energy and no force, in both (there the two
    autograd rules differ, half against the whole gradient of the clip,
    but the factor 2 * overlap is zero).'''
    X = np.array([[-1.1, 0., 0.], [0., 0., 0.], [1.3, 0., 0.]])
    none2, none3 = np.zeros((0, 2), dtype=int), np.zeros((0, 3), dtype=int)
    angle = dict(bonds=none2, bond_r0=np.zeros(0),
                 angles=np.array([[0, 1, 2]]), angle_t0=np.array([2.0]),
                 nb_pairs=none2, nb_r0=np.zeros(0))
    pair = dict(bonds=none2, bond_r0=np.zeros(0), angles=none3,
                angle_t0=np.zeros(0), nb_pairs=np.array([[0, 2]]),
                nb_r0=np.array([2.4]))
    for fields, energy in ((angle, tff.K_ANGLE * (
            np.arccos(-1 + 1e-9) - 2.0) ** 2), (pair, 0.0)):
        jp, tp = both_params(fields)
        ej, gj = jax_energy_gradient(jff.ff_energy, X, jp)
        et, gt = port_energy_gradient(tff.ff_energy, X, tp)
        assert abs(float(et) - energy) < 1e-12
        assert abs(float(ej) - energy) < 1e-12
        assert not gj.any() and not gt.any()


def test_spring_energy_equals_the_jax_package():
    rng = np.random.default_rng(10)
    X = rng.normal(size=(6, N_ATOMS, 3)) * 1.5
    pairs = np.array([[0, 4], [2, 7], [1, 8]])
    targets = rng.uniform(1, 3, 3)
    ej, gj = jax_energy_gradient(jopt.spring_energy, X, jnp.asarray(pairs),
                                 jnp.asarray(targets), 7.0)
    et, gt = port_energy_gradient(topt.spring_energy, X,
                                  torch.as_tensor(pairs), t64(targets), 7.0)
    np.testing.assert_allclose(et, ej, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gt, gj, rtol=1e-10, atol=1e-10)
    empty = topt.spring_energy(t64(X), torch.zeros((0, 2), dtype=torch.long),
                               t64(np.zeros(0)))
    assert empty.shape == (6,) and not empty.any()
    assert not np.asarray(jopt.spring_energy(
        jnp.asarray(X), jnp.zeros((0, 2), dtype=int), jnp.zeros(0))).any()


# ----------------------------------------------------------------- FIRE


def jax_fire_state(monkeypatch, X, n_steps, freeze_mask, jp, **kw):
    '''The six state fields the JAX package's fire_minimize_batch ends
    its scan with, and what it returns: its un-jitted body run on
    concrete arrays, with lax.scan's final carry kept.'''
    kept = {}
    scan = jax.lax.scan

    def spy(body, init, xs, length):
        carry, ys = scan(body, init, xs, length=length)
        kept['state'] = carry
        return carry, ys

    monkeypatch.setattr(jax.lax, 'scan', spy)
    out = jopt.fire_minimize_batch.__wrapped__(
        jnp.asarray(X), jff.ff_energy, n_steps=n_steps,
        freeze_mask=freeze_mask, energy_args=(jp,), **kw)
    monkeypatch.undo()
    return [np.asarray(s) for s in kept['state']], \
        [np.asarray(o) for o in out]


def fire_fixture(jitter, batch=6, seed=21):
    jm, pj, pt = fixture_params('HCOOOH.xyz', False)
    rng = np.random.default_rng(seed)
    X = jm.atomcoords[0] + \
        rng.normal(size=(batch,) + jm.atomcoords[0].shape) * jitter
    return X, jff.params_to_device(pj), tff.params_to_device(
        pt, 'cpu', torch.float64)


FREEZE = {'none': None,
          'atoms': np.array([True, False, False, True, False, False]),
          'rows': np.random.default_rng(4).random((6, 6)) < 0.3}


@pytest.mark.parametrize('n_steps', [1, 10, 300])
@pytest.mark.parametrize('freeze', list(FREEZE))
def test_fire_state_equals_the_jax_package(monkeypatch, n_steps, freeze):
    '''All six fields of the FIRE state after 1, 10 and 300 steps from
    the same start, without a freeze mask and with both of its shapes;
    at 0.25 A of jitter no row has stopped after 10 steps and rows have
    after 300.'''
    X, jp, tp = fire_fixture(0.25)
    mask = FREEZE[freeze]
    want, (cj, ej, dj) = jax_fire_state(monkeypatch, X, n_steps, mask, jp)
    got = topt.fire_run(t64(X), tff.ff_energy, n_steps, freeze_mask=mask,
                        energy_args=(tp,))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-9)
    c, e, done = topt.fire_minimize_batch(
        t64(X), tff.ff_energy, n_steps=n_steps, freeze_mask=mask,
        energy_args=(tp,))
    np.testing.assert_allclose(c.numpy(), cj, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(e.numpy(), ej, rtol=1e-9, atol=1e-9)
    assert done.numpy().tolist() == dj.tolist()
    if mask is not None:
        frozen = np.broadcast_to(mask, X.shape[:2])
        assert np.array_equal(c.numpy()[frozen], X[frozen])
    if n_steps == 300:
        assert dj.any()
    if n_steps == 10:
        assert not dj.any() and np.abs(cj - X).max() > 1e-3


def test_fire_state_after_every_row_has_stopped(monkeypatch):
    '''Every row stops long before the last step (0.02 A of jitter): the
    port's CPU loop ends there and sets the controls that the remaining
    steps would leave, dt halved once a step; the JAX package's scan
    runs them all.'''
    X, jp, tp = fire_fixture(0.02)
    want, _ = jax_fire_state(monkeypatch, X, 300, None, jp)
    assert want[5].all()
    calls = []
    forces = topt.forces
    monkeypatch.setattr(topt, 'forces',
                        lambda *a: calls.append(1) or forces(*a))
    got = topt.fire_run(t64(X), tff.ff_energy, 300, energy_args=(tp,))
    assert 0 < len(calls) < 300
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-300)
    assert 0 < float(got[2].max()) < 1e-20 and int(got[4].max()) == 0


def test_fire_takes_other_steps_and_thresholds(monkeypatch):
    X, jp, tp = fire_fixture(0.25)
    want, _ = jax_fire_state(monkeypatch, X, 80, None, jp, dt0=0.02,
                             fmax=5.0)
    got = topt.fire_run(t64(X), tff.ff_energy, 80, dt0=0.02, fmax=5.0,
                        energy_args=(tp,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-9)
    assert want[5].any()


def test_fire_minimize_single_structure():
    X, jp, tp = fire_fixture(0.1, batch=1)
    cj, ej, dj = jopt.fire_minimize(X[0], jff.ff_energy, n_steps=300,
                                    energy_args=(jp,))
    ct, et, dt = topt.fire_minimize(X[0], tff.ff_energy, n_steps=300,
                                    energy_args=(tp,), device='cpu')
    np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=1e-9)
    assert abs(et - ej) < 1e-9 and dt == dj and isinstance(ct, np.ndarray)


def test_fire_band_update_equals_the_jax_package():
    '''The single-band integrator (scalar controls, time step at most
    4 dt0, 0.05 A displacement cap) over 30 steps of made-up forces that
    shrink, turn uphill now and then and end under fmax.'''
    rng = np.random.default_rng(12)
    c0 = rng.normal(size=(5, 6, 3))
    js = jneb._fire_init(jnp.asarray(c0), jnp.asarray(0.05))
    ts = topt.fire_band_init(t64(c0), torch.tensor(0.05, dtype=torch.float64))
    stopped = []
    for step in range(30):
        f = rng.normal(size=c0.shape) * 3.0 * 0.8 ** step
        if step % 7 == 3:
            f = -np.asarray(js[1]) - 0.1 * f          # against the velocity
        js = jneb._fire_band_update(js, jnp.asarray(f), jnp.asarray(0.05),
                                    jnp.asarray(0.05))
        ts = topt.fire_band_update(ts, t64(f), torch.tensor(
            0.05, dtype=torch.float64), 0.05)
        for g, w in zip(ts, js):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-9)
        stopped.append(bool(ts[5]))
    assert not stopped[0] and stopped[-1]
    assert float(ts[2]) <= 0.2 + 1e-12
