'''The port's bend (tscode_tpu_torch.bending) against the JAX package's,
float64 on the CPU, on the same fixture molecules: the bend energy and
its gradient within 1e-10, the relaxation on an external gradient within
1e-9, bent coordinates within 1e-6 A with the same pivots, the same
messages and the same outcome (reached, stuck, reverted, cached).'''

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from torch_parity import t64

from tscode_tpu import bending as jb
from tscode_tpu import ff as jff
from tscode_tpu.molecule import Molecule as JaxMolecule
from tscode_tpu.pivots import set_pivots as jax_set_pivots
from tscode_tpu_torch import bending as tb
from tscode_tpu_torch import ff as tff
from tscode_tpu_torch.molecule import Molecule as PortMolecule
from tscode_tpu_torch.pivots import set_pivots as port_set_pivots

FIX = os.path.join(os.path.dirname(__file__), 'fixtures')


def both_molecules(name, reactive):
    jm = JaxMolecule(os.path.join(FIX, name), reactive_indices=reactive)
    jm.compute_orbitals()
    jax_set_pivots(jm)
    pm = PortMolecule(os.path.join(FIX, name), reactive)
    pm.compute_orbitals()
    port_set_pivots(pm)
    return jm, pm


def pivot_table(mol, conf=0):
    return [(p.index, float(np.linalg.norm(p.pivot)))
            for p in mol.pivots[conf]]


def test_bend_energy_equals_the_jax_package():
    jm, pm = both_molecules('HCOOOH.xyz', [0, 4])
    pj = jff.build_ff_params(jm.atomcoords[0], jm.atomnos, jm.graph)
    rng = np.random.default_rng(31)
    X = jm.atomcoords[0] + rng.normal(size=(5, 6, 3)) * 0.15
    pairs, targets, k = np.array([[0, 4]]), np.array([2.1]), 80.0
    jargs = (jff.params_to_device(pj), jnp.asarray(pairs),
             jnp.asarray(targets), jnp.asarray(k))
    ej = np.asarray(jb._bend_energy(jnp.asarray(X), *jargs))
    gj = np.asarray(jax.grad(
        lambda c: jnp.sum(jb._bend_energy(c, *jargs)))(jnp.asarray(X)))
    x = t64(X).requires_grad_(True)
    et = tb._bend_energy(
        x, tff.params_to_device(pj, 'cpu', torch.float64),
        torch.as_tensor(pairs), t64(targets), t64(k))
    gt, = torch.autograd.grad(et.sum(), x)
    np.testing.assert_allclose(et.detach().numpy(), ej, rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-10, atol=1e-10)
    # bonds are stiffened beyond the plain force field's
    plain = tff.ff_energy(t64(X), tff.params_to_device(
        pj, 'cpu', torch.float64))
    assert (et.detach() > plain).all()


def test_relax_with_gradient_equals_the_jax_package():
    '''The external-gradient relaxation on a made-up surface (harmonic
    wells about a reference geometry) with the pair spring on top: the
    same coordinates from both packages, the pair pulled toward its
    target, and the same number of callback calls.'''
    rng = np.random.default_rng(32)
    ref = rng.normal(size=(6, 3)) * 1.5
    start = ref + rng.normal(size=ref.shape) * 0.1
    calls = {'jax': 0, 'port': 0}

    def surface(who):
        def gradient_fn(x):
            calls[who] += 1
            return 15.0 * float(np.sum((x - ref) ** 2)), 30.0 * (x - ref)
        return gradient_fn

    d0 = np.linalg.norm(start[0] - start[4])
    for kw in (dict(k=20.0), dict(k=200.0, n_steps=12, fmax=0.5, dt0=0.02)):
        calls.update(jax=0, port=0)
        cj = jb._relax_with_gradient(start, surface('jax'), (0, 4), d0 - 0.5,
                                     **kw)
        ct = tb._relax_with_gradient(start, surface('port'), (0, 4),
                                     d0 - 0.5, **kw)
        np.testing.assert_allclose(ct, cj, rtol=1e-9, atol=1e-9)
        assert calls['jax'] == calls['port'] > 5
        assert np.linalg.norm(ct[0] - ct[4]) < d0 - 0.05
        assert isinstance(ct, np.ndarray) and ct.dtype == np.float64


# name, reactive atoms, how far under its length the first pivot is asked
# to go, EZPROT, and what the bend comes to
BENDS = {
    'reached': ('HCOOH.xyz', [1, 4], 0.6, False, ()),
    'stuck': ('HCOOOH.xyz', [0, 4], 0.3, False, ('stuck',)),
    'reverted': ('HCOOOH.xyz', [0, 4], 0.6, False, ('stuck', 'scrambled')),
    'ezprot': ('C2H4.xyz', [0, 3], 0.3, True, ('stuck',)),
    'monomolecular': ('C2F2H4.xyz', [3, 5], 0.6, False, ()),
}


@pytest.mark.parametrize('case', list(BENDS))
def test_bend_molecule_equals_the_jax_package(case):
    name, reactive, delta, ezprot, messages = BENDS[case]
    jm, pm = both_molecules(name, reactive)
    assert pivot_table(pm) == pytest.approx(pivot_table(jm))
    before = pm.atomcoords.copy(), pivot_table(pm), list(pm.pivots)
    target = float(np.linalg.norm(jm.pivots[0][0].pivot)) - delta
    log_j, log_t, cache, stats = [], [], {}, {}
    bj = jb.bend_molecule(jm, 0, jm.pivots[0][0], target,
                          protect_double_bonds=ezprot,
                          logfunction=log_j.append)
    bt = tb.bend_molecule(pm, 0, pm.pivots[0][0], target,
                          protect_double_bonds=ezprot,
                          logfunction=log_t.append, cache=cache, stats=stats,
                          device='cpu')
    np.testing.assert_allclose(bt.atomcoords, bj.atomcoords, atol=1e-6,
                               rtol=0)
    assert [i for i, _ in pivot_table(bt)] == [i for i, _ in pivot_table(bj)]
    assert [n for _, n in pivot_table(bt)] == pytest.approx(
        [n for _, n in pivot_table(bj)], abs=1e-6)
    assert log_t == log_j
    assert [m for m in ('stuck', 'scrambled')
            if any(m in line for line in log_t)] == list(messages)
    reverted = 'scrambled' in messages
    assert (bt is pm) == (bj is jm) == reverted
    assert stats == {'bends': 1, 'relaxations': stats['relaxations'],
                     **({'reverts': 1} if reverted else {})}
    assert 0 < stats['relaxations'] <= 40
    # the input molecule is left as it was
    assert np.array_equal(pm.atomcoords, before[0])
    assert pivot_table(pm) == before[1]
    assert all(a is b for a, b in zip(pm.pivots, before[2]))
    if not reverted:
        assert bt.atomcoords is not pm.atomcoords
        assert bt.graph is pm.graph
        length = dict(pivot_table(bt))[pm.pivots[0][0].index]
        assert length < before[1][0][1] - 0.05
        if not messages:
            assert length <= target
    if ezprot:
        assert len(tff.build_ff_params(
            pm.atomcoords[0], pm.atomnos, pm.graph,
            protect_double_bonds=True).dihedrals) == 1

    # the same call again is answered by the cache with the same object
    again = tb.bend_molecule(pm, 0, pm.pivots[0][0], target,
                             protect_double_bonds=ezprot, cache=cache,
                             stats=stats, device='cpu')
    assert again is bt and stats['hits'] == 1 and stats['bends'] == 1
    assert list(cache) == [tb.bend_key(pm, pm.pivots[0][0], target)]
    assert tb.bend_key(pm, pm.pivots[0][0], target) == \
        jb.bend_key(jm, jm.pivots[0][0], target)


def test_bend_on_an_external_gradient_equals_the_jax_package():
    '''bend_molecule with a gradient callback in place of the force
    field (the shape of a calculator's): the harmonic surface about the
    input geometry.'''
    jm, pm = both_molecules('HCOOH.xyz', [1, 4])
    ref = jm.atomcoords[0].copy()

    def gradient_fn(x):
        return 25.0 * float(np.sum((x - ref) ** 2)), 50.0 * (x - ref)

    target = float(np.linalg.norm(jm.pivots[0][0].pivot)) - 1.5
    bj = jb.bend_molecule(jm, 0, jm.pivots[0][0], target, max_iter=4,
                          gradient_fn=gradient_fn)
    stats = {}
    bt = tb.bend_molecule(pm, 0, pm.pivots[0][0], target, max_iter=4,
                          gradient_fn=gradient_fn, stats=stats, device='cpu')
    np.testing.assert_allclose(bt.atomcoords, bj.atomcoords, atol=1e-6,
                               rtol=0)
    assert stats['relaxations'] == 4
    assert np.abs(bt.atomcoords[0] - ref).max() > 1e-3


def test_bend_of_a_later_conformer_keeps_the_others():
    '''Conformer 1 of a two-conformer ensemble is bent: conformer 0, its
    atoms and its pivots are the input molecule's own objects.'''
    rng = np.random.default_rng(33)
    _, pm = both_molecules('HCOOH.xyz', [1, 4])
    jm, _ = both_molecules('HCOOH.xyz', [1, 4])
    noisy = np.stack([pm.atomcoords[0],
                      pm.atomcoords[0] + rng.normal(size=(5, 3)) * 0.05])
    for mol, set_pivots in ((pm, port_set_pivots), (jm, jax_set_pivots)):
        mol.atomcoords = noisy.copy()
        mol.compute_orbitals()
        set_pivots(mol)
    target = float(np.linalg.norm(pm.pivots[1][0].pivot)) - 0.3
    bj = jb.bend_molecule(jm, 1, jm.pivots[1][0], target)
    bt = tb.bend_molecule(pm, 1, pm.pivots[1][0], target, device='cpu')
    np.testing.assert_allclose(bt.atomcoords, bj.atomcoords, atol=1e-6,
                               rtol=0)
    assert np.array_equal(bt.atomcoords[0], noisy[0])
    assert bt.pivots[0] is pm.pivots[0]
    assert bt.reactive_atoms[0] is pm.reactive_atoms[0]
    assert bt.pivots[1] is not pm.pivots[1]
    assert np.abs(bt.atomcoords[1] - noisy[1]).max() > 1e-2
