'''The contracts that N1's and I1's redesigns rest on, float64 on the CPU:
the IDPP tables are symmetric to the bit and equal to the JAX package's
(so reading one ordering of each pair, the column, gives the bits of
reading both: idpp_forces_plain against the two-sided form), the wrappers
refuse an asymmetric table, N1's entry layout (each term once, its
vectors term-major, each atom's entries added in incidence order) gives
ff_forces_plain's bits, and both plans' forms, blocks and shared bytes
on the four bands that chip_smoke.py times (phase 19's ring, HCOOH,
150- and 2,500-atom chains).'''

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_neb_kernel import band_case, endpoints, port_terms
from torch_parity import dimer_case, t64

from tscode_tpu import neb as jneb
from tscode_tpu import optimizers as jopt
from tscode_tpu_torch import neb
from tscode_tpu_torch.ops.kernels import ff_fire as kf
from tscode_tpu_torch.ops.kernels import idpp as ki
from tscode_tpu_torch.ops.kernels import neb as kn
from tscode_tpu_torch.suite_inputs import chain_ff

BANDS = ['ring', 'hcooh', 'c2f2h4', 'chain150']


def band_ends(name):
    '''(start, end, ff.FFParams): the SADDLE scan's sub-peak guesses 0
    and 1 of the nine-carbon ring (phase 19's band), the fixtures of
    test_torch_neb_kernel, two conformers of the 150-atom chain_ff chain
    (seed 13).'''
    if name == 'ring':
        a, params = dimer_case('ring', 0)
        return a, dimer_case('ring', 1)[0], params
    if name == 'chain150':
        X, params = chain_ff(150, 2, seed=13)
        return X[0], X[1], params
    return endpoints(name)


def jax_tables(start, end, n_images, monkeypatch):
    '''The targets and weights that the JAX package's idpp_interpolate
    builds inline (tscode_tpu/neb.py:35-57), caught where it hands them
    to fire_minimize_batch.'''
    got = {}

    def catch(chain, energy, n_steps, freeze_mask, energy_args):
        got['tables'] = [np.asarray(t) for t in energy_args]
        return chain, None, None
    monkeypatch.setattr(jopt, 'fire_minimize_batch', catch)
    jneb.idpp_interpolate(start, end, n_images)
    return got['tables']


@pytest.mark.parametrize('name', BANDS)
def test_idpp_tables_symmetric_and_the_jax_packages(name, monkeypatch):
    '''neb.idpp_tables on the 7-image linear band: both tables equal
    their transposes to the bit, the diagonal weight 0, and both equal
    the JAX package's inline tables to the bit.'''
    a, b, _ = band_ends(name)
    chain = neb.interpolate_chain(a, b, 7)
    targets, weights = neb.idpp_tables(chain)
    for t in (targets, weights):
        assert np.array_equal(t, t.transpose(0, 2, 1))
    assert not weights[:, np.arange(len(a)), np.arange(len(a))].any()
    jt, jw = jax_tables(a, b, 7, monkeypatch)
    assert np.array_equal(targets, jt) and np.array_equal(weights, jw)


def two_sided_forces(chain, targets, weights):
    '''PR 22's idpp_forces_plain: a pair's row and column of both
    tables, w_aj (d - t_aj) + w_ja (d - t_ja).'''
    diff = chain[:, :, None, :] - chain[:, None, :, :]
    dx, dy, dz = diff.unbind(-1)
    d = torch.sqrt(dx * dx + dy * dy + dz * dz + ki.D_EPS)
    wt, tt = weights.transpose(1, 2), targets.transpose(1, 2)
    g = 2 * (weights * (d - targets) + wt * (d - tt)) / d
    eye = torch.eye(chain.shape[1], dtype=torch.bool)
    g = torch.where(eye, 0.0, g)
    return -torch.cumsum(g[..., None] * diff, dim=2)[:, :, -1]


@pytest.mark.parametrize('name', BANDS)
def test_idpp_column_forces_equal_the_two_sided_form(name):
    '''idpp_forces_plain (the column's values read for both orderings of
    a pair) gives the two-sided form's bits on the symmetric tables, on
    the linear band and on the band jittered by 0.05 A (seed 4), and the
    twin takes 20 FIRE steps at fmax 0.'''
    a, b, _ = band_ends(name)
    chain = neb.interpolate_chain(a, b, 7)
    targets, weights = (t64(t) for t in neb.idpp_tables(chain))
    x = t64(chain)
    jit = x + t64(np.random.default_rng(4).normal(size=chain.shape) * 0.05)
    for c in (x, jit):
        assert torch.equal(ki.idpp_forces_plain(c, targets, weights),
                           two_sided_forces(c, targets, weights))
    got = ki.idpp_fire_plain(x, targets, weights, 20, fmax=0.0)
    assert got[2].tolist() == [20] * 7
    assert torch.isfinite(got[0]).all()


@pytest.mark.parametrize('table', ['targets', 'weights'])
def test_idpp_wrappers_refuse_an_asymmetric_table(table):
    '''One entry of one image off its mirror by 1e-12: ValueError from
    idpp_fire (the CPU twin's route) and from launch, before anything
    reaches a card; check_symmetric passes the tables idpp_tables
    builds.'''
    a, b, _ = band_ends('hcooh')
    chain = neb.interpolate_chain(a, b, 5)
    tables = {k: t64(t) for k, t in zip(('targets', 'weights'),
                                        neb.idpp_tables(chain))}
    ki.check_symmetric(tables['targets'], tables['weights'])
    tables[table][2, 0, 3] += 1e-12
    for call in (ki.idpp_fire, ki.launch, ki.launch_v1):
        with pytest.raises(ValueError, match='symmetric'):
            call(t64(chain), tables['targets'], tables['weights'], 10)


@pytest.mark.parametrize('name', ['hcooh', 'c2f2h4', 'c2h4', 'ring6',
                                  'chain12', 'ring'])
def test_entry_forces_plain_equal_ff_forces_plain(name):
    '''N1's entry layout in plain PyTorch: entry_forces_plain (each term's
    forces once, term-major, a pair term's on its first atom alone; each
    atom's incidence entries added in order, the second atom of a pair
    its negation) equals ff_forces_plain's term sums to the bit on the
    7-image IDPP band of each fixture (C2H4 with its E/Z dihedral);
    entry_sources points each entry at a vector of its own term.'''
    if name == 'ring':
        a, b, params = band_ends('ring')
        chain = neb.interpolate_chain(a, b, 7)
    else:
        chain, params = band_case(name, 7)
    terms = port_terms(params)
    x = t64(chain)
    assert torch.equal(kn.entry_forces_plain(x, terms),
                       kf.ff_forces_plain(x, terms))
    N = x.shape[1]
    src = kn.entry_sources(terms.params, N).long()
    codes = kn.incidence(terms.params, N)[1].long()
    kinds = kn.term_kinds(terms)[:4]
    assert src.numel() == codes.numel() == kn.n_entries(kinds + (0, 0))
    vec = src >> 1
    assert int(vec.max()) < kinds[0] + 3 * kinds[1] + kinds[2] + \
        4 * kinds[3]
    assert bool(((src & 1 == 1) <= (codes & 3 == 1)).all())


@pytest.mark.parametrize('name', ['ring', 'hcooh', 'chain150', 'chain2500'])
def test_redesign_plans_on_the_timed_bands(name):
    '''The rule's plans on chip_smoke's four NEB bands (7 images):
    N1 large on 5 blocks for the ring (its arrays, entry arrays and
    tables in shared memory), lone for HCOOH, grid for both chains; I1
    lone for the ring and HCOOH, cluster for the chains (2 and 16
    blocks); every plan's shared bytes within 227 KB; the forms on
    request fit or are refused.'''
    if name == 'chain2500':
        X, params = chain_ff(2500, 2, seed=13)
        terms = port_terms(params)
        N = 2500
    else:
        a, _, params = band_ends(name)
        terms, N = port_terms(params), len(a)
    kinds = kn.term_kinds(terms)
    plan = kn.launch_plan(7, N, kinds)
    want = {'ring': ('large', 5), 'hcooh': ('lone', 1),
            'chain150': ('grid', None), 'chain2500': ('grid', 132)}[name]
    assert plan.form == want[0]
    if want[1] is not None:
        assert plan.cluster == want[1]
    if name == 'ring':
        assert plan.shared and plan.staged
    for form in kn.FORMS:
        try:
            p = kn.launch_plan(7, N, kinds, form)
        except ValueError:
            assert form == 'lone'
            continue
        assert p.smem <= kn.SMEM_BYTES <= 232448
    ip = ki.launch_plan(N)
    assert (ip.form, ip.cluster) == {
        'ring': ('lone', 1), 'hcooh': ('lone', 1),
        'chain150': ('cluster', 2), 'chain2500': ('cluster', 16)}[name]
    assert ip.smem <= 232448 and ip.threads * ip.cluster >= N
    assert ip.threads % 32 == 0 and ip.threads <= ki.MAX_THREADS
