'''The force-field FIRE kernel's plain twin (tscode_tpu_torch.ops.kernels.
ff_fire) against the JAX package, float64 on the CPU, on the same numpy
inputs made from a seed: the analytic forces of the four energies that
fire_minimize_batch hands to the kernel within 1e-9 relative of jax.grad
and of torch.autograd, the relaxation's coordinates and stop flags
within 1e-9 A of the JAX fire_minimize_batch, and the routing of
fire_minimize_batch (the registered energies to the kernel on the card,
the others to the captured graph).'''

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
from tscode_tpu import optimization as jopt_stage
from tscode_tpu import optimizers as jopt
from tscode_tpu import scans as jscans
from tscode_tpu_torch import bending as tb
from tscode_tpu_torch import ff as tff
from tscode_tpu_torch import neb as tneb
from tscode_tpu_torch import optimization as topt_stage
from tscode_tpu_torch import optimizers as topt
from tscode_tpu_torch import scans as tscans
from tscode_tpu_torch.molecule import Molecule as PortMolecule
from tscode_tpu_torch.ops.kernels import ff_fire as kff
from tscode_tpu_torch.suite_inputs import chain_ff

FIX = os.path.join(os.path.dirname(__file__), 'fixtures')
RTOL = 1e-9          # forces, relative to the largest
FIRE_ATOL = 1e-9     # A, the plain twin's relaxation against the JAX scan


def fixture_params(name, protect=False):
    '''(coordinates, FFParams) of a fixture molecule; 'trimolecular' is
    CH3Cl + HCOOH + C2H4 merged into one topology, as the three-molecule
    routes relax them, 'three_hcooh' the 15-atom topology of the rigid
    three-molecule route's survivors.'''
    names = {'trimolecular': ('CH3Cl.xyz', 'HCOOH.xyz', 'C2H4.xyz'),
             'three_hcooh': ('HCOOH.xyz',) * 3}.get(name, (name,))
    mols = [PortMolecule(os.path.join(FIX, n)) for n in names]
    parts = [tff.build_ff_params(m.atomcoords[0], m.atomnos, m.graph,
                                 protect_double_bonds=protect) for m in mols]
    offsets = np.concatenate([[0], np.cumsum([m.n_atoms for m in mols])
                              [:-1]])
    coords = np.concatenate([m.atomcoords[0] + 3.0 * k
                             for k, m in enumerate(mols)])
    return coords, (parts[0] if len(parts) == 1
                    else tff.merge_ff_params(parts, offsets))


def empty_params():
    none2, none4 = np.zeros((0, 2), dtype=int), np.zeros((0, 4), dtype=int)
    return tff.FFParams(bonds=none2, bond_r0=np.zeros(0),
                        angles=np.zeros((0, 3), dtype=int),
                        angle_t0=np.zeros(0), nb_pairs=none2,
                        nb_r0=np.zeros(0), dihedrals=none4,
                        dihedral_t0=np.zeros(0))


def energy_case(energy, params, n_atoms):
    '''(JAX energy, its args, port energy, its args) of one of the four
    registered energies on the tables `params` (FFParams), with springs
    on pairs of the first atoms.'''
    jp = jff.params_to_device(jff.FFParams(**vars(params)))
    tp = tff.params_to_device(params, 'cpu', torch.float64)
    last = n_atoms - 1
    sp = np.array([[0, last], [1, last - 1]])
    st = np.array([2.2, 3.1])
    ncip = np.array([[0, last - 1], [2, last]])
    if energy == 'ff_energy':
        return jff.ff_energy, (jp,), tff.ff_energy, (tp,)
    if energy == 'bend':
        return (jb._bend_energy, (jp, jnp.asarray(sp[:1]),
                                  jnp.asarray(st[:1]), jnp.asarray(80.0)),
                tb._bend_energy, (tp, torch.as_tensor(sp[:1]),
                                  t64(st[:1]), t64(80.0)))
    if energy == 'scan_spring':
        return (jscans._ff_spring_energy, (jp, jnp.asarray(sp[1:]),
                                           jnp.asarray(st[1:])),
                tscans._ff_spring_energy, (tp, torch.as_tensor(sp[1:]),
                                           t64(st[1:])))
    return (jopt_stage._spacing_energy,
            (jp, jnp.asarray(sp), jnp.asarray(st), jnp.asarray(ncip),
             jnp.asarray(50.0), jnp.asarray(500.0)),
            topt_stage._spacing_energy,
            (tp, torch.as_tensor(sp), t64(st), torch.as_tensor(ncip),
             t64(50.0), t64(500.0)))


def jax_forces(energy_fn, X, args):
    return -np.asarray(jax.grad(lambda c: jnp.sum(energy_fn(c, *args)))(
        jnp.asarray(X)))


def autograd_forces(energy_fn, X, args):
    x = t64(X).requires_grad_(True)
    e = energy_fn(x, *args).sum()
    if not e.requires_grad:
        return np.zeros_like(X)
    return -torch.autograd.grad(e, x)[0].numpy()


def assert_forces(got, want):
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= RTOL * scale, \
        np.abs(got - want).max() / scale


ENERGIES = ('ff_energy', 'bend', 'scan_spring', 'spacing')
CASES = {'C2H4_dihedral': ('C2H4.xyz', True),
         'HCOOOH': ('HCOOOH.xyz', False),
         'C2F2H4': ('C2F2H4.xyz', True),
         'trimolecular': ('trimolecular', False),
         'empty_tables': None}


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('energy', ENERGIES)
def test_plain_forces_equal_jax_grad_and_autograd(energy, case):
    '''ff_forces_plain on the FireTerms each registered energy builds
    from its energy_args, against jax.grad of the JAX package's energy
    and torch.autograd of the port's, on jittered fixture structures
    (with and without E/Z dihedrals; empty force-field tables leave only
    the springs).'''
    rng = np.random.default_rng(10 * ENERGIES.index(energy)
                                + list(CASES).index(case))
    if CASES[case] is None:
        coords, params = rng.normal(size=(6, 3)) * 1.5, empty_params()
    else:
        coords, params = fixture_params(*CASES[case])
        if case == 'C2H4_dihedral':
            assert len(params.dihedrals) == 1
    X = coords + rng.normal(size=(4,) + coords.shape) * 0.15
    jfn, jargs, tfn, targs = energy_case(energy, params, len(coords))
    got = kff.ff_forces_plain(t64(X), tfn.fire_terms(*targs)).numpy()
    want = jax_forces(jfn, X, jargs)
    assert_forces(got, want)
    assert_forces(got, autograd_forces(tfn, X, targs))
    if CASES[case] is None and energy == 'ff_energy':
        assert not got.any()
    else:
        assert np.abs(got).max() > 1e-3


def clip_case(which):
    '''(coords (1, N, 3), FFParams) with one angle or one dihedral placed
    where a clip or a wrap decides.'''
    none2, none3 = np.zeros((0, 2), dtype=int), np.zeros((0, 3), dtype=int)
    base = dict(bonds=none2, bond_r0=np.zeros(0), angles=none3,
                angle_t0=np.zeros(0), nb_pairs=none2, nb_r0=np.zeros(0))
    if which.startswith('angle'):
        # the angle 0-1-2 a hair from linear: 1e-6 inside the clip's
        # cosine, or exactly linear (outside: no force)
        tilt = {'angle_inside_clip': 1.5e-3, 'angle_linear': 0.0}[which]
        X = np.array([[-1.1, 0., 0.], [0., 0., 0.], [1.3, 1.3 * tilt, 0.]])
        return X[None], tff.FFParams(**dict(base, angles=np.array(
            [[0, 1, 2]]), angle_t0=np.array([2.0])))
    # a dihedral 1e-6 rad short of +pi against a reference 0.3 rad past
    # -pi: the wrapped deviation is -0.3 - 1e-6, not 2 pi - 0.3
    phi = np.pi - 1e-6
    X = np.array([[1.0, 0.2, 0.], [0., 0., 0.], [0., 1.5, 0.],
                  [np.cos(phi), 1.6, -np.sin(phi)]])
    assert abs(tff._dihedral_np(X) - phi) < 1e-9
    return X[None], tff.FFParams(**dict(
        base, dihedrals=np.array([[0, 1, 2, 3]]),
        dihedral_t0=np.array([-np.pi + 0.3])))


@pytest.mark.parametrize('which', ['angle_inside_clip', 'angle_linear',
                                   'dihedral_near_pi'])
def test_plain_forces_where_a_clip_or_the_wrap_decides(which):
    X, params = clip_case(which)
    jfn, jargs, tfn, targs = energy_case('ff_energy', params, X.shape[1])
    got = kff.ff_forces_plain(t64(X), tfn.fire_terms(*targs)).numpy()
    want = jax_forces(jfn, X, jargs)
    assert_forces(got, autograd_forces(tfn, X, targs))
    if which == 'angle_linear':
        assert not got.any() and not want.any()
    else:
        assert_forces(got, want)
        assert np.abs(got).max() > 1e-3


def test_incidence_lists_each_atoms_terms_in_order():
    '''ff.incidence against the host's own listing, and built once per
    table set and atom count.'''
    _, params = fixture_params('C2H4.xyz', True)
    tp = tff.params_to_device(params, 'cpu', torch.float64)
    offsets, codes, pos = tff.incidence(tp, 6)
    tables = (params.bonds, params.angles, params.nb_pairs, params.dihedrals)
    want, base = {a: [] for a in range(6)}, 0
    for table in tables:
        for t, row in enumerate(table):
            for role, a in enumerate(row):
                want[int(a)].append(4 * (base + t) + role)
        base += len(table)
    got = {a: codes[offsets[a]:offsets[a + 1]].tolist() for a in range(6)}
    assert got == {a: sorted(w) for a, w in want.items()}
    assert offsets.dtype == codes.dtype == pos.dtype == torch.int32
    live = pos >= 0
    assert torch.equal(codes[pos[live].long()],
                       torch.arange(len(pos), dtype=torch.int32)[live])
    assert int(live.sum()) == len(codes)
    assert tff.incidence(tp, 6)[1] is codes
    assert len(tff.incidence(tp[:6], 6)[1]) == len(codes) - 4


FREEZE = {'none': None,
          'atoms': np.array([True, False, False, True, False, False]),
          'rows': np.random.default_rng(4).random((6, 6)) < 0.3}


@pytest.mark.parametrize('n_steps', [1, 10, 300])
@pytest.mark.parametrize('freeze', list(FREEZE))
def test_plain_fire_equals_the_jax_package(n_steps, freeze):
    '''ff_fire_plain against the JAX fire_minimize_batch on the force
    field: coordinates and stop flags after 1, 10 and 300 steps, without
    a freeze mask and with both of its shapes.'''
    coords, params = fixture_params('HCOOOH.xyz')
    rng = np.random.default_rng(21)
    X = coords + rng.normal(size=(6,) + coords.shape) * 0.25
    jfn, jargs, tfn, targs = energy_case('ff_energy', params, len(coords))
    mask = FREEZE[freeze]
    cj, _, dj = jopt.fire_minimize_batch(jnp.asarray(X), jfn,
                                         n_steps=n_steps, freeze_mask=mask,
                                         energy_args=jargs)
    c, done, steps = kff.ff_fire(t64(X), tfn.fire_terms(*targs), n_steps,
                                 freeze_mask=mask)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0,
                               atol=FIRE_ATOL)
    assert done.tolist() == np.asarray(dj).tolist()
    assert steps.max() <= n_steps and bool((steps[~done] == n_steps).all())
    if mask is not None:
        frozen = np.broadcast_to(mask, X.shape[:2])
        assert np.array_equal(c.numpy()[frozen], X[frozen])
    if n_steps == 300:
        assert np.asarray(dj).any()


@pytest.mark.parametrize('energy', ENERGIES[1:])
def test_plain_fire_of_each_energy_equals_the_jax_package(energy):
    '''ff_fire_plain on the springs of the bend, the scan point and
    adjust_spacings_batch (merged three-molecule tables), 300 steps.'''
    coords, params = fixture_params('trimolecular')
    rng = np.random.default_rng(22)
    X = coords + rng.normal(size=(3,) + coords.shape) * 0.1
    jfn, jargs, tfn, targs = energy_case(energy, params, len(coords))
    cj, _, dj = jopt.fire_minimize_batch(jnp.asarray(X), jfn, n_steps=300,
                                         energy_args=jargs)
    c, done, _ = kff.ff_fire(t64(X), tfn.fire_terms(*targs), 300)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0,
                               atol=FIRE_ATOL)
    assert done.tolist() == np.asarray(dj).tolist()
    assert np.abs(c.numpy() - X).max() > 1e-2


class OnCard(torch.Tensor):
    '''A CPU tensor that says it lies on the card: the routing tests'
    stand-in for a CUDA tensor.'''

    @property
    def is_cuda(self):
        return True


ROUTES = ('ff_energy', 'bend', 'scan_spring', 'spacing', 'idpp', 'lambda')


@pytest.mark.parametrize('energy', ROUTES)
def test_fire_minimize_batch_routes_the_registered_energies(monkeypatch,
                                                            energy):
    '''On a CUDA tensor the four registered energies reach ff_fire once a
    call, the others the captured graph; on the CPU every energy takes
    the eager loop.'''
    coords, params = fixture_params('HCOOOH.xyz')
    X = coords + np.random.default_rng(5).normal(size=(2,) + coords.shape) \
        * 0.1
    if energy == 'idpp':
        fn = tneb._idpp_energy
        args = (t64(np.full((2, 6, 6), 1.2)), t64(np.ones((2, 6, 6))))
    elif energy == 'lambda':
        def fn(c, center):
            return torch.sum((c - center) ** 2, dim=(-2, -1))
        args = (t64(coords),)
    else:
        _, _, fn, args = energy_case(energy, params, len(coords))
    calls = {'ff_fire': 0, 'graph': 0}

    def kernel(c, terms, n_steps, dt0, fmax, freeze_mask):
        calls['ff_fire'] += 1
        assert isinstance(terms, tff.FireTerms)
        return kff.ff_fire_plain(c.as_subclass(torch.Tensor), terms,
                                 n_steps, dt0, fmax, freeze_mask)

    def graph(*a):
        calls['graph'] += 1
        return topt.fire_run_eager(*a)

    monkeypatch.setattr(kff, 'ff_fire', kernel)
    monkeypatch.setattr(topt, 'fire_run_graph', graph)
    registered = energy not in ('idpp', 'lambda')
    assert hasattr(fn, 'fire_terms') == registered
    c, e, done = topt.fire_minimize_batch(t64(X).as_subclass(OnCard), fn,
                                          n_steps=20, energy_args=args)
    assert calls == ({'ff_fire': 1, 'graph': 0} if registered
                     else {'ff_fire': 0, 'graph': 1})
    assert c.shape == X.shape and e.shape == (2,) and done.shape == (2,)
    cpu = topt.fire_minimize_batch(t64(X), fn, n_steps=20, energy_args=args)
    assert calls['ff_fire'] + calls['graph'] == 1
    np.testing.assert_allclose(c.as_subclass(torch.Tensor).detach().numpy(),
                               cpu[0].numpy(), rtol=0, atol=1e-12)


def test_launch_plan_stages_the_term_forces_that_fit():
    '''The block form's plan: staged (a thread a term, the entries'
    forces in shared memory) while they fit beside the structure, at
    most MAX_THREADS threads; a thread an atom computing its terms past
    that.'''
    # the three-molecule topology, float64
    coords, params = fixture_params('trimolecular')
    n = len(coords)
    tp = tff.params_to_device(params, 'cpu', torch.float64)
    _, codes, _ = tff.incidence(tp, n)
    kinds = tuple(len(getattr(params, f)) for f in
                  ('bonds', 'angles', 'nb_pairs', 'dihedrals'))
    plan = kff.launch_plan(1, n, kinds, len(codes), 8, 'block')
    assert plan.staged and plan.threads == 32 * -(-max(n, sum(kinds)) // 32)
    assert plan.smem == (4 * 3 * n + 3 * len(codes)) * 8
    # 300 atoms and all their pairs: the entries do not fit
    plan = kff.launch_plan(1, 300, (0, 0, 44850, 0), 89700, 8, 'block')
    assert not plan.staged and plan.threads == kff.MAX_THREADS
    assert plan.smem == 4 * 3 * 300 * 8
    plan = kff.launch_plan(1, 5, (3, 0, 0, 0), 6, 4, 'block')
    assert (plan.staged, plan.threads, plan.smem) == (True, 32, (60 + 18) * 4)
    # the largest entry count that stages, and one more
    fit = (kff.SMEM_BYTES - 60 * 4) // 12
    assert kff.launch_plan(1, 5, (3, 0, 0, 0), fit, 4, 'block').staged
    plan = kff.launch_plan(1, 5, (3, 0, 0, 0), fit + 1, 4, 'block')
    assert (plan.staged, plan.threads, plan.smem) == (False, 32, 60 * 4)


def dense_chain_counts(n):
    '''(kinds, incidence entries) of an n-atom chain's force field whose
    repulsion table holds every pair at least 1-3 apart (ff.py), counted
    without building it: n - 1 bonds, about 2 n angles.'''
    bonds, angles = n - 1, 2 * n
    pairs = n * (n - 1) // 2 - bonds - angles
    return (bonds, angles, pairs, 0), 2 * bonds + 3 * angles + 2 * pairs


PLAN_CASES = {
    # the rigid three-molecule route's 24,417 survivors (phase 13)
    'batch_15_atoms': (24417, 'three_hcooh', 'warp'),
    # a bend's or a scan point's lone structure
    'one_15_atoms': (1, 'three_hcooh', 'lone'),
    # the conformer search's 32-atom chain, alone
    'one_32_atoms': (1, 32, 'lone'),
    # past the shared memory of one block: a cluster a structure
    'one_2500_atoms': (1, 2500, 'large'),
    'batch_2500_atoms': (8, 2500, 'large'),
    'one_5000_atoms': (1, 5000, 'large'),
    # past one block's copy of the coordinates: device memory
    'one_20000_atoms': (1, 20000, 'large')}


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('case', list(PLAN_CASES))
def test_launch_plan_picks_the_form(case, dtype):
    '''launch_plan's rule at the shapes the routes launch and past the
    block form's size limit: the lone form for one structure (its warps
    each on terms of one kind; N <= 32: one warp sums the atoms), the
    batch form from BATCH_MIN_ROWS structures, and the large form, which
    refuses no size, where a structure's state does not fit a block (the
    block form raises past its four arrays of 3 N values, ~2,410 atoms
    in float64, as its launch did).'''
    B, what, form = PLAN_CASES[case]
    itemsize = torch.finfo(dtype).bits // 8
    if isinstance(what, str):
        coords, params = fixture_params(what)
        n = len(coords)
        kinds = tuple(len(getattr(params, f)) for f in
                      ('bonds', 'angles', 'nb_pairs', 'dihedrals'))
        tp = tff.params_to_device(params, 'cpu', torch.float64)
        entries = len(tff.incidence(tp, n)[1])
    elif what <= 32:
        _, params = chain_ff(what, 1)
        n = what
        kinds = tuple(len(getattr(params, f)) for f in
                      ('bonds', 'angles', 'nb_pairs', 'dihedrals'))
        entries = 2 * (kinds[0] + kinds[2]) + 3 * kinds[1]
    else:
        n = what
        kinds, entries = dense_chain_counts(n)
    plan = kff.launch_plan(B, n, kinds, entries, itemsize)
    assert plan.form == form
    assert plan.smem <= kff.SMEM_BYTES and plan.threads % 32 == 0
    if form == 'lone':
        lo, slots = plan.slots
        # each kind from a multiple of 32: no warp holds two kinds
        assert all(x % 32 == 0 for x in lo) and slots % 32 == 0
        assert plan.groups == 1 and plan.threads == 32 * plan.warps
        assert plan.warps == min(slots // 32, kff.LONE_WARPS)
        assert plan.smem == (3 * n + 3 * entries) * itemsize   # n <= 32
    elif form == 'large':
        assert plan.cluster == min(kff.MAX_CLUSTER,
                                   -(-n // kff.ATOMS_A_BLOCK))
        # a thread an atom, in whole warps, up to LARGE_THREADS a block
        per_block = -(-n // plan.cluster)
        assert plan.threads == min(32 * -(-per_block // 32),
                                   kff.LARGE_THREADS)
        # each block's copy of the coordinates where it fits
        fits = 3 * n * itemsize <= kff.SMEM_BYTES
        assert plan.staged == fits
        assert plan.smem == (3 * n * itemsize if fits else 0)
        if 12 * n * itemsize > kff.SMEM_BYTES:
            with pytest.raises(ValueError):
                kff.launch_plan(B, n, kinds, entries, itemsize, 'block')
    else:
        assert B >= kff.BATCH_MIN_ROWS
    if B < kff.BATCH_MIN_ROWS and form != 'large':
        assert kff.launch_plan(kff.BATCH_MIN_ROWS, n, kinds, entries,
                               itemsize).form == 'warp'


# resident warps an SM under each plan (the lone form by its warps a
# structure, 'warp' the warp form), as the H100 gave them in phase 13's
# sweeps (chip_smoke.py fire_size_sweep), and the plan the rule takes
RESIDENT_CASES = {
    # the widths that keep 16 warps: the narrowest
    'narrowest_of_16': (1024, 32, 8, {1: 4, 2: 8, 4: 16, 8: 16, 16: 16,
                                      'warp': 8}, ('lone', 4)),
    # one structure's shared memory a block an SM: the widest
    'most_below_16': (1024, 74, 8, {1: 1, 2: 2, 4: 4, 8: 8, 16: 16,
                                    'warp': 1}, ('lone', 16)),
    'float32_two_blocks': (1024, 74, 4, {1: 3, 2: 6, 4: 12, 8: 16,
                                         16: 16, 'warp': 3}, ('lone', 8)),
    # a width past 16 resident warps gains nothing over 16
    'capped_at_16': (1024, 24, 4, {1: 4, 2: 8, 4: 16, 8: 16, 10: 20,
                                   'warp': 8}, ('lone', 4)),
    # the warp form keeps more warps resident: it takes the batch
    'warp_keeps_more': (1024, 'three_hcooh', 8, {1: 5, 2: 10, 3: 15,
                                                 'warp': 24}, ('warp', 1)),
    # as many: the lone form
    'warp_ties': (8192, 32, 4, {1: 4, 2: 8, 4: 16, 8: 16, 16: 16,
                                'warp': 16}, ('lone', 4)),
    # below BATCH_MIN_ROWS the full width, whatever the occupancy
    'few_rows': (512, 32, 8, {1: 4, 2: 8, 4: 16, 8: 16, 16: 1,
                              'warp': 99}, ('lone', 16))}


@pytest.mark.parametrize('case', list(RESIDENT_CASES))
def test_launch_plan_weighs_resident_warps(case):
    '''launch_plan with the card's resident warps (plan_for's
    `resident`): from BATCH_MIN_ROWS structures the lone form narrows to
    the narrowest width that keeps LONE_RESIDENT_WARPS warps resident
    (else the one that keeps the most), and the warp form takes the
    batch only where its block holds WARP_GROUPS structures and keeps
    more warps resident than that.'''
    B, what, itemsize, table, want = RESIDENT_CASES[case]
    if isinstance(what, str):
        coords, params = fixture_params(what)
    else:
        coords, params = chain_ff(what, 1)
        coords = coords[0]
    n = len(coords)
    kinds = tuple(len(getattr(params, f)) for f in
                  ('bonds', 'angles', 'nb_pairs', 'dihedrals'))
    tp = tff.params_to_device(params, 'cpu', torch.float64)
    entries = len(tff.incidence(tp, n)[1])
    widths = [p.warps for p in kff.lone_widths(n, kinds, entries, itemsize)]
    assert set(table) == set(widths) | {'warp'}

    def resident(plan):
        return table['warp' if plan.form == 'warp' else plan.warps]

    plan = kff.launch_plan(B, n, kinds, entries, itemsize, resident=resident)
    assert (plan.form, plan.warps) == want
    assert plan.threads == 32 * plan.warps * plan.groups
    assert plan.smem <= kff.SMEM_BYTES
    # the form asked for by name: the lone form at the rule's width
    if want[0] == 'lone':
        assert kff.launch_plan(B, n, kinds, entries, itemsize, 'lone',
                               resident) == plan


def test_plain_fire_equals_the_jax_package_on_a_long_chain():
    '''ff_fire_plain against the JAX fire_minimize_batch on a 122-atom
    chain (7,020 repulsion pairs), past the fixtures' sizes: 20 steps,
    float64, within 1e-6 A, the same stops.'''
    X, params = chain_ff(122, 2, seed=3, noise=0.1)
    jfn, jargs, tfn, targs = energy_case('ff_energy', params, X.shape[1])
    cj, _, dj = jopt.fire_minimize_batch(jnp.asarray(X), jfn, n_steps=20,
                                         energy_args=jargs)
    c, done, steps = kff.ff_fire(t64(X), tfn.fire_terms(*targs), 20)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0,
                               atol=1e-6)
    assert done.tolist() == np.asarray(dj).tolist()
    assert bool((steps[~done] == 20).all())
    assert np.abs(c.numpy() - X).max() > 1e-2
