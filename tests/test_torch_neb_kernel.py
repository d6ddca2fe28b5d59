'''The NEB band kernel's and the IDPP kernel's plain twins
(tscode_tpu_torch.ops.kernels.neb, .idpp) and the force field's plain
energy (ops/kernels/ff_fire.ff_energy_plain) against the JAX package,
float64 on the CPU, on the same numpy inputs made from a seed: HCOOH
(two conformers of its O-H rotor), C2F2H4 with its E/Z dihedral, the
six-carbon chlorocycloalkane and a jittered 12-atom chain. Energies
within 1e-10 relative, coordinates within 1e-6 A, the flags and steps
equal, no near tie of the energy comparisons that steer a band. Also the
launch plan's forms and host array, the routing of run_neb and
idpp_interpolate (the force field's energy to the kernels on the card,
other energies to the captured graph, the CPU op by op) and the
wrappers' checks.'''

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_ff_fire import OnCard
from torch_parity import t64

from tscode_tpu import ff as jff
from tscode_tpu import neb as jneb
from tscode_tpu import optimizers as jopt
from tscode_tpu_torch import ff, neb
from tscode_tpu_torch.graphs import graphize
from tscode_tpu_torch.io_xyz import read_xyz
from tscode_tpu_torch.ops.kernels import ff_fire as kf
from tscode_tpu_torch.ops.kernels import idpp as ki
from tscode_tpu_torch.ops.kernels import neb as kn
from tscode_tpu_torch.pipeline import FIXTURE_DIR
from tscode_tpu_torch.rot_rmsd import _rotate
from tscode_tpu_torch.suite_inputs import chain_ff, chlorocycloalkane

ATOL = 1e-6            # A
E_RTOL = 1e-10         # energies, relative


def endpoints(name):
    '''(start (N, 3), end (N, 3), ff.FFParams) of a fixture, made with
    numpy from seed 2: 'hcooh' the O-H turned by 0 and 180 degrees about
    the C-O bond, each jittered by 0.05 A; 'c2f2h4' the fixture and a
    copy with its CHF2 group turned by 120 degrees about the C-C bond,
    jittered by 0.05 A; 'c2h4' the fixture and a copy with its hydrogens
    jittered by 0.2 A, its double bond's E/Z dihedral protected (the one
    dihedral term among these); 'ring6' the six-carbon
    chlorocycloalkane and a copy
    jittered by 0.15 A; 'chain12' two conformers of the 12-atom
    suite_inputs.chain_ff chain jittered by 0.3 A.'''
    rng = np.random.default_rng(2)
    if name == 'hcooh':
        mol = read_xyz(os.path.join(FIXTURE_DIR, 'HCOOH.xyz'))
        x, nos = mol.atomcoords[0], mol.atomnos
        mask = np.zeros(5, dtype=bool)
        mask[4] = True
        a, b = (_rotate(x, (1, 0, 3, 4), t, mask) + rng.normal(
            size=x.shape) * 0.05 for t in (0, 180))
        return a, b, ff.build_ff_params(x, nos, graphize(x, nos))
    if name == 'c2f2h4':
        mol = read_xyz(os.path.join(FIXTURE_DIR, 'C2F2H4.xyz'))
        x, nos = mol.atomcoords[0], mol.atomnos
        mask = np.zeros(len(x), dtype=bool)
        mask[5:] = True
        b = _rotate(x, (2, 0, 1, 5), 120, mask)
        return x, b + rng.normal(size=x.shape) * 0.05, \
            ff.build_ff_params(x, nos, graphize(x, nos))
    if name == 'c2h4':
        mol = read_xyz(os.path.join(FIXTURE_DIR, 'C2H4.xyz'))
        x, nos = mol.atomcoords[0], mol.atomnos
        b = x + (nos != 6)[:, None] * rng.normal(size=x.shape) * 0.2
        return x, b, ff.build_ff_params(x, nos, graphize(x, nos),
                                        protect_double_bonds=True)
    if name == 'ring6':
        x, nos = chlorocycloalkane(6)
        return x, x + rng.normal(size=x.shape) * 0.15, \
            ff.build_ff_params(x, nos, graphize(x, nos))
    X, params = chain_ff(12, 2, seed=2, noise=0.3)
    return X[0], X[1], params


def port_terms(params, **springs):
    return ff.FireTerms(ff.params_to_device(params, 'cpu', torch.float64),
                        **springs)


def jax_params(params):
    return jff.params_to_device(jff.FFParams(**vars(params)))


# ------------------------------------------------------------ energies


@pytest.mark.parametrize('name', ['hcooh', 'c2f2h4', 'c2h4', 'ring6',
                                  'chain12'])
def test_ff_energy_plain_equals_both_packages(name):
    '''ff_energy_plain (the term energies summed in the kernel's order)
    on eight jittered frames against ff.ff_energy and the JAX ff_energy:
    within 1e-10 relative; C2H4 carries a dihedral term.'''
    a, _, params = endpoints(name)
    X = a + np.random.default_rng(4).normal(size=(8,) + a.shape) * 0.1
    got = kf.ff_energy_plain(t64(X), port_terms(params)).numpy()
    port = ff.ff_energy(t64(X), port_terms(params).params).numpy()
    want = np.asarray(jff.ff_energy(jnp.asarray(X), jax_params(params)))
    assert (len(params.dihedrals) > 0) == (name == 'c2h4')
    np.testing.assert_allclose(got, want, rtol=E_RTOL, atol=0)
    np.testing.assert_allclose(got, port, rtol=E_RTOL, atol=0)


def test_ff_energy_plain_with_springs_and_half_springs():
    '''The springs k (d - t)^2 and half-springs k_h max(d - 2.5, 0)^2 of
    ff.FireTerms on the ring: against the JAX ff_energy plus its
    spring_energy plus the half-springs; within 1e-10 relative; and the
    kernel's slot order (each kind from a multiple of 32).'''
    a, _, params = endpoints('ring6')
    X = a + np.random.default_rng(5).normal(size=(4,) + a.shape) * 0.1
    pairs = np.array([[0, 9], [3, 12], [1, 15]])
    targets = np.array([2.9, 3.4, 4.1])
    half = np.array([[0, 6], [2, 14]])
    terms = port_terms(params, spring_pairs=torch.as_tensor(pairs),
                       spring_targets=t64(targets), spring_k=7.0,
                       half_pairs=torch.as_tensor(half), half_k=3.0)
    got = kf.ff_energy_plain(t64(X), terms).numpy()
    x = jnp.asarray(X)
    d = jnp.linalg.norm(x[:, half[:, 0]] - x[:, half[:, 1]], axis=-1)
    want = np.asarray(jff.ff_energy(x, jax_params(params)) +
                      jopt.spring_energy(x, jnp.asarray(pairs),
                                         jnp.asarray(targets), k=7.0) +
                      3.0 * jnp.sum(jnp.maximum(d - 2.5, 0.0) ** 2, axis=-1))
    np.testing.assert_allclose(got, want, rtol=E_RTOL, atol=0)
    slots = kf.term_energies(t64(X), terms)
    kinds = kn.term_kinds(terms)
    lo, n = kn.energy_slots(kinds)
    assert slots.shape == (4, n) and kinds[4:] == (3, 2)
    assert lo[5] - lo[4] == 32 and n - lo[5] == 32
    assert float(slots[:, lo[5] + 2:].abs().max()) == 0.0


def test_butterfly_and_chunk_sums_follow_the_kernels_order():
    '''butterfly_sum adds lanes l and l ^ o for o = 16 .. 1 (every lane
    the same bits); chunk_sum adds the 32-value chunks' butterflies one
    after the other: on values whose sum depends on the order.'''
    rng = np.random.default_rng(7)
    x = t64(rng.normal(size=(3, 96)) * 10.0 ** rng.integers(-8, 8, (3, 96)))
    want = []
    for row in x.numpy():
        total = 0.0
        for chunk in row.reshape(-1, 32):
            v = chunk.copy()
            for o in (16, 8, 4, 2, 1):
                v = v + v[np.arange(32) ^ o]
            assert len(set(v.tolist())) == 1
            total = total + v[0]
        want.append(total)
    assert kf.chunk_sum(x).tolist() == want


# ------------------------------------------------------------ the band


def band_case(name, n_images):
    '''(IDPP chain (I, N, 3) of the JAX package, FFParams).'''
    a, b, params = endpoints(name)
    return jneb.idpp_interpolate(a, b, n_images), params


def jax_relax(chain, params, n_steps, climbing):
    jp = jax_params(params)
    return np.asarray(jneb._neb_relax(
        jnp.asarray(chain), lambda c: jff.ff_energy(c, jp), n_steps, 1.0,
        0.01, 0.05, climbing))


@pytest.mark.parametrize('n_steps', [10, 400])
@pytest.mark.parametrize('climbing', [False, True])
@pytest.mark.parametrize('n_images', [3, 5, 7])
def test_neb_twin_equals_jax_neb_relax(n_images, climbing, n_steps):
    '''neb_relax_plain on HCOOH's IDPP band against the JAX _neb_relax,
    k 1, dt0 0.01, fmax 0.05: within 1e-6 A; at 10 steps the band has
    not converged, at 400 it latched `done` and the twin stopped there;
    no near tie of an energy comparison.'''
    chain, params = band_case('hcooh', n_images)
    c, done, steps, ties = kn.neb_relax_plain(
        t64(chain), port_terms(params), n_steps, climbing=climbing)
    want = jax_relax(chain, params, n_steps, climbing)
    np.testing.assert_allclose(c.numpy(), want, rtol=0, atol=ATOL)
    assert ties == 0 and done.dim() == 0 and steps.dim() == 0
    assert bool(done) == (int(steps) < n_steps) == (n_steps == 400)
    assert float(np.abs(want - chain).max()) > 1e-3


@pytest.mark.parametrize('name', ['c2f2h4', 'c2h4', 'ring6', 'chain12'])
def test_neb_twin_equals_jax_on_other_fixtures(name):
    '''The twin against the JAX _neb_relax on C2F2H4, C2H4 (a dihedral
    term), the six-carbon ring and the 12-atom chain, 7 images, climbing, 150
    steps: within 1e-6 A, no near tie.'''
    chain, params = band_case(name, 7)
    c, done, steps, ties = kn.neb_relax_plain(
        t64(chain), port_terms(params), 150, climbing=True)
    np.testing.assert_allclose(c.numpy(), jax_relax(chain, params, 150, True),
                               rtol=0, atol=ATOL)
    assert ties == 0
    assert int(steps) == 150 or bool(done)


def test_near_ties_count_the_steering_pairs():
    '''steering_pairs: each interior image against its neighbours and
    the neighbours against each other; with climbing, the top interior
    image against the others. neb_relax_plain counts a pair whose
    energies lie within NEAR_TIE: a band of equal images is all ties.'''
    e = np.array([0.0, 5.0, 1.0, 2.0, 0.5])
    plain = kn.steering_pairs(5, e, False)
    assert plain == {(0, 1), (1, 2), (0, 2), (2, 3), (1, 3), (3, 4),
                     (2, 4)}
    assert kn.steering_pairs(5, e, True) == plain
    assert kn.steering_pairs(6, np.array([0, 5, 1, 2, 3, 0]), True) - \
        kn.steering_pairs(6, e, False) == {(1, 4)}
    a, _, params = endpoints('hcooh')
    flat = t64(np.stack([a] * 5))
    *_, ties = kn.neb_relax_plain(flat, port_terms(params), 2)
    assert ties == 7


def test_neb_band_on_the_cpu_is_the_twin():
    chain, params = band_case('hcooh', 5)
    got = kn.neb_band(t64(chain), port_terms(params), 40, climbing=True)
    want = kn.neb_relax_plain(t64(chain), port_terms(params), 40,
                              climbing=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want[:3]))


# ------------------------------------------------------------ IDPP


def idpp_tables(a, b, n_images):
    '''idpp_interpolate's linear chain and its targets and weights.'''
    chain = jneb.interpolate_chain(a, b, n_images)
    return (chain, *neb.idpp_tables(chain))


@pytest.mark.parametrize('name, n_images', [('hcooh', 7), ('c2f2h4', 5),
                                            ('ring6', 7), ('chain12', 9)])
def test_idpp_twin_equals_jax(name, n_images):
    '''idpp_fire_plain against the JAX fire_minimize_batch of
    idpp_interpolate (300 steps, the endpoints frozen): within 1e-6 A,
    the same per-image stops (the twin's steps: the frozen ends 1, every
    stopped image under 300); the JAX idpp_interpolate and the port's on
    the CPU (fire_minimize_batch) likewise.'''
    a, b, _ = endpoints(name)
    chain, targets, weights = idpp_tables(a, b, n_images)
    freeze = np.zeros((n_images, chain.shape[1]), dtype=bool)
    freeze[0] = freeze[-1] = True
    jc, _, jdone = jopt.fire_minimize_batch(
        jnp.asarray(chain), jneb._idpp_energy, n_steps=300,
        freeze_mask=jnp.asarray(freeze),
        energy_args=(jnp.asarray(targets), jnp.asarray(weights)))
    c, done, steps = ki.idpp_fire_plain(t64(chain), t64(targets),
                                        t64(weights))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    assert done.tolist() == np.asarray(jdone).tolist()
    assert steps[0] == steps[-1] == 1
    assert all(int(s) < 300 for s, d in zip(steps, done) if d)
    assert int(steps.max()) > 1
    for band in (neb.idpp_interpolate(a, b, n_images, device='cpu'),
                 jneb.idpp_interpolate(a, b, n_images)):
        np.testing.assert_allclose(band, c.numpy(), rtol=0, atol=ATOL)


def test_idpp_forces_are_minus_the_gradient():
    '''idpp_forces_plain against torch.autograd of neb._idpp_energy on
    the chain's linear band (every atom, both orderings of its pairs).'''
    a, b, _ = endpoints('chain12')
    chain, targets, weights = (t64(x) for x in idpp_tables(a, b, 5))
    chain = chain + t64(np.random.default_rng(3).normal(size=chain.shape)
                        * 0.05)
    c = chain.clone().requires_grad_(True)
    grad = torch.autograd.grad(neb._idpp_energy(c, targets, weights).sum(),
                               c)[0]
    np.testing.assert_allclose(ki.idpp_forces_plain(chain, targets,
                                                    weights).numpy(),
                               -grad.numpy(), rtol=1e-9, atol=1e-9)


# ------------------------------------------------------------ plans


def dense_kinds(n_atoms):
    '''Term counts with a dense repulsion table: (bonds, angles, pairs,
    dihedrals, springs, half-springs).'''
    return (n_atoms - 1, max(0, n_atoms - 2), n_atoms * (n_atoms - 1) // 2,
            0, 0, 0)


def layout_bytes(form, n_images, n_atoms, kinds, cluster=1, shared=True,
                 staged=True):
    '''(shared bytes, device values) of csrc/neb_band.cu make_layout,
    written out: the arrays (coordinates, velocities, forces, tangents;
    the large form's also the images either side of its own), the
    energies and 5 partial sums an interior image, two buffers of 4
    chunk values a group, and where staged the chunk sums (the lone
    form's always), the entry arrays (3 values a vector) and the tables
    (t0, then from a 16-byte boundary 16 bytes of atoms a term, I + 1
    offsets and a source an entry); the rest in device memory.'''
    I, N, M = n_images, n_atoms, n_images - 2
    nb, na, npairs, nd = kinds[:4]
    T, V = nb + na + npairs + nd, nb + 3 * na + npairs + 4 * nd
    E = 2 * nb + 3 * na + 2 * npairs + 4 * nd
    K = kn.energy_slots(kinds)[1] // 32
    CH = -(-N // 32)
    per = M if form == 'lone' else -(-M // cluster)
    G = min(per, 16, 8)
    arrays = form == 'lone' or (form == 'large' and shared)
    tables = form != 'grid' and arrays and staged
    imgs = M if form == 'lone' else per
    vals = 8 * CH * G
    vals += ((I if form == 'lone' else per + 2) + 3 * imgs) * 3 * N \
        if arrays else 0
    vals += I * K if form == 'lone' or tables else 0
    vals += I + 5 * M
    vals += imgs * 3 * V + T if tables else 0
    smem = 8 * vals
    if tables:
        smem = 16 * -(-smem // 16) + 16 * T + 4 * (N + 1) + 4 * E
    work = (0 if form == 'lone' else M * 3 * N) + \
        (0 if arrays else 3 * M * 3 * N) + \
        (0 if form == 'lone' or tables else I * K) + \
        (0 if tables else 3 * M * V) + (I + 5 * M if form == 'grid' else 0)
    return smem, work


@pytest.mark.parametrize('n_images, n_atoms', [(3, 5), (7, 5), (7, 12),
                                               (7, 27), (5, 150), (7, 150),
                                               (7, 2500)])
def test_launch_plan_forms(n_images, n_atoms):
    '''The rule on I x N from 3 x 5 to 7 x 2,500 with a dense repulsion
    table: the lone form (its arrays in shared memory, its entry arrays
    and tables beside them while they fit) up to 120 interior atoms
    (I - 2) N while it fits; the grid
    form from 400 interior atoms; else the large form, a cluster of
    min(I - 2, 8) blocks, its arrays, entry arrays and tables in shared
    memory while they fit, else its arrays alone, else neither. Each
    form on request; the lone form refused where it does not fit.'''
    M = n_images - 2
    kinds = dense_kinds(n_atoms)
    lo, n = kn.energy_slots(kinds)
    assert n == sum(32 * -(-k // 32) for k in kinds) and n % 32 == 0
    staged = layout_bytes('lone', n_images, n_atoms, kinds)[0] <= \
        kn.SMEM_BYTES
    lone, lone_work = layout_bytes('lone', n_images, n_atoms, kinds,
                                   staged=staged)
    plan = kn.launch_plan(n_images, n_atoms, kinds)
    rule_lone = M * n_atoms <= kn.LONE_MAX_ATOMS == 120
    rule_grid = M * n_atoms >= kn.GRID_MIN_ATOMS == 400
    assert plan.form == ('lone' if rule_lone and lone <= kn.SMEM_BYTES
                         else 'grid' if rule_grid else 'large')
    assert plan.threads == 512 and plan.slots == (lo, n)
    if lone <= kn.SMEM_BYTES:
        got = kn.launch_plan(n_images, n_atoms, kinds, 'lone')
        assert (got.smem, got.work, got.cluster) == (lone, lone_work, 1)
        assert got.shared and got.staged == staged
        assert plan == got or not rule_lone
    else:
        with pytest.raises(ValueError, match='shared bytes'):
            kn.launch_plan(n_images, n_atoms, kinds, 'lone')
    for cl in range(1, min(M, 8) + 1):
        large = kn.launch_plan(n_images, n_atoms, kinds, 'large', cl)
        assert (large.form, large.cluster) == ('large', cl)
        fits = [(sh, st) for sh, st in ((True, True), (True, False),
                                        (False, False))
                if layout_bytes('large', n_images, n_atoms, kinds, cl, sh,
                                st)[0] <= kn.SMEM_BYTES]
        assert (large.shared, large.staged) == fits[0]
        assert (large.smem, large.work) == layout_bytes(
            'large', n_images, n_atoms, kinds, cl, *fits[0])
    if plan.form == 'large':
        assert plan == kn.launch_plan(n_images, n_atoms, kinds, 'large',
                                      min(M, 8))
        assert plan.shared
    if plan.form == 'grid':
        assert plan == kn.launch_plan(n_images, n_atoms, kinds, 'grid')
    assert kn.launch_plan(n_images, n_atoms, kinds, 'large').shared == \
        (n_atoms < 2500)
    with pytest.raises(ValueError, match='blocks a band'):
        kn.launch_plan(n_images, n_atoms, kinds, 'large', min(M, 8) + 1)


def test_plan_args_follow_the_kernels_plan_fields():
    '''Plan.args: the host array of csrc/neb_band.cu PlanField (form,
    threads, shared bytes, cluster, shared, staged, slots, the first slot
    of each of the six kinds); no device memory for the lone form; I1's
    plans: the warp form's and the cluster form's shared bytes.'''
    chain, params = band_case('ring6', 7)
    terms = port_terms(params, spring_pairs=torch.as_tensor([[0, 9]]),
                       spring_targets=t64([3.0]), spring_k=5.0)
    lone = kn.plan_for(t64(chain), terms, 'lone')
    large = kn.plan_for(t64(chain), terms, 'large', 2)
    assert kn.plan_for(t64(chain), terms) == lone     # 90 interior atoms
    lo, n = lone.slots
    assert lone.form == 'lone' and len(lo) == kn.KINDS
    assert kn.term_kinds(terms)[4:] == (1, 0) and lo[5] == lo[4] + 32 == n
    assert list(lone.args()) == [0, 512, lone.smem, 1, 1, 1, n, *lo]
    assert list(large.args()) == [1, 512, large.smem, 2, int(large.shared),
                                  int(large.staged), n, *lo]
    assert lone.work == 0 and large.work > 0
    assert ki.launch_plan(27) == ki.Plan('lone', 128, 8 * (81 + 3 * 729) +
                                         4 * 352)
    assert ki.launch_plan(2500) == ki.Plan('cluster', 160,
                                           8 * (7500 + 8 * 79), 16)
    assert ki.launch_plan_v1(27) == (32, 8 * (81 + 8))
    assert ki.launch_plan_v1(2500) == (512, 8 * (7500 + 8 * 79))


@pytest.mark.parametrize('n_images, n_atoms, most', [
    (3, 5, 132), (7, 27, 132), (7, 150, 132), (7, 2500, 132), (7, 150, 3),
    (7, 2500, 1)])
def test_grid_plan(n_images, n_atoms, most):
    '''The grid form on request: 512 threads, the groups' reduction
    buffers alone in shared memory, every array in device memory (the
    interior images' coordinates, velocities, forces, tangents, the
    chunk sums, the entry arrays, then I energies and 5 partial sums an
    interior image); a slot a thread of every interior image's, on at
    least one block and at most `most`; a cluster on request taken as
    the blocks; refused past `most` blocks; the host array's form field
    2.'''
    M = n_images - 2
    kinds = dense_kinds(n_atoms)
    lo, n = kn.energy_slots(kinds)
    plan = kn.launch_plan(n_images, n_atoms, kinds, 'grid', grid_blocks=most)
    assert (plan.form, plan.threads, plan.shared, plan.staged) == \
        ('grid', 512, False, False)
    assert plan.cluster == max(1, min(most, -(-M * n // 512)))
    assert (plan.smem, plan.work) == layout_bytes(
        'grid', n_images, n_atoms, kinds, plan.cluster, False, False)
    assert plan.slots == (lo, n)
    assert list(plan.args())[:7] == [2, 512, plan.smem, plan.cluster, 0, 0,
                                     n]
    few = kn.launch_plan(n_images, n_atoms, kinds, 'grid', 1, most)
    assert few.cluster == 1 and few.smem == layout_bytes(
        'grid', n_images, n_atoms, kinds, 1, False, False)[0]
    with pytest.raises(ValueError, match='blocks a band'):
        kn.launch_plan(n_images, n_atoms, kinds, 'grid', most + 1, most)


@pytest.mark.parametrize('n_images, n_atoms', [(3, 5), (7, 27), (7, 150),
                                               (7, 2500)])
def test_first_design_plan_forms(n_images, n_atoms):
    '''PR 22's rule, kept for its kernel (launch_plan_v1): lone up to 64
    interior atoms where its shared values fit (every image's
    coordinates, the interior images' three arrays, the energies' chunk
    sums, I energies and 5 partial sums an interior image), at the most
    walk lanes an atom that keep the interior atoms within 512 threads;
    grid from 550 interior atoms; else large on min(I - 2, 8) blocks, its
    four arrays in shared memory while they fit.'''
    M = n_images - 2
    kinds = dense_kinds(n_atoms)
    lo, n = kn.energy_slots(kinds)
    n3 = 3 * n_atoms
    lone = 8 * (n_images * n3 + 3 * M * n3 + n_images * n // 32 +
                n_images + 5 * M)
    plan = kn.launch_plan_v1(n_images, n_atoms, kinds)
    assert plan.form == ('lone' if M * n_atoms <= 64 and
                         lone <= kn.SMEM_BYTES else 'grid'
                         if M * n_atoms >= 550 else 'large')
    assert plan.threads == 512 and plan.slots == (lo, n)
    if lone <= kn.SMEM_BYTES:
        got = kn.launch_plan_v1(n_images, n_atoms, kinds, 'lone')
        assert got.smem == lone and got.lanes == max(
            g for g in (1, 2, 4, 8, 16, 32) if M * n_atoms * g <= 512 or
            g == 1)
    large = kn.launch_plan_v1(n_images, n_atoms, kinds, 'large')
    full = 8 * (4 * -(-M // large.cluster) * n3 + n_images + 5 * M)
    assert large.cluster == min(M, 8)
    assert large.shared == (full <= kn.SMEM_BYTES)
    assert kn.work_values_v1(large, n_images, n_atoms) == \
        4 * M * n3 + n_images * n // 32
    grid = kn.launch_plan_v1(n_images, n_atoms, kinds, 'grid')
    assert (grid.form, grid.smem) == ('grid', 0)
    assert list(large.args())[:7] == [1, 512, large.smem, large.cluster,
                                      large.lanes, int(large.shared), n]


# ------------------------------------------------------------ routing


@pytest.mark.parametrize('energy, device', [('ff', 'card'),
                                            ('analytic', 'card'),
                                            ('ff', 'cpu')])
def test_run_neb_routes_the_force_field_to_the_kernels(monkeypatch, energy,
                                                       device):
    '''On a CUDA tensor run_neb on ff_energy is one I1 launch (the IDPP
    band) and two N1 launches (the plain and the climbing phase, the
    barrier tested on the host between them), no graph; another energy
    takes the captured graph for both phases (and I1 for its IDPP band);
    on the CPU neither: op by op. Every route gives the CPU's band.'''
    a, b, params = endpoints('hcooh')
    if energy == 'ff':
        fn, args = ff.ff_energy, (port_terms(params).params,)
    else:
        def fn(c, center):
            return torch.sum((c - center) ** 2, dim=(-2, -1))
        args = (t64(a),)
    calls = {'neb_band': 0, 'idpp_fire': 0, 'graph': 0}

    def band_kernel(chain, terms, n_steps, k, dt0, fmax, climbing):
        calls['neb_band'] += 1
        assert isinstance(terms, ff.FireTerms) and chain.is_cuda
        return tuple(t.as_subclass(OnCard) for t in kn.neb_relax_plain(
            chain.as_subclass(torch.Tensor), terms, n_steps, k, dt0, fmax,
            climbing)[:3])

    def idpp_kernel(chain, targets, weights, n_steps):
        calls['idpp_fire'] += 1
        assert chain.is_cuda and targets.shape == weights.shape
        return ki.idpp_fire_plain(*(t.as_subclass(torch.Tensor) for t in
                                    (chain, targets, weights)), n_steps)

    def graph(body, state, energy_args, n):
        calls['graph'] += 1
        state = tuple(s.as_subclass(torch.Tensor) for s in state)
        for _ in range(n):
            state = body(state, energy_args)
        return tuple(s.as_subclass(OnCard) for s in state)

    monkeypatch.setattr(kn, 'neb_band', band_kernel)
    monkeypatch.setattr(ki, 'idpp_fire', idpp_kernel)
    monkeypatch.setattr(neb, 'graph_loop', graph)
    if device == 'card':
        real = neb.band_tensor
        monkeypatch.setattr(neb, 'band_tensor',
                            lambda x, dev: real(x, dev).as_subclass(OnCard))
    got = neb.run_neb(a, b, fn, n_images=5, n_steps=60, climb_after=30,
                      energy_args=args, device='cpu')
    want = {('ff', 'card'): {'neb_band': 2, 'idpp_fire': 1, 'graph': 0},
            ('analytic', 'card'): {'neb_band': 0, 'idpp_fire': 1,
                                   'graph': 2},
            ('ff', 'cpu'): {'neb_band': 0, 'idpp_fire': 0,
                            'graph': 0}}[energy, device]
    assert calls == want
    monkeypatch.undo()
    cpu = neb.run_neb(a, b, fn, n_images=5, n_steps=60, climb_after=30,
                      energy_args=args, device='cpu')
    np.testing.assert_allclose(got[0], cpu[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[1], cpu[1], rtol=0, atol=1e-9)
    assert got[2] == cpu[2]


# ------------------------------------------------------------ checks


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    '''float32 and wrong shapes are refused before anything reaches a
    card, by the launches and by the CPU wrappers.'''
    chain, params = band_case('hcooh', 5)
    terms = port_terms(params)
    c = t64(chain)
    _, tg, w = (t64(x) for x in idpp_tables(chain[0], chain[-1], 5))
    for call in (kn.launch, kn.neb_band):
        with pytest.raises(TypeError, match='float64'):
            call(c.float(), terms, 10)
        with pytest.raises(ValueError, match=r'\(I, N, 3\)'):
            call(c[:2], terms, 10)
        with pytest.raises(ValueError, match=r'\(I, N, 3\)'):
            call(c[0], terms, 10)
    for call in (ki.launch, ki.idpp_fire):
        with pytest.raises(TypeError, match='float64'):
            call(c.float(), tg, w)
        with pytest.raises(TypeError, match='float64'):
            call(c, tg.float(), w)
        with pytest.raises(ValueError, match=r'\(I, N, 3\)'):
            call(c[0], tg, w)
        with pytest.raises(ValueError, match='targets and weights'):
            call(c, tg[:, :3], w)
    with pytest.raises(ValueError, match='form'):
        kn.launch_plan(5, 5, (4, 3, 3, 0, 0, 0), 'cluster')
    with pytest.raises(ValueError, match='term kinds'):
        kn.launch_plan(5, 5, (4, 3, 3, 0))
