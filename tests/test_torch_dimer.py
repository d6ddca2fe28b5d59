'''The dimer kernel's plain twin (tscode_tpu_torch.ops.kernels.dimer)
against the JAX package's dimer_saddle on the internal force field,
float64 on the CPU, on the same numpy inputs made from a seed:
coordinates within 1e-6 A, energies within 1e-6 kcal/mol, the flags
equal. The inputs: jittered HCOOH (several seeds, some of which
converge within a few steps, so the twin's done latch and early exit
meet JAX's full scan), the SADDLE scan's sub-peak guesses on the
nine-carbon chlorocycloalkane, HCOOH and C2H4 on tables merged as the
SADDLE stage merges them, and other n_rot and n_steps. Also the twin
against the port's own op-by-op step (torch.autograd forces) step by
step, the routing of saddle.dimer_saddle (the force field's energy to
the kernel on the card, other energies to the captured graph, the CPU
op by op), the launch plan's forms and the launch's checks.'''

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch in this worker)
from test_torch_ff_fire import OnCard
from torch_parity import dimer_case, t64

from tscode_tpu import ff as jff
from tscode_tpu import saddle as jsaddle
from tscode_tpu_torch import ff, saddle
from tscode_tpu_torch.ops.kernels import dimer as kd

ATOL = 1e-6            # A, and kcal/mol on energies
# the twin against the autograd step, after each step: coordinates (A)
# and the mode; on the ring's near-degenerate soft modes the two force
# routes' rounding moves the mode by up to 5e-9 in a step
STEP_ATOL = {'coords': 1e-8, 'mode': 1e-7}


def port_terms(params):
    return ff.FireTerms(ff.params_to_device(params, 'cpu', torch.float64))


def jax_dimer(x, params, **kw):
    '''The JAX package's dimer_saddle on the force field of `params`:
    (coords, energy, converged) as numpy and Python values.'''
    jp = jff.params_to_device(jff.FFParams(**vars(params)))
    c, e, done = jsaddle.dimer_saddle(jnp.asarray(x), jsaddle._ff_energy_single,
                                      energy_args=(jp,), **kw)
    return np.asarray(c), float(e), bool(done)


def assert_twin_equals_jax(name, seed, **kw):
    '''dimer_plain on case (name, seed) against the JAX dimer: frames
    within ATOL, the energy at the result within ATOL, the same flag; a
    converged twin stopped at its latch. Returns the steps taken.'''
    x, params = dimer_case(name, seed)
    terms = port_terms(params)
    c, done, steps = kd.dimer_plain(t64(x)[None], terms, **kw)
    jc, je, jdone = jax_dimer(x, params, **kw)
    np.testing.assert_allclose(c[0].numpy(), jc, rtol=0, atol=ATOL)
    e = float(ff.ff_energy(c, terms.params)[0])
    assert e == pytest.approx(je, abs=ATOL)
    assert bool(done[0]) == jdone
    n_steps = kw.get('n_steps', 300)
    assert 0 < int(steps[0]) <= n_steps
    assert int(steps[0]) == n_steps or jdone
    return int(steps[0]), jdone


@pytest.mark.parametrize('seed', [0, 2, 7, 9])
def test_twin_equals_jax_on_jittered_hcooh(seed):
    '''Jittered HCOOH, 300 steps: each of these converges (at steps 3,
    25, 38 and 38), so the twin's loop ends at its latch while JAX's scan
    runs its full length with the coordinates frozen.'''
    steps, done = assert_twin_equals_jax('hcooh', seed)
    assert done and steps < 60


@pytest.mark.parametrize('guess', [0, 1])
def test_twin_equals_jax_on_the_ring_sub_peaks(guess):
    '''The SADDLE scan's sub-peak guesses on the nine-carbon
    chlorocycloalkane (27 atoms), 20 steps: no convergence, every step
    taken.'''
    steps, done = assert_twin_equals_jax('ring', guess, n_steps=20)
    assert steps == 20 and not done


@pytest.mark.parametrize('seed', [1, 2])
def test_twin_equals_jax_on_merged_tables(seed):
    '''HCOOH and C2H4 on tables merged over the two molecules (the SADDLE
    stage's form), 300 steps: both converge (at steps 21 and 38).'''
    steps, done = assert_twin_equals_jax('merged', seed)
    assert done and steps < 60


@pytest.mark.parametrize('seed, n_steps, n_rot', [(1, 25, 4), (3, 15, 20)])
def test_twin_equals_jax_at_other_n_rot_and_n_steps(seed, n_steps, n_rot):
    steps, done = assert_twin_equals_jax('hcooh', seed, n_steps=n_steps,
                                         n_rot=n_rot)
    assert steps == n_steps and not done


@pytest.mark.parametrize('name, seed', [('hcooh', 1), ('merged', 0),
                                        ('ring', 0)])
def test_twin_step_equals_the_autograd_step(name, seed):
    '''dimer_step_plain (analytic forces) against saddle._dimer_step
    (torch.autograd forces), the state after each of 8 steps: c and v
    within STEP_ATOL, the same flag.'''
    x, params = dimer_case(name, seed)
    terms = port_terms(params)
    body = saddle._dimer_step(ff.ff_energy, 12, 1e-3, 0.02, 0.05)
    c = t64(x)
    want = (c, saddle.dimer_start(c), torch.zeros((), dtype=torch.bool))
    got = (c[None], saddle.dimer_start(c)[None], torch.zeros(1, dtype=bool))
    for _ in range(8):
        want = body(want, (terms.params,))
        got = kd.dimer_step_plain(got, terms)
        for a, b, key in zip(got[:2], want[:2], ('coords', 'mode')):
            np.testing.assert_allclose(a[0].numpy(), b.numpy(), rtol=0,
                                       atol=STEP_ATOL[key])
        assert bool(got[2][0]) == bool(want[2])


def test_twin_batch_equals_its_structures():
    '''Three structures in one batch, each latching at its own step:
    jittered HCOOH (seed 2; 25 steps) and the twin's frames after 10 and
    20 of its steps (11 and 4 more), each frozen at its latch, as when
    run alone.'''
    x, params = dimer_case('hcooh', 2)
    terms = port_terms(params)
    start = t64(x)[None]
    frames = [start] + [kd.dimer_plain(start, terms, n_steps=k)[0]
                        for k in (10, 20)]
    c, done, steps = kd.dimer_plain(torch.cat(frames), terms)
    for k, frame in enumerate(frames):
        ck, dk, sk = kd.dimer_plain(frame, terms)
        np.testing.assert_allclose(c[k].numpy(), ck[0].numpy(), rtol=0,
                                   atol=1e-12)
        assert bool(done[k]) == bool(dk[0]) and int(steps[k]) == int(sk[0])
    assert bool(done.all()) and len(set(steps.tolist())) == 3


@pytest.mark.parametrize('energy, device', [('ff', 'card'),
                                            ('analytic', 'card'),
                                            ('ff', 'cpu')])
def test_dimer_saddle_routes_the_force_field_to_the_kernel(monkeypatch,
                                                           energy, device):
    '''On a CUDA tensor saddle.dimer_saddle hands ff_energy's tables to
    ops/kernels/dimer.dimer once (the kernel's launch), and another energy
    to the captured graph (graph_loop); on the CPU neither: the steps run
    op by op. Every route gives the CPU's result.'''
    x, params = dimer_case('hcooh', 1)
    if energy == 'ff':
        fn, args = ff.ff_energy, (port_terms(params).params,)
    else:
        def fn(c, center):
            return torch.sum((c - center) ** 2, dim=(-2, -1)) - \
                torch.sum((c[..., 0, :] - center[0]) ** 2, dim=-1) * 3.0
        args = (t64(x),)
    calls = {'dimer': 0, 'graph': 0}

    def kernel(c, terms, n_steps, n_rot, dr, step_size, fmax):
        calls['dimer'] += 1
        assert isinstance(terms, ff.FireTerms) and c.shape == (1,) + x.shape
        return kd.dimer_plain(c.as_subclass(torch.Tensor), terms, n_steps,
                              n_rot, dr, step_size, fmax)

    def graph(body, state, energy_args, n):
        calls['graph'] += 1
        state = tuple(s.as_subclass(torch.Tensor) for s in state)
        for _ in range(n):
            state = body(state, energy_args)
        return state

    monkeypatch.setattr(kd, 'dimer', kernel)
    monkeypatch.setattr(saddle, 'graph_loop', graph)
    start = t64(x)
    if device == 'card':
        start = start.as_subclass(OnCard)
    c, e, done = saddle.dimer_saddle(start, fn, n_steps=12,
                                     energy_args=args)
    want = {('ff', 'card'): {'dimer': 1, 'graph': 0},
            ('analytic', 'card'): {'dimer': 0, 'graph': 1},
            ('ff', 'cpu'): {'dimer': 0, 'graph': 0}}[energy, device]
    assert calls == want
    cpu = saddle.dimer_saddle(t64(x), fn, n_steps=12, energy_args=args)
    np.testing.assert_allclose(c.as_subclass(torch.Tensor).numpy(),
                               cpu[0].numpy(), rtol=0, atol=1e-9)
    assert float(e) == pytest.approx(float(cpu[1]), abs=1e-9)
    assert bool(done) == bool(cpu[2]) and done.dim() == 0


# the forms that fit a dense repulsion table of n_atoms atoms in float64
# (test_launch_plan_forms): the lone and the staged form's shared memory
# past 400 atoms; the large form takes any N
FITS = {27: {'lone', 'large', 'staged'}, 400: {'large'}, 2500: {'large'}}


@pytest.mark.parametrize('n_atoms, form', [(27, 'lone'), (400, 'large'),
                                           (2500, 'large')])
def test_launch_plan_forms(n_atoms, form):
    '''The rule: the lone form while its state, its three copies' entry
    forces and its reductions fit a block's shared memory (the ring),
    the large form past that (a dense repulsion table of 400 atoms, and
    2,500 atoms); the staged form (the first design) only on request;
    each form refused where its shared memory does not fit.'''
    n_terms = n_atoms * (n_atoms - 1) // 2
    kinds = (0, 0, n_terms, 0)
    entries = 2 * n_terms
    plan = kd.launch_plan(n_atoms, kinds, entries, 8)
    assert plan.form == form
    state = kd.STATE * 3 * n_atoms * 8
    lone = (27 * n_atoms + 9 * entries + 8 * -(-n_atoms // 32)) * 8
    if form == 'lone':
        assert plan.smem == lone <= kd.SMEM_BYTES
        assert plan.threads == 32 * plan.warps == 512
    else:
        assert lone > kd.SMEM_BYTES
        assert plan.cluster == kd.MAX_CLUSTER == 16
    assert kd.FORMS == ('lone', 'large', 'staged')
    for other in kd.FORMS:
        if other in FITS[n_atoms]:
            got = kd.launch_plan(n_atoms, kinds, entries, 8, other)
            assert got.form == other
            if other == 'staged':
                assert got.smem == state + 6 * entries * 8
                assert got.threads == min(kd.MAX_THREADS,
                                          32 * -(-2 * n_terms // 32))
        else:
            with pytest.raises(ValueError, match='shared bytes'):
                kd.launch_plan(n_atoms, kinds, entries, 8, other)


def chain_terms(n_atoms, seed=13):
    '''(coords (1, N, 3) float64, ff.FireTerms) of suite_inputs.chain_ff's
    n_atoms-atom chain, one jittered conformer.'''
    from tscode_tpu_torch.suite_inputs import chain_ff
    X, params = chain_ff(n_atoms, 1, seed=seed)
    return t64(X), port_terms(params)


def slots_of(kinds):
    '''A copy's term slots, each kind from a multiple of 32.'''
    return sum(32 * -(-k // 32) for k in kinds)


@pytest.mark.parametrize('n_atoms, form', [(8, 'lone'), (27, 'lone'),
                                           (50, 'lone'), (60, 'large'),
                                           (150, 'large')])
def test_lone_form_widths_on_chains(n_atoms, form):
    '''suite_inputs.chain_ff chains (their bonds, angles and dense
    repulsion tables): the lone form up to 50 atoms in float64 (its
    shared values 27 N + 9 N x the largest degree + 8 a chunk of 32
    atoms), the large form from 55. The lone form's rule width: the narrowest of
    LONE_WIDTHS with a thread for each slot of the two copies' term pass
    (each kind from a multiple of 32) and each atom, else 16 warps; every
    width of LONE_WIDTHS on request, with the same shared bytes; past 50
    atoms the lone form refused at every width.'''
    x, terms = chain_terms(n_atoms)
    kinds = tuple(int(t.shape[0]) for t in terms.tables()[0::2])
    plan = kd.plan_for(x, terms)
    assert plan.form == form
    offsets = ff.incidence(terms.params, n_atoms)[0]
    degree = int((offsets[1:] - offsets[:-1]).max())
    lone = (27 * n_atoms + 9 * degree * n_atoms + 8 * -(-n_atoms // 32)) * 8
    assert (lone <= kd.SMEM_BYTES) == (form == 'lone')
    need = max(-(-2 * slots_of(kinds) // 32), -(-n_atoms // 32))
    rule = next((w for w in kd.LONE_WIDTHS if w >= need), 16)
    for w in kd.LONE_WIDTHS:
        if form == 'lone':
            got = kd.plan_for(x, terms, 'lone', warps=w)
            assert (got.threads, got.smem, got.slots[1]) == \
                (32 * w, plan.smem, slots_of(kinds))
            assert got.smem <= kd.SMEM_BYTES
        else:
            with pytest.raises(ValueError, match='shared bytes'):
                kd.plan_for(x, terms, 'lone', warps=w)
    if form == 'lone':
        assert plan.warps == rule and plan.threads == 32 * rule
        assert (plan.smem, plan.degree) == (lone, degree)
        assert plan.slots[0] == tuple(
            slots_of(kinds[:k]) for k in range(4))
    with pytest.raises(ValueError, match='warps'):
        kd.plan_for(x, terms, 'lone', warps=3)


@pytest.mark.parametrize('itemsize', [8, 4])
@pytest.mark.parametrize('n_atoms', [400, 2500, 5000])
def test_large_form_blocks_and_shared_bytes(n_atoms, itemsize):
    '''The large form: a cluster of 16 blocks by the rule (the sweep's
    fastest), ceil(N / cluster) atoms a block, the most lanes an atom (a
    power of two) that keep a block within 512 threads; the structure's
    coordinates, both copies and a block's four vectors of its atoms in
    shared memory where they fit (2,500 atoms in float64, 5,000 in
    float32), else only the reductions' chunk values (5,000 atoms in
    float64: the rest in device memory, 21 N values a structure). Every
    cluster of 1 to 16 on request, none past 16.'''
    kinds = (n_atoms - 1, 2 * n_atoms, n_atoms * (n_atoms - 1) // 2, 0)
    entries = 2 * kinds[0] + 3 * kinds[1] + 2 * kinds[2]
    for cluster in (None, 1, 2, 4, 8, 16):
        plan = kd.launch_plan(n_atoms, kinds, entries, itemsize, 'large',
                              cluster=cluster)
        cl = cluster or 16
        per = -(-n_atoms // cl)
        lanes = max([1] + [g for g in (2, 4, 8, 16, 32) if per * g <= 512])
        red = 8 * -(-per // 32)
        full = (9 * n_atoms + 12 * per + red) * itemsize
        assert (plan.cluster, plan.lanes) == (cl, lanes)
        assert plan.threads == min(512, 32 * -(-per * lanes // 32))
        assert plan.shared == (full <= kd.SMEM_BYTES)
        assert plan.smem == (full if plan.shared else red * itemsize)
        if cluster is None:
            assert kd.launch_plan(n_atoms, kinds, entries, itemsize) == plan
            assert plan.shared == (n_atoms < 5000 or itemsize == 4)
    with pytest.raises(ValueError, match='blocks a structure'):
        kd.launch_plan(n_atoms, kinds, entries, itemsize, 'large',
                       cluster=17)
    with pytest.raises(ValueError, match='shared bytes'):
        kd.launch_plan(n_atoms, kinds, entries, itemsize, 'lone')


def test_plan_args_follow_the_kernels_plan_fields():
    '''Plan.args: the host array of csrc/dimer.cu PlanField (form,
    threads, shared bytes, entries, cluster, lanes, shared, slots, the
    first slot of each kind, the largest degree).'''
    x, terms = chain_terms(27)
    lone = kd.plan_for(x, terms)
    large = kd.plan_for(x, terms, 'large', cluster=2)
    assert list(lone.args(99)) == [1, lone.threads, lone.smem, 99, 1, 1, 0,
                                   lone.slots[1], *lone.slots[0],
                                   lone.degree]
    assert list(large.args(7)) == [2, large.threads, large.smem, 7, 2,
                                   large.lanes, 1, 0, 0, 0, 0, 0, 0]
    assert [kd.Plan(f, 32, 0).args(0)[0] for f in kd.FORMS] == [1, 2, 0]


@pytest.mark.parametrize('name', ['ring', 'merged', 'chain'])
def test_transposed_entries_keep_incidence_order(name):
    '''The lone form's staging table: each term role's entry, atom a's
    k-th in ff.incidence order, at k N + a; every entry at its own
    position, below N x the largest degree; so summing positions a, N +
    a, 2 N + a, ... adds atom a's entries in incidence order. On the
    ring's guess, HCOOH and C2H4 on merged tables, a 40-atom chain.'''
    if name == 'chain':
        x, terms = chain_terms(40)
        x = x[0]
    else:
        x, params = dimer_case(name, 0)
        terms = port_terms(params)
    N = x.shape[0]
    tpos, degree = kd.transposed_entries(terms.params, N)
    offsets, codes, pos = ff.incidence(terms.params, N)
    tables = terms.tables()[0::2]
    atoms = torch.cat([torch.nn.functional.pad(t, (0, 4 - t.shape[1]),
                                               value=-1) for t in tables])
    assert tpos.shape == atoms.shape and tpos.dtype == torch.int32
    assert torch.equal(tpos < 0, atoms < 0)
    got = tpos[tpos >= 0].long()
    assert len(set(got.tolist())) == codes.numel()
    assert int(got.max()) < degree * N
    # position k N + a holds atom a's k-th code of the incidence
    slot_code = torch.full((degree * N,), -1, dtype=torch.int64)
    term_role = torch.arange(4 * atoms.shape[0]).view(-1, 4)
    slot_code[got] = term_role[tpos >= 0]
    for a in range(N):
        lo, hi = int(offsets[a]), int(offsets[a + 1])
        assert slot_code[a:degree * N:N][:hi - lo].tolist() == \
            codes[lo:hi].tolist()
        assert bool((slot_code[a + (hi - lo) * N:degree * N:N] < 0).all())
    assert degree == int((offsets[1:] - offsets[:-1]).max())


@pytest.mark.parametrize('seed', [13, 14])
def test_twin_equals_jax_on_a_60_atom_chain(seed):
    '''A 60-atom suite_inputs.chain_ff chain, where the lone form meets
    the large form, 4 steps: the twin against the JAX dimer_saddle,
    frames within ATOL, energies within ATOL, the same flag.'''
    x, terms = chain_terms(60, seed)
    from tscode_tpu_torch.suite_inputs import chain_ff
    params = chain_ff(60, 1, seed=seed)[1]
    c, done, steps = kd.dimer_plain(x, terms, n_steps=4)
    jc, je, jdone = jax_dimer(x[0].numpy(), params, n_steps=4)
    np.testing.assert_allclose(c[0].numpy(), jc, rtol=0, atol=ATOL)
    assert float(ff.ff_energy(c, terms.params)[0]) == \
        pytest.approx(je, abs=ATOL)
    assert bool(done[0]) == jdone and int(steps[0]) == 4
    assert float((c - x).abs().max()) > 1e-3


def test_launch_checks_its_inputs():
    '''The launch refuses a type or a shape the kernel does not take
    before anything reaches a card.'''
    x, params = dimer_case('hcooh', 1)
    terms = port_terms(params)
    with pytest.raises(TypeError, match='float32/float64'):
        kd.launch(t64(x)[None].to(torch.int32), terms)
    with pytest.raises(ValueError, match=r'\(B, N, 3\)'):
        kd.launch(t64(x), terms)
    with pytest.raises(ValueError, match='form'):
        kd.launch_plan(5, (4, 6, 0, 0), 20, 8, 'cluster')
