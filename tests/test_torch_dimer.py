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


@pytest.mark.parametrize('n_atoms, form', [(27, 'staged'), (400, 'atom'),
                                           (2500, 'device')])
def test_launch_plan_forms(n_atoms, form):
    '''The rule: staged while the state and both copies' entry forces
    fit a block's shared memory (the ring), the atom form while the state
    does (a dense repulsion table of 400 atoms), device memory past that
    (2,500 atoms); threads for 2 slots a term up to MAX_THREADS.'''
    n_terms = n_atoms * (n_atoms - 1) // 2
    entries = 2 * n_terms
    plan = kd.launch_plan(n_atoms, n_terms, entries, 8)
    assert plan.form == form
    state = kd.STATE * 3 * n_atoms * 8
    assert plan.smem == {'staged': state + 6 * entries * 8, 'atom': state,
                         'device': 0}[form]
    assert plan.threads == min(kd.MAX_THREADS,
                               32 * -(-2 * (n_terms if form == 'staged'
                                            else n_atoms) // 32))
    for other in kd.FORMS[kd.FORMS.index(form) + 1:]:
        assert kd.launch_plan(n_atoms, n_terms, entries, 8, other).form == \
            other
    for other in kd.FORMS[:kd.FORMS.index(form)]:
        with pytest.raises(ValueError, match='shared bytes'):
            kd.launch_plan(n_atoms, n_terms, entries, 8, other)


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
        kd.launch_plan(5, 10, 20, 8, 'lone')
